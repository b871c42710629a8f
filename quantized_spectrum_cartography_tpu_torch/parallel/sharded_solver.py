"""Sharded batched recovery over the ('data', 'model') layout of `mesh`.

Port of ``quantized_spectrum_cartography_tpu/parallel/sharded_solver.py``.
Every entry takes the global arrays, as the JAX functions do, and each rank
cuts its own shard with the helpers of `mesh`; it returns this rank's
shards (the counterpart of a JAX array's addressable shards):

1. `batched_recover_lowrank` — data parallelism: each rank solves its rows
   of the batch with `recover_lowrank_mle` (the 1-bit kernel pair on the
   card).  No communication.

2. `make_sharded_mle_step` / `recover_lowrank_mle_ksharded` — the
   frequency axis also sharded, over 'model': per-rank likelihood
   gradients are local, and the S-factor gradient — the only
   cross-frequency quantity — is summed with one all-reduce over 'model'
   a step (plus the per-map scalars nll and ||C||^2).  The likelihood is
   the plain `ops.likelihood.log_prob_probit_bounds`, as in the JAX
   package.
"""

from __future__ import annotations

from typing import Optional

import torch

from quantized_spectrum_cartography_tpu_torch.config import (
    QuantizerConfig,
    SolverConfig,
)
from quantized_spectrum_cartography_tpu_torch.ops.likelihood import (
    log_prob_probit_bounds,
)
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import (
    project_nonneg,
    project_rank_subspace,
    safe_fro,
)
from quantized_spectrum_cartography_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    batch_freq_sharding,
    batch_sharding,
)
from quantized_spectrum_cartography_tpu_torch.solvers.base import (
    RecoveryResult,
    adam_init,
    adam_step,
)
from quantized_spectrum_cartography_tpu_torch.solvers.lowrank_mle import (
    recover_lowrank_mle,
)


def batched_recover_lowrank(
    mesh: Mesh,
    T_obs: torch.Tensor,      # [B, K, I, J]
    S_init: torch.Tensor,     # [B, R, I, J]
    C_init: torch.Tensor,     # [B, R, K]
    cfg: SolverConfig,
    mean: float,
    std: float,
    T_true: Optional[torch.Tensor] = None,
    **solver_kw,
) -> RecoveryResult:
    """Data-parallel batched low-rank MLE: this rank's rows of the batch
    (`batch_sharding`), solved independently; no communication.
    `solver_kw` goes to `recover_lowrank_mle` (e.g. `probe`)."""
    def rows(x):
        return None if x is None else batch_sharding(mesh, x)

    return recover_lowrank_mle(rows(T_obs), rows(S_init), rows(C_init), cfg,
                               mean, std, T_true=rows(T_true), **solver_kw)


def _local_grads(S, C, W, U, sigma, offset, clamp):
    """(nll [B], dX) of this rank's frequency slice: the
    likelihood's gradient in X, through autograd on the plain log-link
    likelihood.  With `clamp` the log-link argument is floored at 1e-20
    and the gradient is 0 where the floor is active."""
    X = torch.einsum("brk,brp->bkp", C, S)
    Xo = X + offset
    if clamp:
        # an Adam step between nonneg projections can push X + offset
        # below zero, which would NaN the whole trajectory
        Xo = Xo.clamp_min(1e-20)
    x = torch.log(Xo).detach().requires_grad_(True)
    with torch.enable_grad():
        nll = -log_prob_probit_bounds(W, U, x, sigma).sum(dim=(-2, -1))
        (dx,) = torch.autograd.grad(nll.sum(), x)
    dX = dx / Xo
    if clamp:
        # the clamped forward is constant in X where the floor is active,
        # so its true gradient is 0 there; dividing by the floor instead
        # would blow Adam's second moment up to inf
        dX = torch.where(X + offset > 1e-20, dX, torch.zeros_like(dX))
    return nll.detach(), dX


def make_sharded_mle_step(
    mesh: Mesh,
    scfg: SolverConfig,
    qcfg: QuantizerConfig,
    lr: float = 0.001,
):
    """One projected gradient step of both factors, K sharded over 'model'.

    The step takes the global S [B, R, IJ], C [B, R, K], W/U [B, K, IJ] and
    returns this rank's (S [B_loc, R, IJ], C [B_loc, R, K_loc], nll
    [B_loc]):

      local:  X = C_locᵀ S -> logP -> dX        (entrywise in K: no comm)
      dC_loc = dX Sᵀ                            (local: C is K-sharded)
      dS     = all_reduce_model(C_loc dX)       (the one collective)
    """
    sigma, offset = qcfg.noise_std, qcfg.log_offset

    def step(S, C, W, U):
        S = batch_sharding(mesh, S)
        C = batch_freq_sharding(mesh, C, freq_axis=2)
        W = batch_freq_sharding(mesh, W)
        U = batch_freq_sharding(mesh, U)
        with torch.no_grad():
            nll, dX = _local_grads(S, C, W, U, sigma, offset,
                                   clamp=False)
            dC = torch.einsum("bkp,brp->brk", dX, S)
            dS = all_reduce_sum(mesh, "model",
                                torch.einsum("brk,bkp->brp", C, dX))
            nll = all_reduce_sum(mesh, "model", nll)
            return S - lr * dS, project_nonneg(C - lr * dC), nll

    return step


def recover_lowrank_mle_ksharded(
    mesh: Mesh,
    W: torch.Tensor,          # [B, K, IJ] lower log-bin bounds (gathered)
    U: torch.Tensor,          # [B, K, IJ] upper bounds
    S_init: torch.Tensor,     # [B, R, IJ]
    C_init: torch.Tensor,     # [B, R, K]
    scfg: SolverConfig,
    qcfg: QuantizerConfig,
    l2: float = 0.01,
    probe: Optional[torch.Tensor] = None,
):
    """Full K-sharded ordinal-MLE recovery: the model-parallel path for
    problems too large for one device (many bands / finer grids).

    Adam on both factors (both at lr_s, as in the JAX package) over
    scfg.max_iters joint steps; observations and C sharded over 'model', S
    replicated.  Each step sums dS over 'model' with one all-reduce (the
    only cross-frequency tensor) and the per-map nll and ||C||^2 with one
    more; S's Adam state stays in lockstep on every rank, C's is local.
    Every projection_interval steps S is rank-truncated with
    `project_rank_subspace` (square grids only; `probe` is its probe) and C
    clamped nonnegative.

    Returns this rank's (S [B_loc, R, IJ], C [B_loc, R, K_loc], costs
    [B_loc, iters])."""
    sigma, offset = qcfg.noise_std, qcfg.log_offset
    S = batch_sharding(mesh, S_init)
    C = batch_freq_sharding(mesh, C_init, freq_axis=2)
    W = batch_freq_sharding(mesh, W)
    U = batch_freq_sharding(mesh, U)
    B, R, IJ = S.shape
    I_grid = int(round(IJ ** 0.5))
    do_rank_proj = I_grid * I_grid == IJ        # square spatial grid only

    ss, cs = adam_init(S), adam_init(C)
    costs = []
    with torch.no_grad():
        for i in range(scfg.max_iters):
            nll, dX = _local_grads(S, C, W, U, sigma, offset,
                                   clamp=True)
            dC = torch.einsum("bkp,brp->brk", dX, S)
            dS = all_reduce_sum(mesh, "model",
                                torch.einsum("brk,bkp->brp", C, dX))
            scalars = all_reduce_sum(
                mesh, "model", torch.stack([nll, C.square().sum(dim=(1, 2))]))
            nll, c_fro = scalars[0], torch.sqrt(scalars[1] + 1e-12)
            s_fro = safe_fro(S, (1, 2))
            # the regularizers' gradients, in closed form
            dC = dC + l2 * C / c_fro[:, None, None]
            dS = dS + l2 * S / s_fro.clamp_min(1e-12)[:, None, None]
            costs.append(nll + l2 * c_fro + l2 * s_fro)
            S, ss = adam_step(scfg.lr_s, dS, S, ss)
            C, cs = adam_step(scfg.lr_s, dC, C, cs)
            if (i + 1) % scfg.projection_interval == 0:
                if do_rank_proj:
                    # S is replicated over 'model': every rank projects
                    # it identically, no communication
                    S = project_rank_subspace(
                        S.reshape(B, R, I_grid, I_grid), scfg.rank_truncation,
                        probe=probe).reshape(B, R, IJ)
                C = project_nonneg(C)
    return S, C, torch.stack(costs, dim=1)
