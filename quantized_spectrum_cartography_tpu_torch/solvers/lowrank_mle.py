"""Batched low-rank 1-bit MLE recovery (no deep prior).

Port of ``quantized_spectrum_cartography_tpu/solvers/lowrank_mle.py``
(`backup/notebooks/onebit_lowrank.ipynb` cells 1 and 16): S, C are free
factors optimized by alternating (or joint) Adam on the probit/logistic BCE
likelihood, with periodic projection onto the feasible set.  The JAX
package vmaps one map's solver over a batch; here a leading batch axis B is
written out, every per-map reduction runs over the map's own axes, and the
loss handed to backward is the sum of the per-map costs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
from quantized_spectrum_cartography_tpu_torch.ops.kernels.onebit_nll import (
    fused_onebit_nll,
    pack_codes_1bit,
)
from quantized_spectrum_cartography_tpu_torch.ops.kernels.quantized_nll import (
    fused_quantized_nll,
    fused_quantized_nll_coded,
    onebit_bounds,
    pack_bounds_1bit,
)
from quantized_spectrum_cartography_tpu_torch.ops.likelihood import (
    _SIGMA_EFF,
    neg_likelihood_1bit,
    onebit_nll_factors,
    pack_sign_mask,
)
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import (
    get_tensor,
    project_nonneg,
    project_rank,
    project_rank_subspace,
    safe_fro,
)
from quantized_spectrum_cartography_tpu_torch.ops.metrics import nmse
from quantized_spectrum_cartography_tpu_torch.solvers.base import (
    RecoveryResult,
    adam_init,
    adam_step,
    inner_steps,
    value_and_grad,
)

_MAP = (-3, -2, -1)      # per-map axes of T [B,K,I,J] and S [B,R,I,J]
_PSD = (-2, -1)          # per-map axes of C [B,R,K]


class SolverState(NamedTuple):
    """Everything a run carries from one iteration to the next, so a run
    resumes exactly: N iterations then M resumed ones equal N+M straight.
    opt_s/opt_c are Adam's (count, mu, nu); `iteration` is the absolute
    outer-iteration counter, so the projection cadence
    ((i+1) % projection_interval) continues where it left off."""

    S: torch.Tensor
    C: torch.Tensor
    opt_s: tuple
    opt_c: tuple
    iteration: int


def from_jax_state(S, C, opt_s, opt_c, iteration, device="cuda") -> SolverState:
    """Port `SolverState` from the arrays of a JAX run vmapped over maps.

    S [B,R,I,J], C [B,R,K]; opt_s/opt_c are (count, mu, nu) of optax's
    ScaleByAdamState (count [B] or scalar); iteration [B] or scalar.  The
    batched solver steps all maps together, so counts and iterations must
    agree across the batch."""
    def scalar(x, what):
        vals = np.unique(np.asarray(x))
        if vals.size != 1:
            raise ValueError(f"{what} differs across maps: {vals}")
        return int(vals[0])

    def tensor(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def adam(st, what):
        count, mu, nu = st
        return (torch.tensor(scalar(count, what), dtype=torch.int32,
                             device=device), tensor(mu), tensor(nu))

    return SolverState(S=tensor(S), C=tensor(C),
                       opt_s=adam(opt_s, "opt_s count"),
                       opt_c=adam(opt_c, "opt_c count"),
                       iteration=scalar(iteration, "iteration"))


def to_jax_state(state: SolverState):
    """The inverse of `from_jax_state`: numpy (S, C, (count, mu, nu),
    (count, mu, nu), iteration), with counts and iteration per map."""
    B = state.S.shape[0]

    def adam(st):
        count, mu, nu = st
        return (np.full((B,), int(count), np.int32),
                mu.detach().cpu().numpy(), nu.detach().cpu().numpy())

    return (state.S.detach().cpu().numpy(), state.C.detach().cpu().numpy(),
            adam(state.opt_s), adam(state.opt_c),
            np.full((B,), state.iteration, np.int32))


def recover_lowrank_mle(
    T_obs: torch.Tensor,
    S_init: torch.Tensor,
    C_init: torch.Tensor,
    cfg: SolverConfig,
    mean: float,
    std: float,
    probit: bool = True,
    mask: Optional[torch.Tensor] = None,
    T_true: Optional[torch.Tensor] = None,
    l1: float = 0.0,
    l2: float = 0.01,
    joint: bool = False,
    use_fused: bool = True,
    nll_mode: str = "auto",
    obs_encoding: str = "auto",
    state: Optional[SolverState] = None,
    probe: Optional[torch.Tensor] = None,
) -> RecoveryResult:
    """Recover (S, C) of a batch of maps from 1-bit observations.

    T_obs [B,K,I,J] in {0,1}; S_init [B,R,I,J]; C_init [B,R,K]; mask
    [B,K,I,J] or None; T_true [B,K,I,J] enables NMSE tracking.  Runs on
    T_obs's device.  joint=False: s_inner_iters S-steps then c_inner_iters
    C-steps per outer iteration, projection every projection_interval;
    joint=True: one step on both factors and a projection every iteration.

    use_fused with probit takes a likelihood kernel pair (nll_mode="plain"
    takes its plain version on the card too): obs_encoding="auto" the 1-bit
    pair `fused_onebit_nll`, "codes"/"bounds" the ordinal pair on int8
    codes / f32 bounds with the linear link; use_fused=False takes
    `onebit_nll_factors`; probit=False the generic logistic loss.  `state` resumes a previous run from its
    result's aux["state"]; `probe` is the subspace projection's probe
    (`ops.lowrank.default_probe` if None).  costs/nmses are [B, max_iters];
    each cost is the last C step's, evaluated before its update."""
    B, R = S_init.shape[:2]
    track_true = T_true is not None

    if use_fused and probit:
        count = (mask.sum(dim=_MAP) if mask is not None else
                 torch.full((B,), float(T_obs[0].numel()),
                            device=T_obs.device))
        if obs_encoding == "auto":
            # the specialized 2-bin kernel pair on int8 codes
            codes = pack_codes_1bit(T_obs, mask)

            def nll_fn(S_flat, Ct):
                return fused_onebit_nll(S_flat, Ct, codes, float(mean), std,
                                        nll_mode)
        elif obs_encoding == "codes":
            # the generic ordinal kernels, linear link, 2 bins split at mean
            codes = pack_codes_1bit(T_obs, mask)
            bbt = onebit_bounds(mean)

            def nll_fn(S_flat, Ct):
                return fused_quantized_nll_coded(S_flat, Ct, codes, bbt, std,
                                                 0.0, True, None, nll_mode)
        elif obs_encoding == "bounds":
            W, U = pack_bounds_1bit(T_obs, mean, mask)

            def nll_fn(S_flat, Ct):
                return fused_quantized_nll(S_flat, Ct, W, U, std, 0.0, True,
                                           None, nll_mode)
        else:
            raise ValueError(f"unknown obs_encoding {obs_encoding!r}")

        def cost_fn(S, C):
            nll = nll_fn(S.reshape(B, R, -1), C.transpose(1, 2).contiguous())
            return (nll / count + l1 * safe_fro(S, _MAP)
                    + l2 * safe_fro(C, _PSD))
    elif probit:
        sm = pack_sign_mask(T_obs, mask)
        inv_s = 1.0 / (std * _SIGMA_EFF)
        inv_count = (1.0 / mask.sum(dim=_MAP).clamp_min(1.0)
                     if mask is not None else
                     torch.full((B,), 1.0 / T_obs[0].numel(),
                                device=T_obs.device))

        def cost_fn(S, C):
            nll = onebit_nll_factors(S, C, sm, float(mean), inv_s, inv_count)
            return nll + l1 * safe_fro(S, _MAP) + l2 * safe_fro(C, _PSD)
    else:
        def cost_fn(S, C):
            return (neg_likelihood_1bit(get_tensor(S, C), T_obs, mean, std,
                                        probit, mask=mask)
                    + l1 * safe_fro(S, _MAP) + l2 * safe_fro(C, _PSD))

    def project(S, C):
        if cfg.projection_method == "subspace":
            S = project_rank_subspace(S, cfg.rank_truncation, probe=probe)
        else:
            S = project_rank(S, cfg.rank_truncation)
        C = project_nonneg(C)
        if cfg.nonneg_slf:
            S = project_nonneg(S)
        return S, C

    lr_c = cfg.lr_s if joint else cfg.lr_c
    if state is not None:
        S, C, ss, cs, start = state
    else:
        S, C = S_init, C_init
        ss, cs, start = adam_init(S), adam_init(C), 0

    costs, nmses = [], []
    with torch.no_grad():
        for i in range(start, start + cfg.max_iters):
            if joint:
                cost, (gS, gC) = value_and_grad(cost_fn, S, C)
                S, ss = adam_step(cfg.lr_s, gS, S, ss)
                C, cs = adam_step(lr_c, gC, C, cs)
                S, C = project(S, C)
            else:
                S, ss, _ = inner_steps(cfg.s_inner_iters, cfg.lr_s,
                                       lambda s: cost_fn(s, C), S, ss)
                C, cs, cost = inner_steps(cfg.c_inner_iters, lr_c,
                                          lambda c: cost_fn(S, c), C, cs)
                if (i + 1) % cfg.projection_interval == 0:
                    S, C = project(S, C)
            costs.append(cost)
            nmses.append(nmse(get_tensor(S, C), T_true, _MAP) if track_true
                         else torch.zeros(B, device=S.device))

    final = SolverState(S=S, C=C, opt_s=ss, opt_c=cs,
                        iteration=start + cfg.max_iters)
    empty = torch.zeros(B, 0, device=S.device)
    return RecoveryResult(
        S=S, C=C, T_hat=get_tensor(S, C),
        nmses=torch.stack(nmses, dim=1) if nmses else empty,
        costs=torch.stack(costs, dim=1) if costs else empty,
        aux={"state": final})
