"""Main quantized-recovery solver: probit MLE with a GAN deep prior.

Port of ``quantized_spectrum_cartography_tpu/solvers/mle_gan.py`` (the
reference's `qmc/qmc.ipynb` cell 1):

  repeat max_iters times:
    C-step:  Adam on C of  -sum log P(Y | log(T_hat(S, C) + offset))
             + lambda_c ||C||_F + lambda_s ||Z||_F,  then clamp C >= 0
    (at absolute iteration z_search_at_iter: randomized Z re-init, global
     and local candidates scored by the same likelihood)
    S-step:  S = G(Z); Adam on Z of the same cost

One map per call, as in the JAX package.  The likelihood is the ordinal
kernel pair of ``ops/kernels/quantized_nll.py`` on f32 bin bounds
(obs_encoding="bounds") or int8 codes ("codes"), or, with use_fused=False,
the generic bounds likelihood under autograd.  The JAX package's two
`lax.scan` phases around the search are Python loops here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from quantized_spectrum_cartography_tpu_torch.config import (
    QuantizerConfig,
    SolverConfig,
)
from quantized_spectrum_cartography_tpu_torch.ops.kernels.quantized_nll import (
    fused_quantized_nll,
    fused_quantized_nll_coded,
    pack_bounds,
    pack_codes,
    score_quantized_nll,
)
from quantized_spectrum_cartography_tpu_torch.ops.likelihood import (
    gather_bin_bounds,
    log_prob_probit_bounds,
    masked_nll,
)
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import (
    get_tensor,
    project_nonneg,
    safe_fro,
)
from quantized_spectrum_cartography_tpu_torch.ops.metrics import nmse
from quantized_spectrum_cartography_tpu_torch.solvers.base import (
    RecoveryResult,
    adam_init,
    inner_steps,
)
from quantized_spectrum_cartography_tpu_torch.solvers.priors import (
    randomized_search,
)


class GanSolverState(NamedTuple):
    """What an MLE-GAN run carries between iterations.  `iteration` is
    absolute, so a resumed run that starts past z_search_at_iter does not
    run the search again: N then M resumed iterations equal N+M straight.
    opt_c/opt_z are Adam's (count, mu, nu)."""

    C: torch.Tensor          # [R, K]
    Z: torch.Tensor          # [R, z_dim]
    opt_c: tuple
    opt_z: tuple
    iteration: int


def from_jax_state(C, Z, opt_c, opt_z, iteration,
                   device="cuda") -> GanSolverState:
    """Port a JAX `GanSolverState` from its arrays: C [R,K], Z [R,z],
    opt_c/opt_z the (count, mu, nu) of optax's ScaleByAdamState."""
    def tensor(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def adam(st):
        count, mu, nu = st
        return (torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                             device=device), tensor(mu), tensor(nu))

    return GanSolverState(C=tensor(C), Z=tensor(Z), opt_c=adam(opt_c),
                          opt_z=adam(opt_z),
                          iteration=int(np.asarray(iteration)))


def to_jax_state(state: GanSolverState):
    """The inverse of `from_jax_state`: numpy (C, Z, (count, mu, nu),
    (count, mu, nu), iteration)."""
    def adam(st):
        count, mu, nu = st
        return (np.int32(int(count)), mu.detach().cpu().numpy(),
                nu.detach().cpu().numpy())

    return (state.C.detach().cpu().numpy(), state.Z.detach().cpu().numpy(),
            adam(state.opt_c), adam(state.opt_z), np.int32(state.iteration))


def _likelihood(Y, mask, qcfg, R, use_fused, nll_mode, obs_encoding):
    """(nll(S [R,I,J], C [R,K]) -> scalar, score(S [N,R,I,J], C) -> [N])."""
    offset, std = qcfg.log_offset, qcfg.noise_std
    if not use_fused:
        Wb, Ub = gather_bin_bounds(Y, qcfg.boundaries)

        def nll(S, C):
            x = torch.log(get_tensor(S, C) + offset)
            return masked_nll(log_prob_probit_bounds(Wb, Ub, x, std), mask)

        def score(S, C):
            return torch.stack([nll(s, C) for s in S])

        return nll, score
    if obs_encoding == "codes":
        obs = (pack_codes(Y, qcfg.num_bins, mask)[None],)
        bbt = tuple(float(v) for v in qcfg.boundaries)
    elif obs_encoding == "bounds":
        obs = tuple(x[None].contiguous()
                    for x in pack_bounds(Y, qcfg.boundaries, mask))
        bbt = None
    else:
        raise ValueError(f"unknown obs_encoding {obs_encoding!r}: "
                         "'bounds' or 'codes'")

    def factors(S, C):
        return (S.reshape(S.shape[0], R, -1).contiguous(),
                C.T.contiguous()[None])

    def nll(S, C):
        S_flat, Ct = factors(S[None], C)
        if bbt is None:
            return fused_quantized_nll(S_flat, Ct, *obs, std, offset,
                                       mode=nll_mode)[0]
        return fused_quantized_nll_coded(S_flat, Ct, obs[0], bbt, std,
                                         offset, mode=nll_mode)[0]

    def score(S, C):
        S_flat, Ct = factors(S, C)
        return score_quantized_nll(S_flat, Ct, obs, std, offset, bbt,
                                   mode=nll_mode)

    return nll, score


def recover_mle_gan(
    Y: torch.Tensor,
    mask: Optional[torch.Tensor],
    gen_apply: Callable[[torch.Tensor], torch.Tensor],
    scfg: SolverConfig,
    qcfg: QuantizerConfig,
    Z_init: Optional[torch.Tensor] = None,
    C_init: Optional[torch.Tensor] = None,
    num_emitters: int = 2,
    T_true: Optional[torch.Tensor] = None,
    use_fused: bool = True,
    nll_mode: str = "auto",
    obs_encoding: str = "bounds",
    state: Optional[GanSolverState] = None,
    generator: Optional[torch.Generator] = None,
    search_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> RecoveryResult:
    """Recover (S = G(Z), C) from ordinal observations Y [K, I, J] (bin
    indices) with entry mask [K, I, J] (or None), on Y's device.

    use_fused=True takes the ordinal kernel pair (nll_mode="plain": their
    plain versions, on the card too); False the generic likelihood under
    autograd.  Z_init [R, z] and the search's standard normals
    `search_draws` (global [G, R, z], local [L, R, z]) are drawn from
    `generator` unless given.  `state` resumes a previous result's
    aux["state"]."""
    K = Y.shape[0]
    R = num_emitters
    dev = Y.device
    nll, score = _likelihood(Y, mask, qcfg, R, use_fused, nll_mode,
                             obs_encoding)
    track_true = T_true is not None

    if Z_init is None:
        Z_init = torch.randn(R, scfg.z_dim, generator=generator, device=dev)
    if C_init is None:
        C_init = torch.zeros(R, K, device=dev)

    def cost_c(C, S, Z):
        return (nll(S, C) + scfg.lambda_c * safe_fro(C)
                + scfg.lambda_s * safe_fro(Z))

    def cost_z(Z, C):
        return (nll(gen_apply(Z), C) + scfg.lambda_c * safe_fro(C)
                + scfg.lambda_s * safe_fro(Z))

    def c_step(C, S, Z, cs):
        C, cs, _ = inner_steps(scfg.c_inner_iters, scfg.lr_c,
                               lambda c: cost_c(c, S, Z), C, cs, batch_dims=0)
        return project_nonneg(C), cs

    def z_step(C, Z, zs):
        Z, zs, cost = inner_steps(scfg.s_inner_iters, scfg.lr_z,
                                  lambda z: cost_z(z, C), Z, zs, batch_dims=0)
        S = gen_apply(Z)
        err = (nmse(get_tensor(S, C), T_true) if track_true
               else torch.zeros((), device=dev))
        return Z, S, zs, cost, err

    with torch.no_grad():
        if state is not None:
            start = state.iteration
            C, Z, cs, zs = state.C, state.Z, state.opt_c, state.opt_z
        else:
            start = 0
            C, Z = C_init, Z_init
            cs, zs = adam_init(C), adam_init(Z)
        S = gen_apply(Z)

        # the search fires at ABSOLUTE iteration z_search_at_iter; a resumed
        # run that starts past it does not run it again
        t_abs = max(scfg.z_search_at_iter, 0)
        t = min(max(t_abs - start, 0), scfg.max_iters)
        do_search = ((scfg.z_search_global + scfg.z_search_local) > 0
                     and t_abs >= start and t < scfg.max_iters)

        costs, nmses = [], []
        for i in range(scfg.max_iters):
            C, cs = c_step(C, S, Z, cs)
            if do_search and i == t:
                Z = randomized_search(
                    gen_apply, lambda Sc: score(Sc, C), Z,
                    scfg.z_search_global, scfg.z_search_local,
                    scfg.z_search_local_scale, generator=generator,
                    draws=search_draws)
            Z, S, zs, cost, err = z_step(C, Z, zs)
            costs.append(cost)
            nmses.append(err)

    final = GanSolverState(C=C, Z=Z, opt_c=cs, opt_z=zs,
                           iteration=start + scfg.max_iters)
    empty = torch.zeros(0, device=dev)
    return RecoveryResult(
        S=S, C=C, T_hat=get_tensor(S, C),
        nmses=torch.stack(nmses) if nmses else empty,
        costs=torch.stack(costs) if costs else empty,
        aux={"Z": Z, "state": final})
