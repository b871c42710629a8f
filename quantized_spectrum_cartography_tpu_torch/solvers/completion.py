"""Unquantized masked-completion solvers (the pre-quantization toolchain).

Port of ``quantized_spectrum_cartography_tpu/solvers/completion.py``:
- `recover_masked_mse` (`deep_prior/optimization.ipynb` cells 17/19): GAN
  or AE prior completion of masked SLFs, random draws then Adam on z;
- `optimize_z` (`backup/algorithms/nn_descent_gan.py:49-183`): the
  multi-emitter latent descent on masked MSE;
- DowJons proper (`joint_opt_ae.m:403-465`): exact NNLS C-steps alternated
  with latent S-steps on the masked unquantized tensor, through the VAE /
  GAN decoder (`recover_dowjons_unquantized`), the AE's latent
  (`recover_dowjons_ae_latent`) or the AE's input (`recover_dowjons_ae`);
- the observed-entry C polish and the residual peak patches that the
  harness's Nasdac and DowJons methods apply.

Leading axes of T [..., K, I, J] and of the masks [..., I, J] are batch
axes: one call solves every problem of a batch, each with its own
discrete choices (restart winners, peaks, early stops).  Latent descents
use the port's functional Adam (`solvers.base`) in optax's order.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from quantized_spectrum_cartography_tpu_torch.baselines.nnls import (
    nnls_gram,
    nnls_rows,
)
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import get_tensor
from quantized_spectrum_cartography_tpu_torch.ops.metrics import nmse
from quantized_spectrum_cartography_tpu_torch.solvers.base import (
    RecoveryResult,
    adam_init,
    adam_step,
    adam_update,
    gather_winner,
    value_and_grad,
)
from quantized_spectrum_cartography_tpu_torch.solvers.gan_inversion import (
    _adam_descent,
)
from quantized_spectrum_cartography_tpu_torch.solvers.nasdac import (
    _at,
    anchor_weight,
    witness_peaks,
)
from quantized_spectrum_cartography_tpu_torch.solvers.priors import (
    randomized_search,
)
from quantized_spectrum_cartography_tpu_torch.utils.tracing import span

_MAP = (-3, -2, -1)


def _gen(gen_apply: Callable[[torch.Tensor], torch.Tensor],
         Z: torch.Tensor) -> torch.Tensor:
    """gen_apply on latents Z [..., z] of any leading shape -> [..., I, J]."""
    S = gen_apply(Z.reshape(-1, Z.shape[-1]))
    return S.reshape(*Z.shape[:-1], *S.shape[-2:])


def _peak_values(S: torch.Tensor, peaks_yx: torch.Tensor) -> torch.Tensor:
    """S[..., r, y_p, x_p] -> [..., R, P]."""
    return _at(S, peaks_yx[..., None, :, :].expand(
        *S.shape[:-2], *peaks_yx.shape[-2:]))


def _polish_c_to_observed(
    S: torch.Tensor,
    C_anchored: torch.Tensor,
    T_obs: torch.Tensor,
    W: torch.Tensor,
    ridge_rel: float = 0.1,
    nnls_iters: int = 200,
) -> torch.Tensor:
    """Amplitude polish after an anchored solve: per-band NNLS on the
    observed entries with a Tikhonov ridge (relative weight `ridge_rel` of
    the observed design's mean diagonal energy) toward the anchored C.
    S [..., R, I, J], C_anchored [..., R, K], W [..., I, J].  Returns the
    polished C [..., R, K]."""
    R = S.shape[-3]
    S_obs = S.flatten(-2) * W.flatten(-2)[..., None, :]          # [..., R, IJ]
    G = S_obs @ S_obs.transpose(-1, -2)
    lam = ridge_rel * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / R
    sq = torch.sqrt(lam.clamp_min(1e-20))[..., None, None]
    eye = torch.eye(R, dtype=S.dtype, device=S.device)
    A_aug = torch.cat([S_obs.transpose(-1, -2),
                       (sq * eye).expand(*S_obs.shape[:-2], R, R)], -2)
    B_aug = torch.cat([(T_obs * W[..., None, :, :]).flatten(-2),
                       sq * C_anchored.transpose(-1, -2)], -1)
    return nnls_rows(A_aug, B_aug, iters=nnls_iters).transpose(-1, -2)


def peak_gated_blend(
    S: torch.Tensor,
    C_anch: torch.Tensor,
    C_pol: torch.Tensor,
    peaks_yx: torch.Tensor,
    gamma: float = 0.8,
    protect_floor: float = 0.0,
) -> torch.Tensor:
    """Per-band blend a_k * C_pol + (1 - a_k) * C_anch with a_k the largest
    share that renders no protected peak below gamma x its anchored value
    (by linearity in closed form; see the JAX package's docstring for the
    measurements behind it).  A (band, peak) pair is protected where the
    anchored render exceeds `protect_floor`.  S [..., R, I, J]; C_*
    [..., R, K]; peaks_yx [..., P, 2] (y, x).  Returns C [..., R, K]."""
    s_at = _peak_values(S, peaks_yx)                           # [..., R, P]
    v_anch = C_anch.transpose(-1, -2) @ s_at                   # [..., K, P]
    v_pol = C_pol.transpose(-1, -2) @ s_at
    need = (v_pol < gamma * v_anch) & (v_anch > protect_floor)
    a = torch.where(need, (1.0 - gamma) * v_anch
                    / (v_anch - v_pol).clamp_min(1e-12), 1.0)
    a_k = a.amin(-1).clamp(0.0, 1.0)[..., None, :]             # [..., 1, K]
    return a_k * C_pol + (1.0 - a_k) * C_anch


def _constrained_polish_c(
    S: torch.Tensor,
    C_anch: torch.Tensor,
    T_obs: torch.Tensor,
    W: torch.Tensor,
    peaks_yx: torch.Tensor,
    gamma: float = 0.75,
    ridge_rel: float = 0.1,
    beta_rel: float = 10.0,
    rounds: int = 3,
    nnls_iters: int = 200,
) -> torch.Tensor:
    """Per-band peak-constrained observed-entry polish: for every band k

        min_{c >= 0} ||diag(w_obs)(S_obs^T c - t_k)||^2 + lam ||c - c_anch,k||^2
        s.t.         s(p) . c >= gamma * v_anch[k, p] at the witnessed peaks

    by an iterated quadratic penalty in Gram space over the accumulated
    active set (every constraint an earlier iterate violated stays
    penalized), `rounds` rounds of per-band NNLS.  S [..., R, I, J];
    C_anch [..., R, K]; T_obs [..., K, I, J]; W [..., I, J];
    peaks_yx [..., P, 2].  Returns C [..., R, K]."""
    R = S.shape[-3]
    S_obs = S.flatten(-2) * W.flatten(-2)[..., None, :]          # [..., R, IJ]
    G = S_obs @ S_obs.transpose(-1, -2)                         # [..., R, R]
    scale = (torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / R)[..., None, None]
    lam, beta = ridge_rel * scale, beta_rel * scale
    AtB0 = (S_obs @ (T_obs * W[..., None, :, :]).flatten(-2).transpose(-1, -2)
            + lam * C_anch)                                     # [..., R, K]
    AtA0 = G + lam * torch.eye(R, dtype=S.dtype, device=S.device)

    s_at = _peak_values(S, peaks_yx)                            # [..., R, P]
    target = gamma * (C_anch.transpose(-1, -2) @ s_at)          # [..., K, P]
    ss = s_at[..., :, None, :] * s_at[..., None, :, :]          # [..., R, R, P]

    def solve(active):                       # active [..., K, P] in {0, 1}
        AtA = AtA0[..., None, :, :] + beta[..., None, :, :] * (
            active[..., :, None, None, :] * ss[..., None, :, :, :]).sum(-1)
        AtB = AtB0.transpose(-1, -2) + beta * (
            (active * target) @ s_at.transpose(-1, -2))         # [..., K, R]
        return nnls_gram(AtA, AtB[..., None], nnls_iters)[..., 0].transpose(
            -1, -2)                                             # [..., R, K]

    active = torch.zeros_like(target)
    C = solve(active)                        # the unconstrained ridge NNLS
    for _ in range(rounds):
        v = C.transpose(-1, -2) @ s_at                          # [..., K, P]
        active = torch.maximum(active, (v < target - 1e-9).to(S.dtype))
        C = solve(active)
    return C


def gated_polish_c(
    S: torch.Tensor,
    C_anch: torch.Tensor,
    T_obs: torch.Tensor,
    W: torch.Tensor,
    T_wit: torch.Tensor,
    num_peaks: int,
    ridge_rel: float = 0.1,
    gamma: float = 0.8,
    protect_floor: float = 0.0,
    nnls_iters: int = 200,
    mode: str = "blend",
) -> torch.Tensor:
    """Observed-entry C polish gated at the greedy NMS peaks of the witness
    T_wit (`solvers.nasdac.witness_peaks`): mode 'blend' is
    `_polish_c_to_observed` then `peak_gated_blend`; mode 'qp' is
    `_constrained_polish_c`, with the final blend as the exact feasibility
    guarantee.  W [..., I, J]."""
    pts = witness_peaks(T_wit, num_peaks)
    if mode == "qp":
        C_pol = _constrained_polish_c(S, C_anch, T_obs, W, pts, gamma=gamma,
                                      ridge_rel=ridge_rel,
                                      nnls_iters=nnls_iters)
    elif mode == "blend":
        C_pol = _polish_c_to_observed(S, C_anch, T_obs, W,
                                      ridge_rel=ridge_rel,
                                      nnls_iters=nnls_iters)
    else:
        raise ValueError(f"unknown polish mode {mode!r} "
                         "(expected 'blend' or 'qp')")
    return peak_gated_blend(S, C_anch, C_pol, pts, gamma=gamma,
                            protect_floor=protect_floor)


def residual_peak_refine(
    T_hat: torch.Tensor,
    T_obs: torch.Tensor,
    W: torch.Tensor,
    num_patches: int = 2,
    d0: float = 2.0,
    alpha: float = 2.25,
) -> torch.Tensor:
    """Observed-residual local peak refinement (ground-truth-free): for
    each of `num_patches` patches, at the largest positive masked residual
    (summed over bands) drop the simulator's mean path-loss bump
    min(1, (d/d0)^-alpha), fit one nonnegative amplitude per band to the
    observed residuals under it in closed form, and add it.  Where the
    model fits, the amplitudes are ~0.  T_hat, T_obs [..., K, I, J];
    W [..., I, J].  Returns the refined T_hat (factors untouched)."""
    I, J = T_obs.shape[-2:]
    Wb = W.to(T_obs.dtype)[..., None, :, :]
    yy = torch.arange(I, dtype=torch.float32, device=T_obs.device)[:, None]
    xx = torch.arange(J, dtype=torch.float32, device=T_obs.device)[None, :]
    for _ in range(num_patches):
        resid = (T_obs - T_hat) * Wb                           # [..., K, I, J]
        idx = torch.argmax(resid.clamp_min(0.0).sum(-3).flatten(-2), dim=-1)
        cy = (idx // J).to(torch.float32)[..., None, None]
        cx = (idx % J).to(torch.float32)[..., None, None]
        d = torch.sqrt((yy - cy).square() + (xx - cx).square())
        bump = torch.clamp(torch.pow(d.clamp_min(1e-6) / d0, -alpha),
                           max=1.0)[..., None, :, :]           # [..., 1, I, J]
        den = (Wb * bump * bump).sum(_MAP)                     # [...]
        num = (Wb * bump * resid).sum(dim=(-2, -1))            # [..., K]
        a = (num / den.clamp_min(1e-12)[..., None]).clamp_min(0.0)
        T_hat = T_hat + a[..., None, None] * bump
    return T_hat


def recover_masked_mse(
    gen_apply: Callable[[torch.Tensor], torch.Tensor],
    mask: torch.Tensor,
    observed: torch.Tensor,
    z_dim: int = 256,
    num_emitters: int = 1,
    num_global: int = 400,
    num_local: int = 200,
    adam_steps: int = 500,
    lr: float = 0.01,
    generator: Optional[torch.Generator] = None,
    draws=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked-MSE prior completion of SLF(s) (optimization.ipynb cell 17).

    mask/observed: [I, J] (one SLF) or [R, I, J].  `draws` = (z0
    [num_emitters, z_dim], (global, local) search normals) as
    `solvers.priors.randomized_search` takes them; drawn from `generator`
    when not given.  Returns (S_hat, z, losses [adam_steps])."""
    dims = tuple(range(-observed.ndim, 0))
    count = mask.sum().clamp_min(1.0)

    def loss_of(S):
        return (mask * (S - observed).square()).sum(dims) / count

    def of_gen(S):                       # [..., R, I, J] -> the loss's input
        return S if num_emitters > 1 else S[..., 0, :, :]

    if draws is None:
        def normal(*shape):
            return torch.randn(*shape, num_emitters, z_dim,
                               generator=generator, device=observed.device)
        draws = (normal(), (normal(num_global), normal(num_local)))
    z0, search = draws
    z = randomized_search(gen_apply, lambda S: loss_of(of_gen(S)), z0,
                          num_global, num_local, draws=search)
    z, losses = _adam_descent(lambda zz: loss_of(of_gen(gen_apply(zz))), z,
                              lr, adam_steps)
    with torch.no_grad():
        return of_gen(gen_apply(z)), z, losses


def optimize_z(
    gen_apply: Callable[[torch.Tensor], torch.Tensor],
    S_targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    z_init: Optional[torch.Tensor] = None,
    adam_steps: int = 200,
    lr: float = 0.01,
    z_dim: int = 256,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-emitter latent descent to target SLFs [..., R, I, J] on
    (masked) MSE — the MATLAB-callable S-step (nn_descent_gan.py
    optimize_z_raw).  z starts at z_init, else N(0, I) from `generator`.
    Returns (S_hat [..., R, I, J], z)."""
    z0 = (z_init if z_init is not None else torch.randn(
        *S_targets.shape[:-2], z_dim, generator=generator,
        device=S_targets.device))
    m = torch.ones_like(S_targets) if mask is None else mask.to(
        S_targets.dtype)
    # the mask's own entries, as JAX's jnp.sum(m) counts a shared [I, J] mask
    count = m.sum(_MAP if m.ndim == S_targets.ndim else (-2, -1)).clamp_min(
        1.0)

    def loss(zz):
        return (m * (_gen(gen_apply, zz) - S_targets).square()).sum(
            _MAP) / count

    z, _ = _adam_descent(loss, z0, lr, adam_steps)
    with torch.no_grad():
        return _gen(gen_apply, z), z


def _anchored(T_obs, W, T_anchor, mu0, rho0):
    """(Wc, T_fit): the objective's entry weights and target, with the
    low-rho completion anchor at the unobserved entries when T_anchor is
    given.  W [..., 1, I, J]."""
    if T_anchor is None:
        return W, T_obs * W
    mu = anchor_weight(W[..., 0, :, :], mu0, rho0)[..., None, None, None]
    return W + mu * (1.0 - W), T_obs * W + T_anchor * (1.0 - W)


def recover_dowjons_unquantized(
    T_obs: torch.Tensor,
    Om: torch.Tensor,
    gen_apply: Callable[[torch.Tensor], torch.Tensor],
    num_emitters: int = 2,
    z_dim: int = 256,
    outer_iters: int = 20,
    z_steps_per_iter: int = 20,
    nnls_iters: int = 100,
    lr_z: float = 0.01,
    T_true: Optional[torch.Tensor] = None,
    S_init: Optional[torch.Tensor] = None,
    init_steps: int = 150,
    n_restarts: int = 1,
    S_init_dense: bool = False,
    T_anchor: Optional[torch.Tensor] = None,
    anchor_mu0: float = 0.3,
    anchor_rho0: float = 0.05,
    polish_ridge: float = 0.0,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[Optional[torch.Tensor], torch.Tensor]] = None,
) -> RecoveryResult:
    """The harness's DowJons joint optimization on unquantized samples,
    T_obs [..., K, I, J] with the per-location mask Om [..., I, J]:

      Z-init: with `S_init` [..., R, I, J] (the SPA estimate; dense, i.e.
              completed, when `S_init_dense`), restart 0 starts from a
              latent fit to it (scale-invariant: the per-emitter gain is
              solved inside the loss), as the reference seeds its joint
              stage (`joint_opt_ae.m:301-317`); the other restarts start
              from N(0, I);
      restarts: `n_restarts` runs side by side on one axis, the winner of
              each problem by its final masked data fit (argmin, gathered
              on the device);
      C-step: exact NNLS per frequency on the observed locations
              (`:403-418`, one batched Nesterov NNLS);
      S-step: Adam on the latents through the frozen generator on the
              masked residual (`:444-465`).

    `T_anchor` (a dense per-band completion) adds the low-rho completion
    anchor to the one objective that the C-step, the latent descent and
    the restart choice share (`solvers.nasdac.anchor_weight`).  `draws` =
    (the init fit's start [..., R, z_dim] or None without S_init, the
    restarts' starts [..., n_restarts, R, z_dim]); drawn from `generator`
    when not given.  `aux` holds the winner's final latents `Z`, its index
    `best` [...], the restarts' final residuals `residuals` [...,
    n_restarts] (`best` is their argmin), the restarts' starts `Z_start`
    [..., n_restarts, R, z_dim] (restart 0's after the init fit), and with
    `S_init` the init fit's costs `init_costs` [..., init_steps].

    Spans (utils.tracing): `qsc.dowjons.init_fit`, each NNLS C-step with
    the forward before it `qsc.dowjons.c_step`, each block of latent steps
    `qsc.dowjons.z_steps`, and the winner's choice `qsc.dowjons.pick`.
    """
    batch = T_obs.shape[:-3]
    R, n = num_emitters, max(n_restarts, 1)
    W = Om.to(T_obs.dtype)[..., None, :, :]                   # [..., 1, I, J]
    Wc, T_fit = _anchored(T_obs, W, T_anchor, anchor_mu0, anchor_rho0)
    Wf = torch.sqrt(Wc).flatten(-2)[..., None, :, :]          # [..., 1, 1, IJ]
    T_flat = (T_fit.flatten(-2) * Wf[..., 0, :, :])[..., None, :, :]
    Wc, T_fit = Wc[..., None, :, :, :], T_fit[..., None, :, :, :]
    T_ref = T_true[..., None, :, :, :] if T_true is not None else None

    if draws is None:
        def normal(*shape):
            return torch.randn(*batch, *shape, R, z_dim, generator=generator,
                               device=T_obs.device)
        draws = (normal() if S_init is not None else None, normal(n))
    z_fit0, Z = draws

    def c_step(S):                                            # -> [..., n, R, K]
        design = (S.flatten(-2) * Wf).transpose(-1, -2)       # [..., n, IJ, R]
        return nnls_rows(design, T_flat, iters=nnls_iters).transpose(-1, -2)

    def z_loss(Zz, C):                                        # -> [..., n]
        T_hat = get_tensor(_gen(gen_apply, Zz), C)
        return (Wc * (T_hat - T_fit).square()).sum(_MAP)

    if S_init is not None:
        fit = torch.broadcast_to(torch.ones_like(W) if S_init_dense else W,
                                 S_init.shape)

        def init_loss(zz):                                    # -> [...]
            Gm = _gen(gen_apply, zz)
            a = ((fit * Gm * S_init).sum((-2, -1), keepdim=True)
                 / (fit * Gm * Gm).sum((-2, -1), keepdim=True).clamp_min(1e-12))
            return (fit * (a * Gm - S_init).square()).sum(_MAP)

        with span("qsc.dowjons.init_fit", key=init_steps):
            Z_fit, init_costs = _adam_descent(init_loss, z_fit0, lr_z,
                                              init_steps)
        Z = torch.cat([Z_fit[..., None, :, :], Z[..., 1:, :, :]], dim=-3)

    Z_start, state, costs, nmses = Z, adam_init(Z), [], []
    with torch.no_grad():
        for _ in range(outer_iters):
            with span("qsc.dowjons.c_step"):
                C = c_step(_gen(gen_apply, Z))
            with span("qsc.dowjons.z_steps", key=z_steps_per_iter):
                for _ in range(z_steps_per_iter):
                    Z, state, cost = adam_update(
                        lr_z, lambda zz: z_loss(zz, C), Z, state)
            costs.append(cost)
            nmses.append(nmse(get_tensor(_gen(gen_apply, Z), C), T_ref,
                              dim=_MAP) if T_ref is not None
                         else torch.zeros_like(cost))
        with span("qsc.dowjons.c_step"):
            S = _gen(gen_apply, Z)
            C = c_step(S)
        with span("qsc.dowjons.pick"):
            residuals = z_loss(Z, C)                          # [..., n]
            best = torch.argmin(residuals, dim=-1)            # [...]
            costs = torch.stack(costs, -1)
            nmses = torch.stack(nmses, -1)
            S, C, Z, costs, nmses = (gather_winner(x, best)
                                     for x in (S, C, Z, costs, nmses))
            if T_anchor is not None and polish_ridge > 0.0:
                C = _polish_c_to_observed(S, C, T_obs, W[..., 0, :, :],
                                          ridge_rel=polish_ridge)
    aux = {"Z": Z, "best": best, "residuals": residuals, "Z_start": Z_start}
    if S_init is not None:
        aux["init_costs"] = init_costs
    return RecoveryResult(S=S, C=C, T_hat=get_tensor(S, C), nmses=nmses,
                          costs=costs, aux=aux)


def run_descent_ae(
    ae_input_apply: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    C: torch.Tensor,
    T_obs: torch.Tensor,
    W: torch.Tensor,
    lr: float = 0.01,
    max_iters: int = 10,
    min_iters: int = 5,
    tol: float = 1e-5,
):
    """The AE-input S-step with the reference's early stop
    (`backup/algorithms/nn_descent_ae.py:72-142` run_descent): Adam on the
    frozen network's own input x [..., R, I, J, 2] (mask channel, map
    channel), cost the masked squared tensor residual at fixed C
    [..., R, K], at most `max_iters` iterations, and from iteration
    `min_iters` on a problem stops before its step once its loss improves
    by less than `tol` (check-then-step, `:128-131`).  A stopped problem is
    frozen while the others go on.  T_obs [..., K, I, J]; W [..., I, J].
    Returns (x, S_hat [..., R, I, J], iterations used [...], final loss
    [...])."""
    Wk = W.to(T_obs.dtype)[..., None, :, :]
    nb = x0.ndim - 4

    def cost_of(x):
        T_hat = get_tensor(ae_input_apply(x), C)
        return (Wk * (T_hat - T_obs)).square().sum(_MAP)

    def frozen(stop, new, old):
        return torch.where(stop.reshape(*stop.shape, *(1,) * (new.ndim - nb)),
                           old, new)

    with torch.no_grad():
        prev = cost_of(x0)
    x, (_, mu, nu) = x0, adam_init(x0)
    count = torch.zeros((*x0.shape[:nb],) + (1,) * 4, dtype=torch.int32,
                        device=x0.device)
    iters = torch.zeros(x0.shape[:nb], dtype=torch.int32, device=x0.device)
    stop = torch.zeros(x0.shape[:nb], dtype=torch.bool, device=x0.device)
    for i in range(max_iters):
        loss, (g,) = value_and_grad(cost_of, x)
        hit = (i >= min_iters) & (prev - loss < tol) & ~stop
        x_new, (count_new, mu_new, nu_new) = adam_step(lr, g, x,
                                                       (count, mu, nu))
        keep = stop | hit
        x = frozen(keep, x_new, x)
        count, mu, nu = (frozen(keep, a, b) for a, b in
                         ((count_new, count), (mu_new, mu), (nu_new, nu)))
        prev = torch.where(stop, prev, loss)
        iters = torch.where(stop, iters, iters + 1)
        stop = keep
        if bool(stop.all()):
            break
    with torch.no_grad():
        return x, ae_input_apply(x), iters, prev


def recover_dowjons_ae_latent(
    T_obs: torch.Tensor,
    Om: torch.Tensor,
    ae_encode: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    ae_decode: Callable[[torch.Tensor], torch.Tensor],
    num_emitters: int = 2,
    outer_iters: int = 10,
    z_steps: int = 10,
    lr: float = 0.01,
    lambda_z: float = 1e-5,
    nnls_iters: int = 100,
    S_init: Optional[torch.Tensor] = None,
    T_true: Optional[torch.Tensor] = None,
    normalize_init: bool = True,
    T_anchor: Optional[torch.Tensor] = None,
    anchor_mu0: float = 0.3,
    anchor_rho0: float = 0.05,
    polish_ridge: float = 0.0,
) -> RecoveryResult:
    """DowJons as the reference's committed configuration runs it
    (`joint_opt_ae.m:29` use_gan=false): SPA factors -> the AE's encoding
    of (mask, masked SPA SLF) as the latent start (`model_ae`); C-step the
    exact NNLS per frequency over the observed locations; S-step `z_steps`
    Adam steps on the AE latent through the frozen decoder, cost the masked
    squared tensor residual + lambda_z ||z||_F (`run_descent_ae`).
    `normalize_init` rescales each SPA SLF's observed entries to the AE's
    training RMS (1/I) before encoding.  `T_anchor` adds the low-rho
    completion anchor to the one shared objective."""
    K, I, J = T_obs.shape[-3:]
    batch = T_obs.shape[:-3]
    R = num_emitters
    W1 = Om.to(T_obs.dtype)
    W = W1[..., None, :, :]

    if S_init is None:
        from quantized_spectrum_cartography_tpu_torch.baselines.spa import (
            nmf_spa)
        _, S_flat = nmf_spa((T_obs * W).reshape(*batch, K, I * J), R)
        S_init = S_flat.reshape(*batch, R, I, J)

    Wc, T_fit = _anchored(T_obs, W, T_anchor, anchor_mu0, anchor_rho0)
    Wf = torch.sqrt(Wc).flatten(-2)                           # [..., 1, IJ]
    T_flat = T_fit.flatten(-2) * Wf

    if normalize_init:
        n_obs = W1.sum((-2, -1)).clamp_min(1.0)[..., None, None, None]
        rms = torch.sqrt((S_init * W).square().sum((-2, -1), keepdim=True)
                         / n_obs)
        S_init = S_init * ((1.0 / I) / rms.clamp_min(1e-12))

    with torch.no_grad():
        z = ae_encode(W, S_init)                              # [..., R, latent]

    def c_step(S):                                            # -> [..., R, K]
        design = (S.flatten(-2) * Wf).transpose(-1, -2)
        return nnls_rows(design, T_flat, iters=nnls_iters).transpose(-1, -2)

    def z_cost(zz, C):
        T_hat = get_tensor(ae_decode(zz), C)
        return ((Wc * (T_hat - T_fit).square()).sum(_MAP)
                + lambda_z * torch.sqrt(zz.square().sum((-2, -1)) + 1e-12))

    state, costs, nmses = adam_init(z), [], []
    with torch.no_grad():
        for _ in range(outer_iters):
            C = c_step(ae_decode(z))
            for _ in range(z_steps):
                z, state, cost = adam_update(lr, lambda zz: z_cost(zz, C), z,
                                             state)
            costs.append(cost)
            nmses.append(nmse(get_tensor(ae_decode(z), C), T_true, dim=_MAP)
                         if T_true is not None else torch.zeros_like(cost))
        S = ae_decode(z)
        C = c_step(S)
        if T_anchor is not None and polish_ridge > 0.0:
            C = _polish_c_to_observed(S, C, T_obs, W1,
                                      ridge_rel=polish_ridge)
    return RecoveryResult(S=S, C=C, T_hat=get_tensor(S, C),
                          nmses=torch.stack(nmses, -1),
                          costs=torch.stack(costs, -1), aux={"z": z})


def recover_dowjons_ae(
    T_obs: torch.Tensor,
    Om: torch.Tensor,
    ae_input_apply: Callable[[torch.Tensor], torch.Tensor],
    num_emitters: int = 2,
    outer_iters: int = 10,
    nnls_iters: int = 100,
    lr: float = 0.01,
    scale: float = 50.0,
    S_init: Optional[torch.Tensor] = None,
    T_true: Optional[torch.Tensor] = None,
) -> RecoveryResult:
    """DowJons with the AE-input S-step (`joint_opt_ae.m:444-465`, the AE
    branch): C-step the exact NNLS per frequency over the observed
    locations (`:403-418`); S-step `run_descent_ae`, the network-input
    estimate carried across outer iterations as the MATLAB driver
    round-trips `test_slf`.  Seeded by SPA unless S_init is given."""
    from quantized_spectrum_cartography_tpu_torch.baselines.spa import nmf_spa

    K, I, J = T_obs.shape[-3:]
    batch = T_obs.shape[:-3]
    R = num_emitters
    W1 = Om.to(T_obs.dtype)
    Wf = W1.flatten(-2)[..., None, :]                         # [..., 1, IJ]
    T_flat = (T_obs * W1[..., None, :, :]).reshape(*batch, K, I * J)

    if S_init is None:
        _, S_flat = nmf_spa(T_flat, R)
        S_init = S_flat.reshape(*batch, R, I, J)

    x = torch.stack([torch.broadcast_to(W1[..., None, :, :], S_init.shape),
                     S_init * scale], dim=-1)                 # [..., R, I, J, 2]

    def c_step(S):
        design = (S.flatten(-2) * Wf).transpose(-1, -2)
        return nnls_rows(design, T_flat, iters=nnls_iters).transpose(-1, -2)

    costs, nmses = [], []
    for _ in range(outer_iters):
        with torch.no_grad():
            C = c_step(ae_input_apply(x))
        x, S, _, loss = run_descent_ae(ae_input_apply, x, C, T_obs, W1, lr=lr)
        costs.append(loss)
        nmses.append(nmse(get_tensor(S, C), T_true, dim=_MAP)
                     if T_true is not None else torch.zeros_like(loss))
    with torch.no_grad():
        S = ae_input_apply(x)
        C = c_step(S)
    return RecoveryResult(S=S, C=C, T_hat=get_tensor(S, C),
                          nmses=torch.stack(nmses, -1),
                          costs=torch.stack(costs, -1), aux={"x": x})
