"""Nasdac: SPA initialization + autoencoder completion, and the
completion-witness gates shared with the DowJons harness method.

Port of ``quantized_spectrum_cartography_tpu/solvers/nasdac.py``
(`backup/algorithms/joint_opt_ae.m:213-277`): SPA on the unfolded sampled
tensor picks near-pure frequency bands whose spatial columns seed the
per-emitter SLFs; each masked SLF estimate is completed by the trained AE
(`py.nn_descent_ae.model_ae`), and the PSD factor is refit by NNLS on the
completed SLFs.

Leading axes are batch axes throughout: T [..., K, I, J], masks
[..., I, J].  Every discrete choice (SPA's columns, the witness peaks, the
flags) is made per problem with argmax / where, never on the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quantized_spectrum_cartography_tpu_torch.baselines.nnls import nnls_rows
from quantized_spectrum_cartography_tpu_torch.baselines.spa import nmf_spa
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import get_tensor
from quantized_spectrum_cartography_tpu_torch.solvers.base import (
    RecoveryResult,
)


def _at(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """M[..., y_p, x_p] for maps M [..., I, J] and points pts [..., P, 2]
    (y, x) -> [..., P]."""
    J = M.shape[-1]
    return torch.gather(M.flatten(-2), -1, pts[..., 0] * J + pts[..., 1])


def _window(pts: torch.Tensor, I: int, J: int, radius: int) -> torch.Tensor:
    """[..., P, I, J] bool: the square of `radius` around each point."""
    yy = torch.arange(I, device=pts.device)[:, None]
    xx = torch.arange(J, device=pts.device)[None, :]
    y = pts[..., 0, None, None]
    x = pts[..., 1, None, None]
    return ((yy - y).abs() <= radius) & ((xx - x).abs() <= radius)


def lost_peak_flag(
    T_hat: torch.Tensor,
    T_comp: torch.Tensor,
    num_peaks: int,
    radius: int = 4,
    thresh: float = 0.3,
) -> torch.Tensor:
    """Completion-witnessed catastrophe detector (ground-truth-free): the
    `num_peaks` witness peaks of the per-band completion T_comp
    (`witness_peaks`), and True where the factored estimate carries less
    than `thresh` of the completion's band sum at any of them.  Returns a
    bool per problem [...]."""
    pts = witness_peaks(T_comp, num_peaks, radius)
    ratios = (_at(T_hat.sum(-3), pts)
              / _at(T_comp.sum(-3), pts).clamp_min(1e-12))
    return ratios.amin(-1) < thresh


def witnessed_swap_flag(
    T_cur: torch.Tensor,
    T_cand: torch.Tensor,
    T_wit: torch.Tensor,
    T_obs: torch.Tensor,
    W: torch.Tensor,
    num_peaks: int,
    radius: int = 4,
    thresh: float = 0.3,
    fit_factor: float = 0.7,
    window: int = 5,
    min_obs: float = 3.0,
) -> torch.Tensor:
    """`lost_peak_flag` with a local data-support gate: a disputed witness
    peak triggers the swap only when the candidate also fits the observed
    entries in the (2*window+1)^2 neighbourhood of the peak decisively
    better (masked squared residual < fit_factor x the current one's), or
    when that neighbourhood holds fewer than `min_obs` observed locations
    (the data cannot adjudicate).  T_* [..., K, I, J], W [..., I, J].
    Returns a bool per problem [...]."""
    I, J = W.shape[-2:]
    pts = witness_peaks(T_wit, num_peaks, radius)              # [..., P, 2]
    ratio = (_at(T_cur.sum(-3), pts)
             / _at(T_wit.sum(-3), pts).clamp_min(1e-12))       # [..., P]
    near = _window(pts, I, J, window).to(T_obs.dtype)          # [..., P, I, J]
    W = W.to(T_obs.dtype)

    def local_err(T):                                          # [..., P]
        res = (W * (T_obs - T).square().sum(-3))[..., None, :, :]
        return (near * res).sum(dim=(-2, -1))

    n_loc = (near * W[..., None, :, :]).sum(dim=(-2, -1))
    supported = (local_err(T_cand) < fit_factor * local_err(T_cur)) | (
        n_loc < min_obs)
    return ((ratio < thresh) & supported).any(-1)


def witness_peaks(
    T_wit: torch.Tensor,
    num_peaks: int,
    radius: int = 4,
) -> torch.Tensor:
    """Greedy spatial maxima of the witness's band sum with square
    non-max suppression of `radius`: T_wit [..., K, I, J] -> [...,
    num_peaks, 2] int64 (y, x).  argmax takes the first of equal values."""
    M = T_wit.sum(-3)
    J = M.shape[-1]
    pts = []
    for _ in range(num_peaks):
        idx = torch.argmax(M.flatten(-2), dim=-1)
        pt = torch.stack([idx // J, idx % J], dim=-1)          # [..., 2]
        M = M.masked_fill(_window(pt[..., None, :], *M.shape[-2:], radius)
                          [..., 0, :, :], -torch.inf)
        pts.append(pt)
    return torch.stack(pts, dim=-2)


def distance_to_observed(W: torch.Tensor) -> torch.Tensor:
    """Per-pixel Euclidean distance to the nearest observed location:
    W [..., I, J] -> D [..., I, J] in pixels (0 at observed pixels; inf only
    if a mask is empty).  Brute force over the [IJ, IJ] distance grid, one
    map at a time."""
    I, J = W.shape[-2:]
    yy, xx = torch.meshgrid(torch.arange(I, device=W.device),
                            torch.arange(J, device=W.device), indexing="ij")
    coords = torch.stack([yy.reshape(-1), xx.reshape(-1)], 1).float()
    d2 = (coords[:, None] - coords[None]).square().sum(-1)
    flat = W.reshape(-1, I * J) > 0
    D = torch.stack([torch.where(w[None, :], d2, torch.inf).amin(-1)
                     for w in flat])
    return D.sqrt().reshape(W.shape)


def anchor_confidence(W: torch.Tensor, tau: float) -> torch.Tensor:
    """Completion-confidence weight per entry: exp(-max(D - 1, 0) / tau),
    D the distance to the nearest observed sample (tau in pixels; tau=inf
    is the flat anchor).  W [..., I, J] -> [..., I, J] in (0, 1]."""
    D = distance_to_observed(W)
    return torch.exp(-(D - 1.0).clamp_min(0.0) / tau)


def anchor_weight(
    W: torch.Tensor,
    mu0: float = 0.3,
    rho0: float = 0.05,
) -> torch.Tensor:
    """Completion-anchor weight of the amplitude (C) fit from the mask:
    mu0 * clip(1 - f / rho0, 0, 1), f the observed share of W [..., I, J];
    zero from rho0 sampling on.  Returns one weight per problem [...]."""
    f_hat = W.to(torch.float32).mean(dim=(-2, -1))
    return mu0 * (1.0 - f_hat / rho0).clamp(0.0, 1.0)


def recover_nasdac(
    T_obs: torch.Tensor,
    Om: torch.Tensor,
    ae_complete: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    num_emitters: int = 2,
    nnls_iters: int = 200,
    anchor_mu0: float = 0.3,
    anchor_rho0: float = 0.05,
    polish_ridge: float = 0.0,
    polish_gamma: Optional[float] = None,
    polish_peaks_extra: int = 2,
    polish_floor: float = 0.0,
    anchor_conf_tau: float = 0.0,
    polish_mode: str = "blend",
    T_comp: Optional[torch.Tensor] = None,
) -> RecoveryResult:
    """T_obs [..., K, I, J] sampled at the per-location mask Om [..., I, J]
    (zeros elsewhere); ae_complete(mask, slf) -> completed slf, batched.

    Upgrades over the reference's Nasdac, as in the JAX package: C refit
    by NNLS on the completed SLFs, the low-rho completion-anchored C fit
    (`anchor_weight`; anchor_mu0=0 is the observed-entries-only fit),
    `anchor_conf_tau` > 0 scales the anchor per entry by
    `anchor_confidence`, and `polish_ridge` > 0 polishes C on the observed
    entries (gated by `polish_gamma`, `solvers.completion.gated_polish_c`).
    `T_comp`, the per-band completion ae_complete(Om, T_obs), is computed
    here unless the caller passes it."""
    K, I, J = T_obs.shape[-3:]
    batch = T_obs.shape[:-3]
    R = num_emitters
    W = Om.to(T_obs.dtype)
    Wk = W[..., None, :, :]

    C0, S_flat = nmf_spa((T_obs * Wk).reshape(*batch, K, I * J), R)
    S0 = S_flat.reshape(*batch, R, I, J)
    S_hat = ae_complete(Wk, S0)

    if anchor_mu0 > 0.0:
        mu = anchor_weight(W, anchor_mu0, anchor_rho0)[..., None, None, None]
        if T_comp is None:
            T_comp = ae_complete(Wk, T_obs)
        T_fit = T_obs * Wk + T_comp * (1.0 - Wk)
        conf = (anchor_confidence(W, anchor_conf_tau)[..., None, :, :]
                if anchor_conf_tau > 0.0 else 1.0)
        Wf = torch.sqrt(Wk + mu * conf * (1.0 - Wk)).flatten(-2)
    else:
        T_fit = T_obs * Wk
        Wf = Wk.flatten(-2)                                     # [..., 1, IJ]
    design = (S_hat.flatten(-2) * Wf).transpose(-1, -2)         # [..., IJ, R]
    C_hat = nnls_rows(design, T_fit.flatten(-2) * Wf,
                      iters=nnls_iters).transpose(-1, -2)       # [..., R, K]
    if anchor_mu0 > 0.0 and polish_ridge > 0.0:
        from quantized_spectrum_cartography_tpu_torch.solvers.completion import (
            _polish_c_to_observed, gated_polish_c)
        if polish_gamma is not None:
            C_hat = gated_polish_c(S_hat, C_hat, T_obs, W, T_comp,
                                   num_peaks=R + polish_peaks_extra,
                                   ridge_rel=polish_ridge,
                                   gamma=polish_gamma,
                                   protect_floor=polish_floor,
                                   mode=polish_mode)
        else:
            C_hat = _polish_c_to_observed(S_hat, C_hat, T_obs, W,
                                          ridge_rel=polish_ridge)

    zero = torch.zeros(1, device=T_obs.device)
    return RecoveryResult(S=S_hat, C=C_hat, T_hat=get_tensor(S_hat, C_hat),
                          nmses=zero, costs=zero,
                          aux={"S_spa": S0, "C_spa": C0})
