"""Probit / logistic likelihood of quantized observations.

Port of ``quantized_spectrum_cartography_tpu/ops/likelihood.py``: the ordinal
likelihood from bin bounds (the solvers' unfused branch) and the 1-bit
losses.  Every function reduces over the trailing map axes ``[K, I, J]``
only, so a leading batch axis gives one value per map (the JAX package vmaps
instead).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
    F_probit,
    _SQRT2,
)

# Effective probit scale: the reference evaluates erf(y/(std*1.414213)),
# i.e. Phi(y/sigma_eff) with sigma_eff = std*1.414213/sqrt(2).
_SIGMA_EFF = _SQRT2 / 1.4142135623730951

_LOG_SQRT_2PI = 0.9189385332046727
_MAP_DIMS = (-3, -2, -1)


def gather_bin_bounds(
    Y: torch.Tensor,
    bin_boundaries,
    clamp_outer: Optional[float] = None,
):
    """Lower/upper boundary tensors (W, U) = (bb[Y], bb[Y+1]) for bin indices
    Y; clamp_outer sets the outer boundaries to -+clamp_outer."""
    bb = torch.as_tensor(bin_boundaries, dtype=torch.float32, device=Y.device)
    if clamp_outer is not None:
        bb = bb.clone()
        bb[0], bb[-1] = -clamp_outer, clamp_outer
    Yl = Y.long()
    return bb[Yl], bb[Yl + 1]


def log_prob_probit_bounds(
    W: torch.Tensor, U: torch.Tensor, X_hat: torch.Tensor, noise_std
) -> torch.Tensor:
    """Stable log(Phi((U-X)/s) - Phi((W-X)/s)) from precomputed bounds: the
    anchor term in the larger tail (Phi(b)-Phi(a) = Phi(-a)-Phi(-b)), then
    log P = log_ndtr(hi) + log(-expm1(log_ndtr(lo) - log_ndtr(hi))),
    floored at the dtype's smallest normal."""
    s = noise_std * _SIGMA_EFF
    a = (W - X_hat) / s
    b = (U - X_hat) / s
    flip = (a + b) > 0.0
    lo = torch.where(flip, -b, a)
    hi = torch.where(flip, -a, b)
    l_lo = torch.special.log_ndtr(lo)
    l_hi = torch.special.log_ndtr(hi)
    diff = (l_lo - l_hi).clamp(max=0.0)
    tiny = torch.finfo(X_hat.dtype).tiny
    return l_hi + torch.log((-torch.expm1(diff)).clamp(min=tiny))


def prob_probit(
    Y: torch.Tensor,
    X_hat: torch.Tensor,
    bin_boundaries,
    noise_std,
    clamp_outer: Optional[float] = None,
) -> torch.Tensor:
    """P(Y|X_hat) = Phi(U - X) - Phi(W - X) in the direct (non-log) form of
    the reference (`qmc/quantization_model.py:22-39`); solvers take
    `log_prob_probit`."""
    W, U = gather_bin_bounds(Y, bin_boundaries, clamp_outer)
    return F_probit(U - X_hat, noise_std) - F_probit(W - X_hat, noise_std)


def log_prob_probit(
    Y: torch.Tensor,
    X_hat: torch.Tensor,
    bin_boundaries,
    noise_std,
    clamp_outer: Optional[float] = None,
) -> torch.Tensor:
    """Stable log P(Y|X_hat) from bin indices (`log_prob_probit_bounds`)."""
    W, U = gather_bin_bounds(Y, bin_boundaries, clamp_outer)
    return log_prob_probit_bounds(W, U, X_hat, noise_std)


def masked_nll(
    logP: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Negative log-likelihood -sum(mask * logP) over the map axes."""
    if mask is None:
        return -logP.sum(dim=_MAP_DIMS)
    return -(mask * logP).sum(dim=_MAP_DIMS)


def neg_likelihood_1bit(
    T_sample: torch.Tensor,
    T_target: torch.Tensor,
    mean,
    std=None,
    probit: bool = True,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """1-bit MLE loss: mean binary cross-entropy of link(T_sample - mean)
    against {0,1} targets, per map ([..., K, I, J] -> [...]).

    Uses the sign fold t*logF(u) + (1-t)*logF(-u) = logF((2t-1)*u), valid
    for the symmetric probit and logistic links."""
    u = T_sample - mean
    su = (2.0 * T_target - 1.0) * u
    if probit:
        if std is None:
            raise ValueError("probit link needs std")
        bce = -torch.special.log_ndtr(su / (std * _SIGMA_EFF))
    else:
        bce = -F.logsigmoid(su)
    if mask is None:
        return bce.mean(dim=_MAP_DIMS)
    return ((mask * bce).sum(dim=_MAP_DIMS)
            / mask.sum(dim=_MAP_DIMS).clamp_min(1.0))


def deterministic_cost(
    T_hat: torch.Tensor,
    T_target: torch.Tensor,
    mean=0.0,
    lambda_reg: float = 0.001,
) -> torch.Tensor:
    """Max-correlation deterministic cost per map,
    -lambda * sum((T_hat - mean) * T_target) + ||T_hat - mean||_F
    (reference `DeterministicCost`, `qmc/quantization_model.py:115-129`)."""
    Tm = T_hat - mean
    return (-lambda_reg * (Tm * T_target).sum(dim=_MAP_DIMS)
            + Tm.square().sum(dim=_MAP_DIMS).sqrt())


def pack_sign_mask(
    T_target: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """int8 tensor s in {-1, 0, +1}: (2t-1) where observed, 0 elsewhere."""
    s = 2.0 * T_target - 1.0
    if mask is not None:
        s = s * mask
    return s.to(torch.int8)


def _onebit_pre(S, C, sm, mean, inv_s):
    X = torch.einsum("...rij,...rk->...kij", S, C)
    return sm * (X - mean) * inv_s


class _OnebitNLLFactors(torch.autograd.Function):
    """Analytic-gradient 1-bit NLL over the factors: the backward recomputes
    the reconstruction and applies d(-logPhi(x))/dx = -phi(x)/Phi(x), so
    masked entries (sign 0) give an exact zero, never 0*inf."""

    @staticmethod
    def forward(ctx, S, C, sign_mask, mean, inv_s, inv_count):
        sm = sign_mask.to(S.dtype)
        x = _onebit_pre(S, C, sm, mean, inv_s)
        nll = -(sm.abs() * torch.special.log_ndtr(x)).sum(dim=_MAP_DIMS)
        ctx.save_for_backward(S, C, sign_mask, inv_count)
        ctx.mean, ctx.inv_s = mean, inv_s
        return nll * inv_count

    @staticmethod
    def backward(ctx, g):
        S, C, sign_mask, inv_count = ctx.saved_tensors
        sm = sign_mask.to(S.dtype)
        x = _onebit_pre(S, C, sm, ctx.mean, ctx.inv_s)
        ratio = torch.exp(-0.5 * x * x - _LOG_SQRT_2PI
                          - torch.special.log_ndtr(x))
        scale = (g * (-inv_count * ctx.inv_s))[..., None, None, None]
        dT = scale * sm * ratio
        gS = torch.einsum("...kij,...rk->...rij", dT, C)
        gC = torch.einsum("...kij,...rij->...rk", dT, S)
        return gS, gC, None, None, None, None


def onebit_nll_factors(
    S: torch.Tensor,
    C: torch.Tensor,
    sign_mask: torch.Tensor,
    mean: float,
    inv_s: float,
    inv_count: torch.Tensor,
) -> torch.Tensor:
    """Mean 1-bit probit BCE of the rank-R reconstruction, per map.

    S [..., R, I, J], C [..., R, K], sign_mask int8 [..., K, I, J] from
    `pack_sign_mask`; inv_s = 1/(std*_SIGMA_EFF); inv_count [...] =
    1/#observed.  Equals `neg_likelihood_1bit(get_tensor(S, C), T_target,
    mean, std, probit=True, mask=mask)`."""
    return _OnebitNLLFactors.apply(S, C, sign_mask, float(mean),
                                   float(inv_s), inv_count)


