"""Post-solve amplitude recalibration.

Port of ``quantized_spectrum_cartography_tpu/solvers/calibrate.py``.  The
reference's Frobenius penalties shrink the recovered factors along the
quantized likelihood's flat directions; a global gain

    gamma* = argmin_gamma  nll( log(gamma * T_hat + offset) )

is well identified, found by a log-spaced grid (one batched pass over the
candidates) and a golden-section refinement; per emitter, by Adam on the
log-gains from the global optimum.  An addition over the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from quantized_spectrum_cartography_tpu_torch.ops.likelihood import (
    gather_bin_bounds,
    log_prob_probit_bounds,
    masked_nll,
)
from quantized_spectrum_cartography_tpu_torch.ops.lowrank import get_tensor

_GOLDEN = 0.6180339887498949


def recalibrate_gain(
    T_hat: torch.Tensor,
    Y: torch.Tensor,
    bin_boundaries,
    sigma: float,
    offset: float,
    mask: Optional[torch.Tensor] = None,
    num_grid: int = 64,
    gamma_lo: float = 1e-2,
    gamma_hi: float = 1e2,
    refine_iters: int = 20,
    linear: bool = False,
):
    """Returns (gamma_star, T_hat * gamma_star) for one map T_hat
    [K, I, J].  `linear=True` scores the gain against a linear-domain
    quantizer (x = gamma * T_hat, e.g. the 256-bin uniform table,
    qmc/utils.py:17-27) instead of the log link."""
    W, U = gather_bin_bounds(Y, bin_boundaries)

    def nll_of_gamma(g):                    # gains [...] -> nll [...]
        g = g[..., None, None, None]
        x = g * T_hat if linear else torch.log(g * T_hat + offset)
        return masked_nll(log_prob_probit_bounds(W, U, x, sigma), mask)

    log_g = torch.linspace(math.log(gamma_lo), math.log(gamma_hi), num_grid,
                           device=T_hat.device)
    i = torch.argmin(nll_of_gamma(torch.exp(log_g)))
    lo = log_g[(i - 1).clamp_min(0)]
    hi = log_g[(i + 1).clamp_max(num_grid - 1)]
    for _ in range(refine_iters):
        m1 = hi - _GOLDEN * (hi - lo)
        m2 = lo + _GOLDEN * (hi - lo)
        left = nll_of_gamma(torch.exp(m1)) < nll_of_gamma(torch.exp(m2))
        lo, hi = torch.where(left, lo, m1), torch.where(left, m2, hi)
    gamma = torch.exp(0.5 * (lo + hi))
    return gamma, gamma * T_hat


def recalibrate_gains_per_emitter(
    S: torch.Tensor,
    C: torch.Tensor,
    Y: torch.Tensor,
    bin_boundaries,
    sigma: float,
    offset: float,
    mask: Optional[torch.Tensor] = None,
    steps: int = 150,
    lr: float = 0.05,
):
    """Per-emitter gains: argmin_{g in R^R} nll(log(sum_r e^{g_r} S_r o c_r
    + offset)) by Adam on the log-gains, from the global gain; keeps the
    global start where Adam ends worse.  S [R, I, J], C [R, K]; returns
    (gains [R], T_cal [K, I, J])."""
    from quantized_spectrum_cartography_tpu_torch.solvers.gan_inversion import (
        _adam_descent)

    W, U = gather_bin_bounds(Y, bin_boundaries)
    g0, _ = recalibrate_gain(get_tensor(S, C), Y, bin_boundaries, sigma,
                             offset, mask)

    def nll_of(logg):
        T = get_tensor(S * torch.exp(logg)[:, None, None], C)
        x = torch.log(T.clamp_min(0.0) + offset)
        return masked_nll(log_prob_probit_bounds(W, U, x, sigma), mask)

    logg0 = torch.full((S.shape[0],), 1.0, device=S.device) * torch.log(g0)
    logg, _ = _adam_descent(nll_of, logg0, lr, steps)
    with torch.no_grad():
        logg = torch.where(nll_of(logg) < nll_of(logg0), logg, logg0)
    gains = torch.exp(logg)
    return gains, get_tensor(S * gains[:, None, None], C)
