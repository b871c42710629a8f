"""Plain PyTorch copies of the JAX kernels' numerics, shared by the 1-bit and
the ordinal likelihood (``onebit_nll.py``, ``quantized_nll.py``).

Formulas of ``quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py``
(`_erf`, `_log_ndtr`); the CUDA kernels hold the same ones in
``csrc/common.cuh``.  Every branch sees clamped inputs (the JAX code's double
`where`), so the unselected one stays finite and its gradient is never 0*inf.
"""

from __future__ import annotations

import torch

from quantized_spectrum_cartography_tpu_torch.ops.likelihood import _SIGMA_EFF

_LOG_SQRT_2PI = 0.9189385332046727
_INV_SQRT2 = 0.7071067811865476
_LN2 = 0.6931471805599453


def _inv_s(sigma: float) -> float:
    """1 / (sigma * _SIGMA_EFF): the probit scale the kernels multiply by."""
    return 1.0 / (sigma * _SIGMA_EFF)


def _erf(z: torch.Tensor) -> torch.Tensor:
    """erf via the Abramowitz & Stegun 7.1.26 rational polynomial."""
    az = z.abs()
    u = 1.0 / (1.0 + 0.3275911 * az)
    poly = u * (0.254829592 + u * (-0.284496736 + u * (
        1.421413741 + u * (-1.453152027 + u * 1.061405429))))
    val = 1.0 - poly * torch.exp(-az * az)
    return torch.where(z >= 0.0, val, -val)


def _mills_series(safe_t: torch.Tensor) -> torch.Tensor:
    inv2 = 1.0 / (safe_t * safe_t)
    return 1.0 - inv2 * (1.0 - 3.0 * inv2 * (1.0 - 5.0 * inv2))


def _log_ndtr(t: torch.Tensor) -> torch.Tensor:
    """log Phi(t): log(1+erf(t/sqrt2)) - log 2 above t=-4, the Mills
    asymptotic series at or below it."""
    tc = t.clamp(max=0.0)
    t2 = tc * tc
    safe_t = tc.clamp(max=-4.0)
    asym = (-0.5 * t2 - torch.log(-safe_t) - _LOG_SQRT_2PI
            + torch.log(_mills_series(safe_t)))
    t_dir = t.clamp(min=-4.0)
    direct = torch.log(1.0 + _erf(t_dir * _INV_SQRT2)) - _LN2
    return torch.where(t <= -4.0, asym, direct)
