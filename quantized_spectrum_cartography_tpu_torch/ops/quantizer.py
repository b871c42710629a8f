"""Probit link and 1-bit dither.

Port of the 1-bit part of ``quantized_spectrum_cartography_tpu/ops/quantizer.py``.
"""

from __future__ import annotations

import torch

_SQRT2 = 1.414213  # the reference hardcodes 1.414213 (quantization_model.py:61)


def F_probit(y: torch.Tensor, std) -> torch.Tensor:
    """Probit link Phi(y/std) = (1 + erf(y/(std*sqrt2)))/2, with the
    reference's hardcoded sqrt2 (`qmc/quantization_model.py:57-61`)."""
    return 0.5 * (1.0 + torch.erf(y / (std * _SQRT2)))


def dither_probit(y: torch.Tensor, std, generator: torch.Generator) -> torch.Tensor:
    """Sample z ~ Bernoulli(Phi(y/std)) (reference `quantization_model.py:63-68`).

    ``generator`` must live on ``y``'s device."""
    return torch.bernoulli(F_probit(y, std), generator=generator).to(y.dtype)
