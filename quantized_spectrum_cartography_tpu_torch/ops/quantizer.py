"""Ordinal quantizer, probit link and 1-bit dither.

Port of ``quantized_spectrum_cartography_tpu/ops/quantizer.py``.  The noise of
`quantize`/`quantize_log` is drawn from a ``torch.Generator`` or passed in as
a tensor of standard normals (so a test can feed both packages the same
draws).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_SQRT2 = 1.414213  # the reference hardcodes 1.414213 (quantization_model.py:61)


def _bin_indices(noisy: torch.Tensor, bin_boundaries: torch.Tensor) -> torch.Tensor:
    """Bin index per entry: Y = #{internal boundaries b_i : b_i < x}, so
    values <= b_1 map to 0 and values > b_{n-1} to num_bins-1."""
    internal = bin_boundaries[1:-1].contiguous()
    return torch.searchsorted(internal, noisy, side="left").to(torch.int32)


def _noise(X, noise, generator):
    if noise is not None:
        return noise
    return torch.randn(X.shape, generator=generator, dtype=X.dtype,
                       device=X.device)


def quantize(
    X: torch.Tensor,
    noise_std: float,
    bin_boundaries: Sequence[float],
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Linear-domain ordinal quantization Y = Q(X + E), E ~ N(0, noise_std):
    E = noise_std * noise, noise drawn from `generator` unless given."""
    bb = torch.as_tensor(bin_boundaries, dtype=X.dtype, device=X.device)
    noisy = X + _noise(X, noise, generator) * noise_std
    return _bin_indices(noisy, bb)


def quantize_log(
    X: torch.Tensor,
    noise_std: float,
    bin_boundaries: Sequence[float],
    offset: float,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Log-domain ordinal quantization Y = Q(log(X + offset) + E)."""
    bb = torch.as_tensor(bin_boundaries, dtype=X.dtype, device=X.device)
    noisy = torch.log(X + offset) + _noise(X, noise, generator) * noise_std
    return _bin_indices(noisy, bb)


def dequantize_midpoints(Y: torch.Tensor,
                         bin_boundaries: Sequence[float]) -> torch.Tensor:
    """Bin-midpoint dequantization (W+U)/2."""
    bb = torch.as_tensor(bin_boundaries, device=Y.device)
    Yl = Y.long()
    return (bb[Yl] + bb[Yl + 1]) / 2.0


def F_probit(y: torch.Tensor, std) -> torch.Tensor:
    """Probit link Phi(y/std) = (1 + erf(y/(std*sqrt2)))/2, with the
    reference's hardcoded sqrt2 (`qmc/quantization_model.py:57-61`)."""
    return 0.5 * (1.0 + torch.erf(y / (std * _SQRT2)))


def dither_probit(y: torch.Tensor, std, generator: torch.Generator) -> torch.Tensor:
    """Sample z ~ Bernoulli(Phi(y/std)) (reference `quantization_model.py:63-68`).

    ``generator`` must live on ``y``'s device."""
    return torch.bernoulli(F_probit(y, std), generator=generator).to(y.dtype)
