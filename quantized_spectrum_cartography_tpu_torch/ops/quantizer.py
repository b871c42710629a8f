"""Ordinal quantizer, links, dithers and the 1-bit wire format.

Port of ``quantized_spectrum_cartography_tpu/ops/quantizer.py``.  The noise of
`quantize`/`quantize_log` is drawn from a ``torch.Generator`` or passed in as
a tensor of standard normals (so a test can feed both packages the same
draws).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
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


def log_F_probit(y: torch.Tensor, std) -> torch.Tensor:
    """Stable log Phi(y/std) with the reference's probit scale, through
    log_ndtr (finite in the deep tails where log of the erf form is not)."""
    return torch.special.log_ndtr(y / (std * _SQRT2 / math.sqrt(2.0)))


def F_sigmoid(y: torch.Tensor) -> torch.Tensor:
    """Logistic link (reference `qmc/quantization_model.py:43-47`)."""
    return torch.sigmoid(y)


def dither_sigmoid(y: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Sample z ~ Bernoulli(sigmoid(y)); ``generator`` on ``y``'s device."""
    return torch.bernoulli(F_sigmoid(y), generator=generator).to(y.dtype)


def pack_bits_host(y01) -> np.ndarray:
    """Host-side bit-pack of 1-bit observations: {0,1} array -> uint8
    [..., ceil(last/8)], most significant bit first (np.packbits along the
    last axis), 1 bit an entry on the wire."""
    return np.packbits(np.asarray(y01).astype(np.uint8), axis=-1)


def unpack_bits(packed: torch.Tensor, last_dim: int) -> torch.Tensor:
    """`pack_bits_host`'s output back to {0,1} float32 [..., last_dim], on
    the device `packed` lies on."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.to(torch.uint8)[..., None] >> shifts) & 1
    flat = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    return flat[..., :last_dim].to(torch.float32)
