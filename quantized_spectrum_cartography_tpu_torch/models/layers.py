"""Shared NN building blocks.

Port of ``quantized_spectrum_cartography_tpu/models/layers.py``, whose flax
layers were written to match torch's (k, s, p) semantics; here they are
torch's own layers, NCHW.
"""

from __future__ import annotations

import torch.nn as nn


def convt_torch(in_features: int, features: int, kernel: int, stride: int,
                pad: int) -> nn.ConvTranspose2d:
    """ConvTranspose2d(k, s, p): out = (in-1)*s - 2p + k."""
    return nn.ConvTranspose2d(in_features, features, kernel, stride, pad)


def conv_torch(in_features: int, features: int, kernel: int, stride: int,
               pad: int) -> nn.Conv2d:
    """Conv2d(k, s, p): out = floor((in + 2p - k)/s) + 1."""
    return nn.Conv2d(in_features, features, kernel, stride, pad)
