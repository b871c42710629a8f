"""Shared NN building blocks.

Port of ``quantized_spectrum_cartography_tpu/models/layers.py``, whose flax
layers were written to match torch's (k, s, p) semantics; here they are
torch's own layers, NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def convt_torch(in_features: int, features: int, kernel: int, stride: int,
                pad: int) -> nn.ConvTranspose2d:
    """ConvTranspose2d(k, s, p): out = (in-1)*s - 2p + k."""
    return nn.ConvTranspose2d(in_features, features, kernel, stride, pad)


def conv_torch(in_features: int, features: int, kernel: int, stride: int,
               pad: int) -> nn.Conv2d:
    """Conv2d(k, s, p): out = floor((in + 2p - k)/s) + 1."""
    return nn.Conv2d(in_features, features, kernel, stride, pad)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NCHW maps (torch
    nn.Upsample(scale_factor=2))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def total_variation_loss(img: torch.Tensor) -> torch.Tensor:
    """TV loss of NCHW maps: summed squared differences of vertical and
    horizontal neighbours over the element count."""
    tv_h = (img[:, :, 1:, :] - img[:, :, :-1, :]).square().sum()
    tv_w = (img[:, :, :, 1:] - img[:, :, :, :-1]).square().sum()
    return (tv_h + tv_w) / img.numel()


def BatchNorm(features: int) -> nn.BatchNorm2d:
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)``: torch's momentum is
    the weight of the new batch, 1 - flax's."""
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
