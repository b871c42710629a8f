"""Shared NN building blocks.

Port of ``quantized_spectrum_cartography_tpu/models/layers.py``, whose flax
layers were written to match torch's (k, s, p) semantics; here they are
torch's own layers, NCHW.  Training needs two things of flax that torch does
otherwise: BatchNorm's running variance (`BatchNorm`, `frozen_stats`) and
the initializers (`flax_init_`).
"""

from __future__ import annotations

import contextlib
from typing import Optional

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


class BatchNorm(nn.BatchNorm2d):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` (JAX
    ``models/layers.py``).  In eval mode torch's own.  In train mode it
    normalizes by the batch's statistics and, while `update_stats` is set,
    moves the running ones as flax does: running = 0.9 running + 0.1 batch,
    with the *biased* batch variance (torch's BatchNorm2d takes the unbiased
    one).  `frozen_stats` clears `update_stats` for a forward whose
    statistics flax discards."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
                self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
                self.running_var.mul_(0.9).add_(var, alpha=0.1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Train-mode forwards of `module` that leave its running statistics
    (BatchNorm means and variances, spectral-norm vectors) as they are:
    flax's ``apply(..., mutable=[])`` of a collection it then drops."""
    layers = [m for m in module.modules() if hasattr(m, "update_stats")]
    saved = [m.update_stats for m in layers]
    for m in layers:
        m.update_stats = False
    try:
        yield module
    finally:
        for m, flag in zip(layers, saved):
            m.update_stats = flag


# stddev of the standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def flax_init_(module: nn.Module,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-initialize `module` in place as flax initializes the JAX modules:
    kernels lecun_normal (a normal truncated at two of its standard
    deviations, of variance 1 / fan_in, fan_in = in x kh x kw, the HWIO
    kernel's), biases and ``log_gain`` zero, BatchNorm scale 1 and bias 0
    with fresh running statistics, a spectral norm's vector standard
    normal.  The draws come from `generator`."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel() if not isinstance(
                m, nn.ConvTranspose2d) else w.shape[0] * w[0, 0].numel()
            std = fan_in ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        if isinstance(getattr(m, "u", None), torch.Tensor):
            m.u.normal_(generator=generator)
        if isinstance(getattr(m, "log_gain", None), nn.Parameter):
            m.log_gain.zero_()
    return module
