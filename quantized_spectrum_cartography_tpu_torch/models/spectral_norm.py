"""Spectral normalization by power iteration.

Port of ``quantized_spectrum_cartography_tpu/models/spectral_norm.py``, with
its semantics rather than ``torch.nn.utils.spectral_norm``'s: the matrix is
the HWIO kernel flattened to [out, kh*kw*in], the norm's guard is added
(``v / (|v| + 1e-12)``), and the gradient of sigma flows through the power
iteration; only the returned vector is detached.  The vector `u` is a
buffer, written back by a train-mode forward unless `update_stats` is
cleared (`models.layers.frozen_stats`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _l2norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def power_iteration(W: torch.Tensor, u: torch.Tensor, steps: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`steps` rounds of power iteration on W [out, in_flat] from u
    [1, out]: v = l2norm(u W), u = l2norm(v W^T); sigma = u W v^T.
    Returns (sigma, new u detached)."""
    for _ in range(steps):
        v = _l2norm(u @ W)
        u = _l2norm(v @ W.T)
    sigma = ((u @ W) * v).sum()
    return sigma, u.detach()


class SNConv(nn.Conv2d):
    """Conv2d(k, s, p) of the kernel divided by its largest singular value
    (the reference's SNConv2d).  No bias unless `bias`."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int, pad: int, bias: bool = False,
                 power_steps: int = 1):
        super().__init__(in_features, features, kernel, stride, pad,
                         bias=bias)
        self.power_steps = power_steps
        self.update_stats = True
        self.register_buffer("u", torch.randn(1, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # [out, in, kh, kw] -> the JAX kernel's [out, kh*kw*in]
        W = self.weight.permute(0, 2, 3, 1).reshape(self.out_channels, -1)
        sigma, new_u = power_iteration(W, self.u, self.power_steps)
        if self.training and self.update_stats:
            self.u = new_u
        return F.conv2d(x, self.weight / sigma.clamp_min(1e-12), self.bias,
                        self.stride, self.padding)
