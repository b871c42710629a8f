"""DCGAN-style SLF generators (the deep prior G: z -> 51x51 map).

Port of ``quantized_spectrum_cartography_tpu/models/generator.py``: the same
stage tables, each stage ConvTranspose -> BatchNorm (eps 1e-5, running
statistics) -> ReLU, then Conv k4 and a sigmoid; the shape walk is
1 -> 3 -> 6 -> 12 -> 26 -> 54 -> 51.  Internally NCHW; `forward` keeps the
JAX module's output layout, Z [N, z] -> [N, 51, 51, 1].  The builders return
it in eval mode, as the solvers use it; trained weights come from a checkpoint
through ``training.checkpoints``, and ``training.gan_trainer`` trains it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from quantized_spectrum_cartography_tpu_torch.models.layers import (
    BatchNorm,
    conv_torch,
    convt_torch,
)

# (features, kernel, stride, torch_pad) per upsampling stage
_STAGES_256: Tuple[Tuple[int, int, int, int], ...] = (
    (128, 3, 1, 0),   # 1 -> 3
    (64, 4, 2, 1),    # 3 -> 6
    (32, 4, 2, 1),    # 6 -> 12
    (16, 4, 2, 0),    # 12 -> 26
    (2, 4, 2, 0),     # 26 -> 54
)
_STAGES_512: Tuple[Tuple[int, int, int, int], ...] = (
    (256, 3, 1, 0),   # 1 -> 3
    (128, 3, 1, 0),   # 3 -> 5
    (64, 4, 1, 1),    # 5 -> 6
    (32, 4, 2, 1),    # 6 -> 12
    (16, 4, 2, 0),    # 12 -> 26
    (2, 4, 2, 0),     # 26 -> 54
)
_STAGES_128: Tuple[Tuple[int, int, int, int], ...] = (
    (128, 3, 1, 0),
    (64, 4, 2, 1),
    (32, 4, 2, 1),
    (16, 4, 2, 0),
    (2, 4, 2, 0),
)


class DCGANGenerator(nn.Module):
    """Config-driven transpose-conv decoder z [N, z_dim] -> [N, 51, 51, 1].

    Parameters: `stem` (Linear, Generator64 only), `convt.<i>` and `bn.<i>`
    per stage, `conv` (the final 4x4 convolution)."""

    def __init__(self, z_dim: int = 256,
                 stages: Sequence[Tuple[int, int, int, int]] = _STAGES_256,
                 linear_stem: int = 0):
        super().__init__()
        self.z_dim = z_dim
        self.stem = nn.Linear(z_dim, linear_stem) if linear_stem else None
        width = linear_stem or z_dim
        convt, bn = [], []
        for f, k, s, p in stages:
            convt.append(convt_torch(width, f, k, s, p))
            bn.append(BatchNorm(f))
            width = f
        self.convt = nn.ModuleList(convt)
        self.bn = nn.ModuleList(bn)
        self.conv = conv_torch(width, 1, 4, 1, 0)     # 54 -> 51

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        if self.stem is not None:
            x = torch.relu(self.stem(x))
        x = x.reshape(x.shape[0], x.shape[-1], 1, 1)
        for convt, bn in zip(self.convt, self.bn):
            x = torch.relu(bn(convt(x)))
        x = torch.sigmoid(self.conv(x))
        return x.permute(0, 2, 3, 1)                  # NCHW -> NHWC


def _build(z_dim, stages, linear_stem, seed: Optional[int]):
    if seed is None:
        return DCGANGenerator(z_dim, stages, linear_stem).eval()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return DCGANGenerator(z_dim, stages, linear_stem).eval()


def Generator256(seed: Optional[int] = None) -> DCGANGenerator:
    """The production prior behind qmc.ipynb; weights drawn from `seed`
    (torch's default initializers) when given."""
    return _build(256, _STAGES_256, 0, seed)


def Generator512(seed: Optional[int] = None) -> DCGANGenerator:
    return _build(512, _STAGES_512, 0, seed)


def Generator128(seed: Optional[int] = None) -> DCGANGenerator:
    return _build(128, _STAGES_128, 0, seed)


def Generator64(seed: Optional[int] = None) -> DCGANGenerator:
    """The reference's `Generator` (z=64, Linear stem to 128)."""
    return _build(64, _STAGES_128, 128, seed)


def make_generator(z_dim: int, seed: Optional[int] = None) -> DCGANGenerator:
    return {64: Generator64, 128: Generator128,
            256: Generator256, 512: Generator512}[z_dim](seed)
