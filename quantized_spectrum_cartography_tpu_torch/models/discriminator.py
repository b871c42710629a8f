"""DCGAN discriminators, plain and spectrally normalized.

Port of ``quantized_spectrum_cartography_tpu/models/discriminator.py``, NCHW:
five conv stages 51 -> 25 -> 12 -> 6 -> 3 -> 1 with LeakyReLU(0.2), BatchNorm
after stages 2-4, a sigmoid output (or the raw score, for hinge-loss
training).  Layers are named after flax's (`conv.<i>` for ``Conv_<i>`` or
``SNConv_<i>``, `bn.<i>` for ``BatchNorm_<i>``).  Train mode (`train()`)
is the JAX module's ``train=True``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from quantized_spectrum_cartography_tpu_torch.models.layers import BatchNorm
from quantized_spectrum_cartography_tpu_torch.models.spectral_norm import (
    SNConv,
)

_STAGES: Tuple[Tuple[int, int, int, int], ...] = (
    (16, 4, 2, 1),    # 51 -> 25
    (32, 4, 2, 1),    # 25 -> 12
    (64, 4, 2, 1),    # 12 -> 6
    (128, 4, 2, 1),   # 6 -> 3
)


class Discriminator(nn.Module):
    """maps [B, 1, 51, 51] -> [B, 1]: P(real), or the raw score when
    `output_logits`."""

    def __init__(self, spectral_norm: bool = False,
                 output_logits: bool = False):
        super().__init__()
        self.output_logits = output_logits

        def conv(i, f, k, s, p):
            return (SNConv(i, f, k, s, p) if spectral_norm
                    else nn.Conv2d(i, f, k, s, p, bias=False))

        convs, bns, width = [], [], 1
        for i, (f, k, s, p) in enumerate(_STAGES):
            convs.append(conv(width, f, k, s, p))
            if i > 0:         # the first stage has no BN (gan.py:253-255)
                bns.append(BatchNorm(f))
            width = f
        convs.append(conv(width, 1, 3, 1, 0))                # 3 -> 1
        self.conv = nn.ModuleList(convs)
        self.bn = nn.ModuleList(bns)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.conv[:-1]):
            x = conv(x)
            if i > 0:
                x = self.bn[i - 1](x)
            x = F.leaky_relu(x, 0.2)
        x = self.conv[-1](x).flatten(1)
        return x if self.output_logits else torch.sigmoid(x)


def SNDiscriminator() -> Discriminator:
    return Discriminator(spectral_norm=True)
