"""Adversarial autoencoder (AAE) on SLF maps.

Port of ``quantized_spectrum_cartography_tpu/models/aae.py``, NCHW: a conv
encoder to z, a decoder from z that doubles as a generative prior, and a
latent discriminator that tells z ~ N(0, I) from the encoder's codes
(training in ``training.aae_trainer``).  Layers carry flax's names
(`dense.<i>` for ``Dense_<i>``; the submodules flax names ``Encoder_0`` and
``Decoder_0`` keep those names), so ``training.checkpoints`` maps a flax tree
onto them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from quantized_spectrum_cartography_tpu_torch.models.ae import Decoder, Encoder


class LatentDiscriminator(nn.Module):
    """MLP z [B, z_dim] -> P(z is from the prior) [B]: `depth` LeakyReLU
    layers of width `width`, halving, at least 8, then one unit."""

    def __init__(self, z_dim: int = 64, width: int = 128, depth: int = 3):
        super().__init__()
        dense, w, width_in = [], width, z_dim
        for _ in range(depth):
            dense.append(nn.Linear(width_in, max(w, 8)))
            width_in, w = max(w, 8), w // 2
        dense.append(nn.Linear(width_in, 1))
        self.dense = nn.ModuleList(dense)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for layer in self.dense[:-1]:
            x = F.leaky_relu(layer(x), 0.2)
        return torch.sigmoid(self.dense[-1](x))[..., 0]


class AAEEncoder(nn.Module):
    """Conv encoder [B, 1, 51, 51] -> z [B, z_dim] (deterministic)."""

    def __init__(self, z_dim: int = 64, activation: str = "leaky_relu"):
        super().__init__()
        self.Encoder_0 = Encoder(activation=activation, in_channels=1)
        self.dense = nn.ModuleList(
            [nn.Linear(self.Encoder_0.out_features, z_dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense[0](self.Encoder_0(x))


class AAEDecoder(nn.Module):
    """z [B, z_dim] -> maps [B, 1, 51, 51]."""

    def __init__(self, z_dim: int = 64, activation: str = "leaky_relu"):
        super().__init__()
        self.dense = nn.ModuleList([nn.Linear(z_dim, 256)])
        self.Decoder_0 = Decoder(activation=activation, in_features=256)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.Decoder_0(self.dense[0](z))
