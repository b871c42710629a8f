"""Completion autoencoders: (mask, masked map) [B, 2, 51, 51] -> map
[B, 1, 51, 51].

Port of ``quantized_spectrum_cartography_tpu/models/ae.py``, NCHW: the same
stage tables, activations, decoder heads and refinement block.  Parameters
are named after the flax modules' layers (`conv.<i>` for ``Conv_<i>``,
`convt.<i>` for ``ConvTranspose_<i>``, `bn.<i>` for ``BatchNorm_<i>``), so
``training.checkpoints.state_dict_from_flax`` maps a flax tree onto them.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from quantized_spectrum_cartography_tpu_torch.models.layers import (
    BatchNorm,
    conv_torch,
    convt_torch,
)

# Encoder conv stack (features, kernel, stride, pad): 51->25->12->6->3->1
_ENC_STAGES: Tuple[Tuple[int, int, int, int], ...] = (
    (16, 4, 2, 1),
    (32, 4, 2, 1),
    (64, 4, 2, 1),
    (128, 4, 2, 1),
    (256, 3, 1, 0),
)
# Decoder: the Generator256 stack, 1->3->6->12->26->54 -> conv k4 -> 51
_DEC_STAGES: Tuple[Tuple[int, int, int, int], ...] = (
    (128, 3, 1, 0),
    (64, 4, 2, 1),
    (32, 4, 2, 1),
    (16, 4, 2, 0),
    (2, 4, 2, 0),
)
HEADS = ("sigmoid", "softplus", "scaled_sigmoid")


def _act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"selu": F.selu,
            "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
            "relu": F.relu}[name]


def _width(features: int, base_width: int) -> int:
    return max(int(features * base_width / 16.0), 2)


class Encoder(nn.Module):
    """Conv encoder [B, in_channels, 51, 51] -> [B, latent]; `base_width`
    scales every stage's channel count.  The first conv has no BatchNorm;
    the convs have no bias."""

    def __init__(self, activation: str = "selu",
                 stages: Sequence[Tuple[int, int, int, int]] = _ENC_STAGES,
                 base_width: int = 16, in_channels: int = 2):
        super().__init__()
        self.act = _act(activation)
        conv, bn = [], []
        width = in_channels
        for i, (f, k, s, p) in enumerate(stages):
            f = _width(f, base_width)
            conv.append(nn.Conv2d(width, f, k, s, p, bias=False))
            if i > 0:
                bn.append(BatchNorm(f))
            width = f
        self.conv = nn.ModuleList(conv)
        self.bn = nn.ModuleList(bn)
        self.out_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.conv):
            x = conv(x)
            if i > 0:
                x = self.bn[i - 1](x)
            x = self.act(x)
        # flatten in flax's NHWC order
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class Decoder(nn.Module):
    """Transpose-conv decoder [B, in_features] -> [B, 1, 51, 51].

    `head`: 'sigmoid', 'softplus' or 'scaled_sigmoid' (sigmoid times
    exp(`log_gain`), a learned scalar).  `refine_width` > 0 ends with the
    full-resolution block: conv k4 (54 -> 51) to `refine_width` channels,
    act, a SAME 3x3 conv, act, a SAME 3x3 conv to one channel."""

    def __init__(self, activation: str = "selu",
                 stages: Sequence[Tuple[int, int, int, int]] = _DEC_STAGES,
                 base_width: int = 16, head: str = "sigmoid",
                 refine_width: int = 0, in_features: int = 256):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown decoder head {head!r}")
        self.act = _act(activation)
        self.head = head
        convt, bn = [], []
        width = in_features
        for f, k, s, p in stages:
            f = _width(f, base_width)
            convt.append(convt_torch(width, f, k, s, p))
            bn.append(BatchNorm(f))
            width = f
        self.convt = nn.ModuleList(convt)
        self.bn = nn.ModuleList(bn)
        if refine_width:
            conv = [conv_torch(width, refine_width, 4, 1, 0),
                    nn.Conv2d(refine_width, refine_width, 3, padding=1),
                    nn.Conv2d(refine_width, 1, 3, padding=1)]
        else:
            conv = [conv_torch(width, 1, 4, 1, 0)]
        self.conv = nn.ModuleList(conv)
        if head == "scaled_sigmoid":
            self.log_gain = nn.Parameter(torch.zeros(()))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z.reshape(z.shape[0], z.shape[-1], 1, 1)
        for convt, bn in zip(self.convt, self.bn):
            x = self.act(bn(convt(x)))
        for i, conv in enumerate(self.conv):
            x = conv(x)
            if i < len(self.conv) - 1:
                x = self.act(x)
        if self.head == "sigmoid":
            return torch.sigmoid(x)
        if self.head == "softplus":
            return F.softplus(x)
        return torch.sigmoid(x) * torch.exp(self.log_gain)


class Autoencoder(nn.Module):
    """Completion AE: (mask, masked map) channels in, the full map out.

    activation='selu' is the reference's AutoencoderSelu, 'leaky_relu' the
    plain Autoencoder; linear_bottleneck > 0 inserts Dense layers down to
    that width and back up to 256 (AutoencoderLinear)."""

    def __init__(self, activation: str = "selu", linear_bottleneck: int = 0,
                 base_width: int = 16):
        super().__init__()
        self.encoder = Encoder(activation=activation, base_width=base_width)
        width = self.encoder.out_features
        self.decoder = Decoder(activation=activation, base_width=base_width,
                               in_features=256 if linear_bottleneck
                               else width)
        self.linear_bottleneck = linear_bottleneck
        if linear_bottleneck:
            self.bottleneck_down = nn.Linear(width, linear_bottleneck)
            self.bottleneck_up = nn.Linear(linear_bottleneck, 256)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(mask, map) [B, 2, 51, 51] -> latent code [B, latent]."""
        h = self.encoder(x)
        if self.linear_bottleneck:
            h = self.bottleneck_up(F.relu(self.bottleneck_down(h)))
        return h

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        """latent [B, latent] -> completed map [B, 1, 51, 51]."""
        return self.decoder(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def AutoencoderLinear(bottleneck: int = 128) -> Autoencoder:
    """The reference's AutoencoderLinear: the hourglass with a 128-d linear
    bottleneck."""
    return Autoencoder(activation="leaky_relu", linear_bottleneck=bottleneck)


def EncoderDecoder(width: int = 256) -> Autoencoder:
    """The reference's EncoderDecoder completion-net family: the conv
    hourglass with channel widths scaled by `width` (the bottleneck channel
    count; 256 is the default stack)."""
    return Autoencoder(activation="leaky_relu", base_width=max(width // 16, 2))
