"""Architecture-dict-driven network builders.

Port of ``quantized_spectrum_cartography_tpu/models/builders.py`` (the
reference's `deep_prior/networks/model_utils.py:10-260`): a dict like

    {"conv_layers": 5,
     "conv_channels": [16, 32, 64, 128, 256],
     "conv_kernel_sizes": [(4,4)]*5,
     "conv_strides": [(2,2), ...],
     "conv_paddings": [(1,1), ...],
     "z_dimension": 64}

builds the conv stack, tracking output shapes and validating the walk like
the reference's InvalidArchitectureError (networks/utils/errors.py).  NCHW
inside; layers named after flax's (`conv.<i>`, `bn.<i>`, `dense.<i>`), so
``training.checkpoints.state_dict_from_flax`` maps the JAX modules' trees.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from quantized_spectrum_cartography_tpu_torch.models.layers import BatchNorm


class InvalidArchitectureError(ValueError):
    """Shape walk hit a non-positive spatial size (utils/errors.py:1-20)."""


def conv_output_shape(hw: Tuple[int, int], kernel, stride, pad):
    """torch Conv2d arithmetic: floor((in + 2p - k)/s) + 1
    (model_utils.py conv shape helpers)."""
    h = (hw[0] + 2 * pad[0] - kernel[0]) // stride[0] + 1
    w = (hw[1] + 2 * pad[1] - kernel[1]) // stride[1] + 1
    return h, w


def trace_encoder_shapes(arch: Dict,
                         input_hw=(51, 51)) -> List[Tuple[int, int]]:
    shapes = []
    hw = input_hw
    for i in range(arch["conv_layers"]):
        hw = conv_output_shape(hw, arch["conv_kernel_sizes"][i],
                               arch["conv_strides"][i],
                               arch["conv_paddings"][i])
        if hw[0] <= 0 or hw[1] <= 0:
            raise InvalidArchitectureError(
                f"layer {i} collapses spatial dims to {hw}")
        shapes.append(hw)
    return shapes


class DictEncoder(nn.Module):
    """Conv stack from an architecture dict -> z vector (create_encoder +
    GANEncoder, gan.py:227-246): each layer conv, LeakyReLU(0.15),
    BatchNorm, in that order, then a Dense.  x [N, in_channels, H, W] ->
    [N, z_dimension]; train mode is the JAX module's ``train=True``."""

    def __init__(self, arch: Dict, input_hw: Tuple[int, int] = (51, 51),
                 negative_slope: float = 0.15, in_channels: int = 1):
        super().__init__()
        self.negative_slope = negative_slope   # model_utils.py:118
        shapes = trace_encoder_shapes(arch, input_hw)
        conv, bn = [], []
        width = in_channels
        for i in range(arch["conv_layers"]):
            f = arch["conv_channels"][i]
            conv.append(nn.Conv2d(width, f,
                                  tuple(arch["conv_kernel_sizes"][i]),
                                  tuple(arch["conv_strides"][i]),
                                  tuple(arch["conv_paddings"][i])))
            bn.append(BatchNorm(f))
            width = f
        self.conv = nn.ModuleList(conv)
        self.bn = nn.ModuleList(bn)
        h, w = shapes[-1]
        self.dense = nn.ModuleList([nn.Linear(h * w * width,
                                              arch["z_dimension"])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.conv, self.bn):
            x = bn(F.leaky_relu(conv(x), self.negative_slope))
        # flax flattens NHWC: the Dense kernel's rows are in (h, w, c) order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense[0](x)


class DictDiscriminator(nn.Module):
    """z -> 1 MLP with halving widths and LeakyReLU(0.15), then a sigmoid
    (create_discriminator, model_utils.py:196-230)."""

    def __init__(self, z_dimension: int, num_layers: int = 3):
        super().__init__()
        dense, w = [], z_dimension
        for _ in range(num_layers):
            dense.append(nn.Linear(w, max(w // 2, 1)))
            w = max(w // 2, 1)
        dense.append(nn.Linear(w, 1))
        self.dense = nn.ModuleList(dense)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for layer in self.dense[:-1]:
            x = F.leaky_relu(layer(x), 0.15)
        return torch.sigmoid(self.dense[-1](x))


def GANEncoder() -> DictEncoder:
    """The reference GANEncoder architecture (gan.py:227-246)."""
    return DictEncoder(arch={
        "conv_layers": 5,
        "conv_channels": [16, 32, 64, 128, 256],
        "conv_kernel_sizes": [(4, 4)] * 5,
        "conv_strides": [(1, 1), (2, 2), (1, 1), (2, 2), (2, 2)],
        "conv_paddings": [(1, 1)] * 5,
        "z_dimension": 64,
    })
