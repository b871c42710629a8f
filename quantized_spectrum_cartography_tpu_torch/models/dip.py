"""Deep-image-prior decoder (untrained prior).

Port of ``quantized_spectrum_cartography_tpu/models/dip.py`` (the reference's
`deep_prior/networks/dip.py:20-89` `DecoderDip`): five blocks of
Upsample(x2), Conv, BatchNorm, SELU, Conv k3 p1, BatchNorm, SELU from z at
1x1 to 52x52, then Conv(k4, p1) to 51x51 and a sigmoid.  Internally NCHW;
`forward` keeps the JAX module's layout, z [N, z_dim] -> [N, 51, 51, 1].
The layers are flax's (`models.layers.BatchNorm`: momentum 0.9, eps 1e-5,
the biased running variance), in flax's order, so
``training.checkpoints.state_dict_from_flax`` maps the JAX module's tree
(``Conv_<i>`` -> ``conv.<i>``, ``BatchNorm_<i>`` -> ``bn.<i>``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from quantized_spectrum_cartography_tpu_torch.models.layers import (
    BatchNorm,
    conv_torch,
    upsample2x,
)

# (features, first_kernel, first_pad) per upsample block; the second conv is
# always k3 p1.  Shape walk: 1->2->3 | 3->6->6 | 6->12->12 | 12->24->26 |
# 26->52->52  (dip.py:26-80).
_BLOCKS = (
    (128, 2, 1),
    (64, 3, 1),
    (32, 3, 1),
    (16, 3, 2),
    (2, 3, 1),
)


class DecoderDip(nn.Module):
    """Parameters: `conv.<i>` (two per block, then the final k4 conv) and
    `bn.<i>` (two per block).  Train mode normalizes by the batch's
    statistics and moves the running ones, as the JAX solver applies it."""

    def __init__(self, z_dim: int = 256):
        super().__init__()
        self.z_dim = z_dim
        conv, bn = [], []
        width = z_dim
        for f, k1, p1 in _BLOCKS:
            conv += [conv_torch(width, f, k1, 1, p1),
                     conv_torch(f, f, 3, 1, 1)]
            bn += [BatchNorm(f), BatchNorm(f)]
            width = f
        conv.append(conv_torch(width, 1, 4, 1, 1))     # 52 -> 51
        self.conv = nn.ModuleList(conv)
        self.bn = nn.ModuleList(bn)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z.reshape(z.shape[0], self.z_dim, 1, 1)
        for i in range(len(_BLOCKS)):
            x = upsample2x(x)
            x = torch.selu(self.bn[2 * i](self.conv[2 * i](x)))
            x = torch.selu(self.bn[2 * i + 1](self.conv[2 * i + 1](x)))
        x = torch.sigmoid(self.conv[-1](x))
        return x.permute(0, 2, 3, 1)                     # NCHW -> NHWC
