"""The problem container of ``quantized_spectrum_cartography_tpu/data/fixtures.py``.

The ``.mat`` fixture loader is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Problem:
    """One spectrum-cartography problem instance:

    T_true  [K, I, J]   ground-truth map
    S_true  [R, I, J]   true spatial loss fields
    C_true  [R, K]      true PSDs
    T_1bit  [K, I, J]   +-1 thresholded map (generate_test_data.m:65-66)
    Om      [I, J]      per-location sampling mask (bool), or None
    peaks   [R, 2]      (x, y) true emitter locations, or None
    """

    T_true: torch.Tensor
    S_true: torch.Tensor
    C_true: torch.Tensor
    T_1bit: Optional[torch.Tensor] = None
    Om: Optional[torch.Tensor] = None
    mean_slf: float = 0.0045
    peaks: Optional[torch.Tensor] = None

    @property
    def shape(self):
        K, I, J = self.T_true.shape
        R = self.S_true.shape[0]
        return R, I, J, K
