"""Recovery quality metrics (port of the NMSE in
``quantized_spectrum_cartography_tpu/ops/metrics.py``)."""

from __future__ import annotations

import torch


def nmse(T: torch.Tensor, T_target: torch.Tensor, dim=None) -> torch.Tensor:
    """||T - T*||_F / ||T*||_F over `dim` (all axes if None); pass the map
    axes, e.g. ``dim=(-3, -2, -1)``, for one value per map of a batch."""
    def fro(x):
        sq = x.square()
        return torch.sqrt(sq.sum() if dim is None else sq.sum(dim=dim))

    return fro(T - T_target) / fro(T_target)
