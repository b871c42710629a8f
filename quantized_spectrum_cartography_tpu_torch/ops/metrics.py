"""Recovery quality metrics.

Port of ``quantized_spectrum_cartography_tpu/ops/metrics.py``: NMSE and
NMSE after the log link, SRE and NAE of the MATLAB harness, and the miss /
false-detection counts at the emitters' locations.
"""

from __future__ import annotations

import torch


def _fro(x: torch.Tensor, dim=None) -> torch.Tensor:
    sq = x.square()
    return torch.sqrt(sq.sum() if dim is None else sq.sum(dim=dim))


def nmse(T: torch.Tensor, T_target: torch.Tensor, dim=None) -> torch.Tensor:
    """||T - T*||_F / ||T*||_F over `dim` (all axes if None); pass the map
    axes, e.g. ``dim=(-3, -2, -1)``, for one value per map of a batch."""
    return _fro(T - T_target, dim) / _fro(T_target, dim)


def nmse_log(T: torch.Tensor, T_target: torch.Tensor,
             offset: float) -> torch.Tensor:
    """NMSE after the log link log(x + offset)."""
    Tl = torch.log(T + offset)
    Tt = torch.log(T_target + offset)
    return _fro(Tl - Tt) / _fro(Tt)


def sre(X_hat: torch.Tensor, X_true: torch.Tensor) -> torch.Tensor:
    """Squared reconstruction error ||X - X*||_F^2 / ||X*||_F^2."""
    return (X_hat - X_true).square().sum() / X_true.square().sum()


def _l1_normalized(x: torch.Tensor) -> torch.Tensor:
    return x / x.abs().sum().clamp_min(1e-12)


def nae(x_hat: torch.Tensor, x_true: torch.Tensor) -> torch.Tensor:
    """Normalized absolute error between L1-normalized nonnegative signals."""
    return (_l1_normalized(x_hat) - _l1_normalized(x_true)).abs().sum()


def nae_tensor(X_hat: torch.Tensor, X_true: torch.Tensor,
               R: int) -> torch.Tensor:
    """The MATLAB harness's NAE: both tensors normalized by their global
    absolute sum, the summed absolute difference divided by R."""
    return nae(X_hat, X_true) / R


def detection_counts(
    T_hat: torch.Tensor,
    T_ref: torch.Tensor,
    peaks_xy: torch.Tensor,
    miss_threshold: float = 0.25,
    misdetect_threshold: float = 1.75,
    low_level: float = 0.01,
):
    """(misses, peak events, false detections, low events) at the true
    emitter locations, over every band: at peak (x, y) [R, 2] (x a column),
    ref = T_ref[k, y, x]; ref > low_level is a peak event, missed if
    T_hat < miss_threshold * ref; otherwise a low event, falsely detected
    if T_hat > max(low_level, misdetect_threshold * ref)."""
    px = peaks_xy[:, 0].round().long().clamp(0, T_ref.shape[2] - 1)
    py = peaks_xy[:, 1].round().long().clamp(0, T_ref.shape[1] - 1)
    ref_vals = T_ref[:, py, px]                       # [K, R]
    hat_vals = T_hat[:, py, px]
    is_peak = ref_vals > low_level
    miss = is_peak & (hat_vals < miss_threshold * ref_vals)
    misdetect = ~is_peak & (
        hat_vals > torch.clamp(misdetect_threshold * ref_vals, min=low_level))
    return (miss.sum(), is_peak.sum(), misdetect.sum(), (~is_peak).sum())
