"""Bin-boundary tables: the observation model's data.

Copied value for value from ``quantized_spectrum_cartography_tpu/ops/boundaries.py``
(the reference's `qmc/utils.py:10-54`), so the port runs without JAX; the
tables are checked against the JAX package by ``tests/test_torch_ops.py``.
The two estimators, equal-count binning (`qmc/utils.py:57-74`) and the
Gauss-Newton fit of the log offset (`qmc/nlls.py:18-37`), run on the host.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# --- linear-domain boundary tables (qmc/utils.py:10-27) ----------------------

QUANTIZATION_BOUNDARIES_8_BINS_SAMPLE = (
    0.0, 3.219041422308777e-10, 6.34243551758118e-05, 0.0001823223865358159,
    0.00036289551644586027, 0.0006664704997092485, 0.0012639077613130212,
    0.00301913358271122, 0.3312782347202301,
)
SD_8_BINS_SAMPLE = 3.219041422308777e-10

QUANTIZATION_BOUNDARIES_16_BINS = (
    0.0, 8.944017748646615e-10, 2.3812383005861193e-05, 6.808515900047496e-05,
    0.00012131989933550358, 0.00018234866729471833, 0.00025588355492800474,
    0.00034619917278178036, 0.0004588317824527621, 0.0006049227667972445,
    0.0007961964583955705, 0.0010579598601907492, 0.001441714819520712,
    0.0020772861316800117, 0.003326504724100232, 0.006930550094693899,
    0.27432483434677124,
)
SD_16_BINS = 8.944017748646615e-10

_DATA_MAX = 0.3312


def uniform_boundaries(num_bins: int, max_value: float = _DATA_MAX) -> Tuple[float, ...]:
    """Equally spaced boundaries 0..max (qmc/utils.py:20-27)."""
    return tuple(np.arange(num_bins + 1) * max_value / num_bins)


QUANTIZATION_BOUNDARIES_8_BINS_UNIFORM = uniform_boundaries(8)
SD_8_BINS_UNIFORM = QUANTIZATION_BOUNDARIES_8_BINS_UNIFORM[1]
QUANTIZATION_BOUNDARIES_16_BINS_UNIFORM = uniform_boundaries(16)
SD_16_BINS_UNIFORM = QUANTIZATION_BOUNDARIES_16_BINS_UNIFORM[1]
QUANTIZATION_BOUNDARIES_256_BINS_UNIFORM = uniform_boundaries(256)
SD_256_BINS_UNIFORM = QUANTIZATION_BOUNDARIES_256_BINS_UNIFORM[1]

# --- log-domain tables (qmc/utils.py:30-38) ---------------------------------

QUANTIZATION_BOUNDARIES_8_BINS_LOG = (
    -23.025850296020508, -23.000225067138672, -9.472214698791504,
    -8.490324974060059, -7.831082344055176, -7.240789890289307,
    -6.61128044128418, -5.762726783752441, -1.2379993200302124,
)
SD_8_BINS_LOG = 0.0256

QUANTIZATION_BOUNDARIES_7_BINS_LOG = (
    -23.025850296020508, -9.472214698791504, -8.490324974060059,
    -7.831082344055176, -7.240789890289307, -6.61128044128418,
    -5.762726783752441, -1.2379993200302124,
)
QUANTIZATION_BOUNDARIES_4_BINS_LOG = (
    -23.025850296020508, -10.002398490905762, -7.980128765106201,
    -6.692554473876953, -1.0331487655639648,
)
LOG_OFFSET_4 = 1e-10
SD_4_BINS_LOG = 1.287

# The qmc.ipynb headline config refers to these as *_4_BINS / SD_4_BINS.
QUANTIZATION_BOUNDARIES_4_BINS = QUANTIZATION_BOUNDARIES_4_BINS_LOG
SD_4_BINS = SD_4_BINS_LOG

# --- NLLS-adjusted tables (qmc/utils.py:41-52) ------------------------------

QUANTIZATION_BOUNDARIES_7_ADJUSTED = (
    -10.69232977, -9.35950321, -8.49230102, -7.86067357, -7.27999497,
    -6.65573177, -5.7952887, -1.10472809,
)
QUANTIZATION_BOUNDARIES_16_ADJUSTED = (
    -15.25285591, -10.63537803, -9.59126825, -9.01512351, -8.60828803,
    -8.26986013, -7.96781035, -7.68630929, -7.41001714, -7.13536627,
    -6.85118837, -6.54175727, -6.17657863, -5.70576175, -4.97178181,
    -1.29344148,
)
LOG_OFFSET_7_ADJUSTED = 2.27e-05
LOG_OFFSET_16_ADJUSTED = 2.3755e-07


def find_boundaries(samples, num_bins: int = 4) -> Tuple[np.ndarray, float]:
    """Equal-count binning: quantiles of the sorted samples (a tensor or
    array), made strictly increasing by moving a repeated boundary to the
    next larger sample; returns (boundaries [num_bins + 1] float64,
    sd = the smallest gap)."""
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().cpu().numpy()
    data = np.sort(np.asarray(samples).reshape(-1))
    qs = np.linspace(0.0, 1.0, num_bins + 1)
    idx = np.clip((qs * (data.size - 1)).astype(np.int64), 0, data.size - 1)
    bounds = data[idx].astype(np.float64)
    for i in range(1, len(bounds)):
        if bounds[i] <= bounds[i - 1]:
            nxt = data[data > bounds[i - 1]]
            bounds[i] = nxt[0] if nxt.size else bounds[i - 1] + 1e-12
    sd = float(np.min(np.diff(bounds)))
    return bounds, sd


def fit_log_offset(
    raw_boundaries: Sequence[float], iters: int = 40, init_offset: float = 1e-7
) -> Tuple[float, float, torch.Tensor]:
    """Gauss-Newton NLLS fit of (f, b) in y = log(f + x) + b with
    y = 0..n-1, in float64 (the offsets span 9+ orders of magnitude);
    returns (offset f, intercept b, log(f + x) as float32)."""
    x = np.asarray(raw_boundaries, dtype=np.float64)
    y = np.arange(x.shape[0], dtype=np.float64)
    theta = np.array([init_offset, 0.0])
    for _ in range(iters):
        H = np.stack([1.0 / (theta[0] + x), np.ones_like(x)], axis=1)
        r = y - (np.log(theta[0] + x) + theta[1])
        theta = theta + np.linalg.solve(H.T @ H, H.T @ r)
    return (float(theta[0]), float(theta[1]),
            torch.as_tensor(np.log(theta[0] + x), dtype=torch.float32))
