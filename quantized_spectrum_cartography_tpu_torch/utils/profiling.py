"""Profiling and roofline accounting.

Port of ``quantized_spectrum_cartography_tpu/utils/profiling.py``: a
``torch.profiler`` trace written as a Chrome trace, wall-clock timing of a
callable with its first call split from the steady per-call time (the
device synchronized), and the roofline of the fused likelihood kernels
against one NVIDIA H100's published peaks.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch

# NVIDIA H100 SXM 80 GB (data sheet, at its 700 W power limit): HBM3
# bandwidth and float32 outside the tensor cores; the rates the roofline
# of chip_smoke.py uses
H100_HBM_GBPS = 3350.0
H100_F32_TFLOPS = 67.0


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(path: str):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's kernels where there is a card) and write it to `path` as a
    Chrome trace (chrome://tracing, Perfetto).  Yields the profiler, whose
    ``key_averages()`` sums the time by operator."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)


def time_calls(fn: Callable, *args, iters: int = 50) -> Dict[str, float]:
    """{'first_call_s', 'per_call_us'} of `fn(*args)`: the first call (a
    kernel build, cuDNN's algorithm choice, the allocator's first blocks;
    JAX's compile) apart from the mean of `iters` later calls, each
    measurement ending with the device synchronized."""
    _sync()
    t0 = time.perf_counter()
    fn(*args)
    _sync()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    per_call = (time.perf_counter() - t0) / iters
    return {"first_call_s": first_s, "per_call_us": per_call * 1e6}


def likelihood_roofline(
    batch: int, K: int, IJp: int, R: int, measured_us: float,
    backward: bool = False,
) -> Dict[str, float]:
    """Roofline stats for the fused quantized-NLL kernel on one H100.

    Traffic model: reads W,U [K,IJp] f32 per map (+S,C, negligible);
    backward additionally writes dS [R,IJp] and dC [K,R]."""
    bytes_per_map = 4 * (2 * K * IJp + R * IJp + K * R)
    if backward:
        bytes_per_map += 4 * (R * IJp + K * R)
    total_bytes = batch * bytes_per_map
    gbps = total_bytes / (measured_us * 1e-6) / 1e9
    flops = batch * (2 * K * R * IJp * (3 if backward else 1)
                     + 30 * K * IJp)
    tflops = flops / (measured_us * 1e-6) / 1e12
    return {
        "bytes": total_bytes,
        "flops": flops,
        "achieved_GBps": gbps,
        "pct_hbm_peak": 100.0 * gbps / H100_HBM_GBPS,
        "achieved_TFLOPs": tflops,
        "pct_f32_peak": 100.0 * tflops / H100_F32_TFLOPS,
        "bound": "bandwidth" if gbps / H100_HBM_GBPS >
                 tflops / H100_F32_TFLOPS else "compute",
    }
