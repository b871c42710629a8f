"""Profiling helpers.

Port of ``quantized_spectrum_cartography_tpu/utils/profiling.py``: a
``torch.profiler`` trace written as a Chrome trace, and wall-clock timing
of a callable with its first call split from the steady per-call time (the
device synchronized).  The JAX module's kernel roofline is not ported: the
benchmark counts the kernels' work from shapes (``port_bench/roofline.py``).
Spans inside the program are ``utils.tracing``'s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def sync_device(device) -> None:
    """Wait for `device`'s queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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
