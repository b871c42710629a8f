"""Profiling and reporting helpers (port of
``quantized_spectrum_cartography_tpu/utils``)."""

from quantized_spectrum_cartography_tpu_torch.utils.profiling import (  # noqa: F401
    time_calls,
    trace,
)
