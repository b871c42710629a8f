"""Typed configuration: copies of the JAX package's dataclasses.

Field names and defaults match ``quantized_spectrum_cartography_tpu/config.py``
(checked by ``tests/test_torch_config.py``).  They are copied, not imported,
so that the port runs without JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Synthetic radio-map physics (reference `qmc/generate_map.m`,
    `qmc/generate_test_data.m:9-35`)."""

    grid_size: int = 51            # I = J  (50x50 grid at resolution 1 -> 51 points)
    num_bands: int = 64            # K
    num_emitters: int = 2          # R
    shadow_sigma: float = 4.0      # log-normal shadowing std (dB)
    decorrelation_distance: float = 90.0   # Xc; p = exp(-1/Xc)
    psd_basis: str = "g"           # 'g' gaussian bumps | 's' sinc^2 bumps
    separable: bool = True
    num_peaks_per_psd: int = 3
    path_loss_d0: float = 2.0      # min(1, (d/d0)^-alpha)
    alpha_lo: float = 2.0          # alpha ~ U[alpha_lo, alpha_lo + alpha_spread]
    alpha_spread: float = 0.5
    mean_slf: float = 0.0045       # 1-bit threshold (generate_test_data.m:27)
    std_slf: float = 0.0191


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """Quantization / observation model.

    domain='log' applies link(x) = log(x + offset) before dithering+binning
    (reference `qmc/quantization_model_log.py:9-21`); domain='linear' is the
    identity link (`qmc/quantization_model.py:8-20`).
    """

    boundaries: Tuple[float, ...] = ()      # bin boundaries, len = num_bins + 1
    noise_std: float = 5.0                  # dither / probit sigma
    domain: str = "log"                     # 'log' | 'linear'
    log_offset: float = 1e-10
    link_model: str = "probit"              # 'probit' | 'sigmoid'

    @property
    def num_bins(self) -> int:
        return len(self.boundaries) - 1


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Alternating-optimization recovery (reference `qmc/qmc.ipynb` cell 1)."""

    max_iters: int = 500
    lr_c: float = 0.005
    lr_z: float = 0.01
    lr_s: float = 0.001
    lambda_c: float = 100.0
    lambda_s: float = 100.0
    c_inner_iters: int = 1
    s_inner_iters: int = 1
    z_dim: int = 256
    # randomized Z search (qmc.ipynb cell 1, i==1 branch)
    z_search_global: int = 200
    z_search_local: int = 200
    z_search_local_scale: float = 0.2
    z_search_at_iter: int = 1
    # low-rank MLE solver (backup/notebooks/onebit_lowrank.ipynb)
    rank_truncation: int = 10
    projection_interval: int = 5
    # 'svd'      — exact batched SVD truncation
    # 'subspace' — randomized QR subspace iteration (ops/lowrank.py
    #              project_rank_subspace), default
    projection_method: str = "subspace"
    nonneg_slf: bool = False
    sample_fraction: float = 0.1
    mask_mode: str = "per_entry"    # 'per_entry' (qmc.ipynb) | 'per_location' (.mat fixture)
