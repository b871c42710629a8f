"""Typed configuration: copies of the JAX package's dataclasses, and the
INI / JSON config-file loader.

Field names and defaults match ``quantized_spectrum_cartography_tpu/config.py``
(checked by ``tests/test_torch_config.py``).  They are copied, not imported,
so that the port runs without JAX.
"""

from __future__ import annotations

import configparser
import dataclasses
import json
import os
import typing
from typing import Tuple

import torch


def set_card_numerics() -> None:
    """IEEE float32 on the card: no TF32 in matmuls or cuDNN convolutions,
    and deterministic cuDNN algorithms chosen without benchmarking, so that a
    run on the card computes what the CPU tests hold against the JAX
    package.  Process-wide; every entry point that runs on CUDA calls it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh for sharded batched recovery."""

    data_axis: int = -1      # -1: all devices on the data (batch-of-maps) axis
    model_axis: int = 1      # frequency (K) axis sharding factor
    axis_names: Tuple[str, str] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    physics: PhysicsConfig = dataclasses.field(default_factory=PhysicsConfig)
    quantizer: QuantizerConfig = dataclasses.field(default_factory=QuantizerConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    seed: int = 0


_SECTION_TYPES = {
    "physics": PhysicsConfig,
    "quantizer": QuantizerConfig,
    "solver": SolverConfig,
    "mesh": MeshConfig,
}


def _coerce(raw: str, typ):
    """An INI string as a value of the dataclass field's type."""
    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if raw.lower() in ("none", "null", ""):
            return None
        return _coerce(raw, args[0])
    if origin in (tuple, list):
        parts = [p for p in raw.replace(",", " ").split() if p]
        sub = typing.get_args(typ)[0] if typing.get_args(typ) else float
        vals = [_coerce(p, sub) for p in parts]
        return tuple(vals) if origin is tuple else vals
    if typ is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    return raw


def _build_section(cls, entries: dict):
    hints = typing.get_type_hints(cls)
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in entries.items():
        name = key.replace("-", "_")
        if name not in fields:
            raise ValueError(
                f"unknown {cls.__name__} field '{key}' in config file")
        typ = hints[name]
        if isinstance(val, str):
            val = _coerce(val, typ)
        elif isinstance(val, list) and typing.get_origin(typ) is tuple:
            val = tuple(val)
        kwargs[name] = val
    return cls(**kwargs)


def load_config_file(path: str) -> ProblemConfig:
    """A ProblemConfig from an INI or JSON file: sections (JSON top-level
    keys) [physics] [quantizer] [solver] [mesh], and the seed ([general]
    seed in INI, a top-level "seed" in JSON).  Unknown sections and fields
    raise."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    sections: dict = {}
    seed = 0
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        seed = int(data.pop("seed", 0))
        sections = data
    else:
        cp = configparser.ConfigParser()
        cp.read(path)
        for sec in cp.sections():
            if sec == "general":
                seed = cp.getint("general", "seed", fallback=0)
                continue
            sections[sec] = dict(cp.items(sec))
    kwargs = {}
    for name, entries in sections.items():
        if name not in _SECTION_TYPES:
            raise ValueError(f"unknown config section '{name}'")
        kwargs[name] = _build_section(_SECTION_TYPES[name], entries)
    return ProblemConfig(seed=seed, **kwargs)
