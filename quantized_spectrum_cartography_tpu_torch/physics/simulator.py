"""Synthetic radio-map simulator.

Port of ``quantized_spectrum_cartography_tpu/physics/simulator.py``
(`qmc/generate_map.m`, `qmc/generate_test_data.m`).  Maps are drawn as a
batch from one `torch.Generator`, on the generator's device; torch's random
numbers differ from `jax.random`'s, so the tests check the deterministic
assembly on the JAX package's draws and the statistics of whole maps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
from quantized_spectrum_cartography_tpu_torch.data.fixtures import Problem
from quantized_spectrum_cartography_tpu_torch.physics import psd as psd_mod
from quantized_spectrum_cartography_tpu_torch.physics.shadowing import (
    correlation_cholesky,
    sample_shadowing,
)


def path_loss(dist: torch.Tensor, d0: float, alpha) -> torch.Tensor:
    """min(1, (d/d0)^-alpha)  (generate_map.m:90-91)."""
    safe = dist.clamp_min(1e-12)
    return torch.clamp(torch.pow(safe / d0, -alpha), max=1.0)


def slf_from_draws(loc: torch.Tensor, alpha: torch.Tensor,
                   shadow_db: torch.Tensor, cfg: PhysicsConfig) -> torch.Tensor:
    """Frobenius-normalized spatial loss fields [..., I, I] from emitter
    locations loc [..., 2] (x, y), path-loss exponents alpha [...] and
    shadowing shadow_db [..., I, I] (generate_map.m:104-120)."""
    I = cfg.grid_size
    pts = torch.arange(I, dtype=torch.float32, device=loc.device)
    Ym, Xm = torch.meshgrid(pts, pts, indexing="ij")   # Xm[i, j] = j
    x = loc[..., 0, None, None]
    y = loc[..., 1, None, None]
    dist = torch.sqrt((Xm - x).square() + (Ym - y).square())
    S = path_loss(dist, cfg.path_loss_d0, alpha[..., None, None])
    S = S * torch.pow(10.0, shadow_db / 10.0)
    return S / torch.linalg.vector_norm(S, dim=(-2, -1), keepdim=True)


def generate_map_batch(generator: torch.Generator, cfg: PhysicsConfig,
                       batch: int, device="cuda",
                       chol: Optional[torch.Tensor] = None):
    """A batch of maps: T [B, K, I, J], S [B, R, I, J], C [B, R, K],
    peaks [B, R, 2].  PSD rows are L2-normalized, SLFs Frobenius-normalized
    (generate_map.m:1-133).  `generator` must live on `device`."""
    if chol is None:
        chol = torch.as_tensor(
            correlation_cholesky(cfg.grid_size, cfg.decorrelation_distance),
            device=device)
    B, R, K, I = batch, cfg.num_emitters, cfg.num_bands, cfg.grid_size
    Q = cfg.num_peaks_per_psd

    def rand(*shape):
        return torch.rand(*shape, generator=generator, device=device)

    cand = psd_mod.candidate_centers(K, Q, device=device)

    def pick_centers(*shape):         # Q-1 distinct candidates, uniformly
        order = torch.argsort(rand(*shape, cand.shape[0]), dim=-1)
        return cand[order[..., : Q - 1]]

    centers = (pick_centers(B, R) if cfg.separable
               else pick_centers(B, 1).expand(B, R, Q - 1))
    amps = 0.5 + 1.5 * rand(B, R, Q + 1)
    widths = 2.0 + 2.0 * rand(B, R, Q)
    first_w = 2.0 + (3.0 if cfg.separable else 2.0) * rand(B, R)
    emitter = torch.arange(R, dtype=torch.float32, device=device)
    C = psd_mod.psd_from_draws(emitter, K, amps, widths, centers, first_w,
                               basis=cfg.psd_basis, separable=cfg.separable)
    C, _ = psd_mod.column_normalize(C, axis=-1)

    loc = (I - 1.0) * rand(B, R, 2)
    alpha = cfg.alpha_lo + cfg.alpha_spread * rand(B, R)
    shadow_db = sample_shadowing(generator, chol, I, cfg.shadow_sigma,
                                 shape=(B, R))
    S = slf_from_draws(loc, alpha, shadow_db, cfg)
    T = torch.einsum("brij,brk->bkij", S, C)
    return T, S, C, loc


def generate_map(generator: torch.Generator, cfg: PhysicsConfig,
                 chol: Optional[torch.Tensor] = None, device="cuda"):
    """One map: T [K, I, J], S [R, I, J], C [R, K], peaks [R, 2]."""
    return tuple(x[0] for x in
                 generate_map_batch(generator, cfg, 1, device, chol))


def generate_onebit_problem(
    generator: torch.Generator,
    cfg: PhysicsConfig = PhysicsConfig(),
    sample_fraction: float = 1.0,
    device="cuda",
) -> Problem:
    """Equivalent of `qmc/generate_test_data.m:45-80`: a map, its 1-bit
    threshold at mean_slf, and a per-location random mask."""
    T, S, C, peaks = generate_map(generator, cfg, device=device)
    T = T.clamp_min(0.0)
    T_1bit = torch.where(T > cfg.mean_slf, 1.0, -1.0)
    IJ = cfg.grid_size * cfg.grid_size
    num = int(round(sample_fraction * IJ))
    perm = torch.randperm(IJ, generator=generator, device=device)
    Om = torch.zeros(IJ, dtype=torch.bool, device=device)
    Om[perm[:num]] = True
    return Problem(T_true=T, S_true=S, C_true=C, T_1bit=T_1bit,
                   Om=Om.reshape(cfg.grid_size, cfg.grid_size),
                   mean_slf=cfg.mean_slf, peaks=peaks)


def sample_entry_mask(generator: torch.Generator, shape: Tuple[int, ...],
                      fraction: float, device="cuda") -> torch.Tensor:
    """Per-entry Bernoulli(f) observation mask (qmc.ipynb cell 1:
    `Om = torch.bernoulli(torch.ones((64,1,51,51))*f)`)."""
    return (torch.rand(shape, generator=generator, device=device)
            < fraction).to(torch.float32)
