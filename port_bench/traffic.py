"""The benchmark's inputs, made from the seed: frozen copies of the port's
input makers, so that a later change to the program's simulator or
quantizers does not move the yardstick.

Copied from ``quantized_spectrum_cartography_tpu_torch``:
- ``physics/simulator.py:24-72`` (`path_loss`, `slf_from_draws`,
  `generate_map_batch`) and ``:109-115`` (`sample_entry_mask`);
- ``physics/psd.py:14-74`` (`gaussian_bump`, `column_normalize`,
  `candidate_centers`, `psd_from_draws`: the separable Gaussian case the
  configurations use);
- ``physics/shadowing.py:17-52`` (`grid_coords`, `correlation_cholesky`,
  `sample_shadowing`); the Cholesky factor is taken
  here in float64 with torch on the generator's device instead of numpy on
  the host (the same matrix, a second instead of 1.5 s of set-up);
- ``ops/quantizer.py:17-99`` (`quantize_log`, `F_probit`, `dither_probit`,
  `pack_bits_host`; the reference's hardcoded sqrt 2, 1.414213);
- ``serving_bench.py:213-216``: exponential gaps of a Poisson stream, here
  drawn once from a fixed generator and put in the seed's order, so every
  seed offers the same arrivals (see `poisson_gaps`).

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_SQRT2_REF = 1.414213


# -- physics/psd.py ---------------------------------------------------------

def gaussian_bump(indK, f0, sigma):
    return torch.exp(-(indK - f0).square() / (2.0 * (sigma * sigma)))


def column_normalize(C, axis=-1):
    n = torch.linalg.vector_norm(C, dim=axis, keepdim=True)
    safe = torch.where(n > 0, n, torch.ones_like(n))
    return torch.where(n > 0, C / safe, C)


def candidate_centers(K: int, num_peaks: int, device):
    cand = torch.arange(10, K - 1, 2, dtype=torch.float32, device=device)
    if cand.shape[0] < num_peaks - 1:
        raise ValueError(f"K={K} too small for {num_peaks} peaks")
    return cand


def psd_from_draws(emitter_index, K, amps, widths, centers, first_w):
    """Gaussian bumps, the separable case: the first peak at band 5 + r,
    the fixed bump at band 20."""
    indK = torch.arange(1, K + 1, dtype=torch.float32, device=amps.device)
    num_peaks = widths.shape[-1]

    def col(x):
        return x.unsqueeze(-1)

    c = col(amps[..., 0]) * gaussian_bump(indK, col(5.0 + emitter_index),
                                          col(first_w))
    for q in range(num_peaks - 1):
        c = c + col(amps[..., q + 1]) * gaussian_bump(
            indK, col(centers[..., q]), col(widths[..., q]))
    return c + col(amps[..., num_peaks]) * gaussian_bump(
        indK, 20.0, col(widths[..., num_peaks - 1]))


# -- physics/shadowing.py ---------------------------------------------------

def grid_coords(grid_size: int) -> np.ndarray:
    pts = np.arange(grid_size, dtype=np.float64)
    Xm, Ym = np.meshgrid(pts, pts)
    return (Xm + 1j * Ym).reshape(-1, order="F")


def correlation_cholesky(grid_size: int, Xc: float, device) -> torch.Tensor:
    """Lower Cholesky factor of p^|x - x'| over the grid, p = exp(-1/Xc),
    taken in float64 and cast to float32."""
    z = grid_coords(grid_size)
    d = torch.as_tensor(np.abs(z[:, None] - z[None, :]), device=device)
    L = torch.linalg.cholesky(torch.exp(-d / Xc))
    return L.to(torch.float32)


def sample_shadowing(gen, chol, grid_size, sigma, shape):
    n = grid_size * grid_size
    iid = sigma * torch.randn(*shape, n, generator=gen, device=chol.device)
    vec = iid @ chol.transpose(0, 1)
    return vec.reshape(*shape, grid_size, grid_size).transpose(-1, -2)


# -- physics/simulator.py ---------------------------------------------------

def slf_from_draws(loc, alpha, shadow_db, phys):
    I = phys["grid_size"]
    pts = torch.arange(I, dtype=torch.float32, device=loc.device)
    Ym, Xm = torch.meshgrid(pts, pts, indexing="ij")
    x = loc[..., 0, None, None]
    y = loc[..., 1, None, None]
    dist = torch.sqrt((Xm - x).square() + (Ym - y).square()).clamp_min(1e-12)
    S = torch.clamp(torch.pow(dist / phys["path_loss_d0"],
                              -alpha[..., None, None]), max=1.0)
    S = S * torch.pow(10.0, shadow_db / 10.0)
    return S / torch.linalg.vector_norm(S, dim=(-2, -1), keepdim=True)


def generate_map_batch(gen, phys: dict, batch: int, chol: torch.Tensor):
    """T [B, K, I, J], S [B, R, I, J], C [B, R, K] on the generator's
    device; `phys` holds the simulator's settings (the configuration's
    "physics" group)."""
    if phys["psd_basis"] != "g" or not phys["separable"]:
        raise ValueError("the frozen simulator holds the separable "
                         "Gaussian-bump PSDs only")
    dev = chol.device
    B, R, K = batch, phys["num_emitters"], phys["num_bands"]
    I, Q = phys["grid_size"], phys["num_peaks_per_psd"]

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    cand = candidate_centers(K, Q, dev)
    order = torch.argsort(rand(B, R, cand.shape[0]), dim=-1)
    centers = cand[order[..., : Q - 1]]
    amps = 0.5 + 1.5 * rand(B, R, Q + 1)
    widths = 2.0 + 2.0 * rand(B, R, Q)
    first_w = 2.0 + 3.0 * rand(B, R)
    emitter = torch.arange(R, dtype=torch.float32, device=dev)
    C = column_normalize(psd_from_draws(emitter, K, amps, widths, centers,
                                        first_w))
    loc = (I - 1.0) * rand(B, R, 2)
    alpha = phys["alpha_lo"] + phys["alpha_spread"] * rand(B, R)
    shadow_db = sample_shadowing(gen, chol, I, phys["shadow_sigma"], (B, R))
    S = slf_from_draws(loc, alpha, shadow_db, phys)
    return torch.einsum("brij,brk->bkij", S, C), S, C


def sample_entry_mask(gen, shape, fraction: float) -> torch.Tensor:
    """Per-entry Bernoulli(fraction) observation mask, float32."""
    return (torch.rand(shape, generator=gen, device=gen.device)
            < fraction).to(torch.float32)


# -- ops/quantizer.py -------------------------------------------------------

def quantize_log(X, noise_std, boundaries: Sequence[float], offset, gen):
    """Y = #{internal boundaries below log(X + offset) + noise_std N(0,1)}."""
    bb = torch.as_tensor(boundaries, dtype=X.dtype, device=X.device)
    noise = torch.randn(X.shape, generator=gen, dtype=X.dtype,
                        device=X.device)
    noisy = torch.log(X + offset) + noise * noise_std
    return torch.searchsorted(bb[1:-1].contiguous(), noisy,
                              side="left").to(torch.int32)


def dither_probit(y, std, gen):
    """z ~ Bernoulli(Phi(y / std)) with the reference's probit scale."""
    p = 0.5 * (1.0 + torch.erf(y / (std * _SQRT2_REF)))
    return torch.bernoulli(p, generator=gen).to(y.dtype)


def pack_bits_host(y01) -> np.ndarray:
    """{0,1} -> uint8 [..., ceil(last / 8)], most significant bit first."""
    return np.packbits(np.asarray(y01).astype(np.uint8), axis=-1)


# -- arrivals ---------------------------------------------------------------

_GAPS_SEED = 20260101


def poisson_gaps(rate: float, n: int, seed: int) -> np.ndarray:
    """n gaps (s) of a Poisson stream at `rate` per second.  The multiset of
    gaps is the same for every seed (drawn once from a fixed generator and
    rescaled so that they sum to n / rate exactly); the seed orders them.
    So every seed offers the same load, and two seeds differ in when the
    bursts come, not in how much work they bring."""
    gaps = np.random.default_rng(_GAPS_SEED).exponential(1.0, size=n)
    gaps *= n / rate / gaps.sum()
    return gaps[np.random.default_rng(seed).permutation(n)]
