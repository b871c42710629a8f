"""Spatially correlated log-normal shadow fading.

Port of ``quantized_spectrum_cartography_tpu/physics/shadowing.py``
(`qmc/Shadowing_data.m:1-26`): correlation E[z(x)z(x')] = var^2 p^{|x-x'|}
with p = exp(-1/Xc).  The Cholesky factor depends only on (grid, Xc), so it
is computed once in float64 numpy on the host and cached.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def grid_coords(grid_size: int, resolution: float = 1.0) -> np.ndarray:
    """Complex grid coordinates, column-major vectorized like MATLAB
    Xgrid(:) (generate_map.m:96-101)."""
    pts = np.arange(grid_size) * resolution
    Xm, Ym = np.meshgrid(pts, pts)
    Z = Xm + 1j * Ym
    return Z.reshape(-1, order="F")


@functools.lru_cache(maxsize=8)
def correlation_cholesky(grid_size: int, Xc: float) -> np.ndarray:
    """Lower Cholesky factor of R(d) = p^d over all grid-point pairs, in
    float64 (the exponential kernel is ill-conditioned), cast to float32.
    Reference: Shadowing_data.m:18-21."""
    z = grid_coords(grid_size)
    d = np.abs(z[:, None] - z[None, :])
    p = np.exp(-1.0 / Xc)
    L = np.linalg.cholesky(p ** d)
    return L.astype(np.float32)


def correlated_field(chol: torch.Tensor, iid: torch.Tensor,
                     grid_size: int) -> torch.Tensor:
    """unvec(L @ iid): iid [..., I*I] scaled normals -> fields [..., I, I].
    The unvec matches MATLAB's column-major reshape."""
    vec = iid @ chol.transpose(0, 1)
    return vec.reshape(*iid.shape[:-1], grid_size, grid_size).transpose(-1, -2)


def sample_shadowing(generator: torch.Generator, chol: torch.Tensor,
                     grid_size: int, sigma: float, shape=()) -> torch.Tensor:
    """Correlated shadowing fields [*shape, I, I] in dB (Shadowing_data.m:17-23)."""
    n = grid_size * grid_size
    iid = sigma * torch.randn(*shape, n, generator=generator,
                              device=chol.device)
    return correlated_field(chol, iid, grid_size)
