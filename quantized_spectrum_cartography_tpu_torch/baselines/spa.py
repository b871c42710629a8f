"""Successive Projection Algorithm (SPA) NMF initialization.

Port of ``quantized_spectrum_cartography_tpu/baselines/spa.py``
(`backup/algorithms/NMF_SPA.m:1-75`): greedy selection of R near-pure
columns (largest squared norm, then orthogonal deflation), then the other
factor by pseudo-inverse regression, a positivity clamp and column
renormalization.  Leading axes are batch axes; each problem's argmax takes
the first of equal norms, as `jnp.argmax` does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def column_sum_normalize(X: torch.Tensor):
    """Divide each column of X [..., M, N] by its sum (MATLAB
    ColumnSumNormalization); returns (X / sums, sums [..., N])."""
    s = X.sum(dim=-2, keepdim=True)
    safe = torch.where(s.abs() > 0, s, torch.ones_like(s))
    return X / safe, s.squeeze(-2)


def _columns(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """X[..., :, idx] per problem: X [..., M, N], idx [..., P] -> [..., M, P]."""
    return torch.gather(X, -1, idx[..., None, :].expand(
        *X.shape[:-1], idx.shape[-1]))


def spa_indices(X: torch.Tensor, r: int) -> torch.Tensor:
    """Indices [..., r] of r successively projected extreme columns of
    X [..., M, N] (NMF_SPA.m:30-55 `SPA`)."""
    ks = []
    for _ in range(r):
        k = torch.argmax(X.square().sum(dim=-2), dim=-1)        # [...]
        col = _columns(X, k[..., None])[..., 0]                  # [..., M]
        u = col / torch.linalg.vector_norm(
            col, dim=-1, keepdim=True).clamp_min(1e-12)
        X = X - u[..., :, None] * (u[..., None, :] @ X)
        ks.append(k)
    return torch.stack(ks, dim=-1)


def nmf_spa(T_km: torch.Tensor, R: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMF via SPA on the mode-unfolded map T_km [..., K, IJ] = C^T S.

    SPA runs over the per-frequency spatial columns and picks R near-pure
    frequency bands; their columns are the SLF estimates, and C comes from
    the pseudo-inverse regression (NMF_SPA.m:17-21), clamped at 0 and
    L2-normalized by column with the norms pushed into S (:23-27).
    Returns (C [..., R, K], S [..., R, IJ]).
    """
    Tm = T_km.transpose(-1, -2)                                 # [..., IJ, K]
    Tn, normalizer = column_sum_normalize(Tm)
    idx = spa_indices(Tn, R)
    Sm = _columns(Tn, idx) * torch.gather(normalizer, -1, idx)[..., None, :]
    Smt = Sm.transpose(-1, -2)
    eye = torch.eye(R, dtype=Sm.dtype, device=Sm.device)
    C = torch.linalg.solve(Smt @ Sm + 1e-10 * eye,
                           Smt @ Tm).transpose(-1, -2)         # [..., K, R]
    C = C.clamp_min(0.0)
    d = torch.linalg.vector_norm(C, dim=-2)                     # [..., R]
    C = C / d.clamp_min(1e-12)[..., None, :]
    Sm = Sm * d[..., None, :]
    return C.transpose(-1, -2), Sm.transpose(-1, -2)
