"""Rank-R outer-product reconstruction and factor projections.

Port of ``quantized_spectrum_cartography_tpu/ops/lowrank.py``.  Leading
axes are batch axes throughout.
"""

from __future__ import annotations

from typing import Optional

import torch

from quantized_spectrum_cartography_tpu_torch.ops.kernels.householder_qr import (
    householder_qr,
)

_PROBE_SEED = 7


def outer(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """vec[..., k] * mat[..., i, j] -> [..., K, I, J]."""
    return torch.einsum("...ij,...k->...kij", mat, vec)


def get_tensor(S: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """T[..., k, i, j] = sum_r S[..., r, i, j] * C[..., r, k]."""
    return torch.einsum("...rij,...rk->...kij", S, C)


def get_tensor_flat(S_flat: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Flattened-spatial reconstruction: [..., R, IJ] x [..., R, K] -> [..., K, IJ]."""
    return torch.einsum("...rp,...rk->...kp", S_flat, C)


def safe_fro(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Frobenius norm over `dim` (all axes if None) with a well-defined
    (zero) gradient at the origin.

    Solvers start factors at zero; the exact norm's gradient x/||x|| is 0/0
    there and poisons the whole first Adam update with NaNs."""
    sq = x.square()
    total = sq.sum() if dim is None else sq.sum(dim=dim)
    return torch.sqrt(total + 1e-24)


def project_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Nonnegative-orthant projection (reference `C[C<0] = 0`)."""
    return x.clamp_min(0.0)


def project_rank(S: torch.Tensor, rank: int) -> torch.Tensor:
    """SVD rank truncation of each SLF matrix, batched over leading axes."""
    u, s, vh = torch.linalg.svd(S, full_matrices=False)
    s = s * (torch.arange(s.shape[-1], device=S.device) < rank)
    return (u * s.unsqueeze(-2)) @ vh


def default_probe(n: int, k: int, dtype=torch.float32, *,
                  device) -> torch.Tensor:
    """The fixed [n, k] Gaussian probe of `project_rank_subspace`, on
    `device`: drawn on the CPU from a generator seeded with 7, so it is the
    same on every device.
    (The JAX package draws it from PRNGKey(7), which torch cannot reproduce.)"""
    gen = torch.Generator().manual_seed(_PROBE_SEED)
    return torch.randn(n, k, generator=gen, dtype=dtype).to(device)


def project_rank_subspace(
    S: torch.Tensor,
    rank: int,
    oversample: int = 8,
    power_iters: int = 1,
    probe: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rank truncation via randomized subspace iteration (no SVD).

    Q spans the top-(rank+oversample) left singular subspace after
    `power_iters` rounds of (S Sᵀ)-multiplication with Householder-QR
    re-orthonormalization (`householder_qr`: the kernel on CUDA, one launch
    for the whole batch); the top-`rank` directions inside it come from a
    (rank+oversample)² eigendecomposition.  `probe` [n, rank+oversample]
    defaults to `default_probe`.  Eigenvector signs do not matter: the
    result U Uᵀ S is invariant to them."""
    m, n = S.shape[-2], S.shape[-1]
    k = min(rank + oversample, min(m, n))
    if rank >= min(m, n):
        return S
    St = S.transpose(-1, -2)
    G0 = (default_probe(n, k, S.dtype, device=S.device) if probe is None
          else probe.to(device=S.device, dtype=S.dtype))
    Y = S @ G0
    for _ in range(power_iters):
        Q = householder_qr(Y)
        Y = S @ (St @ Q)
    Q = householder_qr(Y)                          # [..., m, k]
    B = Q.transpose(-1, -2) @ S                    # [..., k, n]
    _, evecs = torch.linalg.eigh(B @ B.transpose(-1, -2))   # ascending
    U = Q @ evecs[..., -rank:]                     # [..., m, rank]
    return U @ (U.transpose(-1, -2) @ S)


def init_factors(R: int, I: int, J: int, K: int, dtype=torch.float32,
                 device=None):
    """Zero-start factors S [R, I, J], C [R, K] (qmc.ipynb's 'zero start')."""
    return (torch.zeros((R, I, J), dtype=dtype, device=device),
            torch.zeros((R, K), dtype=dtype, device=device))
