"""Nonnegative least squares by accelerated projected gradient.

Port of ``quantized_spectrum_cartography_tpu/baselines/nnls.py`` (the
DowJons C-step, `lsqnonneg` per frequency row in the MATLAB harness,
`backup/algorithms/joint_opt_ae.m:403-418`): min_{X>=0} ||A X - B||_F^2 by
a fixed number of Nesterov-accelerated projected-gradient steps of length
1 / lambda_max(A^T A), lambda_max from 30 power iterations.  Leading axes
are batch axes throughout: one call solves every problem of a batch.
"""

from __future__ import annotations

import numpy as np
import torch


def _momentum(iters: int):
    """The loop's (t - 1) / t_new for each step, in float32 as the JAX
    loop carries t."""
    t, out = np.float32(1.0), []
    for _ in range(iters):
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return out


def nnls(A: torch.Tensor, B: torch.Tensor, iters: int = 200) -> torch.Tensor:
    """argmin_{X >= 0} ||A @ X - B||_F^2.  A [..., M, R], B [..., M, N]
    -> X [..., R, N]."""
    At = A.transpose(-1, -2)
    return nnls_gram(At @ A, At @ B, iters)


def nnls_gram(AtA: torch.Tensor, AtB: torch.Tensor,
              iters: int = 200) -> torch.Tensor:
    """`nnls` on precomputed normal equations: argmin_{X>=0}
    (1/2) X^T AtA X - AtB^T X per column.  AtA [..., R, R] (PSD), AtB
    [..., R, N] -> X [..., R, N]."""
    v = torch.ones(AtA.shape[:-1], dtype=AtA.dtype, device=AtA.device)
    for _ in range(30):                      # power iteration: lambda_max
        v = (AtA @ v[..., None])[..., 0]
        v = v / torch.linalg.vector_norm(v, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
    L = (v[..., None, :] @ (AtA @ v[..., None]))[..., 0, 0].clamp_min(1e-12)
    step = (1.0 / L)[..., None, None]

    X = Y = torch.zeros_like(AtB)
    for beta in _momentum(iters):
        G = AtA @ Y - AtB
        X_new = (Y - step * G).clamp_min(0.0)
        Y = X_new + beta * (X_new - X)
        X = X_new
    return X


def nnls_rows(A: torch.Tensor, B_rows: torch.Tensor,
              iters: int = 200) -> torch.Tensor:
    """Per-row NNLS (the harness's lsqnonneg loop over frequencies): every
    row b_k of B_rows [..., K, M] against the shared design A [..., M, R];
    returns C [..., K, R]."""
    return nnls(A, B_rows.transpose(-1, -2), iters).transpose(-1, -2)
