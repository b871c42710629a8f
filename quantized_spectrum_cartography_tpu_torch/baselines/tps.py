"""Thin-plate-spline map completion baseline.

Port of ``quantized_spectrum_cartography_tpu/baselines/tps.py`` (the
harness's `full_tps`, `backup/algorithms/joint_opt_ae.m:183`): for each
band fit f(p) = a0 + a^T p + sum_i w_i phi(||p - p_i||), phi(r) = r^2 log r,
to the observed entries and evaluate it on the whole grid.  All K bands of
a map share the sample locations, so one (N+3)^2 solve serves them all;
leading axes are batch axes, one solve per map.

The system is ill-conditioned (phi reaches about 1e4 at the grid's
diameter) and the spline's sum cancels large terms of both signs: in
float32, as the JAX package computes it, LU's pivoting on cuSOLVER and on
LAPACK rounds differently and the card's completion differs from the CPU's
in the fourth digit.  The port solves and evaluates in float64 and
returns float32.
"""

from __future__ import annotations

import torch


def _phi(r2: torch.Tensor) -> torch.Tensor:
    """r^2 log r = 0.5 * r^2 log r^2, with phi(0) = 0."""
    return 0.5 * r2 * torch.log(r2.clamp_min(1e-20))


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances of points a [..., M, 2], b [..., N, 2]."""
    return (a[..., :, None, :] - b[..., None, :, :]).square().sum(-1)


def tps_complete(
    T_obs: torch.Tensor,
    Om: torch.Tensor,
    sample_idx: torch.Tensor,
    reg: float = 1e-6,
) -> torch.Tensor:
    """Complete T [..., K, I, J] from per-location samples.

    sample_idx [..., N, 2] integer (row, col) observed locations, N the
    same for every map of a batch; Om is kept for interface parity."""
    K, I, J = T_obs.shape[-3:]
    batch = T_obs.shape[:-3]
    dev, f64 = T_obs.device, torch.float64
    sample_idx = sample_idx.long()
    pts = sample_idx.to(f64)                                  # [..., N, 2]
    N = pts.shape[-2]
    flat = (sample_idx[..., 0] * J + sample_idx[..., 1])       # [..., N]
    vals = torch.gather(T_obs.reshape(*batch, K, I * J), -1,
                        flat[..., None, :].expand(*batch, K, N))   # [..., K, N]

    def zeros(*shape):
        return torch.zeros(*batch, *shape, dtype=f64, device=dev)

    Phi = _phi(_sq_dist(pts, pts)) + reg * torch.eye(N, dtype=f64, device=dev)
    P = torch.cat([zeros(N, 1) + 1.0, pts], -1)               # [..., N, 3]
    A = torch.cat([torch.cat([Phi, P], -1),
                   torch.cat([P.transpose(-1, -2), zeros(3, 3)], -1)], -2)
    rhs = torch.cat([vals.to(f64), zeros(K, 3)], -1).transpose(-1, -2)
    sol = torch.linalg.solve(A, rhs)                           # [..., N+3, K]
    w, a = sol[..., :N, :], sol[..., N:, :]

    ii, jj = torch.meshgrid(torch.arange(I, dtype=f64, device=dev),
                            torch.arange(J, dtype=f64, device=dev),
                            indexing="ij")
    grid = torch.stack([ii.reshape(-1), jj.reshape(-1)], 1)    # [IJ, 2]
    Pg = torch.cat([torch.ones(I * J, 1, dtype=f64, device=dev), grid], 1)
    full = _phi(_sq_dist(grid, pts)) @ w + Pg @ a              # [..., IJ, K]
    return full.transpose(-1, -2).reshape(*batch, K, I, J).to(T_obs.dtype)
