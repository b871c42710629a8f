"""Power-spectral-density bank: Gaussian / sinc^2 bumps.

Port of ``quantized_spectrum_cartography_tpu/physics/psd.py``
(`qmc/generate_map.m:10-14,54-86`).  The random draws are separate from the
deterministic assembly (`psd_from_draws`), so the assembly can be checked
against the JAX package on the JAX package's own draws.
"""

from __future__ import annotations

import torch


def gaussian_bump(indK: torch.Tensor, f0, sigma) -> torch.Tensor:
    """exp(-(k - f0)^2 / (2 sigma^2))  (generate_map.m:11)."""
    return torch.exp(-(indK - f0).square() / (2.0 * (sigma * sigma)))


def sinc_bump(indK: torch.Tensor, f0, a) -> torch.Tensor:
    """sinc((k-f0)/a)^2 * [|k-f0|/a <= 1]  (generate_map.m:13)."""
    u = (indK - f0) / a
    return torch.sinc(u).square() * (u.abs() <= 1.0)


def column_normalize(C: torch.Tensor, axis: int = -1):
    """L2-normalize along `axis`, returning (normalized, norms); zero
    columns pass through (ColumnNormalization.m:1-19)."""
    n = torch.linalg.vector_norm(C, dim=axis, keepdim=True)
    safe = torch.where(n > 0, n, torch.ones_like(n))
    return torch.where(n > 0, C / safe, C), n.squeeze(axis)


def candidate_centers(K: int, num_peaks: int, *, device) -> torch.Tensor:
    """Peak-center candidates 10:2:K-2 (generate_map.m:54-86), on `device`."""
    cand = torch.arange(10, K - 1, 2, dtype=torch.float32, device=device)
    if cand.shape[0] < num_peaks - 1:
        raise ValueError(
            f"K={K} too small for {num_peaks} peaks: the reference's "
            "candidate range 10:2:K-2 (generate_map.m:54-86) needs "
            f"K >= {10 + 2 * (num_peaks - 1)}; use more bands or fewer "
            "num_peaks_per_psd")
    return cand


def psd_from_draws(
    emitter_index: torch.Tensor,
    K: int,
    amps: torch.Tensor,
    widths: torch.Tensor,
    centers: torch.Tensor,
    first_w: torch.Tensor,
    basis: str = "g",
    separable: bool = True,
) -> torch.Tensor:
    """Un-normalized PSDs [..., K] from their draws.

    emitter_index [...]; amps [..., Q+1]; widths [..., Q]; centers
    [..., Q-1]; first_w [...], for Q peaks.  separable=True anchors the
    first peak at band 5 + r and adds the fixed bump at band 20
    (generate_map.m:54-70); otherwise the first peak sits at 5 + r + 1
    (generate_map.m:72-86)."""
    indK = torch.arange(1, K + 1, dtype=torch.float32, device=amps.device)
    bump = gaussian_bump if basis == "g" else sinc_bump
    num_peaks = widths.shape[-1]
    col = lambda x: x.unsqueeze(-1)           # noqa: E731  [...] -> [..., 1]
    f0 = 5.0 + emitter_index if separable else 5.0 + emitter_index + 1.0
    c = col(amps[..., 0]) * bump(indK, col(f0), col(first_w))
    for q in range(num_peaks - 1):
        c = c + col(amps[..., q + 1]) * bump(indK, col(centers[..., q]),
                                             col(widths[..., q]))
    if separable:
        c = c + col(amps[..., num_peaks]) * bump(
            indK, 20.0, col(widths[..., num_peaks - 1]))
    return c
