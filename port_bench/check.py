"""The numbers that decide `correct`, each a worst case over the answers
checked: the gap between what the timed path produced and the reference,
relative to the reference.  All in float64."""

from __future__ import annotations

import torch


def rel_gap(x: torch.Tensor, ref: torch.Tensor, dims) -> torch.Tensor:
    """||x - ref|| / ||ref|| over `dims`, one value per leading index."""
    x, ref = x.double(), ref.double().to(x.device)
    return (torch.linalg.vector_norm(x - ref, dim=dims)
            / torch.linalg.vector_norm(ref, dim=dims))


def worst(values) -> float:
    """The largest of the values; NaN anywhere reads infinite."""
    parts = [torch.as_tensor(x, dtype=torch.float64).detach().cpu()
             .flatten() for x in values]
    v = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float64)
    if v.numel() == 0:
        return float("inf")
    v = torch.where(torch.isnan(v), torch.full_like(v, float("inf")), v)
    return float(v.max())


def sample(seed: int, n_items: int, k: int, salt: int) -> list:
    """k of range(n_items) drawn from the seed (all when k >= n_items),
    in increasing order."""
    g = torch.Generator().manual_seed((int(seed) * 1000003 + salt)
                                      % (2 ** 63))
    if k >= n_items:
        return list(range(n_items))
    return sorted(torch.randperm(n_items, generator=g)[:k].tolist())


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between order statistics) of the
    values; NaN anywhere reads infinite."""
    parts = [torch.as_tensor(x, dtype=torch.float64).detach().cpu()
             .flatten() for x in values]
    if not parts:
        return float("inf")
    v = torch.cat(parts)
    v = torch.where(torch.isnan(v), torch.full_like(v, float("inf")), v)
    return float(torch.quantile(v, q / 100.0))
