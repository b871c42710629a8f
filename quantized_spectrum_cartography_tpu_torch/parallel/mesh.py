"""The ('data', 'model') process layout and its sharding vocabulary.

Port of ``quantized_spectrum_cartography_tpu/parallel/mesh.py`` onto
``torch.distributed``: one process per device, ranks laid out row-major on
a (data, model) grid (rank = d * model + m).  Logical axes:

- 'data'  — the batch-of-maps axis: independent recoveries, no
            communication (the dominant scaling axis);
- 'model' — the frequency (K) axis of T/Y/C for single large problems:
            the likelihood is entrywise in K, so only the S-factor gradient
            (an all-reduce over 'model') crosses ranks.

Where JAX's `NamedSharding`s tell XLA how a global array is laid out,
`batch_sharding`, `batch_freq_sharding` and `replicated` here cut a global
tensor down to the part this rank holds.  With no process group (one
process) the mesh is (1, 1) and every collective is the identity; once a
group is initialized, each axis line gets its own group, even one of a
single rank, so the collectives run through the backend.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (data, model) grid and the process group of
    each axis line through it (None without a process group)."""

    shape: Tuple[int, int]
    axis_names: Tuple[str, str]
    rank: int
    groups: Dict[str, Optional[dist.ProcessGroup]]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        coords = divmod(self.rank, self.shape[1])
        return coords[self.axis_names.index(axis)]


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
) -> Mesh:
    """2-D layout of every rank of the process group (one rank without
    one); default all-data (shape (n, 1)), since map-batch parallelism
    needs no communication.  Every rank must call it, in the same order as
    its other group creations (`dist.new_group` is collective)."""
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if shape is None:
        shape = (n, 1)
    shape = tuple(shape)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    groups: Dict[str, Optional[dist.ProcessGroup]] = dict.fromkeys(axis_names)
    if initialized:
        D, M = shape
        for d in range(D):                  # 'model' lines: one per d
            g = dist.new_group([d * M + m for m in range(M)])
            if rank // M == d:
                groups[axis_names[1]] = g
        for m in range(M):                  # 'data' lines: one per m
            g = dist.new_group([d * M + m for d in range(D)])
            if rank % M == m:
                groups[axis_names[0]] = g
    return Mesh(shape, tuple(axis_names), rank, groups)


def _shard(x: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    if x.shape[dim] % parts != 0:
        raise ValueError(f"axis {dim} of size {x.shape[dim]} does not "
                         f"divide into {parts} shards")
    return x.chunk(parts, dim=dim)[index]


def batch_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the leading batch-of-maps axis (sharded over
    'data', replicated over 'model')."""
    return _shard(x, 0, mesh.size("data"), mesh.index("data"))


def batch_freq_sharding(mesh: Mesh, x: torch.Tensor,
                        freq_axis: int = 1) -> torch.Tensor:
    """This rank's rows over 'data' and frequency slice over 'model'."""
    x = batch_sharding(mesh, x)
    return _shard(x, freq_axis, mesh.size("model"), mesh.index("model"))


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank holds the whole tensor."""
    return x


def all_reduce_sum(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Sum of `x` over the ranks of `axis` (in place; x itself without a
    process group)."""
    group = mesh.groups[axis]
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather_cat(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """The ranks' equally shaped `x` along `axis`, concatenated in rank
    order on the first dimension."""
    group = mesh.groups[axis]
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
