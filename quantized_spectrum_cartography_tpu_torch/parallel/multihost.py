"""Multi-process distribution layer.

Port of ``quantized_spectrum_cartography_tpu/parallel/multihost.py`` onto
``torch.distributed``: N processes, one device each, cooperating through
one ('data', 'model') layout.  The reference
(shresthasagar/quantized_spectrum_cartography) is single-process
throughout (SURVEY.md section 5.8).

- `init_distributed`   — `torch.distributed.init_process_group` with gloo
  on the CPU and nccl on the card; the caller gives the rendezvous
  (`file://...` or `tcp://host:port`), the world size and the rank.
- `make_global_mesh`   — one layout over every rank.  Map-batch recoveries
  shard over 'data' with no communication.
- `local_batch_to_global` — per-process feeding: each rank holds only its
  own slice of the global batch (no process ever materializes the global
  batch); the result records where the slice sits.
- `multihost_recover_lowrank` — the production entry: local observations
  in, local result slices and the global total cost out.

`tools/multihost_launch.py`'s counterpart is the port's
`multihost_launch.py`.  JAX's `configure_cpu_substitute` (XLA's fake CPU
devices) has no meaning here: gloo joins CPU processes as they are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
from quantized_spectrum_cartography_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    make_mesh,
)
from quantized_spectrum_cartography_tpu_torch.solvers.lowrank_mle import (
    recover_lowrank_mle,
)


def init_distributed(init_method: str, world_size: int, rank: int,
                     device: str = "cuda") -> torch.device:
    """Join the process group: nccl for a CUDA `device`, gloo for the CPU.
    On the card each rank takes device `rank % device_count` (one process
    per device).  Returns this rank's device."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for an nccl process group")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev


def make_global_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
) -> Mesh:
    """2-D layout over every rank of the process group; default all-'data'
    (shape (n, 1)): batched recoveries are independent, so the data axis
    may span hosts freely.  On the card a 'model' dimension must divide the
    host's device count, so that its all-reduces stay on NVLink."""
    mesh = make_mesh(shape, axis_names)
    if (mesh.size(axis_names[1]) > 1 and dist.is_initialized()
            and dist.get_backend() == "nccl"
            and torch.cuda.device_count() % mesh.size(axis_names[1]) != 0):
        raise ValueError(
            f"'model' dim {mesh.size(axis_names[1])} must divide the host's "
            f"device count {torch.cuda.device_count()} so the all-reduce "
            f"stays on NVLink")
    return mesh


def process_local_slice(global_batch: int, mesh: Mesh) -> Tuple[int, int]:
    """[start, stop) of the global batch this rank feeds, given the batch
    sharded over 'data' in rank order."""
    n = mesh.size("data")
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} must divide into {n} data shards")
    per = global_batch // n
    i = mesh.index("data")
    return i * per, (i + 1) * per


class GlobalBatch(NamedTuple):
    """A logically global batch, sharded over 'data': this rank's rows, the
    global row index of the first, and the global shape."""

    local: torch.Tensor
    start: int
    global_shape: Tuple[int, ...]


def local_batch_to_global(mesh: Mesh, local, batch_axis: int = 0,
                          device="cuda") -> GlobalBatch:
    """Place this rank's slice, on `device` (the card unless the caller asks
    for the CPU), in the global batch: the ranks of 'data' exchange their
    row counts and every other dimension must agree
    (`jax.make_array_from_process_local_data`'s check); no rows move."""
    local = torch.as_tensor(local, device=device)
    dims = torch.tensor(local.shape, dtype=torch.int64)
    group = mesh.groups["data"]
    if group is not None and dist.get_backend(group) == "nccl":
        dims = dims.to(local.device)
    every = all_gather_cat(mesh, "data", dims[None]).cpu()
    others = torch.cat([every[:, :batch_axis], every[:, batch_axis + 1:]], 1)
    if not bool((others == others[0]).all()):
        raise ValueError(f"ranks feed slices of different shapes: "
                         f"{every.tolist()}")
    rows = every[:, batch_axis]
    start = int(rows[: mesh.index("data")].sum())
    shape = list(local.shape)
    shape[batch_axis] = int(rows.sum())
    return GlobalBatch(local, start, tuple(shape))


def gather_local(arr) -> np.ndarray:
    """This rank's rows of a batch-sharded global array, on the host."""
    local = arr.local if isinstance(arr, GlobalBatch) else arr
    return local.detach().cpu().numpy()


def multihost_recover_lowrank(
    mesh: Mesh,
    T_obs_local,      # [B_local, K, I, J] this rank's maps
    S_init_local,     # [B_local, R, I, J]
    C_init_local,     # [B_local, R, K]
    cfg: SolverConfig,
    mean: float,
    std: float,
    device="cuda",
    **solver_kw,
):
    """Batched 1-bit low-rank MLE over every rank, the batch sharded over
    'data' (no communication while solving).

    Each rank feeds and solves only its local slice, on `device`: the card
    (the rank's own, which `init_distributed` made current) unless the
    caller asks for the CPU.  Returns (this rank's results as numpy {"S", "C",
    "costs"}, the global total of the per-map final costs).  The total is
    the same on every rank, and does not depend on the process count: the
    final costs are gathered over 'data' and summed in global row order."""
    T_obs = local_batch_to_global(mesh, T_obs_local, device=device)
    dev = T_obs.local.device
    S0 = local_batch_to_global(mesh, S_init_local, device=dev)
    C0 = local_batch_to_global(mesh, C_init_local, device=dev)
    res = recover_lowrank_mle(T_obs.local, S0.local, C0.local, cfg, mean, std,
                              **solver_kw)
    final = all_gather_cat(mesh, "data", res.costs[:, -1].contiguous())
    total = float(final.sum())
    return ({"S": gather_local(res.S), "C": gather_local(res.C),
             "costs": gather_local(res.costs)}, total)
