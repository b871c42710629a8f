"""Multi-process launcher: N local processes joined by torch.distributed.

    python -m quantized_spectrum_cartography_tpu_torch.multihost_launch \\
        --num-processes 2 --global-batch 8 --iters 10 --reps 1 \\
        [--shard-dir DIR] [--device cuda|cpu] [--init-method URL] [--out F]

The counterpart of the JAX package's ``tools/multihost_launch.py``.  It
spawns N worker processes, one device each (the card, one per rank, or the
CPU with gloo), joined into one process group through `--init-method`
(default: a ``file://`` rendezvous in the launcher's temporary directory).
Each worker feeds only its local slice of the global batch of 51x51x64
1-bit problems (R=2), runs `multihost_recover_lowrank` and reports the
global total cost, which every process must compute identically, and a
digest of its local result rows.

Row i of the global problem comes from a CPU generator seeded with i, so
the rows do not depend on the process count or on which other rows a
process makes.  With `--shard-dir`, the production data path: a prep
process per rank writes that rank's rows as a raw float32 shard
(`runtime.write_shard`), and each worker reads ONLY its own shard through
`NativeShardLoader` — no process ever materializes the global batch.
Without it, every worker regenerates the global batch and keeps its rows.
Both paths feed the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
MODULE = "quantized_spectrum_cartography_tpu_torch.multihost_launch"
G, K, R = 51, 64, 2
MEAN, STD = 0.0045, 0.008


def solver_config(iters: int):
    from quantized_spectrum_cartography_tpu_torch.config import SolverConfig

    return SolverConfig(max_iters=iters, s_inner_iters=2, c_inner_iters=2,
                        lr_s=0.001, lr_c=0.001, projection_interval=5,
                        rank_truncation=10)


def problem_rows(lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of the global problem: 1-bit observations, float32
    [hi - lo, K, G, G], made on the CPU."""
    from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
    from quantized_spectrum_cartography_tpu_torch.ops.quantizer import (
        dither_probit)
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_map_batch)
    from quantized_spectrum_cartography_tpu_torch.physics.shadowing import (
        correlation_cholesky)

    pcfg = PhysicsConfig(grid_size=G, num_bands=K, num_emitters=R)
    chol = torch.as_tensor(correlation_cholesky(G, pcfg.decorrelation_distance))
    rows = []
    for i in range(lo, hi):
        gen = torch.Generator().manual_seed(i)
        T = generate_map_batch(gen, pcfg, 1, device="cpu",
                               chol=chol)[0].clamp_min(0.0)
        rows.append(dither_probit(T - MEAN, STD, gen))
    return torch.cat(rows).numpy()


def _shard_path(shard_dir, pid) -> str:
    return os.path.join(shard_dir, f"shard_{pid}.f32")


def prep_shard(args) -> None:
    """Data-pipeline step (its own process): write ONLY process
    `args.process_id`'s rows of the global problem as a raw float32
    shard."""
    from quantized_spectrum_cartography_tpu_torch.runtime import write_shard

    per = args.global_batch // args.num_processes
    lo = args.process_id * per
    write_shard(_shard_path(args.shard_dir, args.process_id),
                problem_rows(lo, lo + per))


def worker(args) -> None:
    """Runs inside each spawned process."""
    import torch.distributed as dist

    from quantized_spectrum_cartography_tpu_torch.config import (
        set_card_numerics)
    from quantized_spectrum_cartography_tpu_torch.parallel.multihost import (
        init_distributed, make_global_mesh, multihost_recover_lowrank,
        process_local_slice)

    dev = init_distributed(args.init_method, args.num_processes,
                           args.process_id, args.device)
    if dev.type == "cuda":
        set_card_numerics()
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // args.num_processes))
    mesh = make_global_mesh()
    scfg = solver_config(args.iters)

    B = args.global_batch
    lo, hi = process_local_slice(B, mesh)
    if args.shard_dir:
        from quantized_spectrum_cartography_tpu_torch.runtime import (
            NativeShardLoader)

        loader = NativeShardLoader(_shard_path(args.shard_dir,
                                               args.process_id),
                                   (K, G, G), batch=hi - lo, num_threads=0)
        if len(loader) != hi - lo:
            raise RuntimeError(f"shard holds {len(loader)} rows, this rank "
                               f"feeds {hi - lo}")
        T_obs_local = loader.read(0, hi - lo)
        loader.close()
    else:
        T_obs_local = problem_rows(0, B)[lo:hi]
    S0 = np.zeros((hi - lo, R, G, G), np.float32)
    C0 = np.full((hi - lo, R, K), 0.01, np.float32)

    def solve():
        return multihost_recover_lowrank(mesh, T_obs_local, S0, C0, scfg,
                                         MEAN, STD, device=dev)

    t0 = time.perf_counter()
    local, total = solve()         # the first run builds the kernels
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.reps):
        local, total = solve()
    dt = (time.perf_counter() - t0) / args.reps if args.reps else first

    digest = hashlib.sha256()
    for key in ("S", "C", "costs"):
        digest.update(np.ascontiguousarray(local[key]).tobytes())
    out = {
        "process_id": args.process_id,
        "num_processes": args.num_processes,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "world_size": dist.get_world_size(),
        "rows": [lo, hi],
        "global_cost": total,
        "local_sha256": digest.hexdigest(),
        "costs_tail": [float(c) for c in local["costs"][:, -1]],
        "first_solve_seconds": first,
        "seconds_per_solve": dt,
        "maps_per_sec": B / dt,
        "data_path": "native_shard" if args.shard_dir else "regenerate",
    }
    with open(args.worker_out, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _wait_all(procs, timeout, what):
    """Wait for every process; kill the rest and raise on a failure or on
    running past `timeout` seconds."""
    deadline = time.monotonic() + timeout
    try:
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise RuntimeError(f"{what} exit codes {rcs}")


def launch(args) -> dict:
    tmp = tempfile.mkdtemp(prefix="qsc_mh_")
    init_method = args.init_method or f"file://{tmp}/rendezvous"
    common = ["--num-processes", str(args.num_processes),
              "--global-batch", str(args.global_batch)]
    shard_dir = os.path.abspath(args.shard_dir) if args.shard_dir else None
    if args.global_batch % args.num_processes:
        raise ValueError("the global batch must divide into the processes")
    if shard_dir:
        # one prep process per shard, each making only its own rows
        os.makedirs(shard_dir, exist_ok=True)
        _wait_all([subprocess.Popen(
            [sys.executable, "-m", MODULE, "--prep-shard", *common,
             "--process-id", str(pid), "--shard-dir", shard_dir], cwd=REPO)
            for pid in range(args.num_processes)], args.timeout,
            "shard prep")
    outs = [os.path.join(tmp, f"proc{pid}.json")
            for pid in range(args.num_processes)]
    _wait_all([subprocess.Popen(
        [sys.executable, "-m", MODULE, "--worker", *common,
         "--init-method", init_method, "--process-id", str(pid),
         "--device", args.device, "--iters", str(args.iters),
         "--reps", str(args.reps), "--worker-out", wout]
        + (["--shard-dir", shard_dir] if shard_dir else []), cwd=REPO)
        for pid, wout in enumerate(outs)], args.timeout, "worker")
    results = []
    for wout in outs:
        with open(wout) as f:
            results.append(json.load(f))

    # every process must see the whole group and the same global cost
    costs = {r["global_cost"] for r in results}
    if len(costs) != 1:
        raise RuntimeError(f"cross-process cost disagreement: {costs}")
    if any(r["world_size"] != args.num_processes for r in results):
        raise RuntimeError("a worker saw another world size")

    tails = []
    for r in sorted(results, key=lambda r: r["rows"][0]):
        tails.extend(r["costs_tail"])
    summary = {
        "data_path": "native_shard" if shard_dir else "regenerate",
        "device": results[0]["device"],
        "num_processes": args.num_processes,
        "global_batch": args.global_batch,
        "iters": args.iters,
        "global_cost": results[0]["global_cost"],
        "global_costs_tail": tails,
        "maps_per_sec": min(r["maps_per_sec"] for r in results),
        "per_process": results,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--prep-shard", action="store_true")
    ap.add_argument("--shard-dir", type=str, default=None)
    ap.add_argument("--init-method", type=str, default=None,
                    help="torch.distributed rendezvous URL (default: a "
                         "file:// one in a temporary directory)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--worker-out", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if args.prep_shard:
        prep_shard(args)
    elif args.worker:
        worker(args)
    else:
        summary = launch(args)
        print(json.dumps({k: v for k, v in summary.items()
                          if k != "per_process"}, indent=1))


if __name__ == "__main__":
    main()
