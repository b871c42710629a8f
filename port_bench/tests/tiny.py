"""Tiny versions of the cells for the CPU tests: the cells' own files with
the sizes cut (9x9 grid and 16 bands for the low-rank cells, 12 iterations
and 8 + 8 search candidates for MLE-GAN, whose generator fixes 51x51)."""

from __future__ import annotations

import time

from port_bench import harness
from port_bench.run import execute


def tiny_cell(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.6):
    cell = harness.load_cell(name)
    c, w = cell.config, cell.workload
    sv, tr = c["solver"], w["traffic"]
    if w["driver"] == "single":
        c["physics"]["num_bands"] = 16
        sv.update(max_iters=12, z_search_global=8, z_search_local=8)
        tr["pool_maps"] = 2
        w["check"].update(early_iters=4, max_maps=3)
    else:
        c["physics"].update(grid_size=9, num_bands=16)
        sv.update(max_iters=4, s_inner_iters=2, c_inner_iters=2,
                  projection_interval=2, rank_truncation=3, oversample=2)
        tr["batch"] = 4
    if w["driver"] == "batch":
        tr["pool_batches"] = 2
        w["check"]["sample_maps"] = 6
    if w["driver"] == "serve":
        tr.update(pool_maps=16, rate=40.0, warm_s=0.2, tail_s=10.0)
        w["check"]["sample_requests"] = 6
        w["trace"]["seconds"] = 0.2
    cell.device, cell.seed, cell.seconds = "cpu", seed, seconds
    return cell


def run_tiny(cell, solver=None) -> dict:
    return execute(cell, time.time(), solver=solver)
