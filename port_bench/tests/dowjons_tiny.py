"""The DowJons cell at a tiny size for its own CPU tests: 4 examples a call,
2 restarts, 2 outer iterations of 3 z-steps, 10 NNLS iterations and a
12-step init fit, the decoder at its published widths (it fixes 51x51).  A
few steps leave rounding no room to grow, so the late iterations and the
init fit's late steps are held to the early limits.  (`tiny.py` cuts the
cell too, for the tests that run every cell, by the names its loops share
with the low-rank configuration.)"""

from __future__ import annotations

import time

from port_bench import harness
from port_bench.run import execute

CELL = "dowjons-vae-z256.eval64"


def tiny_cell(name: str = CELL, seed: int = 2 ** 31 + 11,
              seconds: float = 0.2):
    cell = harness.load_cell(name)
    cell.config["solver"].update(max_iters=2, restarts=2, s_inner_iters=3,
                                 c_inner_iters=10, init_steps=12)
    cell.workload["traffic"].update(batch=4, pool_batches=2)
    chk = cell.workload["check"]
    chk.update(sample_examples=3, init_steps=4, early_iters=1)
    chk["limits"]["late_cost_gap"] = chk["limits"]["early_cost_gap"]
    chk["part_at"]["init_late"] = chk["part_at"]["init"]
    cell.device, cell.seed, cell.seconds = "cpu", seed, seconds
    return cell


def run_tiny(cell, solver=None) -> dict:
    return execute(cell, time.time(), solver=solver)
