"""Readings that the cells' limits and rates are set from, on the card.

    python3 -m port_bench.calibrate --workload <cell> \\
        [--program-seeds 12] [--control-seeds 3] [--seconds 3] \\
        [--fault-seeds N [--faults a,b]] [--curve N]
        [--sweep RATE,RATE,...] [--out DIR]

In one process (so set-up is paid once per seed, not per process):
- the numbers `correct` compares, from the program on `--program-seeds`
  seeds (the lower readings) and from the control, the reference in TF32 in
  the program's place, on `--control-seeds` (the upper readings), each at
  the cell's own size and load with a window of `--seconds`; a batch cell
  compares as many maps from one solve as a run does from all of its;
- `--fault-seeds N`: the same numbers with each fault of
  `port_bench/faults.py` that the cell can have planted in the program, on
  N seeds;
- `--curve N` (one-map cells): on N seeds, the gap of the per-iteration
  cost against the float64 reference at every iteration, for the program
  and the control: where the trajectory parts by rounding;
- `--sweep` (served cells): the window at each offered rate, with the
  backlog at the window's open and close, to find the knee.
Prints one JSON line per reading and writes them to `--out`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _cell(name, seed, seconds):
    from port_bench import harness
    cell = harness.load_cell(name)
    cell.seed, cell.seconds = seed, seconds
    if cell.workload["driver"] == "batch":
        cell.workload["traffic"]["positions"] = \
            cell.workload["check"]["sample_maps"]
    return cell


def reading(name, seed, seconds, control, fault=None):
    """The numbers `correct` compares in one run of the cell: the program's
    (`fault` planted in it, if given) or the control's."""
    from port_bench import faults, harness
    from port_bench.run import execute
    cell = _cell(name, seed, seconds)
    drv = harness.driver(cell)
    t0 = time.time()
    if fault:
        with faults.planted(fault, cell, drv) as solver:
            out = execute(cell, t0, solver=solver)
    else:
        out = execute(cell, t0,
                      solver=drv.control_solver if control else None)
    return {"cell": name, "seed": seed,
            "side": fault or ("control" if control else "program"),
            "numbers": out["numbers"], "correct": out["correct"],
            "per_map": out["per_map"],
            "metrics": out["metrics"], "stderr": out["stderr"],
            "seconds": time.time() - t0}


def curve(name, seed):
    """Per-iteration cost gaps of the program and of the control against
    the float64 reference, one map, all iterations."""
    from port_bench import check
    from port_bench.drivers import single
    from port_bench.reference import mlegan as ref
    from port_bench.reference.numerics import JUDGE
    cell = _cell(name, seed, 0.0)
    cfg = cell.config
    sv, ob, stages = cfg["solver"], cfg["observation"], cfg["prior"]["stages"]
    st = single.setup(cell)
    p = st.pool[0]
    iters = sv["max_iters"]
    r = ref.solve(p["Y"], p["mask"], st.weights, stages, p["Z_init"],
                  p["draws"], sv, ob, ob["boundaries"], JUDGE)["costs"]
    out = {"cell": name, "seed": seed, "iters": iters}
    for side, make in (("program", single.program_solver),
                       ("control", single.control_solver)):
        costs = make(cell, st.weights)(p, iters)["costs"]
        single.sync(cell)
        gap = check.rel_gap(costs[:, None], r[:, None], (1,)).cpu()
        out[side] = [float(g) for g in gap]
    return out


def sweep(name, seed, seconds, rate):
    from port_bench import harness
    cell = _cell(name, seed, seconds)
    cell.workload["traffic"]["rate"] = rate
    drv = harness.driver(cell)
    t0 = time.time()
    st = drv.setup(cell)
    w = drv.measure(st)
    c = w["counters"]
    return {"cell": name, "seed": seed, "rate": rate,
            "metrics": w["metrics"], "attempted": w["attempted"],
            "failed": w["failed"], "maps_completed_in_window": c["maps"],
            "completed_per_s": c["maps"] / seconds,
            "batches": c["batches"], "stderr": w["stderr"],
            "seconds": time.time() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, default=0)
    ap.add_argument("--control-seeds", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--faults", default="",
                    help="comma-separated names of port_bench/faults.py "
                         "(default: every one the cell can have)")
    ap.add_argument("--curve", type=int, default=0)
    ap.add_argument("--sweep", default="")
    ap.add_argument("--out",
                    default=str(ROOT / "build" / "port_bench" / "calibrate"))
    args = ap.parse_args(argv)
    from port_bench.run import environment
    environment()
    import torch
    if not torch.cuda.is_available():
        sys.exit("calibrate needs a CUDA card")
    from quantized_spectrum_cartography_tpu_torch.config import (
        set_card_numerics)
    set_card_numerics()
    Path(args.out).mkdir(parents=True, exist_ok=True)
    dest = Path(args.out) / f"calibrate_{args.workload}.jsonl"
    seed = args.first_seed
    jobs = []
    for _ in range(args.program_seeds):
        jobs.append(lambda s=seed: reading(args.workload, s, args.seconds,
                                           False))
        seed += 1
    for _ in range(args.control_seeds):
        jobs.append(lambda s=seed: reading(args.workload, s, args.seconds,
                                           True))
        seed += 1
    from port_bench import faults, harness
    kind = harness.load_cell(args.workload).workload["driver"]
    names = [f for f in (args.faults.split(",") if args.faults
                         else faults.NAMES) if faults.applies(f, kind)]
    for _ in range(args.fault_seeds):
        for f in names:
            jobs.append(lambda s=seed, f=f: reading(
                args.workload, s, args.seconds, False, fault=f))
        seed += 1
    for _ in range(args.curve):
        jobs.append(lambda s=seed: curve(args.workload, s))
        seed += 1
    for rate in filter(None, args.sweep.split(",")):
        jobs.append(lambda s=seed, r=float(rate): sweep(
            args.workload, s, args.seconds, r))
        seed += 1
    with open(dest, "a") as f:
        for job in jobs:
            line = json.dumps(job())
            print(line[:2000], flush=True)
            f.write(line + "\n")
            f.flush()


if __name__ == "__main__":
    main()
