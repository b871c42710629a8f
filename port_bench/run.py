"""Run one cell of the port's benchmark on the card.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Makes the cell's inputs from the seed on the device, warms the shapes the
cell uses (set-up, reported as `setup_s`), measures for `--seconds`, then
checks the answers of the window against the plain reference (after the
peak memory is read and the program's state is freed).  The last line of
standard output is the result; the numbers compared and their limits are
the last lines of standard error and the result's last key.  With
`--trace 1` the metrics are the cell's per-layer ones, read from a
torch.profiler trace of a stretch of the window.

Exits non-zero without printing a result when there is no CUDA card (or
fewer than the cell asks for), or when JAX, flax or the JAX package was
loaded.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernel library into build/torch_kernels/ beside
    its package, a fixed path of its own).  Nothing else is set: the
    program runs with its own defaults, threads included."""
    base = ROOT / "build" / "port_bench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell, t0: float, solver=None) -> dict:
    """Set up, measure and check `cell` on `cell.device`; returns the parts
    of the result.  `solver` replaces the program's solve (the control and
    the fault tests use it)."""
    import torch

    from port_bench import harness

    drv = harness.driver(cell)
    cuda = torch.device(cell.device).type == "cuda"
    if cuda:
        from quantized_spectrum_cartography_tpu_torch.config import (
            set_card_numerics)
        set_card_numerics()
        torch.cuda.reset_peak_memory_stats()
    t_setup = time.time()
    state = drv.setup(cell, solver)
    setup_s = time.time() - t0
    phases = (f"set-up {setup_s:.3f} s: {t_setup - t0:.3f} s to the "
              f"driver (interpreter, torch, CUDA, the port's modules), "
              f"{time.time() - t_setup:.3f} s in it (inputs, weights, warm "
              "solve)")
    window = drv.measure(state)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    drv.release(state, window)
    numbers = drv.check_numbers(state, window)
    limits = cell.workload["check"]["limits"]
    correct = harness.judge(numbers, limits) and window["failed"] == 0
    metrics, breakdown, device = {}, None, {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if cell.trace:
        tr = window["trace"]
        ctx = Context(cell, window)
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        if tr is not None:
            breakdown = tr.breakdown()
            device.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    return {"correct": correct, "attempted": window["attempted"],
            "failed": window["failed"], "metrics": metrics, "peak": peak,
            "device": device, "breakdown": breakdown, "numbers": numbers,
            "limits": limits, "stderr": [phases] + window.get("stderr", []),
            "per_map": getattr(state, "per_map", None)}


class Context:
    """What a per-layer metric's reader gets: the trace of the stretch, the
    units (solves or maps) it holds, their work counted from shapes, the
    scheduler's counters over the window, and the cell."""

    def __init__(self, cell, window):
        self.cell = cell
        self.trace = window["trace"]
        self.units = window["units"]
        self.work = window.get("work")
        self.counters = window.get("counters")


def main(argv=None) -> int:
    from port_bench import harness

    t0 = harness.process_start_time() or _T_IMPORT
    args = parse(argv)
    environment()
    cell = harness.load_cell(args.workload)
    import torch
    need = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"port_bench: the cell needs {need} CUDA card(s), {found} "
              "found", file=sys.stderr)
        return 2
    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, \
        bool(args.trace)
    out = execute(cell, t0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"port_bench: loaded {bad}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": need, "memory_peak_bytes": int(out["peak"]),
              **out["device"], "power_limit_w": harness.power_limit()}
    for line in out["stderr"]:
        print(line, file=sys.stderr)
    for k, limit in out["limits"].items():
        print(f"check {k} {out['numbers'].get(k)} limit {limit}",
              file=sys.stderr)
    print(harness.result_line(out["correct"], out["attempted"],
                              out["failed"], out["metrics"], device,
                              out["numbers"], out["limits"],
                              out["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
