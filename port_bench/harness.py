"""What every run shares: finding a cell's files by name, the device's
description, the check for JAX, and the result line.

A cell `<config>.<traffic>` is the entry of `workloads` in BENCHMARK.json;
its parameters are `workloads/<cell>.json` (driver, traffic, what the check
compares and the limits), its configuration `configs/<config>.json`, its
driver `drivers/<driver>.py`, and each per-layer metric `metrics/<name>.py`.
Adding a cell, a configuration or a metric adds files and entries only.

A cell held out of BENCHMARK.json (proved correct, but with no end-to-end
metric steady enough for a bound) keeps its entries, as BENCHMARK.json would
hold them, in `held/<cell>.json`: a run, the calibration and the tests can
name it, and putting it back is moving those entries.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "quantized_spectrum_cartography_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                 # its entry in BENCHMARK.json
    workload: dict              # workloads/<name>.json
    config: dict                # configs/<config>.json
    end_to_end: List[dict]      # the end-to-end metrics it reports
    per_layer: List[dict]       # the per-layer metrics it reports
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_spec() -> dict:
    """BENCHMARK.json with the entries of the held cells appended."""
    spec = load_json(ROOT / "BENCHMARK.json")
    for path in sorted((HERE / "held").glob("*.json")):
        for key, entries in load_json(path).items():
            spec[key] = spec[key] + entries
    return spec


def load_cell(name: str, spec: Optional[dict] = None,
              base: Path = HERE) -> Cell:
    """The cell `name` as `spec` (by default BENCHMARK.json and the held
    cells) and its files under `base` give it."""
    spec = spec if spec is not None else load_spec()
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json or held/")
    entry = entries[name]
    workload = load_json(base / "workloads" / f"{name}.json")
    config = load_json(base / "configs" / f"{entry['config']}.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name=name, entry=entry, workload=workload, config=config,
                end_to_end=e2e, per_layer=layer)


def driver(cell: Cell) -> ModuleType:
    return importlib.import_module(
        f"port_bench.drivers.{cell.workload['driver']}")


def metric_reader(name: str, base: Path = HERE) -> ModuleType:
    """metrics/<name>.py, loaded by its path (metric names hold dots)."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (the port's name starts with the JAX package's, so names are
    compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def process_start_time() -> Optional[float]:
    """The process's start on the `time.time()` clock (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import time
        return time.time() - uptime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError):
        return None


def power_limit() -> Optional[float]:
    """The card's power limit in W, as nvidia-smi reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def spans(ends: List[float]) -> str:
    """The durations between successive times, as seconds to 3 places."""
    return " ".join(f"{b - a:.3f}" for a, b in zip(ends, ends[1:]))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared is finite and at most its limit, and every
    limit has its number."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= v for k, v in limits.items())


def result_line(correct, attempted, failed, metrics, device, checks,
                limits, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    def number(x):
        return x if x is not None and math.isfinite(x) else str(x)
    out["checks"] = {k: {"value": number(checks.get(k)), "limit": v}
                     for k, v in limits.items()}
    return json.dumps(out)
