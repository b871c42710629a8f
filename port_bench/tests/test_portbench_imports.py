"""What a run loads: neither JAX, flax nor the JAX package (whose name the
port's begins with, so top-level names are compared whole); and the
reference loads nothing of the program either."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JAX_SIDE = {"jax", "jaxlib", "flax", "quantized_spectrum_cartography_tpu"}
PORT = "quantized_spectrum_cartography_tpu_torch"


def top_level_after(code: str) -> set:
    script = code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_and_metrics_load_no_jax():
    """Every module of the harness, each driver and each metric reader,
    then a tiny run of every cell on the CPU (which loads what the port's
    timed path loads)."""
    top = top_level_after(
        "import glob, importlib, torch\n"
        "torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from port_bench import (calibrate, check, faults, harness,\n"
        "    problems, roofline, run, trace, traffic)\n"
        "for d in sorted(glob.glob('port_bench/drivers/*.py')):\n"
        "    importlib.import_module('port_bench.drivers.' + Path(d).stem)\n"
        "for m in sorted(glob.glob('port_bench/metrics/*.py')):\n"
        "    harness.metric_reader(Path(m).name[:-3])\n"
        "from port_bench.tests.tiny import run_tiny, tiny_cell\n"
        "spec = harness.load_spec()\n"
        "for w in spec['workloads']:\n"
        "    assert run_tiny(tiny_cell(w['name']))['correct']\n"
        "assert not harness.forbidden_modules()\n")
    assert PORT in top
    assert not top & JAX_SIDE


def test_reference_loads_neither_jax_nor_the_port():
    top = top_level_after(
        "from port_bench.reference import lowrank, mlegan, numerics\n"
        "from port_bench import check, problems, roofline, traffic\n")
    assert not top & (JAX_SIDE | {PORT})
