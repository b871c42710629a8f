"""On the card (marked `cuda`; skips without one): a short run of each
cell comes out correct; the control, the reference in TF32 in the
program's place, and each fault of `port_bench/faults.py` that the cell can
have come out not correct at the cell's own size.
Run: python -m pytest -m cuda port_bench/tests -q"""

import json
import subprocess
import sys

import pytest
import torch

from port_bench import calibrate, faults, harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
FAULTS = [(name, fault) for name in CELLS for fault in faults.NAMES
          if faults.applies(fault,
                            harness.load_cell(name).workload["driver"])]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", name,
         "--seed", str(2 ** 31 + 1001), "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    from quantized_spectrum_cartography_tpu_torch.config import (
        set_card_numerics)
    set_card_numerics()
    r = calibrate.reading(name, 2 ** 31 + 2002, 2.0, control=True)
    assert not r["correct"], r["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(card, name, fault):
    from quantized_spectrum_cartography_tpu_torch.config import (
        set_card_numerics)
    set_card_numerics()
    r = calibrate.reading(name, 2 ** 31 + 3003, 2.0, control=False,
                          fault=fault)
    print(f"{name} {fault}: {r['numbers']}")
    assert not r["correct"], r["numbers"]
