"""The reference against the port's plain path (the CPU takes the kernels'
plain versions) at a tiny size: every cell comes out correct, and every
number compared is at float32 rounding (below 1e-4 against the float64
reference after a few dozen Adam steps)."""

import pytest
import torch

from port_bench import harness
from port_bench.tests.tiny import run_tiny, tiny_cell

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_program_matches_reference(name):
    out = run_tiny(tiny_cell(name))
    assert out["correct"], out["numbers"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["numbers"]) == set(out["limits"])
    for k, v in out["numbers"].items():
        assert 0.0 <= v < 1e-4, (k, v)


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program(name):
    """The control, the reference in TF32 in the program's place, reads at
    least ten times the program on some number compared."""
    cell = tiny_cell(name)
    prog = run_tiny(cell)["numbers"]
    ctrl = run_tiny(tiny_cell(name),
                    harness.driver(cell).control_solver)["numbers"]
    assert max(ctrl[k] / max(prog[k], 1e-12) for k in prog) >= 10.0, \
        (prog, ctrl)


def test_same_seed_same_inputs():
    from port_bench import problems
    cell = tiny_cell("lowrank-1bit-r2.batch256", seed=2 ** 33 + 5)
    a = problems.onebit_batches(problems.generator(cell.seed, "cpu"),
                                cell.config, 4, 1)[0]
    b = problems.onebit_batches(problems.generator(cell.seed, "cpu"),
                                cell.config, 4, 1)[0]
    c = problems.onebit_batches(problems.generator(cell.seed + 1, "cpu"),
                                cell.config, 4, 1)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
