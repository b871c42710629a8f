"""A run with the timed path broken underneath comes out not correct, for
each fault the cell can have (`port_bench/faults.py`): a step that returns
its state unchanged (in the one-map cell also only after the early
iterations, and a solve stopped at half its iterations); half of the batch
left out; an answer altered where it is produced.  (No cell spans chips,
so none can lose an exchange between them.)  The harness's look for a card
is skipped: the tiny cells run on the CPU."""

import pytest
import torch

from port_bench import faults
from port_bench.drivers import batch, serve, single
from port_bench.tests.tiny import run_tiny, tiny_cell

BATCH, SINGLE, SERVE = ("lowrank-1bit-r2.batch256",
                        "mlegan-gen256-4bin.single",
                        "lowrank-1bit-r2.serve-poisson")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CASES = [(name, fault) for name, drv in ((BATCH, "batch"), (SERVE, "serve"),
                                         (SINGLE, "single"))
         for fault in faults.NAMES if faults.applies(fault, drv)]
DRIVERS = {BATCH: batch, SERVE: serve, SINGLE: single}


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_comes_out_not_correct(name, fault):
    cell = tiny_cell(name)
    with faults.planted(fault, cell, DRIVERS[name]) as solver:
        out = run_tiny(cell, solver)
    assert not out["correct"], out["numbers"]


def test_sound_tiny_runs_are_correct():
    """The same tiny cells unbroken come out correct (so the faults above
    are what fails them)."""
    for name in (BATCH, SERVE, SINGLE):
        out = run_tiny(tiny_cell(name))
        assert out["correct"], (name, out["numbers"])
