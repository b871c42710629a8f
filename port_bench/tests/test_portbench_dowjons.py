"""The DowJons cell (`drivers/eval.py`): the reference against the port's
plain path at a tiny size (`dowjons_tiny.py`), the control reading above
the program, each fault the cell can have coming out not correct (the two
of `faults.py` that apply, and six planted here: the init fit's steps after
the checked first ones, or the z-steps after the early iterations,
returning their state unchanged; the outer loop stopped at half its
iterations; NNLS at half its iterations; the pick taking the restart of
the largest residual; the loop's C-steps crossed between the examples of
the batch's first quarter), the decoder's work counts against torch's own
count, and the inputs against the program's simulator.  Under `-m cuda`
the planted faults at the cell's own size."""

import contextlib
import dataclasses
import time

import pytest
import torch

from port_bench import (dowjons_inputs, faults, harness, roofline_decoder,
                        traffic)
from port_bench.drivers import eval as ev
from port_bench.reference import dowjons as ref
from port_bench.reference.numerics import Precision
from port_bench.run import execute
from port_bench.tests.dowjons_tiny import CELL, run_tiny, tiny_cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def adam_skipped(lo: int, hi: int):
    """Adam steps lo + 1 to hi of a solve (counted from its first) return
    their state unchanged; the step count still advances."""
    from quantized_spectrum_cartography_tpu_torch.solvers import base

    real, calls = base.adam_step, [0]

    def step(lr, grad, param, opt_state):
        calls[0] += 1
        if not lo < calls[0] <= hi:
            return real(lr, grad, param, opt_state)
        count, mu, nu = opt_state
        return param, (count + 1, mu, nu)
    base.adam_step = step
    try:
        yield
    finally:
        base.adam_step = real


def init_late_unchanged(cell, weights):
    """The init fit's steps after the checked first ones return their state
    unchanged (the restarts' steps run)."""
    lo = cell.workload["check"]["init_steps"]
    hi = cell.config["solver"]["init_steps"]
    solve = ev.program_solver(cell, weights)

    def f(hp, draws):
        with adam_skipped(lo, hi):
            return solve(hp, draws)
    return f


def late_unchanged(cell, weights):
    """The latent steps after the checked early iterations return their
    state unchanged (the init fit's steps and the early ones run)."""
    sv = cell.config["solver"]
    after = (sv["init_steps"]
             + cell.workload["check"]["early_iters"] * sv["s_inner_iters"])
    solve = ev.program_solver(cell, weights)

    def f(hp, draws):
        with adam_skipped(after, float("inf")):
            return solve(hp, draws)
    return f


def outer_halved(cell, weights):
    """The outer loop stops at half its iterations."""
    sv = cell.config["solver"]
    half = dataclasses.replace(cell, config=dict(
        cell.config, solver=dict(sv, max_iters=max(1, sv["max_iters"] // 2))))
    return ev.program_solver(half, weights)


def nnls_halved(cell, weights):
    """Every NNLS C-step runs half its iterations."""
    from quantized_spectrum_cartography_tpu_torch.solvers import completion

    solve = ev.program_solver(cell, weights)

    def f(hp, draws):
        real = completion.nnls_rows
        completion.nnls_rows = lambda A, B, iters=200: real(
            A, B, iters=max(1, iters // 2))
        try:
            return solve(hp, draws)
        finally:
            completion.nnls_rows = real
    return f


def pick_worst(cell, weights):
    """The pick takes the restart of the largest final residual, and
    reports it as the winner (its costs, latents and answer agree)."""
    solve = ev.program_solver(cell, weights)

    def f(hp, draws):
        real = torch.argmin
        torch.argmin = torch.argmax
        try:
            return solve(hp, draws)
        finally:
            torch.argmin = real
    return f


def quarter_crossed(cell, weights):
    """Inside the outer loop each C-step hands each example of the batch's
    first quarter (at least two) the next one's C; the last C-step is
    right, so each answer agrees with its own latents: a fault in a
    minority of the examples that passes the medians."""
    from quantized_spectrum_cartography_tpu_torch.solvers import completion

    solve = ev.program_solver(cell, weights)
    loop = cell.config["solver"]["max_iters"]

    def f(hp, draws):
        real, calls = completion.nnls_rows, [0]

        def crossed(A, B, iters=200):
            X = real(A, B, iters=iters)
            calls[0] += 1
            if calls[0] > loop:
                return X
            q = max(2, X.shape[0] // 4)
            return torch.cat([X[:q].roll(1, 0), X[q:]])
        completion.nnls_rows = crossed
        try:
            return solve(hp, draws)
        finally:
            completion.nnls_rows = real
    return f


PLANTED = {"init_late_unchanged": init_late_unchanged,
           "late_unchanged": late_unchanged, "outer_halved": outer_halved,
           "nnls_halved": nnls_halved, "pick_worst": pick_worst,
           "quarter_crossed": quarter_crossed}
SHARED = [f for f in faults.NAMES if faults.applies(f, "eval")]


def test_program_matches_reference():
    out = run_tiny(tiny_cell())
    assert out["correct"], out["numbers"]
    assert out["failed"] == 0 and out["attempted"] > 0
    for k in out["limits"]:
        assert 0.0 <= out["numbers"][k] < 1e-4, (k, out["numbers"][k])


def test_control_reads_above_the_program():
    prog = run_tiny(tiny_cell())["numbers"]
    ctrl = run_tiny(tiny_cell(), ev.control_solver)["numbers"]
    assert max(ctrl[k] / max(prog[k], 1e-12) for k in prog) >= 10.0, \
        (prog, ctrl)


@pytest.mark.parametrize("fault", SHARED)
def test_shared_fault_comes_out_not_correct(fault):
    cell = tiny_cell()
    with faults.planted(fault, cell, ev) as solver:
        out = run_tiny(cell, solver)
    assert not out["correct"], out["numbers"]


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_fault_comes_out_not_correct(fault):
    out = run_tiny(tiny_cell(), PLANTED[fault])
    assert not out["correct"], out["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_fault_at_the_cells_size(fault):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from quantized_spectrum_cartography_tpu_torch.config import (
        set_card_numerics)
    set_card_numerics()
    cell = harness.load_cell(CELL)
    cell.seed, cell.seconds = 2 ** 31 + 4004, 2.0
    out = execute(cell, time.time(), solver=PLANTED[fault])
    print(f"{CELL} {fault}: {out['numbers']}")
    assert not out["correct"], out["numbers"]


def test_decoder_counts_against_torch():
    """Multiply-adds from the configuration's table, and the least time's
    operations, against `FlopCounterMode` over the reference decoder: the
    forward, then the data gradient (the weights need none)."""
    from torch.utils.flop_counter import FlopCounterMode

    pr = harness.load_cell(CELL).config["prior"]
    assert roofline_decoder.decoder_macs(pr) == 25_226_256
    w = dowjons_inputs.decoder_weights(torch.Generator().manual_seed(3), pr)
    z = torch.randn(3, pr["latent_dim"], requires_grad=True)
    with FlopCounterMode(display=False) as fwd:
        S = ref.decoder_forward(w, pr, z, Precision(torch.float32))
    assert fwd.get_total_flops() == 3 * 2 * 25_226_256
    with FlopCounterMode(display=False) as bwd:
        torch.autograd.grad(S.sum(), z)
    assert bwd.get_total_flops() == 3 * 2 * 25_226_256
    # a call: 600 z-steps on 512 latents forward and back, 150 init steps
    # on 128, 32 forwards on 512
    cfg = harness.load_cell(CELL).config
    work = roofline_decoder.dowjons_call(cfg, 64)
    dec = 2 * 25_226_256 * (2 * (600 * 512 + 150 * 128) + 32 * 512)
    assert dec < work["flops"] < 1.02 * dec
    assert 33.0e12 < work["flops"] < 34.5e12


def test_inputs_are_the_programs_sinc_maps():
    from quantized_spectrum_cartography_tpu_torch.config import PhysicsConfig
    from quantized_spectrum_cartography_tpu_torch.physics import (
        generate_map_batch)

    ph = dowjons_inputs.physics(harness.load_cell(CELL).config)
    chol = traffic.correlation_cholesky(ph["grid_size"],
                                        ph["decorrelation_distance"], "cpu")
    got = dowjons_inputs.generate_sinc_batch(
        torch.Generator().manual_seed(9), ph, 3, chol)
    cfg = PhysicsConfig(num_emitters=2, shadow_sigma=5.0,
                        decorrelation_distance=50.0, psd_basis="s",
                        separable=True)
    want = generate_map_batch(torch.Generator().manual_seed(9), cfg, 3,
                              "cpu", chol)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)


def test_reference_and_inputs_load_neither_jax_nor_the_port():
    from port_bench.tests.test_portbench_imports import (JAX_SIDE, PORT,
                                                         top_level_after)
    top = top_level_after(
        "from port_bench.reference import dowjons\n"
        "from port_bench import dowjons_inputs, eval_spans\n"
        "from port_bench import roofline_decoder\n")
    assert not top & (JAX_SIDE | {PORT})
