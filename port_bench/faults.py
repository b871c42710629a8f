"""Faults planted in the timed path, to show that `correct` comes out false
for each fault a cell can have.  Each is a context manager: it patches the
program (and undoes the patch on leaving) or hands back a solver that
wraps the program's.  The CPU tests run them on tiny cells; the card tests
and `calibrate.py --fault` at each cell's own size.

- `unchanged_step`: every Adam step returns its state unchanged;
- `late_unchanged_step` (one-map cells): the steps after the checked early
  iterations return their state unchanged;
- `truncated` (one-map cells): the solve stops at half its iterations;
- `half_batch` (batched cells): half of the batch left out, the rest
  filled from the half that was solved;
- `altered_answer`: batched cells hand each map's answer to the next; the
  one-map cell moves C by 1% as it is returned.
No cell spans chips, so none can lose an exchange between them.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("unchanged_step", "late_unchanged_step", "truncated", "half_batch",
         "altered_answer")


def applies(fault: str, driver: str) -> bool:
    if fault in ("late_unchanged_step", "truncated"):
        return driver == "single"
    if fault == "half_batch":
        return driver in ("batch", "serve")
    return fault in NAMES


@contextlib.contextmanager
def _patched_adam(after_calls: int):
    """Adam steps after the first `after_calls` return their state
    unchanged (the step count still advances)."""
    from quantized_spectrum_cartography_tpu_torch.solvers import base

    real = base.adam_step
    calls = [0]

    def step(lr, grad, param, opt_state):
        calls[0] += 1
        if calls[0] <= after_calls:
            return real(lr, grad, param, opt_state)
        count, mu, nu = opt_state
        return param, (count + 1, mu, nu)
    base.adam_step = step
    try:
        yield
    finally:
        base.adam_step = real


def _half_batch(driver):
    def make(cell, aux):
        solve = driver.program_solver(cell, aux)

        def fill(out, n):
            return {k: torch.cat([v, v[: n - v.shape[0]]]) for k, v in
                    out.items()}
        if driver.__name__.endswith("serve"):
            def solver_fn(stacked):
                n = stacked["T_obs"].shape[0]
                return fill(solve({"T_obs": stacked["T_obs"][: n // 2]}), n)
            return solver_fn

        def f(y01, S0, C0, iters):
            n = y01.shape[0]
            return fill(solve(y01[: n // 2], S0[: n // 2], C0[: n // 2],
                              iters), n)
        return f
    return make


def _altered_answer(driver):
    def make(cell, aux):
        solve = driver.program_solver(cell, aux)
        if driver.__name__.endswith("single"):
            def f(p, iters):
                out = solve(p, iters)
                return dict(out, C=out["C"] * 1.01)
            return f

        def roll(out):
            return {k: v.roll(1, 0) for k, v in out.items()}
        if driver.__name__.endswith("serve"):
            return lambda stacked: roll(solve(stacked))
        return lambda *a: roll(solve(*a))
    return make


def _late_unchanged(driver, early: int):
    """Each solve's steps after its first `early` iterations (a C step and
    a Z step each) return their state unchanged."""
    def make(cell, aux):
        solve = driver.program_solver(cell, aux)

        def f(p, iters):
            with _patched_adam(2 * early):
                return solve(p, iters)
        return f
    return make


def _truncated(driver):
    def make(cell, aux):
        solve = driver.program_solver(cell, aux)
        return lambda p, iters: solve(p, max(1, iters // 2))
    return make


@contextlib.contextmanager
def planted(fault: str, cell, driver):
    """Yields the solver maker to hand to the driver's `setup` (None: the
    program's own, patched underneath)."""
    if not applies(fault, cell.workload["driver"]):
        raise ValueError(f"{fault} does not apply to {cell.name}")
    if fault == "unchanged_step":
        with _patched_adam(0):
            yield None
    elif fault == "late_unchanged_step":
        yield _late_unchanged(driver, cell.workload["check"]["early_iters"])
    elif fault == "truncated":
        yield _truncated(driver)
    elif fault == "half_batch":
        yield _half_batch(driver)
    else:
        yield _altered_answer(driver)
