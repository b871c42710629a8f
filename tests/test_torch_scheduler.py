"""The port's continuous-batching `RecoveryScheduler` on the CPU: the cases
of tests/test_parallel.py (a fixed batch shape on every call, errors
propagated), a padded last batch, the same toy stream through the JAX
package's scheduler, a stress test of the completion counter, and the
scheduler over the port's `recover_lowrank_mle`, bit for bit against a
direct solve of the same stacked batch."""

import sys
import threading

import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu.parallel import (
    RecoveryScheduler as JaxScheduler,
)
from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
from quantized_spectrum_cartography_tpu_torch.ops.quantizer import F_probit
from quantized_spectrum_cartography_tpu_torch.parallel import (
    RecoveryScheduler,
)
from quantized_spectrum_cartography_tpu_torch.solvers import (
    recover_lowrank_mle,
)


def _scheduler(solver, batch_size, **kw):
    return RecoveryScheduler(solver, batch_size=batch_size, device="cpu",
                             **kw)


def test_scheduler_continuous_batching():
    calls = []

    def solver(batch):
        calls.append(tuple(batch["x"].shape))
        return {"y": batch["x"] * 2.0}

    sched = _scheduler(solver, 4, max_wait_ms=30)
    futs = [sched.submit({"x": np.full((3, 3), i, np.float32)})
            for i in range(10)]
    outs = [f.result(timeout=10) for f in futs]
    sched.shutdown()
    for i, o in enumerate(outs):
        assert isinstance(o["y"], np.ndarray)
        np.testing.assert_array_equal(o["y"], np.full((3, 3), 2.0 * i))
    assert sched.maps_completed == 10
    assert sched.batches_dispatched == len(calls) >= 3
    assert all(c == (4, 3, 3) for c in calls)     # static device batch shape
    assert len(sched.solve_seconds) == len(calls)
    assert all(t >= 0.0 for t in sched.solve_seconds)


def test_scheduler_propagates_errors():
    def solver(batch):
        raise RuntimeError("boom")

    sched = _scheduler(solver, 2, max_wait_ms=10)
    futs = [sched.submit({"x": np.zeros((2, 2), np.float32)})
            for _ in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=10)
    sched.shutdown()
    assert sched.maps_completed == 0
    assert sched.solve_seconds == []


def test_scheduler_pads_last_batch_with_request_zero():
    """5 requests at batch 4: the second batch holds request 4 and three
    copies of it; only the real requests get results."""
    seen = []

    def solver(batch):
        seen.append(batch["x"].clone())
        return {"y": batch["x"] + 1.0}

    sched = _scheduler(solver, 4, max_wait_ms=200)
    first = [sched.submit({"x": np.full(2, i, np.float32)}) for i in range(4)]
    [f.result(timeout=10) for f in first]
    last = sched.submit({"x": np.full(2, 4.0, np.float32)})
    np.testing.assert_array_equal(last.result(timeout=10)["y"], [5.0, 5.0])
    sched.shutdown()
    assert len(seen) == 2
    np.testing.assert_array_equal(seen[1].numpy(), np.full((4, 2), 4.0))
    assert sched.maps_completed == 5


def test_scheduler_matches_jax_package():
    """The same toy stream through both schedulers: the same per-request
    results and the same static batch shape."""
    shapes = {"jax": set(), "port": set()}

    def make(which):
        def solver(batch):
            shapes[which].add(tuple(batch["x"].shape))
            x = batch["x"]
            return {"y": x * 3.0 - 1.0, "n": x[:, 0] + x[:, 1]}
        return solver

    xs = [np.random.default_rng(i).normal(size=5).astype(np.float32)
          for i in range(7)]
    outs = {}
    for which, sched in (("jax", JaxScheduler(make("jax"), batch_size=3,
                                              max_wait_ms=20)),
                         ("port", _scheduler(make("port"), 3,
                                             max_wait_ms=20))):
        futs = [sched.submit({"x": x}) for x in xs]
        outs[which] = [f.result(timeout=30) for f in futs]
        sched.shutdown()
    assert shapes["jax"] == shapes["port"] == {(3, 5)}
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(a["y"], np.asarray(b["y"]))
        np.testing.assert_array_equal(a["n"], np.asarray(b["n"]))


def test_scheduler_counts_under_contention():
    """More drain threads than cores and a short switch interval: every
    request resolves once with its own row, and the completion counter
    loses no update."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        sched = _scheduler(lambda b: {"y": b["x"] + 0.0}, 2, max_wait_ms=1,
                           pipeline_depth=16, drain_threads=16)
        n = 400
        futs = [sched.submit({"x": np.array([i], np.int64)})
                for i in range(n)]
        got = [int(f.result(timeout=60)["y"][0]) for f in futs]
        sched.shutdown()
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(n))
    assert sched.maps_completed == n
    assert not sched._thread.is_alive()


def test_shutdown_fails_queued_requests():
    started, gate = threading.Event(), threading.Event()

    def solver(batch):
        started.set()
        gate.wait(timeout=10)
        return {"y": batch["x"]}

    sched = _scheduler(solver, 1, max_wait_ms=1, pipeline_depth=1)
    futs = [sched.submit({"x": np.zeros(1, np.float32)}) for _ in range(4)]
    assert started.wait(timeout=10)       # request 0 is being solved
    sched.shutdown(wait=False)
    gate.set()
    sched._thread.join(timeout=30)
    assert not sched._thread.is_alive()
    outcomes = [f.exception(timeout=10) for f in futs]
    assert outcomes[0] is None
    assert all(isinstance(e, RuntimeError) for e in outcomes[1:])


G, K, R, BATCH = 16, 8, 2, 4
MEAN, STD = 0.0045, 0.008


def test_scheduler_over_lowrank_solver_bitwise():
    """The scheduler over the port's batched low-rank solver (the plain
    1-bit path on the CPU): every request's S, C and cost equal a direct
    solve of the same stacked batch, pad slots included, bit for bit."""
    rng = np.random.default_rng(0)
    n = 6
    S = rng.uniform(0.0, 0.3, (n, R, G, G)).astype(np.float32)
    C = rng.uniform(0.0, 0.1, (n, R, K)).astype(np.float32)
    T = np.einsum("brij,brk->bkij", S, C).astype(np.float32)
    p = F_probit(torch.from_numpy(T) - MEAN, STD).numpy()
    T_obs = (rng.uniform(size=T.shape) < p).astype(np.float32)
    cfg = SolverConfig(max_iters=5, s_inner_iters=2, c_inner_iters=2,
                       lr_s=0.001, lr_c=0.001, projection_interval=5,
                       rank_truncation=3)
    batches = []

    def solve(T_obs):
        B = T_obs.shape[0]
        res = recover_lowrank_mle(T_obs, torch.zeros(B, R, G, G),
                                  torch.full((B, R, K), 0.01), cfg, MEAN, STD)
        return {"S": res.S, "C": res.C, "cost": res.costs[:, -1]}

    def solver(batch):
        batches.append((batch["id"].numpy(), batch["T_obs"].clone()))
        return solve(batch["T_obs"])

    sched = _scheduler(solver, BATCH, max_wait_ms=50)
    futs = [sched.submit({"T_obs": T_obs[i], "id": np.int64(i)})
            for i in range(n)]
    outs = [f.result(timeout=120) for f in futs]
    sched.shutdown()
    assert sched.batches_dispatched == len(batches) >= 2
    served = []
    for ids, obs in batches:
        direct = solve(obs)
        real = [0] + [j for j in range(1, BATCH) if ids[j] != ids[0]]
        # pad slots are copies of the batch's first request
        for j in set(range(BATCH)) - set(real):
            assert ids[j] == ids[0]
            assert torch.equal(obs[j], obs[0])
        for j in real:
            served.append(int(ids[j]))
            for key in ("S", "C", "cost"):
                np.testing.assert_array_equal(outs[ids[j]][key],
                                              direct[key][j].numpy())
    assert sorted(served) == list(range(n))
    assert any(len(set(ids.tolist())) < BATCH for ids, _ in batches)
    assert all(np.isfinite(o["cost"]) for o in outs)
