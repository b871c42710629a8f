"""The port's span recorder (`utils.tracing`) on the CPU: parents within a
thread and across threads, the ring's bound, recording off, the profiler's
range of a span on the same clock, the low-rank solver's spans (its
results bit for bit with recording on and off) and the scheduler's
request marks.  Imports no JAX."""

import threading
import time

import numpy as np
import pytest
import torch

from quantized_spectrum_cartography_tpu_torch.config import SolverConfig
from quantized_spectrum_cartography_tpu_torch.ops.quantizer import F_probit
from quantized_spectrum_cartography_tpu_torch.parallel import (
    RecoveryScheduler,
)
from quantized_spectrum_cartography_tpu_torch.solvers import (
    recover_lowrank_mle,
)
from quantized_spectrum_cartography_tpu_torch.utils import tracing

NAME, START, END, ID, PARENT, KEY, THREAD = range(7)


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.clear()
    tracing.set_enabled(True)
    yield
    tracing.set_enabled(True)
    tracing.clear()


def named(records, name):
    return [r for r in records if r[NAME] == name]


def test_nesting_gives_parent_ids():
    with tracing.span("qsc.t.outer", key=7) as outer:
        with tracing.span("qsc.t.inner") as inner:
            pass
        with tracing.span("qsc.t.inner"):
            pass
    recs = tracing.spans()
    # a span is recorded as it closes: the inner ones first
    assert [r[NAME] for r in recs] == ["qsc.t.inner", "qsc.t.inner",
                                       "qsc.t.outer"]
    (o,) = named(recs, "qsc.t.outer")
    assert o[ID] == outer.id and o[PARENT] is None and o[KEY] == 7
    assert recs[0][ID] == inner.id
    assert all(r[PARENT] == outer.id for r in named(recs, "qsc.t.inner"))
    assert o[START] <= recs[0][START] <= recs[0][END] <= recs[1][START] \
        <= recs[1][END] <= o[END]
    assert len({r[ID] for r in recs}) == 3


def test_threads_keep_their_own_parents():
    gate = threading.Barrier(2)
    ids = {}

    def work(tag):
        with tracing.span(f"qsc.t.{tag}") as top:
            gate.wait(timeout=10)       # both outer spans open at once
            with tracing.span(f"qsc.t.{tag}.child"):
                gate.wait(timeout=10)
        ids[tag] = (top.id, threading.get_ident())

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    recs = tracing.spans()
    for tag in "ab":
        (child,) = named(recs, f"qsc.t.{tag}.child")
        (top,) = named(recs, f"qsc.t.{tag}")
        assert child[PARENT] == ids[tag][0] == top[ID]
        assert top[PARENT] is None
        assert child[THREAD] == top[THREAD] == ids[tag][1]
    assert ids["a"][1] != ids["b"][1]


def test_ring_holds_at_most_its_bound():
    n = tracing.CAPACITY + 100
    for i in range(n):
        tracing.mark("qsc.t.m", i, i + 1, key=i)
    recs = tracing.spans()
    assert len(recs) == tracing.CAPACITY
    # the newest are kept
    assert recs[0][KEY] == 100 and recs[-1][KEY] == n - 1


def test_disabled_records_nothing():
    tracing.set_enabled(False)
    with tracing.span("qsc.t.off") as s:
        pass
    assert tracing.mark("qsc.t.off", 0, 1) is None
    assert s.id is None and s.start_ns is None and s.end_ns is None
    assert tracing.spans() == []
    tracing.set_enabled(True)
    with tracing.span("qsc.t.on"):
        pass
    assert [r[NAME] for r in tracing.spans()] == ["qsc.t.on"]


def test_mark_records_interval_key_and_parent():
    with tracing.span("qsc.t.batch") as b:
        pass
    sid = tracing.mark("qsc.t.req", 10, 25, key=3, parent_id=b.id)
    (m,) = named(tracing.spans(), "qsc.t.req")
    assert m[:6] == ("qsc.t.req", 10, 25, sid, b.id, 3)
    assert sid != b.id
    tracing.clear()
    assert tracing.spans() == []


def test_span_closes_on_an_exception():
    with pytest.raises(ValueError):
        with tracing.span("qsc.t.raises"):
            raise ValueError("x")
    with tracing.span("qsc.t.after"):
        pass
    recs = tracing.spans()
    assert [r[NAME] for r in recs] == ["qsc.t.raises", "qsc.t.after"]
    # the failed span left the thread's stack: the next one is a root
    assert recs[1][PARENT] is None


def test_span_is_a_profiler_range_on_the_same_clock():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("qsc.t.first"):   # the first range pays its set-up
            pass
        for i in range(20):
            with tracing.span("qsc.t.profiled", key=i):
                torch.ones(8).sum()
    with tracing.span("qsc.t.unprofiled"):
        pass
    recs = named(tracing.spans(), "qsc.t.profiled")
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "qsc.t.profiled"
                     and e.device_type() == DeviceType.CPU),
                    key=lambda e: e.start_ns())
    assert len(events) == len(recs) == 20
    # the range opens before the span's first stamp and closes after its
    # last, on the one clock; a preemption between the two stamps only
    # widens the gap, so the gap's bound is held by the median
    starts, ends = [], []
    for e, r in zip(events, recs):
        starts.append(r[START] - e.start_ns())
        ends.append(e.start_ns() + e.duration_ns() - r[END])
    assert min(starts) >= 0 and min(ends) >= 0
    assert np.median(starts) < 1_000_000 and np.median(ends) < 1_000_000
    assert len(named(tracing.spans(), "qsc.t.unprofiled")) == 1


G, K, R = 12, 6, 2
MEAN, STD = 0.0045, 0.008


def onebit_problem(n, seed=0):
    rng = np.random.default_rng(seed)
    S = rng.uniform(0.0, 0.3, (n, R, G, G)).astype(np.float32)
    C = rng.uniform(0.0, 0.1, (n, R, K)).astype(np.float32)
    T = np.einsum("brij,brk->bkij", S, C).astype(np.float32)
    p = F_probit(torch.from_numpy(T) - MEAN, STD).numpy()
    return (rng.uniform(size=T.shape) < p).astype(np.float32)


@pytest.mark.parametrize("joint", [False, True])
def test_lowrank_spans_and_results_unchanged(joint):
    """The same S, C and costs, bit for bit, with recording on and off;
    with it on, one solve span keyed (B, iters) and its phases under it."""
    iters, every, B = 6, 3, 3
    cfg = SolverConfig(max_iters=iters, s_inner_iters=2, c_inner_iters=2,
                       lr_s=0.001, lr_c=0.001, projection_interval=every,
                       rank_truncation=3)
    T_obs = torch.from_numpy(onebit_problem(B))

    def solve():
        return recover_lowrank_mle(T_obs, torch.zeros(B, R, G, G),
                                   torch.full((B, R, K), 0.01), cfg, MEAN,
                                   STD, joint=joint)

    tracing.set_enabled(False)
    off = solve()
    assert tracing.spans() == []
    tracing.set_enabled(True)
    on = solve()
    for f in ("S", "C", "costs"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    recs = tracing.spans()
    (top,) = named(recs, "qsc.lowrank.solve")
    assert top[KEY] == (B, iters) and top[PARENT] is None
    phases = {n: named(recs, n) for n in (
        "qsc.lowrank.s_steps", "qsc.lowrank.c_steps",
        "qsc.lowrank.joint_step", "qsc.lowrank.project")}
    if joint:
        assert len(recs) == 1 + 2 * iters
        assert len(phases["qsc.lowrank.joint_step"]) == iters
        assert len(phases["qsc.lowrank.project"]) == iters
    else:
        assert len(recs) == 1 + 2 * iters + iters // every
        assert len(phases["qsc.lowrank.s_steps"]) == iters
        assert len(phases["qsc.lowrank.c_steps"]) == iters
        assert len(phases["qsc.lowrank.project"]) == iters // every
    assert all(r[PARENT] == top[ID] for r in recs if r is not top)


def scheduled(solver, n, batch, **kw):
    sched = RecoveryScheduler(solver, batch_size=batch, device="cpu", **kw)
    futs = [sched.submit({"x": np.full(3, i, np.float32)}) for i in range(n)]
    for f in futs:
        f.exception(timeout=60)
    # the drain threads record their marks after resolving; they are joined
    # by the dispatch thread as it stops
    sched.shutdown(wait=True)
    return sched, futs


def test_scheduler_request_marks_add_up():
    """Each request: one queue, one result and one qsc.request mark; its
    queue wait, its batch's stack and solve spans and its result wait add
    up to the whole request within 1 ms."""
    def solver(b):
        time.sleep(0.01)
        return {"y": b["x"] * 2.0}

    n = 10
    sched, futs = scheduled(solver, n, 4, max_wait_ms=20)
    assert [float(f.result()["y"][0]) for f in futs] == [2.0 * i
                                                          for i in range(n)]
    recs = tracing.spans()
    by_id = {r[ID]: r for r in recs}
    marks = {name: {r[KEY]: r for r in named(recs, name)}
             for name in ("qsc.request.queue", "qsc.request.result",
                          "qsc.request")}
    for name, got in marks.items():
        assert sorted(got) == list(range(n)), name
        assert len(named(recs, name)) == n, name
    assert not named(recs, "qsc.request.failed")
    stacks = {r[KEY]: r for r in named(recs, "qsc.scheduler.stack")}
    assert len(stacks) == sched.batches_dispatched
    for name in ("qsc.scheduler.collect", "qsc.scheduler.download",
                 "qsc.scheduler.drain"):
        assert len(named(recs, name)) == sched.batches_dispatched, name
    for rid in range(n):
        q, res, whole = (marks[k][rid] for k in ("qsc.request.queue",
                                                 "qsc.request.result",
                                                 "qsc.request"))
        solve = by_id[whole[PARENT]]
        assert solve[NAME] == "qsc.scheduler.solve"
        assert q[PARENT] == res[PARENT] == solve[ID]
        stack = stacks[solve[KEY]]
        assert q[END] == stack[START] and res[START] == solve[END]
        parts = sum(r[END] - r[START] for r in (q, stack, solve, res))
        assert abs(parts - (whole[END] - whole[START])) < 1_000_000
        assert whole[START] <= q[END] <= res[START] <= whole[END]


def test_scheduler_failed_requests_marked():
    def solver(b):
        raise RuntimeError("boom")

    sched, futs = scheduled(solver, 3, 2, max_wait_ms=10)
    assert all(isinstance(f.exception(), RuntimeError) for f in futs)
    recs = tracing.spans()
    assert sorted(r[KEY] for r in named(recs, "qsc.request.failed")) == [
        0, 1, 2]
    assert not named(recs, "qsc.request")
    assert not named(recs, "qsc.request.result")
    # the solver was called: each request's queue wait was stamped
    assert len(named(recs, "qsc.request.queue")) == 3
