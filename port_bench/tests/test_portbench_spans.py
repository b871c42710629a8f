"""The readers of the program's spans (`program_spans.py` and the five
metrics that read it) on synthetic spans and a synthetic `Trace`: the
served window's edges (it ends where the traced stretch starts), the
traced and the warm-up solves left out, None
where the program recorded nothing or has no recorder; then the tiny cells
traced on the CPU, and on the card a span's profiler range on the span's
own clock."""

import sys

import numpy as np
import pytest
import torch

from port_bench import harness, program_spans as ps
from port_bench import trace as T
from port_bench.tests.tiny import run_tiny, tiny_cell

BATCH = ("project_ms_per_solve.batch", "steps_ms_per_solve.batch")
SERVE = ("queue_wait_ms_p95.serve", "result_wait_ms_p95.serve",
         "idle_in_solve_pct.serve")
US = 1000       # ns a microsecond


class Ctx:
    def __init__(self, trace, seconds=2.0, max_iters=50):
        self.trace = trace
        self.cell = type("Cell", (), {})()
        self.cell.seconds = seconds
        self.cell.config = {"solver": {"max_iters": max_iters}}


def read(name, ctx, recs, monkeypatch):
    monkeypatch.setattr(ps, "records", lambda: recs)
    return harness.metric_reader(name).read(ctx)


def rec(name, a_us, b_us, sid, parent=None, key=None):
    return (name, int(a_us * US), int(b_us * US), sid, parent, key, 1)


def batch_spans():
    # the traced stretch is 1000..2000 us; solves keyed (B, iters)
    return [
        rec("qsc.lowrank.solve", 0, 500, 1, key=(256, 5)),      # warm-up
        rec("qsc.lowrank.project", 100, 400, 11, 1),
        rec("qsc.lowrank.solve", 500, 1000, 2, key=(256, 50)),  # ends at lo
        rec("qsc.lowrank.s_steps", 500, 600, 21, 2),
        rec("qsc.lowrank.c_steps", 600, 700, 22, 2),
        rec("qsc.lowrank.project", 700, 710, 23, 2),
        rec("qsc.lowrank.project", 800, 820, 24, 2),
        rec("qsc.lowrank.joint_step", 820, 900, 25, 2),
        rec("qsc.lowrank.solve", 1000, 2000, 3, key=(256, 50)),  # traced
        rec("qsc.lowrank.project", 1100, 1900, 31, 3),
        rec("qsc.lowrank.solve", 1500, 2500, 4, key=(256, 50)),  # overlaps
        rec("qsc.lowrank.project", 1600, 2400, 41, 4),
        rec("qsc.lowrank.solve", 2000, 3000, 5, key=(256, 50)),  # from hi
        rec("qsc.lowrank.s_steps", 2000, 2300, 51, 5),
        rec("qsc.lowrank.c_steps", 2300, 2400, 52, 5),
        rec("qsc.lowrank.project", 2400, 2440, 53, 5),
        rec("qsc.inner", 2400, 2430, 54, 53),           # a grandchild
    ]


def stretch(lo, hi, device=()):
    return T.Trace(span=(lo, hi), device=list(device), host=[], launches=[])


def test_batch_readers_take_the_untraced_full_solves(monkeypatch):
    ctx = Ctx(stretch(1000.0, 2000.0))
    recs = batch_spans()
    # solves 2 and 5: projections 10 + 20 us and 40 us; steps 200 and 400
    assert read(BATCH[0], ctx, recs, monkeypatch) == pytest.approx(0.035)
    assert read(BATCH[1], ctx, recs, monkeypatch) == pytest.approx(0.3)
    solves = ps.untraced_solves(recs, ctx.trace, 50)
    assert [r[ps.ID] for r in solves] == [2, 5]
    # the warm-up solve is taken only under its own key
    assert [r[ps.ID] for r in ps.untraced_solves(recs, ctx.trace, 5)] == [1]


def serve_spans():
    # the stretch is 13-14 s; with 3 s a window, the window before the
    # stretch is 11-13 s
    s = 1e6
    out = [rec("qsc.scheduler.solve", 10.0 * s, 11.0 * s, 100, key=0),
           rec("qsc.scheduler.solve", 12.0 * s, 13.0 * s, 200, key=1)]
    # request id, submit and answer (s), its batch's solve span, queue and
    # result ms
    reqs = [(0, 10.9, 11.2, 100, 900.0, 1.0),   # before the window
            (1, 11.0, 11.9, 200, 100.0, 2.0),   # at its open
            (2, 11.5, 12.1, 200, 200.0, 3.0),
            (3, 12.0, 12.2, 200, 300.0, 4.0),
            (4, 12.2, 13.5, 200, 800.0, 50.0),  # answered in the stretch
            (5, 12.3, 12.9, 200, 990.0, 60.0),  # submitted after request 4
            (7, 13.1, 13.3, 200, 970.0, 70.0)]  # in the stretch
    sid = 1000
    for rid, t, done, parent, q, r in reqs:
        t0 = t * s
        out.append(rec("qsc.request.queue", t0, t0 + q * 1e3, sid, parent,
                       rid))
        out.append(rec("qsc.request.result", done * s - r * 1e3, done * s,
                       sid + 1, parent, rid))
        out.append(rec("qsc.request", t0, done * s, sid + 2, parent, rid))
        sid += 3
    # a failed request in the window: its queue wait counts
    out.append(rec("qsc.request.queue", 12.1 * s, 12.1 * s + 5e5, 2000, 200,
                   6))
    out.append(rec("qsc.request.failed", 12.1 * s, 12.4 * s, 2001, 200, 6))
    # another scheduler's request 2 (another batch): not joined to ours
    out.append(rec("qsc.request.result", 12.0 * s, 12.1 * s, 2002, 999, 2))
    return out


def test_serve_waits_over_the_window_and_its_edges(monkeypatch):
    ctx = Ctx(stretch(13.0e6, 14.0e6), seconds=3.0)
    recs = serve_spans()
    assert ps.window(ctx) == (11.0e6, 13.0e6)
    # requests 1, 2, 3 and the failed 6; request 4 was answered in the
    # stretch, and request 5, submitted after it, goes with it
    assert ps.answered_in(recs, ps.window(ctx)) == {
        (200, 1), (200, 2), (200, 3), (200, 6)}
    assert read(SERVE[0], ctx, recs, monkeypatch) == pytest.approx(
        float(np.percentile([100.0, 200.0, 300.0, 500.0], 95)))
    assert read(SERVE[1], ctx, recs, monkeypatch) == pytest.approx(
        float(np.percentile([2.0, 3.0, 4.0], 95)))


def test_request_and_batch_parts():
    recs = serve_spans() + [
        rec("qsc.scheduler.collect", 0, 20, 1, key=0),
        rec("qsc.scheduler.download", 30, 31, 2, key=0),
        rec("qsc.scheduler.drain", 31, 41, 3, key=0),
        rec("qsc.scheduler.other", 0, 99, 4, key=0)]
    req = ps.request_ms(recs)
    assert sorted(req) == ["queue", "request", "result"]
    assert len(req["queue"]) == 8 and len(req["result"]) == 8
    assert req["request"] == pytest.approx(
        [300.0, 900.0, 600.0, 200.0, 1300.0, 600.0, 200.0])
    parts = ps.batch_ms(recs)
    assert parts == {"collect": [0.02], "stack": [], "solve": [1000.0,
                     1000.0], "download": [0.001], "drain": [0.01]}


def test_idle_in_solve(monkeypatch):
    # device busy 10-30 and 50-60 us of 0-100; solve open 0-40 and 55-200
    t = stretch(0.0, 100.0, [("k", 10.0, 30.0, 1), ("k", 50.0, 60.0, 2)])
    recs = [rec("qsc.scheduler.solve", 0, 40, 1),
            rec("qsc.scheduler.solve", 55, 200, 2),
            rec("qsc.lowrank.solve", 0, 100, 3)]
    # idle 0-10, 30-40 and 60-100 inside a solve: 60 us of 100
    assert read(SERVE[2], Ctx(t), recs, monkeypatch) == pytest.approx(60.0)
    # solves recorded, none in the stretch: no idle under them
    late = [rec("qsc.scheduler.solve", 300, 400, 1)]
    assert read(SERVE[2], Ctx(t), late, monkeypatch) == 0.0


def test_none_without_spans_or_stretch(monkeypatch):
    trace = stretch(1000.0, 2000.0, [("k", 1100.0, 1200.0, 1)])
    for name in BATCH + SERVE:
        assert read(name, Ctx(trace), [], monkeypatch) is None, name
        assert read(name, Ctx(None), batch_spans() + serve_spans(),
                    monkeypatch) is None, name
    # only the warm-up solve: nothing of the window to read
    assert read(BATCH[0], Ctx(trace), batch_spans()[:2], monkeypatch) is None


def test_program_without_a_recorder_gives_no_spans(monkeypatch):
    import quantized_spectrum_cartography_tpu_torch.utils as utils

    # the program as it was before it had `utils.tracing`
    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(
        sys.modules, "quantized_spectrum_cartography_tpu_torch.utils.tracing",
        None)
    assert ps.records() == []
    ctx = Ctx(stretch(0.0, 1e6))
    for name in BATCH + SERVE:
        assert harness.metric_reader(name).read(ctx) is None, name


@pytest.mark.parametrize("name,metrics", [
    ("lowrank-1bit-r2.batch256", BATCH),
    ("lowrank-1bit-r2.serve-poisson", SERVE)])
def test_tiny_traced_cells_read_every_span_metric(name, metrics):
    from quantized_spectrum_cartography_tpu_torch.utils import tracing

    cell = tiny_cell(name, seconds=1.0)
    cell.trace = True
    tracing.clear()
    out = run_tiny(cell)
    assert out["correct"]
    for m in metrics:
        v = out["metrics"][m]["value"]
        assert np.isfinite(v) and v >= 0.0, m
    if name.endswith("batch256"):
        assert out["metrics"][BATCH[1]]["value"] > 0.0


@pytest.mark.cuda
def test_span_range_on_the_card_starts_with_the_span():
    """On the card, a span's profiler range starts before its recorded
    start and within 50 us of it (the median of 20 spans; every one within
    1 ms, where a preemption between the range's stamp and the span's may
    fall): the two lie on one clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from quantized_spectrum_cartography_tpu_torch.utils import tracing

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with tracing.span("qsc.test.first"):  # the first range's set-up
            (x * 2.0).sum()
        for i in range(20):
            with tracing.span("qsc.test.card", key=i):
                (x * 2.0).sum()
        torch.cuda.synchronize()
    recs = {r[ps.KEY]: r for r in tracing.spans()
            if r[ps.NAME] == "qsc.test.card"}
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "qsc.test.card"
                     and e.device_type() == DeviceType.CPU),
                    key=lambda e: e.start_ns())
    assert len(events) == len(recs) == 20
    gaps = [(recs[i][ps.START] - e.start_ns()) / 1e3
            for i, e in enumerate(events)]
    print(f"span start - range start, us: {gaps}")
    # the range opens first, on the one clock
    assert min(gaps) >= 0.0
    assert float(np.median(gaps)) < 50.0 and max(gaps) < 1000.0
