"""95th percentile of a served request's wait from its submit to the start
of its batch's stacking (`qsc.request.queue`, `parallel/scheduler.py`), over
the requests submitted in the window before the traced stretch and
answered before it (`program_spans.window`, `.answered_in`), in ms."""

from port_bench import program_spans as ps

UNIT, LAYER, MOVES = "ms", "scheduler", "latency_p95_s"


def read(ctx):
    return ps.request_p95_ms(ps.records(), ps.window(ctx), "queue")
