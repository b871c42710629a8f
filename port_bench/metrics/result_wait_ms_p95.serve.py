"""95th percentile of a served request's wait from its batch's solver call
returning to its future resolved (`qsc.request.result`,
`parallel/scheduler.py`: the download and the drain thread), over the
requests submitted in the window before the traced stretch and answered
before it (`program_spans.window`, `.answered_in`), in ms."""

from port_bench import program_spans as ps

UNIT, LAYER, MOVES = "ms", "scheduler", "latency_p95_s"


def read(ctx):
    return ps.request_p95_ms(ps.records(), ps.window(ctx), "result")
