"""Share of the scheduler's batch slots that carried a request over the
window: maps completed / (batches dispatched x batch). A batch dispatched
in the window may complete after it, so the ratio is off by at most the
batches in flight (pipeline depth) over the window's batches."""

UNIT, LAYER, MOVES = "%", "scheduler", "latency_p95_s"


def read(ctx):
    c = ctx.counters
    if not c or c["batches"] <= 0:
        return None
    return 100.0 * c["maps"] / (c["batches"] * c["batch"])
