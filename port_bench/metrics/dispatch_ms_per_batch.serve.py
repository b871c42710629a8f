"""Median host time of the scheduler's dispatch thread per batch in the window
(`RecoveryScheduler.solve_seconds`: stacking, upload and the solver's host
loop), in ms."""

import statistics

UNIT, LAYER, MOVES = "ms", "scheduler", "latency_p95_s"


def read(ctx):
    c = ctx.counters
    if not c or not c["solve_seconds"]:
        return None
    return 1e3 * statistics.median(c["solve_seconds"])
