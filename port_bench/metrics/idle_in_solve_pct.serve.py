"""Share of the traced stretch in which the device runs nothing while the
scheduler's dispatch thread is inside its solver call
(`qsc.scheduler.solve`, `parallel/scheduler.py`): the idle the profiler
cannot put to a thread, since it records only the thread that started
it."""

from port_bench import program_spans as ps

UNIT, LAYER, MOVES = "%", "device", "latency_p95_s"


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    idle = ps.idle_under(ps.records(), t, "qsc.scheduler.solve")
    return None if idle is None else 100.0 * idle / t.window_s
