"""Host time of the Adam steps per solve, read without the profiler: the
median, over the window's solves outside the traced stretch, of the summed
`qsc.lowrank.s_steps` and `qsc.lowrank.c_steps` spans
(`solvers/lowrank_mle.py`) of each, in ms."""

from port_bench import program_spans as ps

UNIT, LAYER, MOVES = "ms", "optimizer and projection", "maps_per_s"


def read(ctx):
    if ctx.trace is None:
        return None
    recs = ps.records()
    solves = ps.untraced_solves(recs, ctx.trace,
                                ctx.cell.config["solver"]["max_iters"])
    return ps.children_ms(recs, solves, ("qsc.lowrank.s_steps",
                                         "qsc.lowrank.c_steps"))
