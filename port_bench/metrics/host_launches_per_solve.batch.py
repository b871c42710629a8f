"""CUDA runtime launch calls (kernel and graph launches) the host made per
solve, from the profiler's runtime events in the traced stretch."""

UNIT, LAYER, MOVES = "launches/solve", "solver entry", "maps_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or not t.launches:
        return None
    return t.launch_count() / ctx.units
