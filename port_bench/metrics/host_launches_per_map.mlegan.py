"""CUDA runtime launch calls the host made per recovered map, from the
profiler's runtime events in the traced stretch."""

UNIT, LAYER, MOVES = "launches/map", "solver entry", "s_per_map"


def read(ctx):
    t = ctx.trace
    if t is None or not t.launches:
        return None
    return t.launch_count() / ctx.units
