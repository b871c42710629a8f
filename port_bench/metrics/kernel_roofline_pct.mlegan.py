"""The bounds pair and the scorer's share of their roofline: the least time of
the solve's launches (bytes / 3.35 TB/s or f32 operations / 67 TFLOP/s,
whichever bounds it, `roofline.bounds_fwd/bwd` over the observed entries,
the scorer reading W, U and C once) over their device time in the trace."""

from port_bench.trace import LIKELIHOOD

UNIT, LAYER, MOVES = "%", "likelihood kernels", "s_per_map"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.work:
        return None
    dev = t.device_s(LIKELIHOOD)
    if dev <= 0:
        return None
    return 100.0 * ctx.work["likelihood_least_s"] * ctx.units / dev
