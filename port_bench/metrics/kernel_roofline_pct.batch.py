"""The 1-bit likelihood pair's share of its roofline: the least time of the
solve's launches (bytes / 3.35 TB/s or f32 operations / 67 TFLOP/s,
whichever bounds it, `roofline.onebit_fwd/bwd` at the solve's shapes) over
their device time in the trace."""

from port_bench.trace import LIKELIHOOD

UNIT, LAYER, MOVES = "%", "likelihood kernels", "maps_per_s"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.work:
        return None
    dev = t.device_s(LIKELIHOOD)
    if dev <= 0:
        return None
    return 100.0 * ctx.work["likelihood_least_s"] * ctx.units / dev
