"""Device time per map of the operations the generator prior's convolutions
launch (forward, transposed, and their data gradients): the kernels
launched while one of these host operators ran, in ms."""

UNIT, LAYER, MOVES = "ms", "prior", "s_per_map"
OPS = ("aten::convolution", "aten::convolution_backward")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s, n = t.device_s_under(OPS)
    return 1e3 * s / ctx.units if n > 0 else None
