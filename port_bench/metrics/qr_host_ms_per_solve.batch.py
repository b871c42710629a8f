"""Host time inside `aten::linalg_qr` per solve (the subspace projection's QR,
which the port runs matrix by matrix), in ms."""

UNIT, LAYER, MOVES = "ms", "optimizer and projection", "maps_per_s"
OPS = ("aten::linalg_qr",)


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = t.host_s(OPS)
    return 1e3 * s / ctx.units if s > 0 else None
