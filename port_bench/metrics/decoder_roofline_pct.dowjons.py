"""The decoder's convolutions' share of their roofline: their least time over
the call (bytes / 3.35 TB/s or f32 operations / 67 TFLOP/s, whichever bounds
each launch; `roofline_decoder.conv_least_s` at each pass's batch of
latents) over the device time of the kernels launched under
`aten::convolution` and `aten::convolution_backward` in the trace."""

UNIT, LAYER, MOVES = "%", "prior", "maps_per_s"
OPS = ("aten::convolution", "aten::convolution_backward")


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.work:
        return None
    s, n = t.device_s_under(OPS)
    if n == 0 or s <= 0:
        return None
    return 100.0 * ctx.work["conv_least_s"] * ctx.units / s
