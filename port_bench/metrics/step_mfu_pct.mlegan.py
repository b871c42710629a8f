"""The whole map's solve's share of the chip's float32 peak (67 TFLOP/s, no
tensor cores: TF32 is off): its operations counted from shapes
(`roofline.mlegan_map`: the generator's convolutions and data gradients,
the search's forwards, the likelihood) over the traced stretch's wall time."""

from port_bench.roofline import PEAK_F32_FLOP_S

UNIT, LAYER, MOVES = "%", "whole step", "s_per_map"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.work or t.window_s <= 0:
        return None
    return 100.0 * ctx.work["flops"] * ctx.units / (t.window_s
                                                    * PEAK_F32_FLOP_S)
