"""Host time of the latent Adam steps per DowJons call, read without the
profiler: the median, over the window's calls outside the traced stretch,
of the summed `qsc.dowjons.z_steps` spans (`solvers/completion.py`) of
each, in ms."""

from port_bench import eval_spans

UNIT, LAYER, MOVES = "ms", "optimizer and projection", "maps_per_s"


def read(ctx):
    return eval_spans.children_ms(ctx, "qsc.dowjons.z_steps")
