"""The DowJons calls' spans (`qsc.dowjons.*`, the port's `utils.tracing`), as
the eval cell's per-layer metrics read them after the window: the calls of
the window outside the traced stretch, each a `qsc.dowjons.solve` span keyed
(examples, restarts, outer iterations).  The warm-up call runs one outer
iteration, so its key is another; the window's calls are the `skip_units`
last ones before the stretch and every one after it.  A program without these spans gives none,
and the readers then return None."""

from __future__ import annotations

from typing import Optional, Sequence

from port_bench import program_spans as ps

SOLVE = "qsc.dowjons.solve"


def untraced_calls(recs: Sequence, ctx) -> list:
    cfg, w = ctx.cell.config, ctx.cell.workload
    key = (w["traffic"]["batch"], cfg["solver"]["restarts"],
           cfg["solver"]["max_iters"])
    calls = [r for r in recs if r[ps.NAME] == SOLVE and r[ps.KEY] == key]
    lo, hi = ctx.trace.span
    before = [r for r in calls if ps.us(r)[1] <= lo]
    skip = w["trace"]["skip_units"]
    return (before[-skip:] if skip else []) + [
        r for r in calls if ps.us(r)[0] >= hi]


def children_ms(ctx, name: str) -> Optional[float]:
    """Median over the window's untraced calls of their summed `name`
    children, in ms; None without a stretch or without such calls."""
    if ctx.trace is None:
        return None
    recs = ps.records()
    return ps.children_ms(recs, untraced_calls(recs, ctx), (name,))
