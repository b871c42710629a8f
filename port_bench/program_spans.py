"""The program's own spans (the port's `utils.tracing`), as the per-layer
metrics read them after the window, in the benchmark's process.

A record is (name, start_ns, end_ns, span_id, parent_id, key, thread_id),
stamped with `time.time_ns()`: the clock of torch.profiler's events, which
a `Trace` keeps in microseconds.  A program without the recorder, or one
that recorded nothing (the control solver, the held cell), gives no spans,
and every reader then returns None.  The port's `serving_bench.py` sums up
its runs with the same functions.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from port_bench.trace import Interval, complement, union

NAME, START, END, ID, PARENT, KEY, THREAD = range(7)
SOLVE = "qsc.lowrank.solve"
REQUEST = ("qsc.request", "qsc.request.failed")
REQUEST_PARTS = {"qsc.request.queue": "queue",
                 "qsc.request.result": "result", "qsc.request": "request"}
BATCH_PARTS = ("collect", "stack", "solve", "download", "drain")


def records() -> list:
    """Every span the program recorded in this process (none if the
    program has no recorder)."""
    try:
        from quantized_spectrum_cartography_tpu_torch.utils import tracing
    except ImportError:
        return []
    return tracing.spans()


def us(r) -> Interval:
    """A record's interval in microseconds."""
    return r[START] / 1e3, r[END] / 1e3


def untraced_solves(recs: Sequence, trace, max_iters: int) -> list:
    """The window's solves outside the traced stretch: solve spans keyed
    (B, `max_iters`) (the warm-up solve runs fewer iterations) that do not
    overlap the stretch."""
    lo, hi = trace.span
    out = []
    for r in recs:
        if r[NAME] != SOLVE or not isinstance(r[KEY], tuple) \
                or r[KEY][1] != max_iters:
            continue
        a, b = us(r)
        if b <= lo or a >= hi:
            out.append(r)
    return out


def children_ms(recs: Sequence, parents: Sequence,
                names: Iterable[str]) -> Optional[float]:
    """Median over `parents` of the summed ms of their children named
    `names`; None without parents."""
    if not parents:
        return None
    names = frozenset(names)
    per: Dict[int, int] = {r[ID]: 0 for r in parents}
    for r in recs:
        if r[PARENT] in per and r[NAME] in names:
            per[r[PARENT]] += r[END] - r[START]
    return statistics.median(per.values()) / 1e6


def ms(r) -> float:
    """A record's length in ms."""
    return (r[END] - r[START]) / 1e6


def window(ctx) -> Optional[Interval]:
    """The served window before the traced stretch, in microseconds: [end
    of the stretch - `--seconds`, start of the stretch] (the stretch ends
    as the window closes), where the scheduler's counters are read too;
    None when the stretch was not read.  The stretch is left out: the
    profiler slows the host, and a request waiting as it closes waits
    through the profiler's stop, which holds the interpreter for
    seconds."""
    if ctx.trace is None:
        return None
    lo, hi = ctx.trace.span
    return hi - ctx.cell.seconds * 1e6, lo


def answered_in(recs: Sequence, win: Interval) -> Set[Tuple]:
    """{(batch's solve span, request id)} of the requests submitted from
    the window's open up to the first one answered (or failed) after its
    close, in the order of submission: each answered inside the window,
    and none left out for a long wait."""
    lo, hi = win
    subs = sorted((r[START] / 1e3, r[END] / 1e3, r[PARENT], r[KEY])
                  for r in recs if r[NAME] in REQUEST
                  and r[START] / 1e3 >= lo)
    out = set()
    for _, end, parent, key in subs:
        if end > hi:
            break
        out.add((parent, key))
    return out


def request_ms(recs: Sequence,
               ids: Optional[Set[Tuple]] = None) -> Dict[str, List[float]]:
    """ms of the requests' marks by part: `queue` (submit to its batch's
    stacking), `result` (its batch's solve returned to its future
    resolved) and `request` (submit to answered), of the requests `ids`
    (`answered_in`) or of all."""
    out: Dict[str, List[float]] = {p: [] for p in REQUEST_PARTS.values()}
    for r in recs:
        part = REQUEST_PARTS.get(r[NAME])
        if part and (ids is None or (r[PARENT], r[KEY]) in ids):
            out[part].append(ms(r))
    return out


def batch_ms(recs: Sequence) -> Dict[str, List[float]]:
    """ms of each batch's scheduler spans by part (`BATCH_PARTS`)."""
    out: Dict[str, List[float]] = {p: [] for p in BATCH_PARTS}
    for r in recs:
        if r[NAME].startswith("qsc.scheduler."):
            part = r[NAME][len("qsc.scheduler."):]
            if part in out:
                out[part].append(ms(r))
    return out


def request_p95_ms(recs: Sequence, win: Optional[Interval],
                   part: str) -> Optional[float]:
    """The 95th percentile in ms of the requests' `part` (`request_ms`)
    over those `answered_in` `win`."""
    if win is None:
        return None
    v = request_ms(recs, answered_in(recs, win))[part]
    return float(np.percentile(v, 95)) if v else None


def overlap_s(a: List[Interval], b: List[Interval]) -> float:
    """Seconds of the overlap of two sorted lists of disjoint intervals
    (microseconds)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e6


def idle_under(recs: Sequence, trace, name: str) -> Optional[float]:
    """Seconds of the traced stretch in which the device runs nothing while
    a span `name` is open; None if the program recorded no such span."""
    lo, hi = trace.span
    spans = [us(r) for r in recs if r[NAME] == name]
    if not spans:
        return None
    inside = union((max(a, lo), min(b, hi)) for a, b in spans
                   if b > lo and a < hi)
    return overlap_s(inside, complement(trace.busy_intervals(), trace.span))
