"""Reading a torch.profiler trace into the numbers the per-layer metrics
take: device intervals, host operators, launch calls, the traced stretch.

The trace is kept in memory as plain tuples (a whole solve has some 150k
launches; no chrome trace is written).  Times are in microseconds on the
profiler's clock.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import sys
from typing import Iterable, List, Optional, Sequence, Tuple

STRETCH = "port_bench.stretch"
LAUNCH_NAMES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
))
# the likelihood kernels of csrc/: the 1-bit pair, the ordinal tile pair
# (bounds and codes), and the reduction both launch after a forward
LIKELIHOOD = re.compile(r"onebit_(fwd|bwd)_kernel|qnll_(fwd|bwd)_kernel|"
                        r"sum_partials_kernel")

Interval = Tuple[float, float]


@dataclasses.dataclass
class Trace:
    span: Interval                          # the traced stretch
    device: List[Tuple[str, float, float, int]]   # name, start, end, corr
    host: List[Tuple[str, float, float, int]]     # name, start, end, thread
    launches: List[Tuple[int, float, int]]        # corr, time, thread

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e6

    def _clip(self, ivs: Iterable[Interval]) -> List[Interval]:
        lo, hi = self.span
        return [(max(a, lo), min(b, hi)) for a, b in ivs
                if b > lo and a < hi]

    def busy_intervals(self) -> List[Interval]:
        return union(self._clip((s, e) for _, s, e, _ in self.device))

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def launch_count(self) -> int:
        lo, hi = self.span
        return sum(1 for _, t, _ in self.launches if lo <= t <= hi)

    def device_s(self, pattern: re.Pattern) -> float:
        """Summed device seconds of the operations whose names match."""
        return sum(e - s for name, s, e, _ in self.device
                   if pattern.search(name)) / 1e6

    def host_s(self, names: Sequence[str]) -> float:
        """Host seconds covered by operators of these names (nested calls
        of them counted once), per thread, summed."""
        per = collections.defaultdict(list)
        for name, s, e, tid in self.host:
            if name in names:
                per[tid].append((s, e))
        return sum(b - a for ivs in per.values() for a, b in union(ivs)) / 1e6

    def device_s_under(self, names: Sequence[str]) -> Tuple[float, int]:
        """Device seconds of the operations launched while a host operator
        of these names ran on the launching thread, and how many."""
        per = collections.defaultdict(list)
        for name, s, e, tid in self.host:
            if name in names:
                per[tid].append((s, e))
        merged = {tid: union(ivs) for tid, ivs in per.items()}
        starts = {tid: [a for a, _ in ivs] for tid, ivs in merged.items()}
        launched = {corr: (t, tid) for corr, t, tid in self.launches}
        total, n = 0.0, 0
        for _, s, e, corr in self.device:
            hit = launched.get(corr)
            if hit is None or hit[1] not in merged:
                continue
            t, tid = hit
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and merged[tid][i][1] >= t:
                total += e - s
                n += 1
        return total / 1e6, n

    def main_thread(self) -> Optional[int]:
        c = collections.Counter(tid for _, _, tid in self.launches)
        return c.most_common(1)[0][0] if c else None

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host operator running on the launching
        thread at each gap's middle."""
        ops = collections.Counter()
        for name, s, e, _ in self.device:
            ops[name[:120]] += (e - s) / 1e6
        gaps = complement(self.busy_intervals(), self.span)
        tid = self.main_thread()
        host = sorted((h for h in self.host if h[3] == tid),
                      key=lambda h: (h[1], -h[2]))
        by = collections.Counter()
        stack: List[Tuple[str, float, float, int]] = []
        i = 0
        for a, b in sorted(gaps):
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][2] <= host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            by[stack[-1][0] if stack else "(no host operator)"] += \
                (b - a) / 1e6
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in by.most_common(top)]}


def union(ivs: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def complement(busy: Sequence[Interval], span: Interval) -> List[Interval]:
    lo, hi = span
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def from_profile(prof) -> Trace:
    """A `Trace` of a finished `torch.profiler.profile` whose stretch was
    marked with `record_function(STRETCH)`."""
    from torch.autograd import DeviceType

    device, host, launches, span = [], [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and name != STRETCH:
                device.append((name, start, end, e.correlation_id()))
        elif name in LAUNCH_NAMES:
            launches.append((e.correlation_id(), start, e.start_thread_id()))
        elif name == STRETCH:
            span = (start, end)
        else:
            host.append((name, start, end, e.start_thread_id()))
    if span is None:
        raise RuntimeError("the profile has no stretch marked "
                           f"{STRETCH!r}")
    lo, hi = span
    # device work launched inside the stretch may run past its end: the
    # stretch of whole solves ends at a synchronize, so it does not
    device = [d for d in device if d[2] > lo and d[1] < hi]
    host = [h for h in host if lo <= h[1] <= hi]
    launches = [x for x in launches if lo <= x[1] <= hi]
    corr = {c for c, _, _ in launches}
    linked = sum(1 for d in device if d[3] in corr)
    print(f"trace: {len(device)} device operations ({linked} linked to a "
          f"launch), {len(launches)} launch calls, {len(host)} host "
          f"operators, stretch {(hi - lo) / 1e6:.6f} s", file=sys.stderr)
    return Trace(span=span, device=device, host=host, launches=launches)
