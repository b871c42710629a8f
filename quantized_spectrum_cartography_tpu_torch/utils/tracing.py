"""Spans: where the host's time goes inside a solve or a served request,
recorded in-process and read without a profiler.

    from quantized_spectrum_cartography_tpu_torch.utils import tracing

    with tracing.span("qsc.lowrank.project"):
        ...
    records = tracing.spans()

A record is ``(name, start_ns, end_ns, span_id, parent_id, key,
thread_id)``: both ends stamped with ``time.time_ns()`` (the Unix epoch,
the clock ``torch.profiler``'s events are on, so spans lie against a
device trace without conversion), `parent_id` the innermost span open on
the same thread when it opened (None at the top), `key` whatever the
caller hands in (a batch's shape, a request or batch id), `thread_id` the
recording thread's `threading.get_ident()` (no system call: the OS thread
id takes one, 6.2 us on the H100 machine's host).  Records go into one
ring of the newest `CAPACITY`, shared by every thread of the process, so a
long-running server keeps its recent spans and does not grow.

Recording is on by default and costs two clock reads and an append a
span.  While a ``torch.profiler`` runs on the calling thread, a span also
opens a ``record_function`` range of its name, so a trace shows where the
host was between operators.  A span never synchronizes the device, reads
a tensor or changes a result.  Names start with ``qsc.``; the solver's and
the scheduler's are listed in README.md.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, List, Optional, Tuple

import torch

CAPACITY = 65536

Record = Tuple[str, int, int, int, Optional[int], Any, int]

_ring: "collections.deque[Record]" = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_enabled = True


def _open() -> list:
    """The calling thread's stack of open span ids."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """Context manager: records the block as one span.  `id`, `start_ns`
    and `end_ns` are the span's once stamped (None when recording is
    off)."""

    __slots__ = ("name", "key", "id", "parent", "start_ns", "end_ns", "_rf")

    def __init__(self, name: str, key: Any = None):
        self.name = name
        self.key = key
        self.id = self.start_ns = self.end_ns = None

    def __enter__(self) -> "span":
        if not _enabled:
            return self
        stack = _open()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.id is None:
            return False
        self.end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _open().pop()
        _ring.append((self.name, self.start_ns, self.end_ns, self.id,
                      self.parent, self.key, threading.get_ident()))
        return False


def mark(name: str, start_ns: int, end_ns: int, key: Any = None,
         parent_id: Optional[int] = None) -> Optional[int]:
    """Record an interval whose ends were stamped elsewhere (on other
    threads, say); returns its id, or None when recording is off."""
    if not _enabled:
        return None
    sid = next(_ids)
    _ring.append((name, start_ns, end_ns, sid, parent_id, key,
                  threading.get_ident()))
    return sid


def spans() -> List[Record]:
    """A copy of the recorded spans, oldest first."""
    while True:
        try:
            return list(_ring)
        except RuntimeError:        # appended to while copied: again
            continue


def clear() -> None:
    """Forget every recorded span."""
    _ring.clear()


def set_enabled(flag: bool) -> None:
    """Turn recording on or off for every thread (spans open now still
    close as they opened)."""
    global _enabled
    _enabled = bool(flag)
