"""Host-side continuous batching scheduler for map recoveries.

Port of ``quantized_spectrum_cartography_tpu/parallel/scheduler.py``.  The
reference processes one map per notebook run; serving needs a stream:
requests arrive, are grouped into fixed-shape device batches, solved by a
batched solver, and their results returned per request.  Pad slots (copies
of the batch's first request) keep the batch shape fixed when the queue
runs dry.

Threads: one dispatch thread collects requests, stacks them onto the
device and runs the solver; a pool of drain threads hands the results
back.  JAX dispatches a solve asynchronously, so its loop goes on
collecting while the device works.  The port's solver holds the dispatch
thread for its whole host loop instead, and a drain thread's plain
``.cpu()`` would queue on the default stream behind the *next* batch's
kernels and serialize the pipeline.  So on the card:

- the dispatch thread records a CUDA event after each solve;
- the batch's copies to pinned host buffers go on a side stream that waits
  on that event (and on nothing the next batch enqueues);
- a drain thread waits for that batch's copy event, and nothing else,
  before it resolves the batch's futures.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class _Request:
    payload: Dict[str, np.ndarray]
    future: Future


class RecoveryScheduler:
    """Continuous batching over a fixed-shape batched solver.

    solver_fn: dict of stacked tensors [B, ...] on `device` -> dict of
    stacked result tensors (on the device: the scheduler downloads them).
    batch_size: the static device batch (pad slots replicate request 0).
    Each request's result is a dict of numpy arrays, its row of each
    result.  `solve_seconds` holds the dispatch thread's host time per
    batch (stacking, upload and the solver's call), in dispatch order.
    """

    def __init__(
        self,
        solver_fn: Callable[[Dict[str, torch.Tensor]],
                            Dict[str, torch.Tensor]],
        batch_size: int,
        max_wait_ms: float = 50.0,
        pipeline_depth: int = 3,
        drain_threads: int = 2,
        device="cuda",
    ):
        """pipeline_depth bounds the batches in flight (dispatch runs ahead
        of result downloads); drain_threads download results concurrently,
        so that one batch's download overlaps the next one's."""
        self._solver = solver_fn
        self._batch = batch_size
        self._max_wait = max_wait_ms / 1000.0
        self._depth = max(1, pipeline_depth)
        self._drains = max(1, drain_threads)
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        if self._cuda:
            self._device = torch.device(
                "cuda", self._device.index if self._device.index is not None
                else torch.cuda.current_device())
            self._copy_stream = torch.cuda.Stream(device=self._device)
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._count_lock = threading.Lock()
        self.batches_dispatched = 0
        self.maps_completed = 0
        self.solve_seconds: List[float] = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, payload: Dict[str, np.ndarray]) -> Future:
        """Enqueue one map recovery; resolves to its result dict."""
        f: Future = Future()
        self._q.put(_Request(payload, f))
        return f

    def shutdown(self, wait: bool = True):
        """Stop collecting; requests still queued fail with RuntimeError."""
        self._stop.set()
        if wait:
            self._thread.join(timeout=30)

    # ------------------------------------------------------------------

    def _collect(self) -> List[_Request]:
        reqs: List[_Request] = []
        try:
            reqs.append(self._q.get(timeout=0.1))
        except queue.Empty:
            return reqs
        t0 = time.monotonic()
        while (len(reqs) < self._batch
               and (time.monotonic() - t0) < self._max_wait):
            try:
                reqs.append(self._q.get(timeout=0.005))
            except queue.Empty:
                pass
        return reqs

    def _stack(self, reqs: List[_Request]) -> Dict[str, torch.Tensor]:
        stacked = {}
        for k in reqs[0].payload:
            arrs = [np.asarray(r.payload[k]) for r in reqs]
            # pad to the static batch with copies of request 0
            arrs += [arrs[0]] * (self._batch - len(arrs))
            stacked[k] = torch.from_numpy(np.stack(arrs)).to(self._device)
        return stacked

    def _download(self, out: Dict[str, torch.Tensor]):
        """(host tensors being filled, event that marks them full or None)."""
        if not self._cuda:
            return {k: v.detach().cpu() for k, v in out.items()}, None
        solved = torch.cuda.Event()
        solved.record()                  # after the solve, on its stream
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(solved)
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    .copy_(v.detach(), non_blocking=True)
                    for k, v in out.items()}
            # a blocking event: its waiter sleeps instead of spinning on
            # a core the dispatch thread's host loop needs
            copied = torch.cuda.Event(blocking=True)
            copied.record(self._copy_stream)
        return host, copied

    def _drain(self, inflight: "queue.Queue", slots: threading.Semaphore):
        if self._cuda:
            torch.cuda.set_device(self._device)
        while True:
            item = inflight.get()
            if item is None:
                return
            reqs, out, host, copied, err = item
            del item
            try:
                if err is not None:
                    raise err
                if copied is not None:
                    copied.synchronize()    # this batch's copies only
                del out         # the device results may be reused now
                rows = {k: v.numpy() for k, v in host.items()}
                for i, r in enumerate(reqs):
                    r.future.set_result({k: v[i] for k, v in rows.items()})
                with self._count_lock:
                    self.maps_completed += len(reqs)
            except Exception as e:  # noqa: BLE001 -- resolves the futures
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
            finally:
                slots.release()

    def _loop(self):
        if self._cuda:
            torch.cuda.set_device(self._device)
        inflight: "queue.Queue" = queue.Queue()
        slots = threading.Semaphore(self._depth)
        drainers = [threading.Thread(target=self._drain,
                                     args=(inflight, slots), daemon=True)
                    for _ in range(self._drains)]
        for d in drainers:
            d.start()
        try:
            while not self._stop.is_set():
                reqs = self._collect()
                if not reqs:
                    continue
                slots.acquire()
                t0 = time.perf_counter()
                try:
                    out = self._solver(self._stack(reqs))
                    self.solve_seconds.append(time.perf_counter() - t0)
                    # `out` stays referenced until the batch is drained, so
                    # the allocator cannot hand its memory to the next
                    # batch while the side stream still copies it
                    inflight.put((reqs, out, *self._download(out), None))
                except Exception as e:  # noqa: BLE001 -- to the futures
                    inflight.put((reqs, None, None, None, e))
                self.batches_dispatched += 1
        finally:
            for _ in drainers:
                inflight.put(None)
            for d in drainers:
                d.join(timeout=30)
            err = RuntimeError("the scheduler was shut down")
            while True:
                try:
                    r = self._q.get_nowait()
                except queue.Empty:
                    break
                r.future.set_exception(err)
