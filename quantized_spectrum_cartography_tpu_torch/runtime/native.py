"""ctypes bindings for the native C++ host runtime (``runtime/cpp``).

Port of ``quantized_spectrum_cartography_tpu/runtime/native.py``, with the
same C API (``qsc_queue_*``, ``qsc_loader_*``).  The shared library is built
from the port's own copy of ``qsc_runtime.cpp`` with ``g++`` at first use,
into ``build/native_runtime/`` beside the package, named by a hash of the
source, the flags and the host (``-march=native`` ties the code to this
host's CPU), so later processes reuse it.  A failed build raises; nothing
falls back to a Python queue.  Components:

- NativeBatchQueue: MPMC batching queue of fixed-size byte payloads.
- NativeShardLoader: mmap + threaded-prefetch random-batch sampler over a
  raw float32 shard, and ordered row reads — the native replacement for
  the reference's file-per-index torch.load dataset
  (deep_prior/slf_dataset.py:107-110).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG_DIR = Path(__file__).resolve().parents[1]
_SRC = Path(__file__).resolve().parent / "cpp" / "qsc_runtime.cpp"
BUILD_DIR = _PKG_DIR.parent / "build" / "native_runtime"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
GXX_TIMEOUT_S = 120
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library for the current source, flags and host lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libqsc_runtime_{h.hexdigest()[:16]}.so"


def build_runtime() -> str:
    """Compile the shared library if no library for this source exists yet;
    returns its path.  Raises RuntimeError with g++'s output on failure."""
    out = library_path()
    with _lock:
        if out.exists():
            return str(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
            capture_output=True, text=True, timeout=GXX_TIMEOUT_S)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {_SRC}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)        # atomic: concurrent builds agree
    return str(out)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_runtime())
    lib.qsc_queue_create.restype = ctypes.c_void_p
    lib.qsc_queue_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.qsc_queue_push.restype = ctypes.c_int
    lib.qsc_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.qsc_queue_pop_batch.restype = ctypes.c_int
    lib.qsc_queue_pop_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int, ctypes.c_int]
    lib.qsc_queue_close.restype = None
    lib.qsc_queue_close.argtypes = [ctypes.c_void_p]
    lib.qsc_queue_pushed.restype = ctypes.c_uint64
    lib.qsc_queue_pushed.argtypes = [ctypes.c_void_p]
    lib.qsc_queue_popped.restype = ctypes.c_uint64
    lib.qsc_queue_popped.argtypes = [ctypes.c_void_p]
    lib.qsc_queue_destroy.restype = None
    lib.qsc_queue_destroy.argtypes = [ctypes.c_void_p]
    lib.qsc_loader_open.restype = ctypes.c_void_p
    lib.qsc_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_size_t, ctypes.c_int,
                                    ctypes.c_uint64]
    lib.qsc_loader_next.restype = ctypes.c_int
    lib.qsc_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int]
    lib.qsc_loader_num_items.restype = ctypes.c_size_t
    lib.qsc_loader_num_items.argtypes = [ctypes.c_void_p]
    lib.qsc_loader_read.restype = ctypes.c_int
    lib.qsc_loader_read.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_size_t, ctypes.c_void_p]
    lib.qsc_loader_batches_served.restype = ctypes.c_uint64
    lib.qsc_loader_batches_served.argtypes = [ctypes.c_void_p]
    lib.qsc_loader_close.restype = None
    lib.qsc_loader_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here (a probe: callers that
    need the runtime call it directly and get the build's error)."""
    try:
        _load()
        return True
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False


class NativeBatchQueue:
    """MPMC queue of fixed-size numpy payloads with batched pops."""

    def __init__(self, capacity: int, item_bytes: int):
        self._lib = _load()
        self._item_bytes = item_bytes
        self._q = self._lib.qsc_queue_create(capacity, item_bytes)

    def push(self, item: np.ndarray, timeout_ms: int = -1) -> bool:
        """Copy one payload in; False if the queue is closed or stays full
        past timeout_ms (-1: wait)."""
        buf = np.ascontiguousarray(item).tobytes()
        if len(buf) != self._item_bytes:
            raise ValueError(f"payload of {len(buf)} bytes, queue items are "
                             f"{self._item_bytes}")
        return bool(self._lib.qsc_queue_push(self._q, buf, timeout_ms))

    def pop_batch(self, max_items: int, timeout_ms: int = -1) -> np.ndarray:
        """Up to max_items payloads as uint8 [n, item_bytes], waiting up to
        timeout_ms for the first; n is 0 on timeout."""
        out = ctypes.create_string_buffer(self._item_bytes * max_items)
        n = self._lib.qsc_queue_pop_batch(self._q, out, max_items, timeout_ms)
        raw = np.frombuffer(out.raw[: n * self._item_bytes], dtype=np.uint8)
        return raw.reshape(n, self._item_bytes)

    @property
    def pushed(self) -> int:
        return int(self._lib.qsc_queue_pushed(self._q))

    @property
    def popped(self) -> int:
        return int(self._lib.qsc_queue_popped(self._q))

    def close(self):
        self._lib.qsc_queue_close(self._q)

    def __del__(self):
        if getattr(self, "_q", None):
            self._lib.qsc_queue_destroy(self._q)
            self._q = None


def write_shard(path: str, maps: np.ndarray) -> None:
    """Write maps [N, ...] as a raw float32 shard for NativeShardLoader."""
    arr = np.ascontiguousarray(maps, dtype=np.float32)
    arr.reshape(arr.shape[0], -1).tofile(path)


class NativeShardLoader:
    """Random-batch sampler over a float32 shard with C++ prefetch threads."""

    def __init__(self, path: str, item_shape, batch: int,
                 num_threads: int = 2, seed: int = 0):
        self._lib = _load()
        self._item_shape = tuple(item_shape)
        self._elems = int(np.prod(item_shape))
        self._batch = batch
        self._L = self._lib.qsc_loader_open(
            str(path).encode(), self._elems, batch, num_threads, seed)
        if not self._L:
            raise OSError(f"cannot open shard {path} "
                          f"(missing, empty, or size % item_bytes != 0)")

    def __len__(self):
        return int(self._lib.qsc_loader_num_items(self._L))

    @property
    def batches_served(self) -> int:
        return int(self._lib.qsc_loader_batches_served(self._L))

    def read(self, start: int, count: int) -> np.ndarray:
        """Ordered read of items [start, start+count) straight off the mmap
        (short at the end of the shard): deterministic per-rank feeding,
        independent of the sampling threads."""
        out = np.empty((count, self._elems), np.float32)
        n = self._lib.qsc_loader_read(
            self._L, start, count, out.ctypes.data_as(ctypes.c_void_p))
        return out[:n].reshape((n,) + self._item_shape)

    def next_batch(self, timeout_ms: int = -1) -> np.ndarray:
        out = np.empty((self._batch, self._elems), np.float32)
        ok = self._lib.qsc_loader_next(
            self._L, out.ctypes.data_as(ctypes.c_void_p), timeout_ms)
        if not ok:
            raise TimeoutError("loader timeout")
        return out.reshape((self._batch,) + self._item_shape)

    def close(self):
        if self._L:
            self._lib.qsc_loader_close(self._L)
            self._L = None

    def __del__(self):
        if getattr(self, "_L", None):
            self.close()
