"""Build ``csrc/*.cu`` into one shared library, and load it with ``ctypes``.

Each source is compiled by its own ``nvcc`` process, all started together,
and one more ``nvcc`` call links the objects.  The library lands in
``build/torch_kernels/`` beside the package, named by a hash of the sources
and flags, so the first launch builds it and later processes reuse it.
Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
NVCC_TIMEOUT_S = 300


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libqsc_torch_kernels_{h.hexdigest()[:16]}.so"


def _run(procs, log):
    """Wait for every process; append its output to `log`; raise on failure."""
    failed = []
    for name, proc in procs:
        try:
            out, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, p in procs:
                p.kill()
            raise RuntimeError(f"nvcc on {name} ran past {NVCC_TIMEOUT_S} s")
        log.append(f"== {name}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{err[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> Path:
    """Compile the sources if no library for them exists yet; return its path.

    ptxas' register and spill report goes to a ``.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in cu]
    log = []
    try:
        _run([(src.name, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for src, obj in zip(cu, objs)], log)
        tmp = BUILD_DIR / f"{stem}.tmp"
        _run([("link", subprocess.Popen(
            [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))], log)
        os.replace(tmp, out)
    finally:
        out.with_suffix(".log").write_text("".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return ctypes.CDLL(str(build()))


def raise_on_error(err: int, what: str) -> None:
    """Raise if a kernel library call returned a cudaError_t other than 0."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
