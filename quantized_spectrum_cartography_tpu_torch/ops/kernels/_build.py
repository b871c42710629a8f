"""Build ``csrc/*.cu`` into one shared library with a single ``nvcc`` call,
and load it with ``ctypes``.

The library lands in ``build/torch_kernels/`` beside the package, named by a
hash of the sources and flags, so the first launch builds it (a few seconds)
and later processes reuse it.  Nothing builds at import time.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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


def build() -> Path:
    """Compile the sources if no library for them exists yet; return its path.

    ptxas' register and spill report goes to a ``.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return ctypes.CDLL(str(build()))
