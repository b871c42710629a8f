"""Thin Householder QR of a batch of small matrices: the hand-written CUDA
kernel (``csrc/householder_qr.cu``) and its dispatch.

`project_rank_subspace` orthonormalizes Y [..., m, k] (k <= m) twice a
projection.  ``torch.linalg.qr`` on CUDA runs such a batch matrix by
matrix; the kernel factorizes the whole batch in one launch.  It takes
LAPACK's conventions (dlarfg's reflectors, beta = -sign(alpha)||x||, tau =
0 where the column below the diagonal is all zero; orgqr's explicit Q, the
reflectors applied backward to the first k columns of the identity), so Q
is the one ``torch.linalg.qr`` returns up to rounding.

Dispatch: a CPU tensor takes ``torch.linalg.qr`` (LAPACK, one call for the
batch); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from quantized_spectrum_cartography_tpu_torch.ops.kernels._build import (
    raise_on_error,
)

# as in csrc/householder_qr.cu: the opt-in shared memory a block may take
_SMEM_LIMIT = 227 * 1024


def _smem_bytes(m: int, k: int) -> int:
    """The kernel's shared memory: Y's reflectors and Q, m*k floats each,
    and k taus."""
    return (2 * m * k + k) * 4


def _check_shape(Y: torch.Tensor):
    """Validate what either device takes; return (N, m, k)."""
    if Y.dim() < 2:
        raise ValueError(f"expected Y [..., m, k], got {tuple(Y.shape)}")
    if Y.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Y must be float32 or float64, got {Y.dtype}")
    m, k = Y.shape[-2:]
    if not 1 <= k <= m:
        raise ValueError(f"the thin QR needs 1 <= k <= m, got m={m}, k={k}")
    N = math.prod(Y.shape[:-2])
    if N == 0:
        raise ValueError(f"empty batch {tuple(Y.shape)}")
    return N, m, k


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from quantized_spectrum_cartography_tpu_torch.ops.kernels._build import (
        load_library,
    )

    lib = load_library()
    lib.qsc_householder_qr.argtypes = [_P, _P, _I, _I, _I, _P]
    lib.qsc_householder_qr.restype = _I
    return lib


def householder_qr_cuda(Y: torch.Tensor) -> torch.Tensor:
    """Q [..., m, k] of a CUDA f32 Y [..., m, k] in one launch.  Counts its
    launches in ``.launches``."""
    if Y.device.type != "cuda":
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    N, m, k = _check_shape(Y)
    if Y.dtype != torch.float32:
        raise TypeError("the CUDA kernel takes float32 only")
    if not Y.is_contiguous():
        raise ValueError("Y must be contiguous")
    if _smem_bytes(m, k) > _SMEM_LIMIT:
        raise ValueError(f"m={m}, k={k} needs {_smem_bytes(m, k)} bytes of "
                         f"shared memory, more than {_SMEM_LIMIT}")
    if N >= 2 ** 31:
        raise ValueError(f"batch {N} exceeds the grid's 2**31 - 1 matrices")
    lib = _lib()
    Q = torch.empty_like(Y)
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qsc_householder_qr(Y.data_ptr(), Q.data_ptr(), N, m, k,
                                     stream)
    raise_on_error(err, "householder_qr")
    householder_qr_cuda.launches += 1
    return Q


householder_qr_cuda.launches = 0


def reset_launches():
    householder_qr_cuda.launches = 0


def householder_qr(Y: torch.Tensor) -> torch.Tensor:
    """Q [..., m, k] with orthonormal columns spanning Y [..., m, k]
    (k <= m), as ``torch.linalg.qr(Y)[0]``: the kernel for a CUDA tensor,
    LAPACK for a CPU tensor."""
    if Y.device.type == "cpu":
        _check_shape(Y)
        return torch.linalg.qr(Y)[0]
    return householder_qr_cuda(Y)
