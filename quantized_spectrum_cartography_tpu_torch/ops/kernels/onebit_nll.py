"""1-bit probit NLL of a rank-R reconstruction: plain PyTorch version and the
hand-written CUDA kernel pair (``csrc/onebit_nll.cu``).

Port of the 1-bit part of
``quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py``: the
kernels replace ``_fwd_kernel_1bit`` and ``_bwd_kernel_1bit``.  The numerics
(`_erf`, `_log_ndtr` from ``numerics.py``, `_hazard_ratio`) are that module's
own formulas, in both the plain version and the kernels, so the port stays
at parity with the JAX package.

Layout: S_flat [B, R, P], C [B, K, R], codes int8 [B, K, P] with P = I*J
(no lane padding).  Both versions return one NLL (a sum) per map.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  ``mode="plain"`` forces the plain version on any device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from quantized_spectrum_cartography_tpu_torch.ops.kernels._build import (
    raise_on_error,
)
from quantized_spectrum_cartography_tpu_torch.ops.kernels.numerics import (
    _INV_SQRT2,
    _LOG_SQRT_2PI,
    _erf,
    _inv_s,
    _log_ndtr,
    _mills_series,
)

# as in csrc/onebit_nll.cu: ranks instantiated; and a cap on K*R, (1 +
# _WARPS)*K*R floats within the default 48 KB of dynamic shared memory per
# block, which covers what the backward takes (3*K*R floats and at most
# 24 KB for adding the dS of its thread groups)
_MAX_RANK = 16
_WARPS = 8
_SMEM_LIMIT = 48 * 1024


def pack_codes_1bit(
    y01: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """1-bit observations [..., K, I, J] as int8 codes [..., K, I*J]:
    y=0 -> 0, y=1 -> 1, masked -> 2.  Do this once per solve."""
    codes = (y01 > 0.5).to(torch.int8)
    if mask is not None:
        codes = torch.where(mask > 0, codes, torch.full_like(codes, 2))
    return codes.flatten(-2).contiguous()


# --------------------------------------------------------------------------
# numerics of the JAX kernel (fused_likelihood.py:608-627); _erf and
# _log_ndtr are shared with the ordinal kernels (numerics.py)
# --------------------------------------------------------------------------

def _hazard_ratio(t: torch.Tensor) -> torch.Tensor:
    """phi(t)/Phi(t): direct above t=-4 (denominator floored at 1e-30), the
    Mills series -t/(1 - 1/t^2 + 3/t^4 - 15/t^6) below it."""
    t_dir = t.clamp(min=-4.0)
    num = torch.exp(-0.5 * t_dir * t_dir - _LOG_SQRT_2PI)
    den = 0.5 * (1.0 + _erf(t_dir * _INV_SQRT2))
    direct = num / den.clamp(min=1e-30)
    safe_t = t.clamp(max=-4.0)
    tail = -safe_t / _mills_series(safe_t)
    return torch.where(t < -4.0, tail, direct)


def _signs_and_t(S_flat, C, codes, mean, sigma):
    X = torch.matmul(C, S_flat)                               # [B, K, P]
    sgn = torch.where(codes == 1, 1.0, torch.where(codes == 0, -1.0, 0.0))
    sgn = sgn.to(S_flat.dtype)
    return sgn, sgn * ((X - mean) * _inv_s(sigma))


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def onebit_nll_plain(S_flat, C, codes, mean: float, sigma: float):
    """Plain forward: nll[b] = -sum |sgn| * logPhi(t), t = sgn*(C@S - mean)/s."""
    sgn, t = _signs_and_t(S_flat, C, codes, mean, sigma)
    return -(sgn.abs() * _log_ndtr(t)).sum(dim=(-2, -1))


def onebit_nll_grad_plain(S_flat, C, codes, g, mean: float, sigma: float):
    """Plain backward: dX = g * (-1/s) * sgn * phi/Phi(t); dS = Cᵀ dX,
    dC = dX Sᵀ."""
    sgn, t = _signs_and_t(S_flat, C, codes, mean, sigma)
    dX = (g * -_inv_s(sigma))[:, None, None] * sgn * _hazard_ratio(t)
    dS = torch.matmul(C.transpose(-1, -2), dX)
    dC = torch.matmul(dX, S_flat.transpose(-1, -2))
    return dS, dC


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    from quantized_spectrum_cartography_tpu_torch.ops.kernels._build import (
        load_library,
    )

    lib = load_library()
    for fn in (lib.qsc_onebit_cols, lib.qsc_onebit_blocks):
        fn.restype = _I
    lib.qsc_onebit_cols.argtypes = [_I, _I]
    lib.qsc_onebit_blocks.argtypes = [_I] * 4
    lib.qsc_onebit_nll_fwd.argtypes = [_P] * 5 + [_I] * 4 + [_F, _F, _P]
    lib.qsc_onebit_nll_fwd.restype = _I
    lib.qsc_onebit_nll_bwd.argtypes = [_P] * 7 + [_I] * 4 + [_F, _F, _P]
    lib.qsc_onebit_nll_bwd.restype = _I
    return lib


def _check(S_flat, C, codes, g=None):
    """Validate what the kernels take; return (B, R, K, P)."""
    tensors = [S_flat, C, codes] + ([] if g is None else [g])
    if any(x.device.type != "cuda" for x in tensors):
        raise ValueError("the CUDA kernels take CUDA tensors only")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("inputs lie on different devices")
    if S_flat.dim() != 3 or C.dim() != 3 or codes.dim() != 3:
        raise ValueError("expected S_flat [B,R,P], C [B,K,R], codes [B,K,P]")
    B, R, P = S_flat.shape
    K = C.shape[1]
    if C.shape != (B, K, R) or codes.shape != (B, K, P):
        raise ValueError(f"shape mismatch: S_flat {tuple(S_flat.shape)}, "
                         f"C {tuple(C.shape)}, codes {tuple(codes.shape)}")
    if g is not None and g.shape != (B,):
        raise ValueError(f"g must be [B]={B}, got {tuple(g.shape)}")
    if S_flat.dtype != torch.float32 or C.dtype != torch.float32:
        raise TypeError("S_flat and C must be float32")
    if codes.dtype != torch.int8:
        raise TypeError("codes must be int8")
    if g is not None and g.dtype != torch.float32:
        raise TypeError("g must be float32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("inputs must be contiguous")
    if not 1 <= R <= _MAX_RANK:
        raise ValueError(f"rank {R} outside the kernels' 1..{_MAX_RANK}")
    if (1 + _WARPS) * K * R * 4 > _SMEM_LIMIT:
        raise ValueError(f"K*R = {K * R} needs more than 48 KB of shared memory")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 maps")
    return B, R, K, P


def _nblk(R: int, K: int, P: int, bwd: bool) -> int:
    """Partial sums per map of the forward or backward kernel: the size of
    its scratch (the kernels pick their tiling from R, K and P)."""
    return _lib().qsc_onebit_blocks(R, K, P, int(bwd))


def onebit_nll_fwd_cuda(S_flat, C, codes, mean: float, sigma: float):
    """Forward kernel: nll [B].  Counts its launches in ``.launches``."""
    B, R, K, P = _check(S_flat, C, codes)
    lib = _lib()
    partial = torch.empty(B, _nblk(R, K, P, False), device=S_flat.device)
    out = torch.empty(B, device=S_flat.device)
    with torch.cuda.device(S_flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qsc_onebit_nll_fwd(
            S_flat.data_ptr(), C.data_ptr(), codes.data_ptr(),
            partial.data_ptr(), out.data_ptr(), B, R, K, P,
            float(mean), _inv_s(sigma), stream)
    raise_on_error(err, "onebit_nll_fwd")
    onebit_nll_fwd_cuda.launches += 1
    return out


def onebit_nll_bwd_cuda(S_flat, C, codes, g, mean: float, sigma: float):
    """Backward kernel: (dS [B,R,P], dC [B,K,R]).  Counts its launches in
    ``.launches``."""
    B, R, K, P = _check(S_flat, C, codes, g)
    lib = _lib()
    dS = torch.empty_like(S_flat)
    dC = torch.empty_like(C)
    partial = torch.empty(B, _nblk(R, K, P, True), K * R, device=S_flat.device)
    with torch.cuda.device(S_flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qsc_onebit_nll_bwd(
            S_flat.data_ptr(), C.data_ptr(), codes.data_ptr(), g.data_ptr(),
            dS.data_ptr(), partial.data_ptr(), dC.data_ptr(), B, R, K, P,
            float(mean), _inv_s(sigma), stream)
    raise_on_error(err, "onebit_nll_bwd")
    onebit_nll_bwd_cuda.launches += 1
    return dS, dC


onebit_nll_fwd_cuda.launches = 0
onebit_nll_bwd_cuda.launches = 0


def reset_launches():
    onebit_nll_fwd_cuda.launches = 0
    onebit_nll_bwd_cuda.launches = 0


# --------------------------------------------------------------------------
# autograd entry point
# --------------------------------------------------------------------------

class _FusedOnebitNLL(torch.autograd.Function):

    @staticmethod
    def forward(ctx, S_flat, C, codes, mean, sigma, plain):
        ctx.save_for_backward(S_flat, C, codes)
        ctx.mean, ctx.sigma, ctx.plain = mean, sigma, plain
        if plain:
            return onebit_nll_plain(S_flat, C, codes, mean, sigma)
        return onebit_nll_fwd_cuda(S_flat, C, codes, mean, sigma)

    @staticmethod
    def backward(ctx, g):
        S_flat, C, codes = ctx.saved_tensors
        if ctx.plain:
            dS, dC = onebit_nll_grad_plain(S_flat, C, codes, g, ctx.mean,
                                           ctx.sigma)
        else:
            dS, dC = onebit_nll_bwd_cuda(S_flat, C, codes, g.contiguous(),
                                         ctx.mean, ctx.sigma)
        return dS, dC, None, None, None, None


def fused_onebit_nll(
    S_flat: torch.Tensor,    # [B, R, P]
    C: torch.Tensor,         # [B, K, R]
    codes: torch.Tensor,     # [B, K, P] int8 from pack_codes_1bit
    mean: float,
    sigma: float,
    mode: str = "auto",
) -> torch.Tensor:
    """1-bit probit NLL (sum over each map's entries) -> [B], with an
    analytic backward.  Masked entries (code 2) contribute exactly zero.

    mode="auto": the kernels for CUDA tensors, the plain version for CPU
    tensors; mode="plain": the plain version on any device."""
    if mode not in ("auto", "plain"):
        raise ValueError(f"unknown mode {mode!r}: 'auto' or 'plain'")
    plain = mode == "plain" or S_flat.device.type == "cpu"
    return _FusedOnebitNLL.apply(S_flat, C, codes, float(mean), float(sigma),
                                 plain)
