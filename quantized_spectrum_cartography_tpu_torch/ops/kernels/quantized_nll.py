"""Ordinal (multi-bit) probit NLL of a rank-R reconstruction: plain PyTorch
versions and the hand-written CUDA kernels (one tile body,
``csrc/ordinal_tile.cuh``, on f32 bounds in ``csrc/quantized_nll.cu`` and on
int8 codes in ``csrc/quantized_nll_coded.cu``).

Port of the ordinal part of
``quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py``: the
kernels replace ``_fwd_kernel``/``_bwd_kernel`` (observations as f32 bin
bounds W, U) and ``_fwd_kernel_coded``/``_bwd_kernel_coded`` (int8 bin codes
decoded with a boundary table).  Per map,

    nll = -sum_{k,p} log(Phi((U - x)/s) - Phi((W - x)/s)),
    x = log(C @ S + offset)   (log link)   or   C @ S   (linear link),

with the JAX kernels' numerics (`_log_prob` robust in both tails, or the
direct `_log_prob_fast` where `_fast_ok(sigma)`), in both the plain versions
and the kernels.  Masked entries, bounds (-MASK_SENTINEL, +MASK_SENTINEL) or
code == nbins, add exactly 0 to the value and to the gradient.

Layout: S_flat [B, R, P], C [B, K, R], W, U [B, K, P] f32 or codes [B, K, P]
int8, P = I*J (no lane padding); one NLL per map.  The forward also serves
the z-search (`score_quantized_nll`): there an input with a leading size of 1
is shared by all B maps, read by the kernel with a batch stride of 0.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  ``mode="plain"`` forces the plain version on any device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from quantized_spectrum_cartography_tpu_torch.ops.kernels._build import (
    raise_on_error,
)
from quantized_spectrum_cartography_tpu_torch.ops.kernels.numerics import (
    _LOG_SQRT_2PI,
    _INV_SQRT2,
    _erf,
    _inv_s,
    _log_ndtr,
)

MASK_SENTINEL = 1e4     # |log-domain values| are < 30; +-1e4 => logP = 0
_CODED_MAX_BINS = 32
_MAX_RANK = 16          # ranks the kernels are instantiated for
_MAX_P = 2 ** 25        # a chunk of 64 bands indexed in 32 bits


# --------------------------------------------------------------------------
# observation packing (once per solve)
# --------------------------------------------------------------------------

def _fold_mask(W, U, mask):
    if mask is None:
        return W, U
    mf = mask.flatten(-2) > 0
    return (torch.where(mf, W, -MASK_SENTINEL),
            torch.where(mf, U, MASK_SENTINEL))


def pack_bounds(
    Y: torch.Tensor,
    bin_boundaries: Sequence[float],
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, U) [..., K, I*J] f32 from bin indices Y [..., K, I, J], with
    masked entries folded to (-MASK_SENTINEL, +MASK_SENTINEL)."""
    bb = torch.as_tensor(bin_boundaries, dtype=torch.float32,
                         device=Y.device)
    Yf = Y.flatten(-2).long()
    return _fold_mask(bb[Yf], bb[Yf + 1], mask)


def pack_bounds_1bit(
    y01: torch.Tensor,
    mean: float,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-bit observations [..., K, I, J] as the 2-bin ordinal case of the
    linear link: y=1 -> (mean, +S), y=0 -> (-S, mean), S = MASK_SENTINEL."""
    yf = y01.flatten(-2) > 0.5
    W = torch.where(yf, float(mean), -MASK_SENTINEL).float()
    U = torch.where(yf, MASK_SENTINEL, float(mean)).float()
    return _fold_mask(W, U, mask)


def pack_codes(
    Y: torch.Tensor,
    num_bins: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int8 codes [..., K, I*J] from bin indices Y [..., K, I, J] in
    [0, num_bins); masked entries get code == num_bins."""
    if num_bins >= _CODED_MAX_BINS:
        raise ValueError(f"num_bins {num_bins} > {_CODED_MAX_BINS}")
    Yf = Y.flatten(-2).long()
    if mask is not None:
        Yf = torch.where(mask.flatten(-2) > 0, Yf, num_bins)
    return Yf.to(torch.int8).contiguous()


def onebit_bounds(mean: float) -> Tuple[float, float, float]:
    """Boundary tuple of the 1-bit linear-link case (2 bins split at
    `mean`): code 0 -> (-inf, mean), 1 -> (mean, +inf)."""
    return (-MASK_SENTINEL, float(mean), MASK_SENTINEL)


def _bounds_from_codes(codes: torch.Tensor, bb_vals: Sequence[float]):
    """(W, U) from codes: code i < nbins -> (bb[i], bb[i+1]); anything else
    -> (-MASK_SENTINEL, +MASK_SENTINEL)."""
    n = len(bb_vals) - 1
    lo = torch.tensor(list(bb_vals[:-1]) + [-MASK_SENTINEL],
                      dtype=torch.float32, device=codes.device)
    hi = torch.tensor(list(bb_vals[1:]) + [MASK_SENTINEL],
                      dtype=torch.float32, device=codes.device)
    c = codes.long()
    idx = torch.where((c >= 0) & (c < n), c, n)
    return lo[idx], hi[idx]


# --------------------------------------------------------------------------
# numerics of the JAX kernels (fused_likelihood.py:69-150)
# --------------------------------------------------------------------------

def _log1mexp(d: torch.Tensor) -> torch.Tensor:
    """log(1 - e^d) for d <= -1e-12: a series above -ln 2, direct below."""
    d_small = d.clamp(-0.6931472, -1e-12)
    series = 1.0 + d_small * (0.5 + d_small * (
        1.0 / 6.0 + d_small * (1.0 / 24.0 + d_small / 120.0)))
    small_val = torch.log(-d_small * series)
    d_large = d.clamp(max=-0.6931472)
    large_val = torch.log(1.0 - torch.exp(d_large))
    return torch.where(d > -0.6931472, small_val, large_val)


def _log_prob(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(Phi(b) - Phi(a)), b > a, with the anchor in the larger tail."""
    flip = (a + b) > 0.0
    lo = torch.where(flip, -b, a)
    hi = torch.where(flip, -a, b)
    l_hi = _log_ndtr(hi)
    diff = (_log_ndtr(lo) - l_hi).clamp(max=-1e-12)
    return l_hi + _log1mexp(diff)


def _dlogp_dx(a, b, logP, inv_s: float) -> torch.Tensor:
    """d log P / dx = (phi(a) - phi(b)) / (s P), as exp of log differences
    capped at 30, so tail ratios stay finite."""
    log_phi_a = -0.5 * a * a - _LOG_SQRT_2PI
    log_phi_b = -0.5 * b * b - _LOG_SQRT_2PI
    ra = torch.exp((log_phi_a - logP).clamp(max=30.0))
    rb = torch.exp((log_phi_b - logP).clamp(max=30.0))
    return (ra - rb) * inv_s


def _log_prob_fast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct log((erf(b/sqrt2) - erf(a/sqrt2))/2), floored at 1e-38."""
    ea = _erf(a * _INV_SQRT2)
    eb = _erf(b * _INV_SQRT2)
    return torch.log((0.5 * (eb - ea)).clamp(min=1e-38))


def _fast_ok(sigma: float) -> bool:
    """The direct form stays out of the deep tail iff sigma >= 2."""
    return float(sigma) >= 2.0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _entries(S_flat, C, W, U, sigma, offset, linear, fast):
    X = torch.matmul(C, S_flat)                               # [B, K, P]
    Xo = X + offset
    x = X if linear else torch.log(Xo)
    a = (W - x) * _inv_s(sigma)
    b = (U - x) * _inv_s(sigma)
    logP = _log_prob_fast(a, b) if fast else _log_prob(a, b)
    return Xo, a, b, logP


def quantized_nll_plain(S_flat, C, W, U, sigma: float, offset: float,
                        linear: bool = False, fast: bool = False):
    """Plain forward: nll [B].  Inputs of leading size 1 broadcast."""
    logP = _entries(S_flat, C, W, U, sigma, offset, linear, fast)[3]
    return -logP.sum(dim=(-2, -1))


def quantized_nll_grad_plain(S_flat, C, W, U, g, sigma: float,
                             offset: float, linear: bool = False,
                             fast: bool = False):
    """Plain analytic backward: dX = -g * dlogP/dx * (1 or 1/(X+offset));
    dS = Cᵀ dX, dC = dX Sᵀ."""
    Xo, a, b, logP = _entries(S_flat, C, W, U, sigma, offset, linear, fast)
    dlogp = _dlogp_dx(a, b, logP, _inv_s(sigma))
    dX = -g[:, None, None] * (dlogp if linear else dlogp / Xo)
    dS = torch.matmul(C.transpose(-1, -2), dX)
    dC = torch.matmul(dX, S_flat.transpose(-1, -2))
    return dS, dC


def quantized_nll_coded_plain(S_flat, C, codes, bb_vals, sigma: float,
                              offset: float, linear: bool = False,
                              fast: bool = False):
    """Plain coded forward: the bounds version on decoded (W, U)."""
    W, U = _bounds_from_codes(codes, bb_vals)
    return quantized_nll_plain(S_flat, C, W, U, sigma, offset, linear, fast)


def quantized_nll_coded_grad_plain(S_flat, C, codes, bb_vals, g,
                                   sigma: float, offset: float,
                                   linear: bool = False, fast: bool = False):
    """Plain coded backward: the bounds version on decoded (W, U)."""
    W, U = _bounds_from_codes(codes, bb_vals)
    return quantized_nll_grad_plain(S_flat, C, W, U, g, sigma, offset,
                                    linear, fast)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_TABLE = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=None)
def _lib():
    from quantized_spectrum_cartography_tpu_torch.ops.kernels._build import (
        load_library,
    )

    lib = load_library()
    lib.qsc_qnll_tiles.restype = _I
    lib.qsc_qnll_tiles.argtypes = [_I]
    tail = [_I] * 4 + [_L] * 3 + [_F] * 2 + [_I] * 2 + [_P]
    lib.qsc_qnll_fwd.argtypes = [_P] * 6 + tail
    lib.qsc_qnll_bwd.argtypes = [_P] * 8 + tail
    lib.qsc_qnll_coded_fwd.argtypes = [_P] * 3 + [_TABLE, _I] + [_P] * 2 + tail
    lib.qsc_qnll_coded_bwd.argtypes = [_P] * 3 + [_TABLE, _I] + [_P] * 4 + tail
    for fn in (lib.qsc_qnll_fwd, lib.qsc_qnll_bwd, lib.qsc_qnll_coded_fwd,
               lib.qsc_qnll_coded_bwd):
        fn.restype = _I
    return lib


def _check(S_flat, C, obs, g=None):
    """Validate what the kernels take; return (B, R, K, P, batch strides of
    S, C and the observations).  The forward (g None) shares an input of
    leading size 1 across the batch; the backward takes per-map inputs.
    The kernels' shared memory depends on R only (csrc/ordinal_tile.cuh),
    so K is free."""
    tensors = [S_flat, C, *obs] + ([] if g is None else [g])
    if any(x.device.type != "cuda" for x in tensors):
        raise ValueError("the CUDA kernels take CUDA tensors only")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("inputs lie on different devices")
    if any(x.dim() != 3 for x in [S_flat, C, *obs]):
        raise ValueError("expected S_flat [B,R,P], C [B,K,R] and "
                         "observations [B,K,P]")
    R, P = S_flat.shape[1:]
    K = C.shape[1]
    sizes = [S_flat.shape[0], C.shape[0]] + [o.shape[0] for o in obs]
    B = max(sizes)
    if (C.shape[2] != R or any(o.shape[1:] != (K, P) for o in obs)
            or len({o.shape[0] for o in obs}) != 1
            or any(n not in (1, B) for n in sizes)):
        raise ValueError(f"shape mismatch: S_flat {tuple(S_flat.shape)}, "
                         f"C {tuple(C.shape)}, observations "
                         f"{[tuple(o.shape) for o in obs]}")
    if g is not None and (min(sizes) != B or g.shape != (B,)):
        raise ValueError("the backward takes per-map inputs and g [B]")
    if any(x.dtype != torch.float32
           for x in [S_flat, C] + ([] if g is None else [g])):
        raise TypeError("S_flat, C and g must be float32")
    if len(obs) == 2 and any(o.dtype != torch.float32 for o in obs):
        raise TypeError("W and U must be float32")
    if len(obs) == 1 and obs[0].dtype != torch.int8:
        raise TypeError("codes must be int8")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("inputs must be contiguous")
    if not 1 <= R <= _MAX_RANK:
        raise ValueError(f"rank {R} outside the kernels' 1..{_MAX_RANK}")
    if P >= _MAX_P:
        raise ValueError(f"{P} columns: the kernels take fewer than {_MAX_P}")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 maps")
    strides = tuple(0 if n == 1 else x[0].numel()
                    for n, x in zip(sizes, [S_flat, C, obs[0]]))
    return B, R, K, P, strides


@functools.lru_cache(maxsize=None)
def _table(bb_vals: Tuple[float, ...]):
    """The boundary table as a ctypes array, and nbins; one per table."""
    n = len(bb_vals) - 1
    if not 1 <= n < _CODED_MAX_BINS:
        raise ValueError(f"{n} bins outside 1..{_CODED_MAX_BINS - 1}")
    return (ctypes.c_float * (n + 1))(*map(float, bb_vals)), n


@functools.lru_cache(maxsize=None)
def _nblk(P: int) -> int:
    """Partial sums per map: the size of a kernel's scratch."""
    return _lib().qsc_qnll_tiles(P)


def _launch(fn, name, S_flat, *args):
    with torch.cuda.device(S_flat.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    raise_on_error(err, name)


def _fwd_cuda(S_flat, C, obs, bb_vals, sigma, offset, linear, fast):
    B, R, K, P, (sS, sC, sO) = _check(S_flat, C, obs)
    lib = _lib()
    coded = bb_vals is not None
    # the output and the scratch in one allocation
    buf = torch.empty(B * (1 + _nblk(P)), device=S_flat.device)
    out, partial = buf[:B], buf[B:]
    tail = (B, R, K, P, sS, sC, sO, _inv_s(sigma), float(offset),
            int(linear), int(fast))
    if coded:
        _launch(lib.qsc_qnll_coded_fwd, "quantized_nll_coded_fwd", S_flat,
                S_flat.data_ptr(), C.data_ptr(), obs[0].data_ptr(),
                *_table(tuple(bb_vals)), partial.data_ptr(), out.data_ptr(),
                *tail)
    else:
        _launch(lib.qsc_qnll_fwd, "quantized_nll_fwd", S_flat,
                S_flat.data_ptr(), C.data_ptr(), obs[0].data_ptr(),
                obs[1].data_ptr(), partial.data_ptr(), out.data_ptr(), *tail)
    return out


def _bwd_cuda(S_flat, C, obs, bb_vals, g, sigma, offset, linear, fast):
    B, R, K, P, (sS, sC, sO) = _check(S_flat, C, obs, g)
    lib = _lib()
    coded = bb_vals is not None
    dS = torch.empty_like(S_flat)
    dC = torch.empty_like(C)
    partial = torch.empty(B, _nblk(P), K * R, device=S_flat.device)
    ptrs = (g.data_ptr(), dS.data_ptr(), partial.data_ptr(), dC.data_ptr())
    tail = (B, R, K, P, sS, sC, sO, _inv_s(sigma), float(offset),
            int(linear), int(fast))
    if coded:
        _launch(lib.qsc_qnll_coded_bwd, "quantized_nll_coded_bwd", S_flat,
                S_flat.data_ptr(), C.data_ptr(), obs[0].data_ptr(),
                *_table(tuple(bb_vals)), *ptrs, *tail)
    else:
        _launch(lib.qsc_qnll_bwd, "quantized_nll_bwd", S_flat,
                S_flat.data_ptr(), C.data_ptr(), obs[0].data_ptr(),
                obs[1].data_ptr(), *ptrs, *tail)
    return dS, dC


def quantized_nll_fwd_cuda(S_flat, C, W, U, sigma: float, offset: float,
                           linear: bool = False, fast: bool = False):
    """Bounds forward kernel: nll [B].  Counts its launches in ``.launches``."""
    out = _fwd_cuda(S_flat, C, (W, U), None, sigma, offset, linear, fast)
    quantized_nll_fwd_cuda.launches += 1
    return out


def quantized_nll_bwd_cuda(S_flat, C, W, U, g, sigma: float, offset: float,
                           linear: bool = False, fast: bool = False):
    """Bounds backward kernel: (dS [B,R,P], dC [B,K,R]).  Counts its
    launches in ``.launches``."""
    out = _bwd_cuda(S_flat, C, (W, U), None, g, sigma, offset, linear, fast)
    quantized_nll_bwd_cuda.launches += 1
    return out


def quantized_nll_coded_fwd_cuda(S_flat, C, codes, bb_vals, sigma: float,
                                 offset: float, linear: bool = False,
                                 fast: bool = False):
    """Coded forward kernel: nll [B].  Counts its launches in ``.launches``."""
    out = _fwd_cuda(S_flat, C, (codes,), bb_vals, sigma, offset, linear, fast)
    quantized_nll_coded_fwd_cuda.launches += 1
    return out


def quantized_nll_coded_bwd_cuda(S_flat, C, codes, bb_vals, g, sigma: float,
                                 offset: float, linear: bool = False,
                                 fast: bool = False):
    """Coded backward kernel: (dS [B,R,P], dC [B,K,R]).  Counts its
    launches in ``.launches``."""
    out = _bwd_cuda(S_flat, C, (codes,), bb_vals, g, sigma, offset, linear,
                    fast)
    quantized_nll_coded_bwd_cuda.launches += 1
    return out


_KERNELS = (quantized_nll_fwd_cuda, quantized_nll_bwd_cuda,
            quantized_nll_coded_fwd_cuda, quantized_nll_coded_bwd_cuda)


def reset_launches():
    for fn in _KERNELS:
        fn.launches = 0


reset_launches()


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def _forward(S_flat, C, obs, bb_vals, sigma, offset, linear, fast, plain):
    if plain:
        if bb_vals is None:
            return quantized_nll_plain(S_flat, C, *obs, sigma, offset,
                                       linear, fast)
        return quantized_nll_coded_plain(S_flat, C, obs[0], bb_vals, sigma,
                                         offset, linear, fast)
    if bb_vals is None:
        return quantized_nll_fwd_cuda(S_flat, C, *obs, sigma, offset,
                                      linear, fast)
    return quantized_nll_coded_fwd_cuda(S_flat, C, obs[0], bb_vals, sigma,
                                        offset, linear, fast)


def _backward(S_flat, C, obs, bb_vals, g, sigma, offset, linear, fast, plain):
    if plain:
        if bb_vals is None:
            return quantized_nll_grad_plain(S_flat, C, *obs, g, sigma,
                                            offset, linear, fast)
        return quantized_nll_coded_grad_plain(S_flat, C, obs[0], bb_vals, g,
                                              sigma, offset, linear, fast)
    if bb_vals is None:
        return quantized_nll_bwd_cuda(S_flat, C, *obs, g, sigma, offset,
                                      linear, fast)
    return quantized_nll_coded_bwd_cuda(S_flat, C, obs[0], bb_vals, g, sigma,
                                        offset, linear, fast)


class _QuantizedNLL(torch.autograd.Function):
    """Both encodings: obs is (W, U) with bb_vals None, or (codes,)."""

    @staticmethod
    def forward(ctx, S_flat, C, obs, bb_vals, sigma, offset, linear, fast,
                plain):
        ctx.save_for_backward(S_flat, C, *obs)
        ctx.args = (bb_vals, sigma, offset, linear, fast, plain)
        return _forward(S_flat, C, obs, bb_vals, sigma, offset, linear, fast,
                        plain)

    @staticmethod
    def backward(ctx, g):
        S_flat, C, *obs = ctx.saved_tensors
        bb_vals, sigma, offset, linear, fast, plain = ctx.args
        dS, dC = _backward(S_flat, C, tuple(obs), bb_vals, g.contiguous(),
                           sigma, offset, linear, fast, plain)
        return dS, dC, None, None, None, None, None, None, None


def _resolve(S_flat, sigma, fast, mode):
    if mode not in ("auto", "plain"):
        raise ValueError(f"unknown mode {mode!r}: 'auto' or 'plain'")
    fast = _fast_ok(sigma) if fast is None else bool(fast)
    return fast, mode == "plain" or S_flat.device.type == "cpu"


def fused_quantized_nll(
    S_flat: torch.Tensor,    # [B, R, P]
    C: torch.Tensor,         # [B, K, R]
    W: torch.Tensor,         # [B, K, P] from pack_bounds
    U: torch.Tensor,         # [B, K, P]
    sigma: float,
    offset: float,
    linear: bool = False,
    fast: Optional[bool] = None,
    mode: str = "auto",
) -> torch.Tensor:
    """Masked quantized-observation NLL per map -> [B], with an analytic
    backward in S_flat and C.  fast=None takes the direct form iff
    `_fast_ok(sigma)`.  mode="auto": the kernels for CUDA tensors, the plain
    version for CPU tensors; mode="plain": the plain version anywhere."""
    fast, plain = _resolve(S_flat, sigma, fast, mode)
    return _QuantizedNLL.apply(S_flat, C, (W, U), None, float(sigma),
                               float(offset), bool(linear), fast, plain)


def fused_quantized_nll_coded(
    S_flat: torch.Tensor,    # [B, R, P]
    C: torch.Tensor,         # [B, K, R]
    codes: torch.Tensor,     # [B, K, P] int8 from pack_codes/pack_codes_1bit
    bb_vals: Sequence[float],
    sigma: float,
    offset: float,
    linear: bool = False,
    fast: Optional[bool] = None,
    mode: str = "auto",
) -> torch.Tensor:
    """Coded-observation variant of `fused_quantized_nll`: the same math from
    1 byte of observation per entry.  bb_vals: the nbins+1 boundaries
    (`onebit_bounds(mean)` for the 1-bit case)."""
    fast, plain = _resolve(S_flat, sigma, fast, mode)
    return _QuantizedNLL.apply(S_flat, C, (codes,), tuple(bb_vals),
                               float(sigma), float(offset), bool(linear),
                               fast, plain)


def score_quantized_nll(
    S_flat: torch.Tensor,    # [N, R, P] candidates
    C: torch.Tensor,         # [1, K, R] shared (or [N, K, R])
    obs: Tuple[torch.Tensor, ...],
    sigma: float,
    offset: float,
    bb_vals: Optional[Sequence[float]] = None,
    linear: bool = False,
    fast: Optional[bool] = None,
    mode: str = "auto",
) -> torch.Tensor:
    """Forward only, for scoring candidates: nll [N] in one launch.  obs is
    (W, U) with bb_vals None, or (codes,) with its boundary table; inputs of
    leading size 1 are shared across the N candidates without copies."""
    fast, plain = _resolve(S_flat, sigma, fast, mode)
    with torch.no_grad():
        return _forward(S_flat, C, tuple(obs),
                        None if bb_vals is None else tuple(bb_vals),
                        float(sigma), float(offset), bool(linear), fast,
                        plain)
