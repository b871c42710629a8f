"""The likelihoods' formulas, and the precision the reference computes in.

The formulas are frozen copies of the program's plain versions, which hold
the JAX kernels' numerics (the configuration's likelihood is defined by
them, approximations included):
- ``ops/kernels/numerics.py:20-51`` (`_erf` as Abramowitz & Stegun 7.1.26,
  `_mills_series`, `_log_ndtr`);
- ``ops/kernels/onebit_nll.py:63-103`` (`_hazard_ratio`, the 1-bit
  forward and its analytic backward);
- ``ops/kernels/quantized_nll.py:130-205`` (`_log1mexp`, `_log_prob`,
  `_log_prob_fast`, `_dlogp_dx`, the ordinal forward and backward);
- ``ops/likelihood.py:24`` (the probit scale 1.414213 / sqrt 2).
Each is evaluated in the dtype of its inputs: float64 for the judge, float32
with TF32 operands for the control.

`Precision` carries the dtype and whether the operands of every matrix
product and convolution are rounded to TF32 (10 mantissa bits, round to
nearest, ties away; products accumulated in float32): what a TF32 tensor
core computes.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

SIGMA_EFF = 1.414213 / 1.4142135623730951
LOG_SQRT_2PI = 0.9189385332046727
INV_SQRT2 = 0.7071067811865476
LN2 = 0.6931471805599453


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, as this precision feeds it."""
        if not self.tf32:
            return x
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    def matmul(self, a, b):
        return torch.matmul(self.op(a), self.op(b))

    def einsum(self, spec, *xs):
        return torch.einsum(spec, *(self.op(x) for x in xs))

    def conv2d(self, x, w, b, stride, padding):
        return F.conv2d(self.op(x), self.op(w), b, stride, padding)

    def conv_transpose2d(self, x, w, b, stride, padding):
        return F.conv_transpose2d(self.op(x), self.op(w), b, stride, padding)


JUDGE = Precision(torch.float64, False)
CONTROL = Precision(torch.float32, True)


def inv_s(sigma: float) -> float:
    return 1.0 / (sigma * SIGMA_EFF)


def erf_as(z):
    az = z.abs()
    u = 1.0 / (1.0 + 0.3275911 * az)
    poly = u * (0.254829592 + u * (-0.284496736 + u * (
        1.421413741 + u * (-1.453152027 + u * 1.061405429))))
    val = 1.0 - poly * torch.exp(-az * az)
    return torch.where(z >= 0.0, val, -val)


def mills_series(safe_t):
    inv2 = 1.0 / (safe_t * safe_t)
    return 1.0 - inv2 * (1.0 - 3.0 * inv2 * (1.0 - 5.0 * inv2))


def log_ndtr(t):
    tc = t.clamp(max=0.0)
    safe_t = tc.clamp(max=-4.0)
    asym = (-0.5 * tc * tc - torch.log(-safe_t) - LOG_SQRT_2PI
            + torch.log(mills_series(safe_t)))
    direct = torch.log(1.0 + erf_as(t.clamp(min=-4.0) * INV_SQRT2)) - LN2
    return torch.where(t <= -4.0, asym, direct)


def hazard_ratio(t):
    t_dir = t.clamp(min=-4.0)
    num = torch.exp(-0.5 * t_dir * t_dir - LOG_SQRT_2PI)
    den = 0.5 * (1.0 + erf_as(t_dir * INV_SQRT2))
    direct = num / den.clamp(min=1e-30)
    safe_t = t.clamp(max=-4.0)
    return torch.where(t < -4.0, -safe_t / mills_series(safe_t), direct)


def log1mexp(d):
    d_small = d.clamp(-0.6931472, -1e-12)
    series = 1.0 + d_small * (0.5 + d_small * (
        1.0 / 6.0 + d_small * (1.0 / 24.0 + d_small / 120.0)))
    small_val = torch.log(-d_small * series)
    large_val = torch.log(1.0 - torch.exp(d.clamp(max=-0.6931472)))
    return torch.where(d > -0.6931472, small_val, large_val)


def log_prob_robust(a, b):
    flip = (a + b) > 0.0
    lo = torch.where(flip, -b, a)
    hi = torch.where(flip, -a, b)
    l_hi = log_ndtr(hi)
    return l_hi + log1mexp((log_ndtr(lo) - l_hi).clamp(max=-1e-12))


def log_prob_fast(a, b):
    ea = erf_as(a * INV_SQRT2)
    eb = erf_as(b * INV_SQRT2)
    return torch.log((0.5 * (eb - ea)).clamp(min=1e-38))


def dlogp_dx(a, b, logP, scale):
    ra = torch.exp((-0.5 * a * a - LOG_SQRT_2PI - logP).clamp(max=30.0))
    rb = torch.exp((-0.5 * b * b - LOG_SQRT_2PI - logP).clamp(max=30.0))
    return (ra - rb) * scale


class OnebitNLL(torch.autograd.Function):
    """nll [B] = -sum_obs log Phi(t), t = sgn (C S - mean) / s, with the
    program's analytic backward dX = -g sgn phi/Phi(t) / s.
    S [B, R, P], Ct [B, K, R], sgn [B, K, P] in {-1, 0, +1}."""

    @staticmethod
    def forward(ctx, S, Ct, sgn, mean, sigma, prec):
        X = prec.matmul(Ct, S)
        t = sgn * ((X - mean) * inv_s(sigma))
        ctx.save_for_backward(S, Ct, sgn, t)
        ctx.sigma, ctx.prec = sigma, prec
        return -(sgn.abs() * log_ndtr(t)).sum(dim=(-2, -1))

    @staticmethod
    def backward(ctx, g):
        S, Ct, sgn, t = ctx.saved_tensors
        prec = ctx.prec
        dX = (g * -inv_s(ctx.sigma))[:, None, None] * sgn * hazard_ratio(t)
        dS = prec.matmul(Ct.transpose(-1, -2), dX)
        dC = prec.matmul(dX, S.transpose(-1, -2))
        return dS, dC, None, None, None, None


class BoundsNLL(torch.autograd.Function):
    """nll [B] = -sum_obs log(Phi(b) - Phi(a)), a, b = (W, U - x) / s,
    x = log(C S + offset), over the entries where `obs` is 1, with the
    program's analytic backward.  S [B, R, P], Ct [B or 1, K, R], W, U, obs
    [1, K, P] shared by the B candidates."""

    @staticmethod
    def forward(ctx, S, Ct, W, U, obs, sigma, offset, fast, prec):
        X = prec.matmul(Ct, S)
        Xo = X + offset
        x = torch.log(Xo)
        a = (W - x) * inv_s(sigma)
        b = (U - x) * inv_s(sigma)
        logP = log_prob_fast(a, b) if fast else log_prob_robust(a, b)
        ctx.save_for_backward(S, Ct, obs, Xo, a, b, logP)
        ctx.sigma, ctx.prec = sigma, prec
        return -(obs * logP).sum(dim=(-2, -1))

    @staticmethod
    def backward(ctx, g):
        S, Ct, obs, Xo, a, b, logP = ctx.saved_tensors
        prec = ctx.prec
        d = dlogp_dx(a, b, logP, inv_s(ctx.sigma))
        dX = -g[:, None, None] * obs * d / Xo
        dS = prec.matmul(Ct.transpose(-1, -2), dX)
        dC = prec.matmul(dX, S.transpose(-1, -2))
        if dC.shape[0] != Ct.shape[0]:
            dC = dC.sum(dim=0, keepdim=True)
        return dS, dC, None, None, None, None, None, None, None


def safe_fro(x, dim=None):
    sq = x.square()
    return torch.sqrt((sq.sum() if dim is None else sq.sum(dim=dim)) + 1e-24)


def adam_step(lr, grad, param, state):
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8 outside the root), frozen
    copy of ``solvers/base.py:66-76``."""
    count, mu, nu = state
    mu = 0.1 * grad + 0.9 * mu
    nu = 0.001 * grad.square() + 0.999 * nu
    count = count + 1
    mu_hat = mu / (1 - 0.9 ** count)
    nu_hat = nu / (1 - 0.999 ** count)
    return param - lr * (mu_hat / (torch.sqrt(nu_hat) + 1e-8)), (count, mu, nu)


def value_and_grad(loss_fn, *params):
    ps = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        cost = loss_fn(*ps)
        grads = torch.autograd.grad(cost.sum(), ps)
    return cost.detach(), grads
