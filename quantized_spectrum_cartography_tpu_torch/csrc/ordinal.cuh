// Numerics of the ordinal probit likelihood, shared by the bounds kernels
// (quantized_nll.cu) and the coded kernels (quantized_nll_coded.cu).  The
// formulas are those of the JAX kernels in
// quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py: _log_prob
// with its flip (a + b) > 0 and _log1mexp's series/direct split at -ln 2 and
// its -1e-12 clamp, _dlogp_dx's min(., 30), and the fast path's floor of
// 1e-38, which is subnormal in f32: build without --use_fast_math or -ftz.
// Their plain PyTorch copies are in ops/kernels/quantized_nll.py.

#pragma once

#include "common.cuh"

namespace qsc {

// log(1 - e^d) for d <= -1e-12 (fused_likelihood.py:_log1mexp).
__device__ __forceinline__ float log1mexp(float d) {
  if (d > -0.6931472f) {
    const float ds = fminf(fmaxf(d, -0.6931472f), -1e-12f);
    const float series = 1.0f + ds * (0.5f + ds * (
        1.0f / 6.0f + ds * (1.0f / 24.0f + ds / 120.0f)));
    return logf(-ds * series);
  }
  return logf(1.0f - expf(d));
}

// log(Phi(b) - Phi(a)), b > a, robust in both tails
// (fused_likelihood.py:_log_prob).
__device__ __forceinline__ float log_prob(float a, float b) {
  const bool flip = (a + b) > 0.0f;
  const float lo = flip ? -b : a;
  const float hi = flip ? -a : b;
  const float l_lo = log_ndtr(lo);
  const float l_hi = log_ndtr(hi);
  const float diff = fminf(l_lo - l_hi, -1e-12f);
  return l_hi + log1mexp(diff);
}

// log((erf(b/sqrt2) - erf(a/sqrt2))/2) (fused_likelihood.py:_log_prob_fast).
__device__ __forceinline__ float log_prob_fast(float a, float b) {
  const float ea = as_erf(a * kInvSqrt2);
  const float eb = as_erf(b * kInvSqrt2);
  return logf(fmaxf(0.5f * (eb - ea), 1e-38f));
}

// d log P / dx (fused_likelihood.py:_dlogp_dx).
__device__ __forceinline__ float dlogp_dx(float a, float b, float logP,
                                          float inv_s) {
  const float log_phi_a = -0.5f * a * a - kLogSqrt2Pi;
  const float log_phi_b = -0.5f * b * b - kLogSqrt2Pi;
  const float ra = expf(fminf(log_phi_a - logP, 30.0f));
  const float rb = expf(fminf(log_phi_b - logP, 30.0f));
  return (ra - rb) * inv_s;
}

// One entry of the sum: x from X = (C @ S)[k, p] through the link, the
// standardized bounds a, b of its bin (w, u), and log P.
template <bool LINEAR, bool FAST>
struct Entry {
  float xo, a, b, logP;
  __device__ __forceinline__ Entry(float X, float w, float u, float inv_s,
                                   float offset) {
    xo = X + offset;
    const float x = LINEAR ? X : logf(xo);
    a = (w - x) * inv_s;
    b = (u - x) * inv_s;
    logP = FAST ? log_prob_fast(a, b) : log_prob(a, b);
  }
};

}  // namespace qsc
