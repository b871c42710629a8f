// Numerics and reductions shared by the likelihood kernels (onebit_nll.cu,
// quantized_nll.cu).  The formulas are those of the JAX kernels in
// quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py, so the
// port stays at parity with the reference; their plain PyTorch copies are in
// ops/kernels/numerics.py.  Build without --use_fast_math (and without
// -ftz=true): the fast ordinal path's floor of 1e-38 is subnormal in f32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qsc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLogSqrt2Pi = 0.9189385332046727f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kLn2 = 0.6931471805599453f;

// erf via Abramowitz & Stegun 7.1.26 (fused_likelihood.py:_erf).
__device__ __forceinline__ float as_erf(float z) {
  const float az = fabsf(z);
  const float u = 1.0f / (1.0f + 0.3275911f * az);
  const float poly = u * (0.254829592f + u * (-0.284496736f + u * (
      1.421413741f + u * (-1.453152027f + u * 1.061405429f))));
  const float val = 1.0f - poly * expf(-az * az);
  return z >= 0.0f ? val : -val;
}

// 1 - 1/t^2 + 3/t^4 - 15/t^6, the Mills-ratio series.
__device__ __forceinline__ float mills_series(float t) {
  const float inv2 = 1.0f / (t * t);
  return 1.0f - inv2 * (1.0f - 3.0f * inv2 * (1.0f - 5.0f * inv2));
}

// log Phi(t) (fused_likelihood.py:_log_ndtr): the Mills tail at or below
// t = -4, log(1 + erf(t/sqrt2)) - log 2 above it.
__device__ __forceinline__ float log_ndtr(float t) {
  if (t <= -4.0f) {
    return -0.5f * (t * t) - logf(-t) - kLogSqrt2Pi + logf(mills_series(t));
  }
  return logf(1.0f + as_erf(t * kInvSqrt2)) - kLn2;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// out[b, i] = sum_j partial[b, j, i] over j < nblk, in order (in double), so
// the result does not depend on how the blocks were scheduled.
// static: every source that includes this header has its own copy.
static __global__ void sum_partials_kernel(const float* __restrict__ partial,
                                           float* __restrict__ out,
                                           int B, int nblk, int inner) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * inner) return;
  const int b = idx / inner, i = idx % inner;
  const float* src = partial + (size_t)b * nblk * inner + i;
  double acc = 0.0;
  for (int j = 0; j < nblk; ++j) acc += (double)src[(size_t)j * inner];
  out[idx] = (float)acc;
}

static int launch_sum_partials(const float* partial, float* out, int B,
                               int nblk, int inner, cudaStream_t stream) {
  const int n = B * inner;
  sum_partials_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, out, B, nblk, inner);
  return (int)cudaGetLastError();
}

}  // namespace qsc

#define QSC_RANK_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)
