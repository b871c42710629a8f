// 1-bit probit NLL of a rank-R reconstruction, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pair in
// quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py:
//   _fwd_kernel_1bit (called by _fwd_pallas_1bit)
//     nll[b] = -sum_{k,p} |sgn| * logPhi(sgn * (X[b,k,p] - mean) * inv_s),
//     X[b] = C[b] @ S[b], sgn = -1 / +1 / 0 for code 0 / 1 / 2 (masked);
//   _bwd_kernel_1bit (called by _bwd_pallas_1bit)
//     dX = g[b] * (-inv_s) * sgn * phi(t)/Phi(t),
//     dS[b] = C[b]^T dX,  dC[b] = dX S[b]^T.
// Layout: S [B,R,P] f32, C [B,K,R] f32, codes [B,K,P] int8, P = I*J (no
// lane padding).  JAX vmaps the TPU kernel over maps; here the map index b
// is the grid's y axis.
//
// What bounds it: at the bench shapes (B=256, K=64, P=2601, R=2) each pass
// reads 42.6 MB of int8 codes plus 5.3 MB of S, and the backward also
// writes 5.3 MB of dS: about 14-16 us at 3.35 TB/s.  The work is 42.6 M
// elements, each with one logPhi (forward) or one hazard ratio (backward):
// exp, log, a reciprocal and a 5-term polynomial in f32, plus 2R FMAs for
// the contraction.  With R <= 16 the contraction is FMAs in registers from
// C held in shared memory; no tensor cores.
//
// Design (simple and deterministic first):
// - one thread per spatial column p, looping over the K bands, so X[b,:,p]
//   and dS[b,:,p] stay in registers and need no reduction across threads;
// - the forward writes one partial sum per block and a second pass sums the
//   partials of each map in a fixed order;
// - dC[b,k,r] = sum_p dX*S is reduced per warp with shuffles, across warps
//   in shared memory, across blocks by the same second pass.  No float
//   atomics, so a run (and a resumed run) is bitwise reproducible.
// The numerics are the JAX kernel's own: the A&S 7.1.26 erf, the Mills tail
// below t=-4 in logPhi, and the hazard ratio with max(den, 1e-30).  Build
// without --use_fast_math, or the results leave parity with the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// log Phi(t) (fused_likelihood.py:_log_ndtr).
__device__ __forceinline__ float log_ndtr(float t) {
  if (t <= -4.0f) {
    return -0.5f * (t * t) - logf(-t) - kLogSqrt2Pi + logf(mills_series(t));
  }
  return logf(1.0f + as_erf(t * kInvSqrt2)) - kLn2;
}

// phi(t) / Phi(t) (fused_likelihood.py:_hazard_ratio).
__device__ __forceinline__ float hazard_ratio(float t) {
  if (t < -4.0f) {
    return -t / mills_series(t);
  }
  const float num = expf(-0.5f * t * t - kLogSqrt2Pi);
  const float den = 0.5f * (1.0f + as_erf(t * kInvSqrt2));
  return num / fmaxf(den, 1e-30f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// grid (nblk, B); dynamic shared memory: K*R + kWarps floats.
template <int R>
__global__ void __launch_bounds__(kThreads) onebit_fwd_kernel(
    const float* __restrict__ S, const float* __restrict__ C,
    const int8_t* __restrict__ codes, float* __restrict__ partial,
    int K, int P, float mean, float inv_s) {
  extern __shared__ float smem[];
  float* sC = smem;
  float* sWarp = smem + K * R;
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const float* Cb = C + (size_t)b * K * R;
  for (int i = threadIdx.x; i < K * R; i += kThreads) sC[i] = Cb[i];
  __syncthreads();

  float acc = 0.0f;
  if (p < P) {
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = S[((size_t)b * R + r) * P + p];
    const int8_t* yb = codes + (size_t)b * K * P + p;
    for (int k = 0; k < K; ++k) {
      const int code = yb[(size_t)k * P];
      if (code == 0 || code == 1) {
        float x = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) x = fmaf(sC[k * R + r], s[r], x);
        const float sgn = code == 1 ? 1.0f : -1.0f;
        acc -= log_ndtr(sgn * ((x - mean) * inv_s));
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc = warp_sum(acc);
  if (lane == 0) sWarp[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += sWarp[w];
    partial[(size_t)b * gridDim.x + blockIdx.x] = total;
  }
}

// grid (nblk, B); dynamic shared memory: K*R + kWarps*K*R floats.
template <int R>
__global__ void __launch_bounds__(kThreads) onebit_bwd_kernel(
    const float* __restrict__ S, const float* __restrict__ C,
    const int8_t* __restrict__ codes, const float* __restrict__ g,
    float* __restrict__ dS, float* __restrict__ dC_partial,
    int K, int P, float mean, float inv_s) {
  extern __shared__ float smem[];
  const int KR = K * R;
  float* sC = smem;
  float* sWarp = smem + KR;                 // [kWarps][K*R]
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = p < P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* Cb = C + (size_t)b * KR;
  for (int i = threadIdx.x; i < KR; i += kThreads) sC[i] = Cb[i];
  __syncthreads();

  float s[R], ds[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = valid ? S[((size_t)b * R + r) * P + p] : 0.0f;
    ds[r] = 0.0f;
  }
  const float scale = g[b] * -inv_s;
  const int8_t* yb = codes + (size_t)b * K * P + p;
  for (int k = 0; k < K; ++k) {
    float dx = 0.0f;
    const int code = valid ? (int)yb[(size_t)k * P] : 2;
    if (code == 0 || code == 1) {
      float x = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) x = fmaf(sC[k * R + r], s[r], x);
      const float sgn = code == 1 ? 1.0f : -1.0f;
      dx = scale * sgn * hazard_ratio(sgn * ((x - mean) * inv_s));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ds[r] = fmaf(sC[k * R + r], dx, ds[r]);
      const float v = warp_sum(dx * s[r]);
      if (lane == 0) sWarp[warp * KR + k * R + r] = v;
    }
  }
  if (valid) {
#pragma unroll
    for (int r = 0; r < R; ++r) dS[((size_t)b * R + r) * P + p] = ds[r];
  }
  __syncthreads();
  float* out = dC_partial + ((size_t)b * gridDim.x + blockIdx.x) * KR;
  for (int i = threadIdx.x; i < KR; i += kThreads) {
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w) a += sWarp[w * KR + i];
    out[i] = a;
  }
}

// out[b, i] = sum_j partial[b, j, i] over j < nblk, in order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
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

int launch_sum_partials(const float* partial, float* out, int B, int nblk,
                        int inner, cudaStream_t stream) {
  const int n = B * inner;
  sum_partials_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, out, B, nblk, inner);
  return (int)cudaGetLastError();
}

#define QSC_RANK_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

}  // namespace

extern "C" {

int qsc_onebit_threads() { return kThreads; }

// partial: [B, nblk] scratch; out: [B].  Returns a cudaError_t value.
int qsc_onebit_nll_fwd(const float* S, const float* C, const int8_t* codes,
                       float* partial, float* out, int B, int R, int K, int P,
                       float mean, float inv_s, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int nblk = (P + kThreads - 1) / kThreads;
  const dim3 grid(nblk, B);
  const size_t smem = (size_t)(K * R + kWarps) * sizeof(float);
  switch (R) {
#define QSC_FWD(r) \
    case r: onebit_fwd_kernel<r><<<grid, kThreads, smem, stream>>>( \
        S, C, codes, partial, K, P, mean, inv_s); break;
    QSC_RANK_CASES(QSC_FWD)
#undef QSC_FWD
    default: return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_sum_partials(partial, out, B, nblk, 1, stream);
}

// g: [B]; dS: [B,R,P]; dC_partial: [B, nblk, K*R] scratch; dC: [B,K,R].
int qsc_onebit_nll_bwd(const float* S, const float* C, const int8_t* codes,
                       const float* g, float* dS, float* dC_partial, float* dC,
                       int B, int R, int K, int P, float mean, float inv_s,
                       void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int nblk = (P + kThreads - 1) / kThreads;
  const dim3 grid(nblk, B);
  const size_t smem = (size_t)(1 + kWarps) * K * R * sizeof(float);
  switch (R) {
#define QSC_BWD(r) \
    case r: onebit_bwd_kernel<r><<<grid, kThreads, smem, stream>>>( \
        S, C, codes, g, dS, dC_partial, K, P, mean, inv_s); break;
    QSC_RANK_CASES(QSC_BWD)
#undef QSC_BWD
    default: return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_sum_partials(dC_partial, dC, B, nblk, K * R, stream);
}

}  // extern "C"
