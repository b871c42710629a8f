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

#include "common.cuh"

using namespace qsc;

namespace {

// phi(t) / Phi(t) (fused_likelihood.py:_hazard_ratio).
__device__ __forceinline__ float hazard_ratio(float t) {
  if (t < -4.0f) {
    return -t / mills_series(t);
  }
  const float num = expf(-0.5f * t * t - kLogSqrt2Pi);
  const float den = 0.5f * (1.0f + as_erf(t * kInvSqrt2));
  return num / fmaxf(den, 1e-30f);
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
