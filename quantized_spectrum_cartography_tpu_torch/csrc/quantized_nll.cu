// Ordinal probit NLL of a rank-R reconstruction, forward and backward, for
// Hopper (sm_90a), with the observations as f32 bin bounds (W, U).  The
// int8-coded kernels are in quantized_nll_coded.cu; the numerics both use
// are in ordinal.cuh.
//
// Replaces two TPU kernels in
// quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py:
//   _fwd_kernel (called by _fwd_pallas):
//     nll[b] = -sum_{k,p} log(Phi((U - x)/s) - Phi((W - x)/s)),
//     x = log(X + offset) (log link) or X (linear link), X[b] = C[b] @ S[b];
//   _bwd_kernel (called by _bwd_pallas):
//     dX = -g[b] * dlogP/dx * (1 or 1/(X + offset)),
//     dS[b] = C[b]^T dX,  dC[b] = dX S[b]^T.
// (W, U) = (-1e4, +1e4) is masked (the JAX package's MASK_SENTINEL).
// A masked entry adds exactly 0 to the value and to the gradient, as in the
// JAX kernels, where erf saturates to +-1 and log 1 = 0; here it is skipped.
// Layout: S [B,R,P] f32, C [B,K,R] f32, W/U [B,K,P] f32, P = I*J (no lane
// padding), with a batch stride per input that may be 0: the z-search
// scorer shares C and the observations across candidates.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside tensor
// cores): bytes.  Every entry reads 8 B of (W, U); at the MLE-GAN shape
// (B=1, K=64, P=2601) that is 1.3 MB, 0.4 us, far below the time of a
// launch; at the low-rank shape (B=256) 341 MB, about 0.1 ms.
// Design (simple and deterministic first, as onebit_nll.cu was):
// - one thread per spatial column p, looping over the K bands, so X[b,:,p]
//   and dS[b,:,p] stay in registers; C (K x R) sits in shared memory;
// - masked entries are skipped, so with a 10% sample the transcendental
//   work falls to a tenth, while every observation byte is still read;
// - the forward writes one partial sum per block, dC is reduced per warp
//   with shuffles and across warps in shared memory, and a second pass sums
//   the per-block partials in a fixed order: no float atomics, so a run and
//   a resumed run are bitwise equal.

#include "ordinal.cuh"

using namespace qsc;

constexpr float kSentinel = 1e4f;

// The kernels' arguments, passed by value (__grid_constant__).
struct QnllParams {
  const float* S;
  const float* C;
  const float* W;
  const float* U;
  const float* g;        // backward: [B]
  float* partial;        // forward: [B, nblk]; backward: [B, nblk, K*R]
  float* dS;             // backward: [B, R, P]
  long long stride_S, stride_C, stride_obs;   // batch strides, 0: shared
  int K, P;
  float inv_s, offset;
};

namespace {

// The bin bounds of entry idx; false where it is masked.
__device__ __forceinline__ bool bin_bounds(const QnllParams& p, size_t idx,
                                           float& w, float& u) {
  w = p.W[idx];
  u = p.U[idx];
  return !(w <= -kSentinel && u >= kSentinel);
}

// grid (nblk, B); dynamic shared memory: K*R + kWarps floats.
template <int R, bool LINEAR, bool FAST>
__global__ void __launch_bounds__(kThreads) qnll_fwd_kernel(
    const __grid_constant__ QnllParams p) {
  extern __shared__ float smem[];
  float* sC = smem;
  float* sWarp = smem + p.K * R;
  const int b = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const float* Cb = p.C + b * p.stride_C;
  for (int i = threadIdx.x; i < p.K * R; i += kThreads) sC[i] = Cb[i];
  __syncthreads();

  float acc = 0.0f;
  if (col < p.P) {
    float s[R];
    const float* Sb = p.S + b * p.stride_S + col;
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = Sb[(size_t)r * p.P];
    const size_t obase = b * p.stride_obs + col;
    for (int k = 0; k < p.K; ++k) {
      float w, u;
      if (!bin_bounds(p, obase + (size_t)k * p.P, w, u)) continue;
      float X = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) X = fmaf(sC[k * R + r], s[r], X);
      acc -= Entry<LINEAR, FAST>(X, w, u, p.inv_s, p.offset).logP;
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc = warp_sum(acc);
  if (lane == 0) sWarp[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += sWarp[w];
    p.partial[(size_t)b * gridDim.x + blockIdx.x] = total;
  }
}

// grid (nblk, B); dynamic shared memory: K*R + kWarps*K*R floats.
template <int R, bool LINEAR, bool FAST>
__global__ void __launch_bounds__(kThreads) qnll_bwd_kernel(
    const __grid_constant__ QnllParams p) {
  extern __shared__ float smem[];
  const int KR = p.K * R;
  float* sC = smem;
  float* sWarp = smem + KR;                 // [kWarps][K*R]
  const int b = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = col < p.P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* Cb = p.C + b * p.stride_C;
  for (int i = threadIdx.x; i < KR; i += kThreads) sC[i] = Cb[i];
  __syncthreads();

  float s[R], ds[R];
  const float* Sb = p.S + b * p.stride_S + col;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = valid ? Sb[(size_t)r * p.P] : 0.0f;
    ds[r] = 0.0f;
  }
  const float gb = p.g[b];
  const size_t obase = b * p.stride_obs + col;
  for (int k = 0; k < p.K; ++k) {
    float dx = 0.0f, w, u;
    if (valid && bin_bounds(p, obase + (size_t)k * p.P, w, u)) {
      float X = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) X = fmaf(sC[k * R + r], s[r], X);
      const Entry<LINEAR, FAST> e(X, w, u, p.inv_s, p.offset);
      const float dlogp = dlogp_dx(e.a, e.b, e.logP, p.inv_s);
      dx = -gb * (LINEAR ? dlogp : dlogp / e.xo);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ds[r] = fmaf(sC[k * R + r], dx, ds[r]);
      const float v = warp_sum(dx * s[r]);
      if (lane == 0) sWarp[warp * KR + k * R + r] = v;
    }
  }
  if (valid) {
    float* dSb = p.dS + (size_t)b * R * p.P + col;
#pragma unroll
    for (int r = 0; r < R; ++r) dSb[(size_t)r * p.P] = ds[r];
  }
  __syncthreads();
  float* out = p.partial + ((size_t)b * gridDim.x + blockIdx.x) * KR;
  for (int i = threadIdx.x; i < KR; i += kThreads) {
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w) a += sWarp[w * KR + i];
    out[i] = a;
  }
}

template <bool BWD, bool LINEAR, bool FAST>
int launch_rank(int R, dim3 grid, size_t smem, cudaStream_t stream,
                const QnllParams& p) {
  switch (R) {
#define QSC_CASE(r)                                                          \
    case r:                                                                  \
      if constexpr (BWD) {                                                   \
        qnll_bwd_kernel<r, LINEAR, FAST>                                     \
            <<<grid, kThreads, smem, stream>>>(p);                           \
      } else {                                                               \
        qnll_fwd_kernel<r, LINEAR, FAST>                                     \
            <<<grid, kThreads, smem, stream>>>(p);                           \
      }                                                                      \
      break;
    QSC_RANK_CASES(QSC_CASE)
#undef QSC_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool BWD>
int launch(bool linear, bool fast, int R, dim3 grid, size_t smem,
           cudaStream_t stream, const QnllParams& p) {
  if (linear) {
    return fast ? launch_rank<BWD, true, true>(R, grid, smem, stream, p)
                : launch_rank<BWD, true, false>(R, grid, smem, stream, p);
  }
  return fast ? launch_rank<BWD, false, true>(R, grid, smem, stream, p)
              : launch_rank<BWD, false, false>(R, grid, smem, stream, p);
}

QnllParams make_params(const float* S, const float* C, const float* W,
                       const float* U, long long stride_S, long long stride_C,
                       long long stride_obs, int K, int P, float inv_s,
                       float offset) {
  QnllParams p{};
  p.S = S;
  p.C = C;
  p.W = W;
  p.U = U;
  p.stride_S = stride_S;
  p.stride_C = stride_C;
  p.stride_obs = stride_obs;
  p.K = K;
  p.P = P;
  p.inv_s = inv_s;
  p.offset = offset;
  return p;
}

}  // namespace

extern "C" {

int qsc_qnll_threads() { return kThreads; }

// Forward.  partial: [B, nblk] scratch; out: [B].  Returns a cudaError_t.
int qsc_qnll_fwd(const float* S, const float* C, const float* W,
                 const float* U, float* partial, float* out, int B, int R,
                 int K, int P, long long stride_S, long long stride_C,
                 long long stride_obs, float inv_s, float offset, int linear,
                 int fast, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  QnllParams p = make_params(S, C, W, U, stride_S, stride_C, stride_obs, K, P,
                             inv_s, offset);
  p.partial = partial;
  const int nblk = (P + kThreads - 1) / kThreads;
  const size_t smem = (size_t)(K * R + kWarps) * sizeof(float);
  const int err = launch<false>(linear != 0, fast != 0, R, dim3(nblk, B),
                                smem, stream, p);
  if (err != 0) return err;
  return launch_sum_partials(partial, out, B, nblk, 1, stream);
}

// Backward, with the inputs of the forward and g: [B]; dS: [B,R,P];
// dC_partial: [B, nblk, K*R] scratch; dC: [B,K,R].
int qsc_qnll_bwd(const float* S, const float* C, const float* W,
                 const float* U, const float* g, float* dS, float* dC_partial,
                 float* dC, int B, int R, int K, int P, long long stride_S,
                 long long stride_C, long long stride_obs, float inv_s,
                 float offset, int linear, int fast, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  QnllParams p = make_params(S, C, W, U, stride_S, stride_C, stride_obs, K, P,
                             inv_s, offset);
  p.g = g;
  p.dS = dS;
  p.partial = dC_partial;
  const int nblk = (P + kThreads - 1) / kThreads;
  const size_t smem = (size_t)(1 + kWarps) * K * R * sizeof(float);
  const int err = launch<true>(linear != 0, fast != 0, R, dim3(nblk, B), smem,
                               stream, p);
  if (err != 0) return err;
  return launch_sum_partials(dC_partial, dC, B, nblk, K * R, stream);
}

}  // extern "C"
