// Ordinal probit NLL of a rank-R reconstruction, forward and backward, for
// Hopper (sm_90a), with the observations as f32 bin bounds (W, U) or as int8
// bin codes decoded in registers.
//
// Replaces four TPU kernels in
// quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py:
//   _fwd_kernel (called by _fwd_pallas), bounds, and
//   _fwd_kernel_coded (called by _fwd_pallas_coded), codes:
//     nll[b] = -sum_{k,p} log(Phi((U - x)/s) - Phi((W - x)/s)),
//     x = log(X + offset) (log link) or X (linear link), X[b] = C[b] @ S[b];
//   _bwd_kernel (called by _bwd_pallas) and
//   _bwd_kernel_coded (called by _bwd_pallas_coded):
//     dX = -g[b] * dlogP/dx * (1 or 1/(X + offset)),
//     dS[b] = C[b]^T dX,  dC[b] = dX S[b]^T.
// Codes: code c < nbins has bounds (bb[c], bb[c+1]); code >= nbins is masked.
// Bounds: (W, U) = (-1e4, +1e4) is masked (the JAX package's MASK_SENTINEL).
// A masked entry adds exactly 0 to the value and to the gradient, as in the
// JAX kernels, where erf saturates to +-1 and log 1 = 0; here it is skipped.
// Layout: S [B,R,P] f32, C [B,K,R] f32, W/U [B,K,P] f32 or codes [B,K,P]
// int8, P = I*J (no lane padding), with a batch stride per input that may be
// 0: the z-search scorer shares C and the observations across candidates.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside tensor cores):
// - bounds kernels: bytes.  Every entry reads 8 B of (W, U); at the MLE-GAN
//   shape (B=1, K=64, P=2601) that is 1.3 MB, 0.4 us, far below the time of
//   a launch; at the low-rank shape (B=256) 341 MB, about 0.1 ms.
// - coded kernels: 1 B per entry, so where most entries are observed the
//   arithmetic bounds them: the TPU kernels' cost estimate (_coded_cost,
//   fused_likelihood.py:472) is 2R + 25 flops and 4 transcendentals per
//   entry forward, 6R + 30 and 5 backward; 0.02-0.03 ms at the low-rank
//   shape.  With a 10% sample (MLE-GAN) the skipped entries leave bytes as
//   the bound again, and at B=1 either bound is far below a launch.
// Design (simple and deterministic first, as onebit_nll.cu):
// - one thread per spatial column p, looping over the K bands, so X[b,:,p]
//   and dS[b,:,p] stay in registers; C (K x R) sits in shared memory;
// - masked entries are skipped, so with a 10% sample the transcendental
//   work falls to a tenth, while every observation byte is still read;
// - the boundary table (<= 33 floats) travels by value in the kernel's
//   parameter struct (__grid_constant__), and a code is decoded by a select
//   chain over it, as _bounds_from_codes does; no per-element memory load;
// - the forward writes one partial sum per block, dC is reduced per warp
//   with shuffles and across warps in shared memory, and a second pass sums
//   the per-block partials in a fixed order: no float atomics, so a run and
//   a resumed run are bitwise equal.
// The numerics are the JAX kernels' own (common.cuh, and below): _log_prob
// with its flip (a + b) > 0 and _log1mexp's series/direct split at -ln 2 and
// its -1e-12 clamp, _dlogp_dx's min(., 30), and the fast path's floor of
// 1e-38, which is subnormal in f32: build without --use_fast_math or -ftz.

#include "common.cuh"

using namespace qsc;

constexpr float kSentinel = 1e4f;
constexpr int kMaxTable = 33;     // nbins + 1 boundaries, nbins < 32

// The kernels' arguments, passed by value (__grid_constant__).
struct QnllParams {
  const float* S;
  const float* C;
  const float* W;        // bounds kernels
  const float* U;
  const int8_t* codes;   // coded kernels
  const float* g;        // backward: [B]
  float* partial;        // forward: [B, nblk]; backward: [B, nblk, K*R]
  float* dS;             // backward: [B, R, P]
  long long stride_S, stride_C, stride_obs;   // batch strides, 0: shared
  int K, P, nbins;
  float inv_s, offset;
  float bb[kMaxTable];
};

namespace {

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

// The bin bounds of entry idx; false where it is masked.
template <bool CODED>
__device__ __forceinline__ bool bin_bounds(const QnllParams& p, size_t idx,
                                           float& w, float& u) {
  if constexpr (CODED) {
    const int code = p.codes[idx];
    if (code < 0 || code >= p.nbins) return false;
    w = -kSentinel;
    u = kSentinel;
    for (int i = 0; i < p.nbins; ++i) {
      if (code == i) {
        w = p.bb[i];
        u = p.bb[i + 1];
      }
    }
    return true;
  } else {
    w = p.W[idx];
    u = p.U[idx];
    return !(w <= -kSentinel && u >= kSentinel);
  }
}

template <bool LINEAR, bool FAST>
struct Entry {
  float xo, a, b, logP;
  __device__ __forceinline__ Entry(float X, float w, float u,
                                   const QnllParams& p) {
    xo = X + p.offset;
    const float x = LINEAR ? X : logf(xo);
    a = (w - x) * p.inv_s;
    b = (u - x) * p.inv_s;
    logP = FAST ? log_prob_fast(a, b) : log_prob(a, b);
  }
};

// grid (nblk, B); dynamic shared memory: K*R + kWarps floats.
template <int R, bool CODED, bool LINEAR, bool FAST>
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
      if (!bin_bounds<CODED>(p, obase + (size_t)k * p.P, w, u)) continue;
      float X = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) X = fmaf(sC[k * R + r], s[r], X);
      acc -= Entry<LINEAR, FAST>(X, w, u, p).logP;
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
template <int R, bool CODED, bool LINEAR, bool FAST>
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
    if (valid && bin_bounds<CODED>(p, obase + (size_t)k * p.P, w, u)) {
      float X = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) X = fmaf(sC[k * R + r], s[r], X);
      const Entry<LINEAR, FAST> e(X, w, u, p);
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

template <bool BWD, bool CODED, bool LINEAR, bool FAST>
int launch_rank(int R, dim3 grid, size_t smem, cudaStream_t stream,
                const QnllParams& p) {
  switch (R) {
#define QSC_CASE(r)                                                          \
    case r:                                                                  \
      if constexpr (BWD) {                                                   \
        qnll_bwd_kernel<r, CODED, LINEAR, FAST>                              \
            <<<grid, kThreads, smem, stream>>>(p);                           \
      } else {                                                               \
        qnll_fwd_kernel<r, CODED, LINEAR, FAST>                              \
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
int launch(bool coded, bool linear, bool fast, int R, dim3 grid, size_t smem,
           cudaStream_t stream, const QnllParams& p) {
  if (coded) {
    if (linear) {
      return fast ? launch_rank<BWD, true, true, true>(R, grid, smem, stream, p)
                  : launch_rank<BWD, true, true, false>(R, grid, smem, stream, p);
    }
    return fast ? launch_rank<BWD, true, false, true>(R, grid, smem, stream, p)
                : launch_rank<BWD, true, false, false>(R, grid, smem, stream, p);
  }
  if (linear) {
    return fast ? launch_rank<BWD, false, true, true>(R, grid, smem, stream, p)
                : launch_rank<BWD, false, true, false>(R, grid, smem, stream, p);
  }
  return fast ? launch_rank<BWD, false, false, true>(R, grid, smem, stream, p)
              : launch_rank<BWD, false, false, false>(R, grid, smem, stream, p);
}

// Fills the parameter struct; false if the table does not fit.
bool make_params(QnllParams& p, const float* S, const float* C,
                 const float* W, const float* U, const int8_t* codes,
                 const float* table, int nbins, long long stride_S,
                 long long stride_C, long long stride_obs, int K, int P,
                 float inv_s, float offset) {
  if (codes != nullptr && (nbins < 1 || nbins + 1 > kMaxTable)) return false;
  p = QnllParams{};
  p.S = S;
  p.C = C;
  p.W = W;
  p.U = U;
  p.codes = codes;
  p.stride_S = stride_S;
  p.stride_C = stride_C;
  p.stride_obs = stride_obs;
  p.K = K;
  p.P = P;
  p.nbins = codes != nullptr ? nbins : 0;
  p.inv_s = inv_s;
  p.offset = offset;
  for (int i = 0; i < kMaxTable; ++i) {
    p.bb[i] = (codes != nullptr && i <= nbins) ? table[i] : 0.0f;
  }
  return true;
}

}  // namespace

extern "C" {

int qsc_qnll_threads() { return kThreads; }

// Forward.  Pass (W, U) and codes = table = NULL for the bounds kernel, or
// codes with its host table of nbins+1 floats and W = U = NULL for the coded
// kernel.  partial: [B, nblk] scratch; out: [B].  Returns a cudaError_t.
int qsc_qnll_fwd(const float* S, const float* C, const float* W,
                 const float* U, const int8_t* codes, const float* table,
                 int nbins, float* partial, float* out, int B, int R, int K,
                 int P, long long stride_S, long long stride_C,
                 long long stride_obs, float inv_s, float offset, int linear,
                 int fast, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  QnllParams p;
  if (!make_params(p, S, C, W, U, codes, table, nbins, stride_S, stride_C,
                   stride_obs, K, P, inv_s, offset)) {
    return (int)cudaErrorInvalidValue;
  }
  p.partial = partial;
  const int nblk = (P + kThreads - 1) / kThreads;
  const size_t smem = (size_t)(K * R + kWarps) * sizeof(float);
  const int err = launch<false>(codes != nullptr, linear != 0, fast != 0, R,
                                dim3(nblk, B), smem, stream, p);
  if (err != 0) return err;
  return launch_sum_partials(partial, out, B, nblk, 1, stream);
}

// Backward, with the inputs of the forward and g: [B]; dS: [B,R,P];
// dC_partial: [B, nblk, K*R] scratch; dC: [B,K,R].
int qsc_qnll_bwd(const float* S, const float* C, const float* W,
                 const float* U, const int8_t* codes, const float* table,
                 int nbins, const float* g, float* dS, float* dC_partial,
                 float* dC, int B, int R, int K, int P, long long stride_S,
                 long long stride_C, long long stride_obs, float inv_s,
                 float offset, int linear, int fast, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  QnllParams p;
  if (!make_params(p, S, C, W, U, codes, table, nbins, stride_S, stride_C,
                   stride_obs, K, P, inv_s, offset)) {
    return (int)cudaErrorInvalidValue;
  }
  p.g = g;
  p.dS = dS;
  p.partial = dC_partial;
  const int nblk = (P + kThreads - 1) / kThreads;
  const size_t smem = (size_t)(1 + kWarps) * K * R * sizeof(float);
  const int err = launch<true>(codes != nullptr, linear != 0, fast != 0, R,
                               dim3(nblk, B), smem, stream, p);
  if (err != 0) return err;
  return launch_sum_partials(dC_partial, dC, B, nblk, K * R, stream);
}

}  // extern "C"
