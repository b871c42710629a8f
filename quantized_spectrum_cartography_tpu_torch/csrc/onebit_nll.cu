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
// What bounds it on an H100, at the bench shapes (B=256, K=64, P=2601,
// R=2; bench_onebit.py --floor measures each figure below):
// - bytes: each pass reads 42.6 MB of int8 codes plus 5.3 MB of S (the
//   backward also writes 5.3 MB of dS), about 14-16 us at 3.35 TB/s, and
//   the codes fit in the 50 MB L2.  Not the limit.
// - instruction issue: every one of the 42.6 M elements runs one logPhi
//   (forward) or one hazard ratio (backward) in IEEE f32.  Without
//   --use_fast_math, expf, logf, the reciprocal and the division compile
//   to 8-27 instructions each, with range checks and branches to
//   slow-path calls; the direct branch (t > -4) of logPhi alone is about
//   68 SASS instructions, of the hazard ratio about 70.  With the
//   contraction, the code decode and the loop, the band loops issue some
//   84 (forward) and 93 (backward) instructions per element: an issue
//   floor near 0.11 and 0.12 ms at the card's 1.98 GHz, which it holds
//   under this load.  This is the limit, and the numerics' share of it is
//   fixed, since they must not change.
// - the SFU: 2 (forward) or 4 (backward) MUFU operations per element, at
//   a quarter of the issue rate: below the issue floor.
// So the design cuts the instructions around the numerics and keeps the
// issue slots full:
// - a thread owns kCols columns (Tile<R>), kGroup apart, so the loads of a
//   warp stay coalesced, and pays the shared-memory reads of C and the
//   loop overhead once per band for all of them; it loads the next band's
//   codes while the current band's math runs;
// - masked entries take t = 0 and are dropped by a select: no branch, and
//   no warp sent down the tail branch by an entry it then ignores;
// - the bands of a tile are split into ranges (kSplitFwd blocks in the
//   forward, kSplitBwd thread groups of a block in the backward), so a
//   launch is some five waves of short blocks rather than one and a third
//   of long ones, whose last partial wave left SMs idle;
// - the backward sums dX*S over a thread's columns in registers, then
//   reduces the per-band dC over the warp two ranks per exchange
//   (warp_sums), and the groups of a block add their dS in shared memory.
// Each block writes its partial sums; the ordered pass of common.cuh adds
// them in double.  No float atomics, so two launches on the same inputs
// give the same bits and a resumed solve is bitwise the straight one.  (A
// one-launch variant, the blocks of a map as a thread-block cluster summed
// by the first, timed no faster at R=2 and slower at R=10.)
// The numerics are the JAX kernel's own: the A&S 7.1.26 erf, the Mills tail
// below t=-4 in logPhi, and the hazard ratio with max(den, 1e-30).  Each
// element's value is what it was; only the order of the sums differs (the
// dS sums run per band range, the dC sums per thread's columns with FMAs).
// Build without --use_fast_math, or the results leave parity with the
// reference.

#include "common.cuh"

using namespace qsc;

namespace {

// A thread group of kGroup threads covers the columns of one tile; a
// thread owns kCols of them, kGroup apart, so that each load instruction
// of a warp stays coalesced.
constexpr int kGroup = 64;
constexpr int kGroupWarps = kGroup / 32;
template <int R>
struct Tile {
  static constexpr int kColsFwd = 2;
  static constexpr int kColsBwd = R <= 3 ? 4 : 2;
};
// The bands of a tile are split into this many ranges: across blocks in
// the forward (each writes its own partial), across the thread groups of
// one block in the backward (which add their dS in shared memory).
constexpr int kSplitFwd = 2;
constexpr int kSplitBwd = 4;

// phi(t) / Phi(t) (fused_likelihood.py:_hazard_ratio).
__device__ __forceinline__ float hazard_ratio(float t) {
  if (t < -4.0f) {
    return -t / mills_series(t);
  }
  const float num = expf(-0.5f * t * t - kLogSqrt2Pi);
  const float den = 0.5f * (1.0f + as_erf(t * kInvSqrt2));
  return num / fmaxf(den, 1e-30f);
}

// Bands [*k0, *k1) of range i of n.
__device__ __forceinline__ void band_range(int K, int i, int n, int* k0,
                                           int* k1) {
  *k0 = K * i / n;
  *k1 = K * (i + 1) / n;
}

// The CT columns of tile `tile` that thread t of a group owns, and their S.
template <int R, int CT>
struct Columns {
  int p0;
  bool ok[CT];
  float s[CT][R];

  __device__ __forceinline__ Columns(const float* __restrict__ Sb, int P,
                                     int tile, int t) {
    p0 = tile * CT * kGroup + t;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int p = p0 + j * kGroup;
      ok[j] = p < P;
#pragma unroll
      for (int r = 0; r < R; ++r) s[j][r] = ok[j] ? Sb[(size_t)r * P + p] : 0.0f;
    }
  }
};

// The codes of one band at a thread's columns; 2 (masked) past P.
template <int CT>
__device__ __forceinline__ void load_codes(int (&code)[CT],
                                           const uint8_t* __restrict__ y,
                                           const bool (&ok)[CT]) {
#pragma unroll
  for (int j = 0; j < CT; ++j) code[j] = ok[j] ? (int)y[j * kGroup] : 2;
}

// t = sgn * ((x - mean) * inv_s) at an observed entry (sgn * y is y or -y
// exactly); 0 at a masked one, whose term the caller drops, so that it
// never sends its warp down the tail branch.
template <int R>
__device__ __forceinline__ float signed_t(int code, const float (&c)[R],
                                          const float (&s)[R], float mean,
                                          float inv_s) {
  float x = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) x = fmaf(c[r], s[r], x);
  const float y = (x - mean) * inv_s;
  return (unsigned)code < 2u ? (code == 1 ? y : -y) : 0.0f;
}

// The warp's sums of v[0..R-1] into dst[0..R-1]: ranks go in pairs, one
// exchange across the half-warps leaves rank r of the pair in lanes 0-15
// and rank r+1 in lanes 16-31, and a 16-lane tree finishes each; an odd
// last rank takes a warp tree.  A fixed order, so the bits are too.
template <int R>
__device__ __forceinline__ void warp_sums(const float (&v)[R], int lane,
                                          float* __restrict__ dst) {
  const bool hi = (lane & 16) != 0;
#pragma unroll
  for (int r = 0; r + 1 < R; r += 2) {
    float keep = hi ? v[r + 1] : v[r];
    const float give = hi ? v[r] : v[r + 1];
    keep += __shfl_xor_sync(0xffffffffu, give, 16);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      keep += __shfl_xor_sync(0xffffffffu, keep, off);
    }
    if ((lane & 15) == 0) dst[r + hi] = keep;
  }
  if (R & 1) {
    const float s = warp_sum(v[R - 1]);
    if (lane == 0) dst[R - 1] = s;
  }
}

// Calls band(k, codes of band k) for k in [k0, k1); `y` points at band k0
// of the thread's first column.  Band k+1's codes load while band k's math
// runs.
template <int CT, typename Band>
__device__ __forceinline__ void for_each_band(const uint8_t* __restrict__ y,
                                              const bool (&ok)[CT], int k0,
                                              int k1, int P, Band band) {
  if (k0 >= k1) return;
  int cur[CT];
  load_codes<CT>(cur, y, ok);
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    // the last band reloads its own row rather than branch
    y += k + 1 < k1 ? P : 0;
    int nxt[CT];
    load_codes<CT>(nxt, y, ok);
    band(k, cur);
#pragma unroll
    for (int j = 0; j < CT; ++j) cur[j] = nxt[j];
  }
}

// grid (ntiles, B, splits), kGroup threads; dynamic shared memory: K*R
// floats.  partial: [B, splits * ntiles].
template <int R>
__global__ void __launch_bounds__(kGroup) onebit_fwd_kernel(
    const float* __restrict__ S, const float* __restrict__ C,
    const int8_t* __restrict__ codes, float* __restrict__ partial,
    int K, int P, float mean, float inv_s) {
  constexpr int CT = Tile<R>::kColsFwd;
  extern __shared__ float sC[];
  __shared__ float sWarp[kGroupWarps];
  const int b = blockIdx.y;
  int k0, k1;
  band_range(K, blockIdx.z, gridDim.z, &k0, &k1);
  const float* Cb = C + (size_t)b * K * R;
  for (int i = k0 * R + threadIdx.x; i < k1 * R; i += kGroup) sC[i] = Cb[i];
  __syncthreads();

  const Columns<R, CT> col(S + (size_t)b * R * P, P, blockIdx.x, threadIdx.x);
  const uint8_t* y = reinterpret_cast<const uint8_t*>(codes) +
                     ((size_t)b * K + k0) * P + col.p0;
  float acc = 0.0f;
  for_each_band<CT>(y, col.ok, k0, k1, P, [&](int k, const int (&code)[CT]) {
    float c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = sC[k * R + r];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float v = log_ndtr(signed_t<R>(code[j], c, col.s[j], mean, inv_s));
      acc -= (unsigned)code[j] < 2u ? v : 0.0f;
    }
  });

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc = warp_sum(acc);
  if (lane == 0) sWarp[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kGroupWarps; ++w) total += sWarp[w];
    partial[((size_t)b * gridDim.z + blockIdx.z) * gridDim.x + blockIdx.x] =
        total;
  }
}

// Dynamic shared memory of the backward, in floats: C, the warps' dC
// partials, and the dS of groups 1.. for group 0 to add.
template <int R>
size_t bwd_smem_floats(int K) {
  return (size_t)(1 + kGroupWarps) * K * R +
         (size_t)(kSplitBwd - 1) * Tile<R>::kColsBwd * R * kGroup;
}

// grid (ntiles, B), kSplitBwd groups of kGroup threads; group g takes band
// range g of the tile.  dC_partial: [B, ntiles, K*R].  The minimum of one
// block per SM lets ptxas use the registers it needs: with the default it
// spills a few bytes around the division's slow-path call at some ranks.
template <int R>
__global__ void __launch_bounds__(kGroup * kSplitBwd, 1) onebit_bwd_kernel(
    const float* __restrict__ S, const float* __restrict__ C,
    const int8_t* __restrict__ codes, const float* __restrict__ g,
    float* __restrict__ dS, float* __restrict__ dC_partial,
    int K, int P, float mean, float inv_s) {
  constexpr int CT = Tile<R>::kColsBwd;
  extern __shared__ float smem[];
  const int KR = K * R;
  float* sC = smem;
  float* sWarp = smem + KR;                    // [kGroupWarps][K*R]
  float* sDS = sWarp + kGroupWarps * KR;       // [kSplitBwd-1][CT][R][kGroup]
  const int b = blockIdx.y;
  const int group = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int lane = t & 31, warp = t >> 5;
  const float* Cb = C + (size_t)b * KR;
  for (int i = threadIdx.x; i < KR; i += kGroup * kSplitBwd) sC[i] = Cb[i];
  __syncthreads();

  int k0, k1;
  band_range(K, group, kSplitBwd, &k0, &k1);
  const Columns<R, CT> col(S + (size_t)b * R * P, P, blockIdx.x, t);
  const uint8_t* y = reinterpret_cast<const uint8_t*>(codes) +
                     ((size_t)b * K + k0) * P + col.p0;
  const float scale = g[b] * -inv_s;
  float ds[CT][R];
#pragma unroll
  for (int j = 0; j < CT; ++j) {
#pragma unroll
    for (int r = 0; r < R; ++r) ds[j][r] = 0.0f;
  }
  float* sWarpW = sWarp + warp * KR;
  for_each_band<CT>(y, col.ok, k0, k1, P, [&](int k, const int (&code)[CT]) {
    float c[R], dc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c[r] = sC[k * R + r];
      dc[r] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      // dx = g * (-inv_s) * sgn * phi/Phi(t); scale * sgn is +-scale exactly
      const float h = hazard_ratio(signed_t<R>(code[j], c, col.s[j], mean,
                                               inv_s));
      const float dx = (unsigned)code[j] < 2u
                           ? (code[j] == 1 ? scale : -scale) * h : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ds[j][r] = fmaf(c[r], dx, ds[j][r]);
        dc[r] = fmaf(dx, col.s[j][r], dc[r]);
      }
    }
    warp_sums<R>(dc, lane, sWarpW + k * R);
  });

  // dS: group 0 adds the other groups' sums, in group order
  if (group > 0) {
#pragma unroll
    for (int j = 0; j < CT; ++j) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sDS[(((group - 1) * CT + j) * R + r) * kGroup + t] = ds[j][r];
      }
    }
  }
  __syncthreads();
  if (group == 0) {
    float* dSb = dS + (size_t)b * R * P;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      if (!col.ok[j]) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v = ds[j][r];
        for (int q = 0; q < kSplitBwd - 1; ++q) {
          v += sDS[((q * CT + j) * R + r) * kGroup + t];
        }
        dSb[(size_t)r * P + col.p0 + j * kGroup] = v;
      }
    }
  }
  // dC: band k's entries come from the warps of the group that took it
  float* out = dC_partial + ((size_t)b * gridDim.x + blockIdx.x) * KR;
  for (int i = threadIdx.x; i < KR; i += kGroup * kSplitBwd) {
    float a = 0.0f;
    for (int w = 0; w < kGroupWarps; ++w) a += sWarp[w * KR + i];
    out[i] = a;
  }
}

template <int R>
int tiles(int P, bool bwd) {
  const int cols = (bwd ? Tile<R>::kColsBwd : Tile<R>::kColsFwd) * kGroup;
  return (P + cols - 1) / cols;
}

int splits_fwd(int K) { return K < kSplitFwd ? K : kSplitFwd; }

}  // namespace

extern "C" {

// Columns per thread of the forward (bwd = 0) or backward kernel at rank
// R; 0 for a rank outside 1..16.
int qsc_onebit_cols(int R, int bwd) {
  switch (R) {
#define QSC_COLS(r) \
    case r: return bwd ? Tile<r>::kColsBwd : Tile<r>::kColsFwd;
    QSC_RANK_CASES(QSC_COLS)
#undef QSC_COLS
    default: return 0;
  }
}

// Partial sums per map of the forward (bwd = 0) or backward kernel at rank
// R (the size of their scratch); 0 for a rank outside 1..16.
int qsc_onebit_blocks(int R, int K, int P, int bwd) {
  switch (R) {
#define QSC_BLOCKS(r) \
    case r: return bwd ? tiles<r>(P, true) : tiles<r>(P, false) * splits_fwd(K);
    QSC_RANK_CASES(QSC_BLOCKS)
#undef QSC_BLOCKS
    default: return 0;
  }
}

// partial: [B, qsc_onebit_blocks(R, K, P, 0)] scratch; out: [B].  Returns a
// cudaError_t value.
int qsc_onebit_nll_fwd(const float* S, const float* C, const int8_t* codes,
                       float* partial, float* out, int B, int R, int K, int P,
                       float mean, float inv_s, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int ntiles = qsc_onebit_blocks(R, K, P, 0) / splits_fwd(K);
  const dim3 grid(ntiles, B, splits_fwd(K));
  const size_t smem = (size_t)K * R * sizeof(float);
  switch (R) {
#define QSC_FWD(r) \
    case r: onebit_fwd_kernel<r><<<grid, kGroup, smem, stream>>>( \
        S, C, codes, partial, K, P, mean, inv_s); break;
    QSC_RANK_CASES(QSC_FWD)
#undef QSC_FWD
    default: return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_sum_partials(partial, out, B, ntiles * splits_fwd(K), 1,
                             stream);
}

// g: [B]; dS: [B,R,P]; dC_partial: [B, qsc_onebit_blocks(R, K, P, 1), K*R]
// scratch; dC: [B,K,R].  Returns a cudaError_t value.
int qsc_onebit_nll_bwd(const float* S, const float* C, const int8_t* codes,
                       const float* g, float* dS, float* dC_partial, float* dC,
                       int B, int R, int K, int P, float mean, float inv_s,
                       void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int ntiles = qsc_onebit_blocks(R, K, P, 1);
  const dim3 grid(ntiles, B);
  switch (R) {
#define QSC_BWD(r) \
    case r: onebit_bwd_kernel<r><<<grid, kGroup * kSplitBwd, \
        bwd_smem_floats<r>(K) * sizeof(float), stream>>>( \
        S, C, codes, g, dS, dC_partial, K, P, mean, inv_s); break;
    QSC_RANK_CASES(QSC_BWD)
#undef QSC_BWD
    default: return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_sum_partials(dC_partial, dC, B, ntiles, K * R, stream);
}

}  // extern "C"
