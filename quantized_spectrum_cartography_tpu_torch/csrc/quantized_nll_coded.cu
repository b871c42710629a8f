// Ordinal probit NLL of a rank-R reconstruction from int8 bin codes, forward
// and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel pair in
// quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py:
//   _fwd_kernel_coded (called by _fwd_pallas_coded)
//     nll[b] = -sum_{k,p} log(Phi((U - x)/s) - Phi((W - x)/s)),
//     x = log(X + offset) (log link) or X (linear link), X[b] = C[b] @ S[b],
//     (W, U) = (bb[c], bb[c+1]) for code c < nbins; code >= nbins is masked;
//   _bwd_kernel_coded (called by _bwd_pallas_coded)
//     dX = -g[b] * dlogP/dx * (1 or 1/(X + offset)),
//     dS[b] = C[b]^T dX,  dC[b] = dX S[b]^T.
// A masked entry adds exactly 0 to the value and to the gradients.
// Layout: S [B,R,P] f32, C [B,K,R] f32, codes [B,K,P] int8, P = I*J (no
// lane padding), with a batch stride per input that may be 0: the z-search
// scorer shares C and the codes across candidates.
//
// What bounds it on an H100: each entry reads 1 B, so the bytes bound is
// far below the arithmetic (0.00006 ms at the MLE-GAN shape, B=1, K=64,
// P=2601; 0.013 ms at the low-rank shape, B=256).  The arithmetic is the
// JAX kernels' IEEE numerics on every observed entry: without
// --use_fast_math, erf, exp and log compile to long instruction sequences,
// so the limit is instruction issue over the observed entries
// (bench_ordinal.py --floor reads the instructions per entry from the SASS
// and gives the issue floor).  What the
// previous design (one thread per column looping over the K bands) lost:
// - at B=1 a map made 11 blocks, each a 64-step chain of dependent loads;
// - a masked entry was skipped per thread, so a warp with one observed lane
//   in a band issued the whole transcendental path for it: at a 10% sample
//   96.6% of a warp's bands have one;
// - codes were decoded by an nbins-long select chain, and dC was reduced
//   by R warp reductions per band.
// This design:
// - a block takes a tile of kTileCols columns and all K bands, in chunks
//   of kChunkBands; the split depends on K and P only, never on B, so the
//   scorer's one launch over N candidates gives the N single launches'
//   bits;
// - phase 1 (compaction): the block reads the chunk's codes with coalesced
//   loads, 16 a thread, all issued before any is used, into shared memory;
//   where an entry is masked, it lists the observed entries in shared
//   memory, in an order fixed by the codes, from a scan of the threads'
//   counts; where none is (the low-rank case), no list is built;
// - phase 2: the block's threads run the numerics densely over the
//   observed entries, with the codes decoded by two shared-memory loads of
//   the boundary table; the forward sums log P per thread, the backward
//   writes dX into a [bands x columns] tile in shared memory (0 where
//   masked);
// - phase 3 (backward): dS (a sum over bands per column) and dC (a sum over
//   columns per band) from that tile with FMAs, in a fixed order: the dS
//   of a column is summed by four threads over interleaved bands and added
//   in order at the end; the dC of a band by four threads over interleaved
//   columns, added by two exchanges;
// - the forward writes one partial sum per block and the backward one dC
//   partial per block; the ordered pass of common.cuh adds them in double.
//   No float atomics, so two launches on the same inputs give the same bits.
// Each element's value is what it was in the previous design (the same X by
// the same FMAs, the same numerics); only the order of the sums differs.

#include "ordinal.cuh"

using namespace qsc;

namespace {

constexpr int kTileCols = 64;                   // columns of a block's tile
constexpr int kChunkBands = 64;                 // bands of a chunk
constexpr int kCodedThreads = 256;
constexpr int kCodedWarps = kCodedThreads / 32;
constexpr int kChunk = kTileCols * kChunkBands;          // entries a chunk
constexpr int kSteps = kChunk / kCodedThreads;           // entries a thread
constexpr int kBandsPerStep = kCodedThreads / kTileCols;
constexpr int kRowPad = kTileCols + 4;   // dX row stride: phase 3 reads of
                                         // 8 bands x 4 columns hit 32 banks
constexpr int kMaxTable = 33;            // nbins + 1 boundaries, nbins < 32
// Blocks per SM each kernel is compiled for, which caps its registers at
// 65536 / (kCodedThreads x blocks): 40 and 64, the fewest that ptxas
// takes without spilling at any rank.  The numerics' chains of dependent
// instructions need many warps in flight; with ptxas' own choice (76-80
// registers, 3 blocks) the low-rank shape ran 1.1-1.3x slower.
constexpr int kFwdBlocksPerSM = 6;
constexpr int kBwdBlocksPerSM = 4;
static_assert(kCodedThreads == 4 * kChunkBands, "phase 3: 4 threads a band");
static_assert(kSteps <= 32, "phase 1: a bit per entry of a thread");
static_assert(kChunk <= 65536, "an entry's index takes 16 bits");

// The kernels' arguments, passed by value (__grid_constant__).
struct CodedParams {
  const float* S;
  const float* C;
  const int8_t* codes;
  const float* g;        // backward: [B]
  float* partial;        // forward: [B, ntiles]; backward: [B, ntiles, K*R]
  float* dS;             // backward: [B, R, P]
  long long stride_S, stride_C, stride_obs;   // batch strides, 0: shared
  int K, P, nbins;
  float inv_s, offset;
  float bb[kMaxTable];
};

template <int R, bool BWD>
struct Smem {
  float bb[kMaxTable];
  float S[R][kTileCols];
  float C[kChunkBands * R];
  union {
    // entry e = band * kTileCols + column of the chunk: its code (255 past
    // the tile), and the list of observed entries, thread by thread
    struct {
      uint8_t code[kChunk];
      uint16_t list[kChunk];
    } chunk;
    // after phase 3: the dS sums of threads kTileCols.. for threads
    // 0..kTileCols-1 to add
    float red[BWD ? (kBandsPerStep - 1) * R * kTileCols : 1];
  };
  float dX[BWD ? kChunkBands * kRowPad : 1];
  int warp_count[kCodedWarps];   // observed entries of each warp
  float warp_acc[kCodedWarps];
};
static_assert((kBandsPerStep - 1) * 16 * kTileCols * sizeof(float) <=
                  kChunk * (sizeof(uint8_t) + sizeof(uint16_t)),
              "the dS sums fit where the chunk's codes were");

// The block's shared inputs: the boundary table and its tile of S (0 past
// P).  Made visible by phase 1's first barrier.
template <int R, bool BWD>
__device__ __forceinline__ void load_tile(Smem<R, BWD>& sm,
                                          const CodedParams& p, int b,
                                          int p0, int ncols) {
  for (int i = threadIdx.x; i <= p.nbins; i += kCodedThreads) {
    sm.bb[i] = p.bb[i];
  }
  const float* Sb = p.S + b * p.stride_S + p0;
  for (int i = threadIdx.x; i < R * kTileCols; i += kCodedThreads) {
    const int r = i / kTileCols, c = i % kTileCols;
    sm.S[r][c] = c < ncols ? Sb[(size_t)r * p.P + c] : 0.0f;
  }
}

// Calls f(kl, cl, code, X) for every observed entry (band kl, column cl) of
// a chunk, with X = (C @ S)[k, p] by the FMAs of the previous design; the
// backward's dX gets 0 at every other entry of the tile.
// Phase 1: thread t reads the codes of column t % kTileCols at bands
// t / kTileCols + j * kBandsPerStep, j < kSteps (entry e = t + j *
// kCodedThreads), so a warp reads 32 consecutive bytes of one band, all
// loads issued before any is used; it stores them in sm.chunk.code and
// keeps a bit for each observed one.  A scan of the threads' counts (over
// the warp by exchanges, over the warps after one barrier) gives the
// chunk's count and each thread's place in the list:
// - if every entry in range is observed, thread t runs entries t,
//   t + kCodedThreads, ... (those past the tile are skipped);
// - else each thread lists its observed entries in sm.chunk.list, thread
//   by thread, and after one more barrier thread t runs list entries t,
//   t + kCodedThreads, ...
// Either way the order is fixed by the codes alone.  The numerics exist
// once in the code: sixteen inlined copies overflowed the instruction
// cache.  `y` points at the chunk's first band, at the tile's first column.
template <int R, bool BWD, typename F>
__device__ __forceinline__ void for_each_observed(
    Smem<R, BWD>& sm, const uint8_t* __restrict__ y, int kb, int ncols,
    int nbins, int P, F f) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cl = t % kTileCols, kq = t / kTileCols;
  unsigned code[kSteps];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int kl = kq + j * kBandsPerStep;
    code[j] = (cl < ncols && kl < kb) ? y[(size_t)kl * P + cl] : 255u;
  }
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const bool obs = code[j] < (unsigned)nbins;
    sm.chunk.code[t + j * kCodedThreads] = (uint8_t)code[j];
    bits |= (unsigned)obs << j;
    if constexpr (BWD) {
      if (!obs) sm.dX[(kq + j * kBandsPerStep) * kRowPad + cl] = 0.0f;
    }
  }
  const int count = __popc(bits);
  int incl = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int m = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += m;
  }
  if (lane == 31) sm.warp_count[warp] = incl;
  __syncthreads();
  int n = 0, at = incl - count;
#pragma unroll
  for (int w = 0; w < kCodedWarps; ++w) {
    const int m = sm.warp_count[w];
    at += w < warp ? m : 0;
    n += m;
  }
  const bool all = n == ncols * kb;
  if (all) {
    n = kChunk;
  } else {
    for (; bits != 0; bits &= bits - 1) {
      sm.chunk.list[at++] = (uint16_t)(t + (__ffs(bits) - 1) * kCodedThreads);
    }
    __syncthreads();
  }
#pragma unroll 1
  for (int i = t; i < n; i += kCodedThreads) {
    const int e = all ? i : sm.chunk.list[i];
    const unsigned c = sm.chunk.code[e];
    if (c >= (unsigned)nbins) continue;   // with `all`, past the tile only
    const int kl = e / kTileCols, col = e % kTileCols;
    float X = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) X = fmaf(sm.C[kl * R + r], sm.S[r][col], X);
    f(kl, col, (int)c, X);
  }
}

// grid (ntiles, B).  partial: [B, ntiles].
template <int R, bool LINEAR, bool FAST>
__global__ void __launch_bounds__(kCodedThreads, kFwdBlocksPerSM)
qnll_coded_fwd_kernel(const __grid_constant__ CodedParams p) {
  __shared__ Smem<R, false> sm;
  const int b = blockIdx.y, t = threadIdx.x;
  const int p0 = blockIdx.x * kTileCols;
  const int ncols = min(kTileCols, p.P - p0);
  load_tile(sm, p, b, p0, ncols);
  const uint8_t* y = reinterpret_cast<const uint8_t*>(p.codes) +
                     b * p.stride_obs + p0;
  const float* Cb = p.C + b * p.stride_C;
  float acc = 0.0f;
  for (int k0 = 0; k0 < p.K; k0 += kChunkBands) {
    const int kb = min(kChunkBands, p.K - k0);
    if (k0 > 0) __syncthreads();          // the last chunk's readers are done
    for (int i = t; i < kb * R; i += kCodedThreads) sm.C[i] = Cb[k0 * R + i];
    for_each_observed(sm, y + (size_t)k0 * p.P, kb, ncols, p.nbins, p.P,
                      [&](int, int, int c, float X) {
      acc -= Entry<LINEAR, FAST>(X, sm.bb[c], sm.bb[c + 1], p.inv_s,
                                 p.offset).logP;
    });
  }
  acc = warp_sum(acc);
  if ((t & 31) == 0) sm.warp_acc[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    float total = 0.0f;
    for (int w = 0; w < kCodedWarps; ++w) total += sm.warp_acc[w];
    p.partial[(size_t)b * gridDim.x + blockIdx.x] = total;
  }
}

// grid (ntiles, B).  dC_partial: [B, ntiles, K*R]: tile i's sums over its
// columns.
template <int R, bool LINEAR, bool FAST>
__global__ void __launch_bounds__(kCodedThreads, kBwdBlocksPerSM)
qnll_coded_bwd_kernel(const __grid_constant__ CodedParams p) {
  __shared__ Smem<R, true> sm;
  const int b = blockIdx.y, t = threadIdx.x;
  const int p0 = blockIdx.x * kTileCols;
  const int ncols = min(kTileCols, p.P - p0);
  load_tile(sm, p, b, p0, ncols);
  const uint8_t* y = reinterpret_cast<const uint8_t*>(p.codes) +
                     b * p.stride_obs + p0;
  const float* Cb = p.C + b * p.stride_C;
  const float gb = p.g[b];
  float* dC_out = p.partial + ((size_t)b * gridDim.x + blockIdx.x) * p.K * R;
  // phase 3's threads: dS of column s_col over bands s_q, s_q + 4, ...;
  // dC of band c_band over columns c_q, c_q + 4, ...
  const int s_col = t % kTileCols, s_q = t / kTileCols;
  const int c_band = t / 4, c_q = t % 4;
  float* dSb = p.dS + (size_t)b * R * p.P + p0 + s_col;

  for (int k0 = 0; k0 < p.K; k0 += kChunkBands) {
    const int kb = min(kChunkBands, p.K - k0);
    if (k0 > 0) __syncthreads();          // the last chunk's readers are done
    for (int i = t; i < kb * R; i += kCodedThreads) sm.C[i] = Cb[k0 * R + i];
    for_each_observed(sm, y + (size_t)k0 * p.P, kb, ncols, p.nbins, p.P,
                      [&](int kl, int cl, int c, float X) {
      const Entry<LINEAR, FAST> en(X, sm.bb[c], sm.bb[c + 1], p.inv_s,
                                   p.offset);
      const float dlogp = dlogp_dx(en.a, en.b, en.logP, p.inv_s);
      sm.dX[kl * kRowPad + cl] = -gb * (LINEAR ? dlogp : dlogp / en.xo);
    });
    __syncthreads();

    // phase 3, dS: threads 0..kTileCols-1 add the other band sets' sums in
    // order, and the chunk's sum onto the earlier chunks' in dS itself.
    // Nothing of rank R lives across phase 2, which needs the registers,
    // and dS is done before dC starts.
    {
      float ds[R];
#pragma unroll
      for (int r = 0; r < R; ++r) ds[r] = 0.0f;
      for (int kl = s_q; kl < kb; kl += kBandsPerStep) {
        const float dx = sm.dX[kl * kRowPad + s_col];
#pragma unroll
        for (int r = 0; r < R; ++r) ds[r] = fmaf(sm.C[kl * R + r], dx, ds[r]);
      }
      if (s_q > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sm.red[((s_q - 1) * R + r) * kTileCols + s_col] = ds[r];
        }
      }
      __syncthreads();
      if (s_q == 0 && s_col < ncols) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float v = ds[r];
          for (int q = 0; q < kBandsPerStep - 1; ++q) {
            v += sm.red[(q * R + r) * kTileCols + s_col];
          }
          dSb[(size_t)r * p.P] = k0 == 0 ? v : dSb[(size_t)r * p.P] + v;
        }
      }
    }
    // phase 3, dC: four threads a band, added by two exchanges
    float dc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dc[r] = 0.0f;
    if (c_band < kb) {
#pragma unroll 4
      for (int cl = c_q; cl < kTileCols; cl += 4) {
        const float dx = sm.dX[c_band * kRowPad + cl];
#pragma unroll
        for (int r = 0; r < R; ++r) dc[r] = fmaf(dx, sm.S[r][cl], dc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dc[r] += __shfl_xor_sync(0xffffffffu, dc[r], 1);
      dc[r] += __shfl_xor_sync(0xffffffffu, dc[r], 2);
      if (c_band < kb && (r & 3) == c_q) dC_out[(k0 + c_band) * R + r] = dc[r];
    }
  }
}

template <bool BWD, bool LINEAR, bool FAST>
int launch_rank(int R, dim3 grid, cudaStream_t stream, const CodedParams& p) {
  switch (R) {
#define QSC_CASE(r)                                                          \
    case r:                                                                  \
      if constexpr (BWD) {                                                   \
        qnll_coded_bwd_kernel<r, LINEAR, FAST>                               \
            <<<grid, kCodedThreads, 0, stream>>>(p);                         \
      } else {                                                               \
        qnll_coded_fwd_kernel<r, LINEAR, FAST>                               \
            <<<grid, kCodedThreads, 0, stream>>>(p);                         \
      }                                                                      \
      break;
    QSC_RANK_CASES(QSC_CASE)
#undef QSC_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool BWD>
int launch(bool linear, bool fast, int R, dim3 grid, cudaStream_t stream,
           const CodedParams& p) {
  if (linear) {
    return fast ? launch_rank<BWD, true, true>(R, grid, stream, p)
                : launch_rank<BWD, true, false>(R, grid, stream, p);
  }
  return fast ? launch_rank<BWD, false, true>(R, grid, stream, p)
              : launch_rank<BWD, false, false>(R, grid, stream, p);
}

int tiles(int P) { return (P + kTileCols - 1) / kTileCols; }

// Fills the parameter struct; false if the table does not fit.
bool make_params(CodedParams& p, const float* S, const float* C,
                 const int8_t* codes, const float* table, int nbins,
                 long long stride_S, long long stride_C, long long stride_obs,
                 int K, int P, float inv_s, float offset) {
  if (nbins < 1 || nbins + 1 > kMaxTable) return false;
  p = CodedParams{};
  p.S = S;
  p.C = C;
  p.codes = codes;
  p.stride_S = stride_S;
  p.stride_C = stride_C;
  p.stride_obs = stride_obs;
  p.K = K;
  p.P = P;
  p.nbins = nbins;
  p.inv_s = inv_s;
  p.offset = offset;
  for (int i = 0; i <= nbins; ++i) p.bb[i] = table[i];
  return true;
}

}  // namespace

extern "C" {

// Partial sums per map of either kernel (the size of their scratch): one
// per tile of columns.
int qsc_qnll_coded_tiles(int P) { return tiles(P); }

// Forward: codes with its host table of nbins+1 floats.  partial:
// [B, qsc_qnll_coded_tiles(P)] scratch; out: [B].  Returns a cudaError_t.
int qsc_qnll_coded_fwd(const float* S, const float* C, const int8_t* codes,
                       const float* table, int nbins, float* partial,
                       float* out, int B, int R, int K, int P,
                       long long stride_S, long long stride_C,
                       long long stride_obs, float inv_s, float offset,
                       int linear, int fast, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  CodedParams p;
  if (!make_params(p, S, C, codes, table, nbins, stride_S, stride_C,
                   stride_obs, K, P, inv_s, offset)) {
    return (int)cudaErrorInvalidValue;
  }
  p.partial = partial;
  const int err = launch<false>(linear != 0, fast != 0, R, dim3(tiles(P), B),
                                stream, p);
  if (err != 0) return err;
  return launch_sum_partials(partial, out, B, tiles(P), 1, stream);
}

// Backward, with the inputs of the forward and g: [B]; dS: [B,R,P];
// dC_partial: [B, qsc_qnll_coded_tiles(P), K*R] scratch; dC: [B,K,R].
int qsc_qnll_coded_bwd(const float* S, const float* C, const int8_t* codes,
                       const float* table, int nbins, const float* g,
                       float* dS, float* dC_partial, float* dC, int B, int R,
                       int K, int P, long long stride_S, long long stride_C,
                       long long stride_obs, float inv_s, float offset,
                       int linear, int fast, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  CodedParams p;
  if (!make_params(p, S, C, codes, table, nbins, stride_S, stride_C,
                   stride_obs, K, P, inv_s, offset)) {
    return (int)cudaErrorInvalidValue;
  }
  p.g = g;
  p.dS = dS;
  p.partial = dC_partial;
  const int err = launch<true>(linear != 0, fast != 0, R, dim3(tiles(P), B),
                               stream, p);
  if (err != 0) return err;
  return launch_sum_partials(dC_partial, dC, B, tiles(P), K * R, stream);
}

}  // extern "C"
