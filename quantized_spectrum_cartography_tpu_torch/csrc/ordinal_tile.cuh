// The tile body of the ordinal probit NLL kernels, forward and backward, for
// Hopper (sm_90a), shared by the two encodings of the observations: f32 bin
// bounds (quantized_nll.cu) and int8 codes with a boundary table
// (quantized_nll_coded.cu).  Each of those files defines one observation
// source and instantiates the kernels below on it; the numerics are in
// ordinal.cuh.
//
// Per map b:
//   nll[b] = -sum_{k,p} log(Phi((U - x)/s) - Phi((W - x)/s)),
//   x = log(X + offset) (log link) or X (linear link), X[b] = C[b] @ S[b];
//   dX = -g[b] * dlogP/dx * (1 or 1/(X + offset)),
//   dS[b] = C[b]^T dX,  dC[b] = dX S[b]^T.
// A masked entry adds exactly 0 to the value and to the gradients.
// Layout: S [B,R,P] f32, C [B,K,R] f32, observations [B,K,P], P = I*J (no
// lane padding), with a batch stride per input that may be 0: the z-search
// scorer shares C and the observations across candidates.
//
// What bounds it on an H100: the bytes are few (1 B an entry coded, 8 B as
// bounds: at most 0.00039 ms at the MLE-GAN shape, B=1, K=64, P=2601, and
// 0.10 ms at the low-rank shape, B=256).  The arithmetic is the JAX
// kernels' IEEE numerics on every observed entry: without --use_fast_math,
// erf, exp and log compile to long instruction sequences, so the limit is
// instruction issue over the observed entries (bench_ordinal.py --floor
// reads the instructions per entry from the SASS and gives the issue
// floor).  The first design (a thread per column looping over the K bands)
// made 11 blocks of 64 dependent steps at B=1 and ran the numerics of a
// warp's band wherever one lane was observed (96.6% of them at a 10%
// sample).  This design:
// - a block takes a tile of kTileCols columns and all K bands, in chunks
//   of kChunkBands; the split depends on K and P only, never on B, so the
//   scorer's one launch over N candidates gives the N single launches'
//   bits;
// - phase 1 (compaction): the block reads the chunk's observations with
//   coalesced loads and keeps a bit for each observed entry; where an entry
//   is masked, it lists the observed entries in shared memory, in an order
//   fixed by the mask, from a scan of the threads' counts; where none is
//   (the low-rank case), no list is built;
// - phase 2: the block's threads run the numerics densely over the
//   observed entries, with (W, U) from the source: where none is masked,
//   each thread its own entries of phase 1, in order; else thread t the
//   list entries t, t + kThreads, ...; the forward sums log P per thread,
//   the backward writes dX into a [bands x columns] tile in shared memory
//   (0 where masked);
// - phase 3 (backward): dS (a sum over bands per column) and dC (a sum over
//   columns per band) from that tile with FMAs, in a fixed order: the dS
//   of a column is summed by four threads over interleaved bands and added
//   in order at the end; the dC of a band by four threads over interleaved
//   columns, added by two exchanges;
// - the forward writes one partial sum per block and the backward one dC
//   partial per block; the ordered pass of common.cuh adds them in double.
//   No float atomics, so two launches on the same inputs give the same bits.
// Both sources give each entry the same (W, U) floats, the same X by the
// same FMAs and the same numerics, and list the same entries in the same
// order where their masks agree, so a coded launch and a bounds launch on
// (W, U) = table[codes] give the same bits.
//
// An observation source Obs provides:
//   Args    its kernel arguments;
//   Table   what a block keeps in shared memory for all its chunks;
//   Chunk   what phase 1 leaves in shared memory for phase 2;
//   Cursor(const Args&, at): a chunk's observations, `at` the offset of its
//     first band at the tile's first column;
//   fwd_blocks_per_sm(R), bwd_blocks_per_sm(R): the kernels' occupancy,
//     which caps their registers;
//   load_table(Table&, const Args&): once per block;
//   observe<BWD, FAST>(Chunk&, const Cursor&, kb, ncols, P): phase 1, the
//     bits of the calling thread's entries t + j * kThreads, j < kSteps
//     (band t / kTileCols + j * kBandsPerStep, column t % kTileCols),
//     observed and in the chunk's kb bands and ncols columns;
//   dense(const Table&, const Chunk&, const Cursor&, j, P, w, u): phase 2,
//     (W, U) of the calling thread's entry t + j * kThreads;
//   listed(const Table&, const Chunk&, const Cursor&, e, P, w, u): phase 2,
//     (W, U) of the listed entry e (band e / kTileCols, column
//     e % kTileCols).
// Phase 2 asks only for entries in range that phase 1 marked observed.

#pragma once

#include "ordinal.cuh"

namespace qsc {

constexpr int kTileCols = 64;                   // columns of a block's tile
constexpr int kChunkBands = 64;                 // bands of a chunk
constexpr int kChunk = kTileCols * kChunkBands;          // entries a chunk
constexpr int kSteps = kChunk / kThreads;                // entries a thread
constexpr int kBandsPerStep = kThreads / kTileCols;
constexpr int kRowPad = kTileCols + 4;   // dX row stride: phase 3 reads of
                                         // 8 bands x 4 columns hit 32 banks
// Blocks per SM a kernel is compiled for (a source's fwd_blocks_per_sm and
// bwd_blocks_per_sm, from these unless its registers need fewer), which
// caps its registers at 65536 / (kThreads x blocks): 40 and 64, the fewest
// that ptxas takes for the codes without spilling at any rank.  The
// numerics' chains of dependent instructions need many warps in flight;
// with ptxas' own choice (76-80 registers, 3 blocks) the low-rank shape ran
// 1.1-1.3x slower.
constexpr int kFwdBlocksPerSM = 6;
constexpr int kBwdBlocksPerSM = 4;
static_assert(kThreads == 4 * kChunkBands, "phase 3: 4 threads a band");
static_assert(kSteps <= 32, "phase 1: a bit per entry of a thread");
static_assert(kChunk <= 65536, "an entry's index takes 16 bits");

inline int tiles(int P) { return (P + kTileCols - 1) / kTileCols; }

// The kernels' arguments, passed by value (__grid_constant__).
template <class Obs>
struct Params {
  const float* S;
  const float* C;
  const float* g;        // backward: [B]
  float* partial;        // forward: [B, ntiles]; backward: [B, ntiles, K*R]
  float* dS;             // backward: [B, R, P]
  long long stride_S, stride_C, stride_obs;   // batch strides, 0: shared
  int K, P;
  float inv_s, offset;
  typename Obs::Args obs;
};

template <class Obs, int R, bool BWD>
struct Smem {
  typename Obs::Table table;
  float S[R][kTileCols];
  float C[kChunkBands * R];
  union {
    // entry e = band * kTileCols + column of the chunk: what phase 1 leaves
    // for phase 2, and the list of observed entries, thread by thread
    struct {
      typename Obs::Chunk obs;
      uint16_t list[kChunk];
    } chunk;
    // after phase 3: the dS sums of threads kTileCols.. for threads
    // 0..kTileCols-1 to add
    float red[BWD ? (kBandsPerStep - 1) * R * kTileCols : 1];
  };
  float dX[BWD ? kChunkBands * kRowPad : 1];
  int warp_count[kWarps];   // observed entries of each warp
  float warp_acc[kWarps];
};

// The block's shared inputs: the source's table and its tile of S (0 past
// P).  Made visible by phase 1's first barrier.
template <class Obs, int R, bool BWD>
__device__ __forceinline__ void load_tile(Smem<Obs, R, BWD>& sm,
                                          const Params<Obs>& p, int b,
                                          int p0, int ncols) {
  Obs::load_table(sm.table, p.obs);
  const float* Sb = p.S + b * p.stride_S + p0;
  for (int i = threadIdx.x; i < R * kTileCols; i += kThreads) {
    const int r = i / kTileCols, c = i % kTileCols;
    sm.S[r][c] = c < ncols ? Sb[(size_t)r * p.P + c] : 0.0f;
  }
}

// Calls f(kl, cl, w, u, X) for every observed entry (band kl, column cl) of
// a chunk, with X = (C @ S)[k, p] by the FMAs of the first design; the
// backward's dX gets 0 at every other entry of the tile.
// Phase 1 (Obs::observe) gives each thread a bit for each of its entries.
// A scan of the threads' counts (over the warp by exchanges, over the warps
// after one barrier) gives the chunk's count and each thread's place in the
// list:
// - if every entry in range is observed (the dense case), thread t runs its
//   own entries t, t + kThreads, ... in range, in order: its column and
//   a band that steps by kBandsPerStep, with no list to read;
// - else each thread lists its observed entries in sm.chunk.list, thread
//   by thread, and after one more barrier thread t runs list entries t,
//   t + kThreads, ...
// Either way the order is fixed by the mask alone.  The numerics exist
// once in each loop: sixteen inlined copies overflowed the instruction
// cache.  `at`: the offset of the chunk's first band at the tile's first
// column in the observations.
template <bool FAST, class Obs, int R, bool BWD, typename F>
__device__ __forceinline__ void for_each_observed(
    Smem<Obs, R, BWD>& sm, const Params<Obs>& p, size_t at, int kb,
    int ncols, F f) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cl = t % kTileCols, kq = t / kTileCols;
  const typename Obs::Cursor cur(p.obs, at);
  unsigned bits =
      Obs::template observe<BWD, FAST>(sm.chunk.obs, cur, kb, ncols, p.P);
  if constexpr (BWD) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (!((bits >> j) & 1u)) {
        sm.dX[(kq + j * kBandsPerStep) * kRowPad + cl] = 0.0f;
      }
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
  int n = 0, at_list = incl - count;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int m = sm.warp_count[w];
    at_list += w < warp ? m : 0;
    n += m;
  }
  if (n == ncols * kb) {
    // the dense case: count is this thread's entries in range
#pragma unroll 1
    for (int j = 0; j < count; ++j) {
      const int kl = kq + j * kBandsPerStep;
      float w, u;
      Obs::dense(sm.table, sm.chunk.obs, cur, j, p.P, w, u);
      float X = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) X = fmaf(sm.C[kl * R + r], sm.S[r][cl], X);
      f(kl, cl, w, u, X);
    }
    return;
  }
  for (; bits != 0; bits &= bits - 1) {
    sm.chunk.list[at_list++] = (uint16_t)(t + (__ffs(bits) - 1) * kThreads);
  }
  __syncthreads();
#pragma unroll 1
  for (int i = t; i < n; i += kThreads) {
    const unsigned e = sm.chunk.list[i];
    const int kl = e / kTileCols, col = e % kTileCols;
    float w, u;
    Obs::listed(sm.table, sm.chunk.obs, cur, e, p.P, w, u);
    float X = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) X = fmaf(sm.C[kl * R + r], sm.S[r][col], X);
    f(kl, col, w, u, X);
  }
}

// grid (ntiles, B).  partial: [B, ntiles].
template <class Obs, int R, bool LINEAR, bool FAST>
__global__ void __launch_bounds__(kThreads, Obs::fwd_blocks_per_sm(R))
qnll_fwd_kernel(const __grid_constant__ Params<Obs> p) {
  __shared__ Smem<Obs, R, false> sm;
  const int b = blockIdx.y, t = threadIdx.x;
  const int p0 = blockIdx.x * kTileCols;
  const int ncols = min(kTileCols, p.P - p0);
  load_tile(sm, p, b, p0, ncols);
  const size_t at = b * p.stride_obs + p0;
  const float* Cb = p.C + b * p.stride_C;
  float acc = 0.0f;
  for (int k0 = 0; k0 < p.K; k0 += kChunkBands) {
    const int kb = min(kChunkBands, p.K - k0);
    if (k0 > 0) __syncthreads();          // the last chunk's readers are done
    for (int i = t; i < kb * R; i += kThreads) sm.C[i] = Cb[k0 * R + i];
    for_each_observed<FAST>(sm, p, at + (size_t)k0 * p.P, kb, ncols,
                            [&](int, int, float w, float u, float X) {
      acc -= Entry<LINEAR, FAST>(X, w, u, p.inv_s, p.offset).logP;
    });
  }
  acc = warp_sum(acc);
  if ((t & 31) == 0) sm.warp_acc[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += sm.warp_acc[w];
    p.partial[(size_t)b * gridDim.x + blockIdx.x] = total;
  }
}

// grid (ntiles, B).  dC_partial: [B, ntiles, K*R]: tile i's sums over its
// columns.
template <class Obs, int R, bool LINEAR, bool FAST>
__global__ void __launch_bounds__(kThreads, Obs::bwd_blocks_per_sm(R))
qnll_bwd_kernel(const __grid_constant__ Params<Obs> p) {
  __shared__ Smem<Obs, R, true> sm;
  const int b = blockIdx.y, t = threadIdx.x;
  const int p0 = blockIdx.x * kTileCols;
  const int ncols = min(kTileCols, p.P - p0);
  load_tile(sm, p, b, p0, ncols);
  const size_t at = b * p.stride_obs + p0;
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
    for (int i = t; i < kb * R; i += kThreads) sm.C[i] = Cb[k0 * R + i];
    for_each_observed<FAST>(sm, p, at + (size_t)k0 * p.P, kb, ncols,
                            [&](int kl, int cl, float w, float u, float X) {
      const Entry<LINEAR, FAST> en(X, w, u, p.inv_s, p.offset);
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

template <class Obs, bool BWD, bool LINEAR, bool FAST>
int launch_rank(int R, dim3 grid, cudaStream_t stream,
                const Params<Obs>& p) {
  switch (R) {
#define QSC_CASE(r)                                                          \
    case r:                                                                  \
      if constexpr (BWD) {                                                   \
        qnll_bwd_kernel<Obs, r, LINEAR, FAST>                                \
            <<<grid, kThreads, 0, stream>>>(p);                              \
      } else {                                                               \
        qnll_fwd_kernel<Obs, r, LINEAR, FAST>                                \
            <<<grid, kThreads, 0, stream>>>(p);                              \
      }                                                                      \
      break;
    QSC_RANK_CASES(QSC_CASE)
#undef QSC_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One kernel (grid: a tile of columns x the B maps), then the ordered pass
// that adds its partials per map and tile into out: 1 each forward (out:
// [B]), K*R backward (out: dC [B,K,R]).  Returns a cudaError_t.
template <class Obs, bool BWD>
int launch(const Params<Obs>& p, int B, int R, int linear, int fast,
           float* out, void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid(tiles(p.P), B);
  int err;
  if (linear) {
    err = fast ? launch_rank<Obs, BWD, true, true>(R, grid, stream, p)
               : launch_rank<Obs, BWD, true, false>(R, grid, stream, p);
  } else {
    err = fast ? launch_rank<Obs, BWD, false, true>(R, grid, stream, p)
               : launch_rank<Obs, BWD, false, false>(R, grid, stream, p);
  }
  if (err != 0) return err;
  return launch_sum_partials(p.partial, out, B, tiles(p.P),
                             BWD ? p.K * R : 1, stream);
}

}  // namespace qsc
