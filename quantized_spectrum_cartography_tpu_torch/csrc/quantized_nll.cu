// Ordinal probit NLL of a rank-R reconstruction from f32 bin bounds (W, U),
// forward and backward, for Hopper (sm_90a): the tile kernels of
// ordinal_tile.cuh on the bounds source below.
//
// Replaces the TPU kernel pair in
// quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py:
//   _fwd_kernel (called by _fwd_pallas) and
//   _bwd_kernel (called by _bwd_pallas):
//     the ordinal NLL and its gradients (ordinal_tile.cuh) with the bounds
//     of every entry given; (W, U) = (-1e4, +1e4) is masked (the JAX
//     package's MASK_SENTINEL).  An entry with one bound at a sentinel (the
//     1-bit encoding's (mean, +1e4) and (-1e4, mean)) is observed.
// Layout: W, U [B,K,P] f32.
// Each entry reads 8 B: 0.00039 ms of bytes at the MLE-GAN shape (B=1,
// K=64, P=2601), 0.10 ms at the low-rank shape (B=256); the limit is the
// numerics' instruction issue (ordinal_tile.cuh).  A chunk's bounds (32 KB)
// do not fit in shared memory beside the occupancy the kernels are compiled
// for, so phase 1 reads them only for the mask, in groups of loads all
// issued before any is used, and phase 2 reads an observed entry's bounds
// again, from L1 or L2.  A tensor map (TMA) cannot stage them: a row of W
// is 4P bytes, not a multiple of 16 at P = 2601.

#include "ordinal_tile.cuh"

using namespace qsc;

namespace {

constexpr float kSentinel = 1e4f;
static_assert(kSteps % 2 == 0, "phase 1: groups of all or half the steps");

__device__ __forceinline__ bool observed(float w, float u) {
  return !(w <= -kSentinel && u >= kSentinel);
}

struct Bounds {
  struct Args {
    const float* W;
    const float* U;
  };
  struct Table {};
  struct Chunk {};
  // a chunk's bounds, at its first band and the tile's first column
  struct Cursor {
    const float* W;
    const float* U;
    __device__ __forceinline__ Cursor(const Args& a, size_t at)
        : W(a.W + at), U(a.U + at) {}
  };

  // Registers, as ptxas takes them without spilling (bench_ordinal.py
  // --floor): the forward runs 5 blocks per SM (48 registers), which hold
  // all of a thread's phase-1 loads in flight with the robust numerics and
  // half of them with the fast ones; the backward holds half, and with the
  // two pointers of a chunk's bounds its 64 registers spill a few bytes
  // from R = 12 on, so there it runs 3 blocks per SM.
  static constexpr int fwd_blocks_per_sm(int) { return 5; }
  static constexpr int bwd_blocks_per_sm(int R) {
    return R >= 12 ? 3 : kBwdBlocksPerSM;
  }
  __host__ __device__ static constexpr int in_flight(bool bwd, bool fast) {
    return bwd || fast ? kSteps / 2 : kSteps;
  }

  static __device__ __forceinline__ void load_table(Table&, const Args&) {}

  // Phase 1 in groups of in_flight(BWD, FAST) entries, each group's loads
  // all issued before any is used; an entry past the chunk reads as masked.
  // 32-bit offsets: a chunk spans kChunkBands * P < 2^31 entries (the
  // wrapper checks P).
  template <bool BWD, bool FAST>
  static __device__ __forceinline__ unsigned observe(Chunk&,
                                                     const Cursor& c, int kb,
                                                     int ncols, int P) {
    constexpr int kGroup = in_flight(BWD, FAST);
    const int t = threadIdx.x, cl = t % kTileCols, kq = t / kTileCols;
    // the thread's entries in range: bands kq, kq + kBandsPerStep, ... < kb
    const int n =
        cl < ncols ? (kb - kq + kBandsPerStep - 1) / kBandsPerStep : 0;
    const int step = kBandsPerStep * P;
    const float* W = c.W + kq * P + cl;
    const float* U = c.U + kq * P + cl;
    unsigned bits = 0;
#pragma unroll 1
    for (int j0 = 0; j0 < kSteps; j0 += kGroup) {
      float w[kGroup], u[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j, W += step, U += step) {
        const bool in = j0 + j < n;
        w[j] = in ? __ldg(W) : -kSentinel;
        u[j] = in ? __ldg(U) : kSentinel;
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        bits |= (unsigned)observed(w[j], u[j]) << (j0 + j);
      }
    }
    return bits;
  }

  static __device__ __forceinline__ void dense(const Table&, const Chunk&,
                                               const Cursor& c, int j, int P,
                                               float& w, float& u) {
    const int t = threadIdx.x;
    const unsigned off =
        (t / kTileCols + j * kBandsPerStep) * P + t % kTileCols;
    w = __ldg(c.W + off);
    u = __ldg(c.U + off);
  }

  static __device__ __forceinline__ void listed(const Table&, const Chunk&,
                                                const Cursor& c, unsigned e,
                                                int P, float& w, float& u) {
    const unsigned off = e / kTileCols * P + e % kTileCols;
    w = __ldg(c.W + off);
    u = __ldg(c.U + off);
  }
};

}  // namespace

extern "C" {

// Partial sums per map of any ordinal kernel, bounds or coded (the size of
// their scratch): one per tile of columns.
int qsc_qnll_tiles(int P) { return tiles(P); }

// Forward.  partial: [B, qsc_qnll_tiles(P)] scratch; out: [B].  Returns a
// cudaError_t.
int qsc_qnll_fwd(const float* S, const float* C, const float* W,
                 const float* U, float* partial, float* out, int B, int R,
                 int K, int P, long long stride_S, long long stride_C,
                 long long stride_obs, float inv_s, float offset, int linear,
                 int fast, void* stream) {
  const Params<Bounds> p{S, C, nullptr, partial, nullptr, stride_S,
                         stride_C, stride_obs, K, P, inv_s, offset, {W, U}};
  return launch<Bounds, false>(p, B, R, linear, fast, out, stream);
}

// Backward, with the inputs of the forward and g: [B]; dS: [B,R,P];
// dC_partial: [B, qsc_qnll_tiles(P), K*R] scratch; dC: [B,K,R].
int qsc_qnll_bwd(const float* S, const float* C, const float* W,
                 const float* U, const float* g, float* dS, float* dC_partial,
                 float* dC, int B, int R, int K, int P, long long stride_S,
                 long long stride_C, long long stride_obs, float inv_s,
                 float offset, int linear, int fast, void* stream) {
  const Params<Bounds> p{S, C, g, dC_partial, dS, stride_S, stride_C,
                         stride_obs, K, P, inv_s, offset, {W, U}};
  return launch<Bounds, true>(p, B, R, linear, fast, dC, stream);
}

}  // extern "C"
