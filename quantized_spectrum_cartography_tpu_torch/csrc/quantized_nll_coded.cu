// Ordinal probit NLL of a rank-R reconstruction from int8 bin codes, forward
// and backward, for Hopper (sm_90a): the tile kernels of ordinal_tile.cuh on
// the codes source below.
//
// Replaces the TPU kernel pair in
// quantized_spectrum_cartography_tpu/ops/pallas/fused_likelihood.py:
//   _fwd_kernel_coded (called by _fwd_pallas_coded) and
//   _bwd_kernel_coded (called by _bwd_pallas_coded):
//     the ordinal NLL and its gradients (ordinal_tile.cuh) with
//     (W, U) = (bb[c], bb[c+1]) for code c < nbins; code >= nbins is masked.
// Layout: codes [B,K,P] int8, the boundary table bb of nbins + 1 floats.
// Each entry reads 1 B: 0.00006 ms of bytes at the MLE-GAN shape (B=1,
// K=64, P=2601), 0.013 ms at the low-rank shape (B=256); the limit is the
// numerics' instruction issue (ordinal_tile.cuh).

#include "ordinal_tile.cuh"

using namespace qsc;

namespace {

constexpr int kMaxTable = 33;            // nbins + 1 boundaries, nbins < 32

// Phase 1 reads the chunk's codes, 16 a thread, all loads issued before any
// is used, and stores them in shared memory (255 past the tile); phase 2
// decodes a code by two shared-memory loads of the table.
struct Codes {
  struct Args {
    const int8_t* codes;
    int nbins;
    float bb[kMaxTable];
  };
  struct Table {
    float bb[kMaxTable];
  };
  struct Chunk {
    uint8_t code[kChunk];
  };
  // a chunk's codes, at its first band and the tile's first column
  struct Cursor {
    const uint8_t* y;
    unsigned nbins;
    __device__ __forceinline__ Cursor(const Args& a, size_t at)
        : y(reinterpret_cast<const uint8_t*>(a.codes) + at), nbins(a.nbins) {}
  };

  static constexpr int fwd_blocks_per_sm(int) { return kFwdBlocksPerSM; }
  static constexpr int bwd_blocks_per_sm(int) { return kBwdBlocksPerSM; }

  static __device__ __forceinline__ void load_table(Table& tb,
                                                    const Args& a) {
    for (int i = threadIdx.x; i <= a.nbins; i += kThreads) tb.bb[i] = a.bb[i];
  }

  template <bool, bool>
  static __device__ __forceinline__ unsigned observe(Chunk& ch,
                                                     const Cursor& c, int kb,
                                                     int ncols, int P) {
    const int t = threadIdx.x, cl = t % kTileCols, kq = t / kTileCols;
    const uint8_t* y = c.y + cl;
    unsigned code[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int kl = kq + j * kBandsPerStep;
      code[j] = (cl < ncols && kl < kb) ? y[(size_t)kl * P] : 255u;
    }
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      ch.code[t + j * kThreads] = (uint8_t)code[j];
      bits |= (unsigned)(code[j] < c.nbins) << j;
    }
    return bits;
  }

  static __device__ __forceinline__ void dense(const Table& tb,
                                               const Chunk& ch,
                                               const Cursor& c, int j, int P,
                                               float& w, float& u) {
    listed(tb, ch, c, threadIdx.x + j * kThreads, P, w, u);
  }

  static __device__ __forceinline__ void listed(const Table& tb,
                                                const Chunk& ch,
                                                const Cursor&, unsigned e,
                                                int, float& w, float& u) {
    const unsigned code = ch.code[e];
    w = tb.bb[code];
    u = tb.bb[code + 1];
  }
};

// The source's arguments; false if the table does not fit.
bool make_args(Codes::Args& a, const int8_t* codes, const float* table,
               int nbins) {
  if (nbins < 1 || nbins + 1 > kMaxTable) return false;
  a.codes = codes;
  a.nbins = nbins;
  for (int i = 0; i <= nbins; ++i) a.bb[i] = table[i];
  return true;
}

}  // namespace

extern "C" {

// Forward: codes with its host table of nbins+1 floats.  partial:
// [B, qsc_qnll_tiles(P)] scratch; out: [B].  Returns a cudaError_t.
int qsc_qnll_coded_fwd(const float* S, const float* C, const int8_t* codes,
                       const float* table, int nbins, float* partial,
                       float* out, int B, int R, int K, int P,
                       long long stride_S, long long stride_C,
                       long long stride_obs, float inv_s, float offset,
                       int linear, int fast, void* stream) {
  Params<Codes> p{S, C, nullptr, partial, nullptr, stride_S, stride_C,
                  stride_obs, K, P, inv_s, offset, {}};
  if (!make_args(p.obs, codes, table, nbins)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<Codes, false>(p, B, R, linear, fast, out, stream);
}

// Backward, with the inputs of the forward and g: [B]; dS: [B,R,P];
// dC_partial: [B, qsc_qnll_tiles(P), K*R] scratch; dC: [B,K,R].
int qsc_qnll_coded_bwd(const float* S, const float* C, const int8_t* codes,
                       const float* table, int nbins, const float* g,
                       float* dS, float* dC_partial, float* dC, int B, int R,
                       int K, int P, long long stride_S, long long stride_C,
                       long long stride_obs, float inv_s, float offset,
                       int linear, int fast, void* stream) {
  Params<Codes> p{S, C, g, dC_partial, dS, stride_S, stride_C, stride_obs,
                  K, P, inv_s, offset, {}};
  if (!make_args(p.obs, codes, table, nbins)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<Codes, true>(p, B, R, linear, fast, dC, stream);
}

}  // extern "C"
