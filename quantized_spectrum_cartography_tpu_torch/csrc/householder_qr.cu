// Thin Householder QR of a batch of small matrices, one launch for the whole
// batch: Y [N, m, k] f32 (k <= m, contiguous) -> Q [N, m, k] with
// orthonormal columns spanning Y's range.
//
// Replaces no TPU kernel: the JAX package's project_rank_subspace
// (quantized_spectrum_cartography_tpu/ops/lowrank.py) calls jnp.linalg.qr,
// which XLA runs as one batched op.  It was added because torch.linalg.qr
// on CUDA factorizes a batch matrix by matrix (cuSOLVER's geqrf and orgqr
// per matrix, each several launches), so the low-rank solver's projection
// of B x R = 512 matrices of 51 x 18 spent its time in some 10,000 host
// launches, not in work.
//
// What bounds it on an H100: bytes.  At [512, 51, 18] it reads Y once and
// writes Q once, 3.8 MB, about 1.1 us at 3.35 TB/s; the factorization and
// the explicit Q are about 30 MFLOP, under 0.5 us at 67 TFLOP/s.  Its time
// is the latency of 2k dependent steps inside each block, each a short
// reduction and a barrier, so the design keeps the launch count at one and
// every intermediate in shared memory:
// - one thread block a matrix; Y's reflectors and Q live in shared memory,
//   column-major, so a warp's lanes read consecutive rows of one column
//   without bank conflicts ((2mk + k) floats, 7.4 KB at 51 x 18; above
//   48 KB the launch opts in to dynamic shared memory, up to 227 KB);
// - step j: warp 0 builds reflector j (LAPACK's dlarfg convention: beta =
//   -sign(alpha) ||x||, v_j = 1, tau = (beta - alpha) / beta; tau = 0 and
//   H_j = I where the column below the diagonal is all zero), then the
//   warps apply it to columns j+1..k-1, one column a warp at a time;
// - Q is formed explicitly, as orgqr does: the reflectors applied backward,
//   H_{k-1} first, to the first k columns of the identity.  No Gram matrix
//   and no Gram-Schmidt, so Q stays orthonormal when Y is rank-deficient
//   (right after a projection S has rank <= 10, so Y's 18 columns have
//   rank about 10).
// Every sum runs in f32 in a fixed order (each lane's rows in turn, then a
// butterfly over the warp), with no atomics, so two launches on the same
// input give the same bits and a resumed solve is bitwise the straight one.
// Build without --use_fast_math and without -ftz.

#include "common.cuh"

using namespace qsc;

namespace {

constexpr int kQrWarps = 8;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kOptinSmem = 227 * 1024;

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// col[j:m] -= tau * (v . col[j:m]) * v, v = v[j:m] with v_j = 1 stored.
__device__ __forceinline__ void apply_reflector(const float* v, float* col,
                                                float tau, int j, int m,
                                                int lane) {
  float s = 0.0f;
  for (int i = j + lane; i < m; i += 32) s = fmaf(v[i], col[i], s);
  const float w = warp_allsum(s) * tau;
  for (int i = j + lane; i < m; i += 32) col[i] = fmaf(-w, v[i], col[i]);
}

__global__ void __launch_bounds__(kQrWarps * 32)
householder_qr_kernel(const float* __restrict__ Y, float* __restrict__ Q,
                      int m, int k) {
  extern __shared__ float smem[];
  float* A = smem;              // [k][m]: Y, then its reflectors
  float* Qs = A + m * k;        // [k][m]: Q
  float* tau = Qs + m * k;      // [k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mk = m * k;
  const size_t base = (size_t)blockIdx.x * mk;

  for (int t = tid; t < mk; t += blockDim.x) {
    const int i = t / k, c = t - i * k;
    A[c * m + i] = Y[base + t];
    Qs[c * m + i] = i == c ? 1.0f : 0.0f;
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    float* v = A + j * m;
    if (warp == 0) {
      float s = 0.0f;
      for (int i = j + 1 + lane; i < m; i += 32) s = fmaf(v[i], v[i], s);
      s = warp_allsum(s);
      const float alpha = v[j];
      float t = 0.0f, scale = 0.0f;
      if (s > 0.0f) {
        const float norm = sqrtf(fmaf(alpha, alpha, s));
        const float beta = alpha >= 0.0f ? -norm : norm;
        t = (beta - alpha) / beta;
        scale = 1.0f / (alpha - beta);
      }
      for (int i = j + 1 + lane; i < m; i += 32) v[i] *= scale;
      __syncwarp();             // every lane has read alpha = v[j]
      if (lane == 0) {
        v[j] = 1.0f;
        tau[j] = t;
      }
    }
    __syncthreads();
    const float tj = tau[j];
    if (tj != 0.0f) {
      for (int c = j + 1 + warp; c < k; c += kQrWarps) {
        apply_reflector(v, A + c * m, tj, j, m, lane);
      }
    }
    __syncthreads();
  }

  for (int j = k - 1; j >= 0; --j) {
    const float tj = tau[j];
    if (tj != 0.0f) {
      for (int c = j + warp; c < k; c += kQrWarps) {
        apply_reflector(A + j * m, Qs + c * m, tj, j, m, lane);
      }
    }
    __syncthreads();
  }

  for (int t = tid; t < mk; t += blockDim.x) {
    const int i = t / k, c = t - i * k;
    Q[base + t] = Qs[c * m + i];
  }
}

}  // namespace

extern "C" {

// Y, Q: [N, m, k] f32, contiguous, 1 <= k <= m.  Returns a cudaError_t
// value (cudaErrorInvalidValue for a shape the kernel does not take).
int qsc_householder_qr(const float* Y, float* Q, int N, int m, int k,
                       void* stream_ptr) {
  if (N < 1 || k < 1 || k > m) return (int)cudaErrorInvalidValue;
  const int smem = (2 * m * k + k) * (int)sizeof(float);
  if (smem > kOptinSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        householder_qr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  householder_qr_kernel<<<N, kQrWarps * 32, smem,
                          (cudaStream_t)stream_ptr>>>(Y, Q, m, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
