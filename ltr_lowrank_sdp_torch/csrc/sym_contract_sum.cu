// K4 sym_contract_sum: <C, sym(U V^T)> as a float64 scalar on the device,
//   sum_k coef_k * 1/2 (<U[r_k], V[c_k]> + <U[c_k], V[r_k]>)
// over the upper-triangle entries (r_k, c_k) of C, coef_k = 2 c_k off the
// diagonal and c_k on it (or coef_k * <U[r_k], U[c_k]> when U is V).
//
// Replaces: ltr_lowrank_sdp_tpu/ops/coneops.py ConeOps.obj_value (:332),
// sparse branch :342 -> _SparseSym.contract (:87-102) followed by
// ops/compsum.py csum (:78).
//
// Bound on the card: memory.  It reads the entry lists (rows, cols, coef)
// and U, V once; the gathers of U/V rows it does per entry hit L2 (the
// factors fit in the 50 MB L2 at the slice's widths), so the least time is
// the bytes of the inputs over 3.35 TB/s.
//
// Design: one warp per entry (a grid-stride loop over entries): the lanes
// stride over the r columns of the two gathered rows (coalesced), a
// shuffle-down tree reduces the dot products to lane 0, which accumulates
// coef_k * e_k into a per-warp sum.  With U is V the kernel reads only U
// rows (half the gathers).  The warps' sums are added in a fixed order per
// block into a partials array, and a second single-block launch adds the
// partials in a fixed tree: no atomics, so the result is the same on every
// run for the same grid.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kFinishThreads = 256;

__global__ void sym_contract_partial_kernel(const int* __restrict__ rows,
                                            const int* __restrict__ cols,
                                            const double* __restrict__ coef,
                                            const double* __restrict__ U,
                                            const double* __restrict__ V,
                                            int nnz, int r, int same,
                                            double* __restrict__ partials) {
  __shared__ double warp_sums[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  double wsum = 0.0;
  for (long long e = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
       e < nnz; e += stride) {
    const long long i = static_cast<long long>(rows[e]) * r;
    const long long j = static_cast<long long>(cols[e]) * r;
    double a = 0.0;
    double b = 0.0;
    if (same) {
      for (int c = lane; c < r; c += 32) a += U[i + c] * U[j + c];
    } else {
      for (int c = lane; c < r; c += 32) {
        a += U[i + c] * V[j + c];
        b += U[j + c] * V[i + c];
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if (lane == 0) wsum += coef[e] * (same ? a : 0.5 * (a + b));
  }
  if (lane == 0) warp_sums[warp] = wsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarpsPerBlock; ++w) s += warp_sums[w];
    partials[blockIdx.x] = s;
  }
}

__global__ void sym_contract_finish_kernel(const double* __restrict__ partials,
                                           int nparts,
                                           double* __restrict__ out) {
  __shared__ double sh[kFinishThreads];
  double s = 0.0;
  for (int k = threadIdx.x; k < nparts; k += kFinishThreads) s += partials[k];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int width = kFinishThreads / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) sh[threadIdx.x] += sh[threadIdx.x + width];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = sh[0];
}

}  // namespace

// partials must hold nblocks doubles (the caller's scratch); V may equal U
// (pass same = 1 to read U only).  Returns cudaGetLastError().
extern "C" int ltr_sym_contract_sum(const void* rows, const void* cols,
                                    const void* coef, const void* U,
                                    const void* V, int nnz, int r, int same,
                                    void* partials, int nblocks, void* out,
                                    void* stream) {
  if (nblocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sym_contract_partial_kernel<<<nblocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const double*>(coef), static_cast<const double*>(U),
      static_cast<const double*>(V), nnz, r, same,
      static_cast<double*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_contract_finish_kernel<<<1, kFinishThreads, 0, s>>>(
      static_cast<const double*>(partials), nblocks,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
