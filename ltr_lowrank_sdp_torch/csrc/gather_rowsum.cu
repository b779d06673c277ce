// K13 gather_rowsum: the sum of index-gathered rows, float32.
//
//   out[0, j] = sum_i Y[idx[i], j]        Y (N, R), idx (M,) int32, out (1, R)
//
// Replaces: scripts/pallas_gather_probe.py kern (:41-56, the repo's one
// pl.pallas_call, :57): Y held whole in VMEM, a grid over index tiles of
// 8,192 that gathers each tile's rows with jnp.take and adds their column sum
// into a (1, R) VMEM scratch carried from grid step to grid step, float32.
//
// Bound on the card: memory.  The compulsory traffic is idx, Y and out once
// (about 2.1 MB at the probe's defaults N = 8,192, M = 262,144, R = 32); the
// gathered volume, M x R x 4 bytes (33.5 MB there), comes from L2, which
// holds Y (1 MB) the way VMEM held it on the TPU: Y does not fit a block's
// 227 KB of shared memory, and every block needs all of it.
//
// Design.  The TPU kernel's sequential grid carries its sum in scratch; here
// blocks run in parallel in no order, so the first launch gives each block
// one contiguous tile of indices (the host sizes the grid to at most 1,056
// blocks, 8 per SM, tiles of at least 256 indices) and writes one partial
// row per block, and a second launch of one block adds the partials in block
// order.  No atomics: the same bits on every call.  In a block, each of the
// 8 warps walks every 8th index group of the tile; lanes run over columns,
// L = min(32, next_pow2(R)) lanes a row and C = ceil(R / L) <= 8 columns a
// lane, so at R = 32 one warp reads one 128-byte row per index, coalesced,
// and at R = 8 one warp reads four rows at once (32 / L index groups).  The
// groups of a warp are added by a butterfly of shuffles (the same bits in
// every lane), the warps in warp order through shared memory.  float32
// accumulation, as the TPU kernel's scratch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxR = 256;         // 8 columns per lane

template <int C>
__global__ void gather_rowsum_tiles_kernel(const float* __restrict__ Y,
                                           const int* __restrict__ idx, int M,
                                           int R, int L, int tile,
                                           float* __restrict__ part) {
  __shared__ float warp_sum[kWarps][kMaxR];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / L;                 // index groups per warp
  const int g = lane / L;
  const int c0 = lane % L;
  float acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0.0f;
  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long end = start + tile < M ? start + tile : M;
  for (long long i = start + warp * groups + g; i < end;
       i += kWarps * groups) {
    const float* row = Y + static_cast<long long>(__ldg(idx + i)) * R;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int col = c0 + k * L;
      if (col < R) acc[k] += __ldg(row + col);
    }
  }
  // lanes c0, c0 + L, ... hold the same columns: add them
  for (int off = 16; off >= L; off >>= 1) {
#pragma unroll
    for (int k = 0; k < C; ++k)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  }
  if (lane < L) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int col = c0 + k * L;
      if (col < R) warp_sum[warp][col] = acc[k];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < R; col += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w][col];
    part[static_cast<long long>(blockIdx.x) * R + col] = s;
  }
}

__global__ void gather_rowsum_combine_kernel(const float* __restrict__ part,
                                             int n_blocks, int R,
                                             float* __restrict__ out) {
  for (int col = threadIdx.x; col < R; col += blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b)
      s += part[static_cast<long long>(b) * R + col];
    out[col] = s;
  }
}

}  // namespace

extern "C" int ltr_gather_rowsum(const void* Y, const void* idx, int N, int M,
                                 int R, int tile, int n_blocks, void* part,
                                 void* out, void* stream) {
  if (R < 1 || R > kMaxR || N < 1 || M < 0 || n_blocks < 1 || tile < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int L = 1;
  while (L < R && L < 32) L <<= 1;
  const int C = (R + L - 1) / L;
  const float* y = static_cast<const float*>(Y);
  const int* ix = static_cast<const int*>(idx);
  float* p = static_cast<float*>(part);
  switch (C) {
#define LTR_K13_CASE(c)                                                    \
  case c:                                                                  \
    gather_rowsum_tiles_kernel<c><<<n_blocks, kWarps * 32, 0, s>>>(        \
        y, ix, M, R, L, tile, p);                                          \
    break;
    LTR_K13_CASE(1)
    LTR_K13_CASE(2)
    LTR_K13_CASE(3)
    LTR_K13_CASE(4)
    LTR_K13_CASE(5)
    LTR_K13_CASE(6)
    LTR_K13_CASE(7)
    LTR_K13_CASE(8)
#undef LTR_K13_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rowsum_combine_kernel<<<1, kMaxR, 0, s>>>(
      p, n_blocks, R, static_cast<float*>(out));
  err = cudaGetLastError();
  return static_cast<int>(err);
}
