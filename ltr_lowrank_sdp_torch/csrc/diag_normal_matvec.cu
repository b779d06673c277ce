// K3 diag_normal_matvec: y = x + (dv^2 o rowsum(x o F)) o F, float64 or
// float32.
//
// Replaces: the diag_identity branch of
// ltr_lowrank_sdp_tpu/ops/coneops.py ConeOps.cg_normal_matvec (:272,
// :285-292), the ADMM normal-equation operator x -> x + A*(A(sym(x F^T))) F
// (linSysProduct, lorads_admm.c:471-486) that every CG iteration applies.
//
// Bound on the card: memory.  It reads x, F and dv once and writes y once;
// four flops per 16 bytes read, so time >= bytes / 3.35 TB/s.
//
// Design: one pass instead of three.  One warp per row: the lanes stride
// over the r columns and form the row dot <x_i, F_i> (coalesced), a
// shuffle-down tree reduces it to lane 0, lane 0's value is broadcast, and
// the same lanes write y_i = x_i + dv_i (dv_i <x_i, F_i>) F_i while x_i and
// F_i are still in registers or L1.  No atomics: the same result on every
// run, and every column of a row uses the same coefficient.
//
// Value type: a template on T; float32 loads and accumulates in float32 (as
// XLA does on the TPU), which halves the bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void diag_normal_matvec_kernel(const T* __restrict__ x,
                                          const T* __restrict__ F,
                                          const T* __restrict__ dv,
                                          T* __restrict__ y, int n, int r) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp leaves together: one row per warp
  const long long base = static_cast<long long>(row) * r;
  T dot = T(0);
  for (int c = lane; c < r; c += 32) dot += x[base + c] * F[base + c];
  for (int off = 16; off > 0; off >>= 1) {
    dot += __shfl_down_sync(0xffffffffu, dot, off);
  }
  dot = __shfl_sync(0xffffffffu, dot, 0);
  const T d = dv[row];
  const T coef = d * (d * dot);
  for (int c = lane; c < r; c += 32) y[base + c] = x[base + c] + coef * F[base + c];
}

template <typename T>
int launch(const void* x, const void* F, const void* dv, void* y, int n,
           int r, void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  diag_normal_matvec_kernel<T><<<grid, block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(F),
      static_cast<const T*>(dv), static_cast<T*>(y), n, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 != 0: x, F, dv, y are float32, else float64.  Returns
// cudaGetLastError() of the launch.
extern "C" int ltr_diag_normal_matvec(int f32, const void* x, const void* F,
                                      const void* dv, void* y, int n, int r,
                                      void* stream) {
  if (n <= 0 || r <= 0) return 0;
  return f32 ? launch<float>(x, F, dv, y, n, r, stream)
             : launch<double>(x, F, dv, y, n, r, stream);
}
