// K8 lp_col_wsum: the weighted column sums of the LP cone,
//   out[j] = c0 * c[j] + sum_{e: col_e = j} val_e * w[cid_e],
// the LP analog of (c0 C + A*(w)), float64 or float32.
//
// The LP cone's entries are sorted by column on the host into a CSC: the
// entries of column j are col_ptr[j] .. col_ptr[j+1] of (cid, val), in the
// problem's own order.
//
// Replaces: ltr_lowrank_sdp_tpu/ops/coneops.py LPOps.weighted_col_sums
// (:443): the weight gather w[cid], the product with the values, the
// EllSegSum over columns (ops/gatherseg.py:129-155) and the objective term in
// one pass.  It serves the ALM gradient of the LP factor, both sides of the
// ADMM LP sweep and the LP term of the dual certificate.
//
// Bound on the card: memory.  It must read col_ptr, cid, val, w and c once
// and write (n_lp,): 2 flops per 12 bytes of entry data.  w ((m,) doubles)
// stays in L2.
//
// Design: an LP column has few entries (a slack column one, a generated
// column three), far fewer than a warp has lanes, so one thread owns one
// column and walks its entries in order: neighbouring threads read
// neighbouring col_ptr, c and out, and nearly neighbouring entries.  No
// atomics, a fixed sum order, the same bits on every run; a column with no
// entry writes c0 * c[j].  A column with very many entries is one thread's
// serial loop, accepted here.
//
// Value type: a template on T.  float32 loads, multiplies and accumulates in
// float32, as XLA does on the TPU; the value bytes halve.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void lp_col_wsum_kernel(const int* __restrict__ col_ptr,
                                   const int* __restrict__ cid,
                                   const T* __restrict__ val,
                                   const T* __restrict__ w,
                                   const T* __restrict__ c, T c0,
                                   int n_cols, T* __restrict__ out) {
  const long long j =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n_cols) return;
  const int start = col_ptr[j];
  const int end = col_ptr[j + 1];
  T s = T(0);
  for (int k = start; k < end; ++k) s += val[k] * w[cid[k]];
  out[j] = c0 * c[j] + s;
}

template <typename T>
int launch(const void* col_ptr, const void* cid, const void* val,
           const void* w, const void* c, double c0, int n_cols, void* out,
           void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((n_cols + kThreads - 1) / kThreads);
  lp_col_wsum_kernel<T><<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(col_ptr), static_cast<const int*>(cid),
      static_cast<const T*>(val), static_cast<const T*>(w),
      static_cast<const T*>(c), static_cast<T>(c0), n_cols,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 != 0: every value array is float32, else float64.  Returns the
// cudaGetLastError() code of the launch.
extern "C" int ltr_lp_col_wsum(int f32, const void* col_ptr,
                               const void* cid, const void* val,
                               const void* w, const void* c, double c0,
                               int n_cols, void* out, void* stream) {
  if (n_cols <= 0) return 0;
  return f32 ? launch<float>(col_ptr, cid, val, w, c, c0, n_cols, out, stream)
             : launch<double>(col_ptr, cid, val, w, c, c0, n_cols, out,
                              stream);
}
