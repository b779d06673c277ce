// K8 lp_col_wsum: the weighted column sums of the LP cone,
//   out[j] = c0 * c[j] + sum_{e: col_e = j} val_e * w[cid_e],
// the LP analog of (c0 C + A*(w)), float64 or float32.
//
// Replaces: ltr_lowrank_sdp_tpu/ops/coneops.py LPOps.weighted_col_sums
// (:443): the weight gather w[cid], the product with the values, the
// EllSegSum over columns (ops/gatherseg.py:129-155) and the objective term in
// one pass.  It serves the ALM gradient of the LP factor, both sides of the
// ADMM LP sweep and the LP term of the dual certificate.
//
// Bound on the card: memory.  It must read the entries (cid, val), w and c
// once and write (n_lp,): 2 flops per 12 bytes of entry data.  w ((m,)
// values) stays in L2.
//
// Layout (built once on the host, kernels.LPEntries.from_coo).  The entries
// of column j, in CSC order (a stable sort of the problem's own order), sit
// in a slot-major ELL of W slots: slot k of column j at k * n_cols + j of
// (ell_cid, ell_val), with the column's count in ell_cnt[j]; a padded slot
// holds (0, 0).  A column with more than W entries (count -1 in ell_cnt) is
// on the tail list tail_col, and its entries are read from the CSC
// (col_ptr, col_cid, col_val).
//
// Design.  One thread a column of the ELL: its count, c[j] and all W slots
// are loaded at once (no pointer to wait for; neighbouring threads read
// neighbouring words of every slot row), then the gathers of w for the
// slots below the count, then the sum.  One warp a tail column, in the same
// launch (the blocks past the ELL's): the lanes form 32 products at a time
// and every lane adds them in order.  Either way the column's sum is
// ((0 + p_0) + p_1) + ..., each product and sum rounded once (no fused
// multiply-add), and then c0 * c[j] + sum: the bits of the plain version's
// sequential index_add_.  A padded slot never enters the sum, whatever w
// holds; a column with no entry writes c0 * c[j] + 0.  The host picks the
// block size so that the columns reach every SM (kernels.k8_plan).
//
// Value type: a template on T.  float32 loads, multiplies and accumulates in
// float32, as XLA does on the TPU; the value bytes halve.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T, int W>
__global__ void lp_col_wsum_kernel(const int* __restrict__ ell_cnt,
                                   const int* __restrict__ ell_cid,
                                   const T* __restrict__ ell_val,
                                   const int* __restrict__ tail_col,
                                   const int* __restrict__ col_ptr,
                                   const int* __restrict__ col_cid,
                                   const T* __restrict__ col_val,
                                   const T* __restrict__ w,
                                   const T* __restrict__ c, T c0,
                                   int n_cols, int n_tail, int ell_blocks,
                                   T* __restrict__ out) {
  if (static_cast<int>(blockIdx.x) < ell_blocks) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_cols) return;
    const int cnt = ell_cnt[j];
    const T cj = c[j];
    int id[W];
    T v[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const long long at = static_cast<long long>(k) * n_cols + j;
      id[k] = ell_cid[at];
      v[k] = ell_val[at];
    }
    if (cnt < 0) return;                 // a tail column
    T x[W];
#pragma unroll
    for (int k = 0; k < W; ++k) x[k] = k < cnt ? w[id[k]] : T(0);
    T s = T(0);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k < cnt) s = add_rn(s, mul_rn(v[k], x[k]));
    }
    out[j] = add_rn(mul_rn(c0, cj), s);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int t = (blockIdx.x - ell_blocks) * (blockDim.x >> 5) +
                (threadIdx.x >> 5);
  if (t >= n_tail) return;
  const int j = tail_col[t];
  const int b = col_ptr[j];
  const int e = col_ptr[j + 1];
  T s = T(0);
  for (int k0 = b; k0 < e; k0 += 32) {
    const int k = k0 + lane;
    const T p = k < e ? mul_rn(col_val[k], w[col_cid[k]]) : T(0);
    const int m = min(32, e - k0);
    for (int i = 0; i < m; ++i) s = add_rn(s, __shfl_sync(kFull, p, i));
  }
  if (lane == 0) out[j] = add_rn(mul_rn(c0, c[j]), s);
}

template <typename T, int W>
int launch(const void* ell_cnt, const void* ell_cid, const void* ell_val,
           const void* tail_col, const void* col_ptr, const void* col_cid,
           const void* col_val, const void* w, const void* c, double c0,
           int n_cols, int n_tail, int threads, void* out,
           cudaStream_t stream) {
  const int ell_blocks = (n_cols + threads - 1) / threads;
  const int warps = threads / 32;
  const int tail_blocks = (n_tail + warps - 1) / warps;
  lp_col_wsum_kernel<T, W><<<ell_blocks + tail_blocks, threads, 0, stream>>>(
      static_cast<const int*>(ell_cnt), static_cast<const int*>(ell_cid),
      static_cast<const T*>(ell_val), static_cast<const int*>(tail_col),
      static_cast<const int*>(col_ptr), static_cast<const int*>(col_cid),
      static_cast<const T*>(col_val), static_cast<const T*>(w),
      static_cast<const T*>(c), static_cast<T>(c0), n_cols, n_tail,
      ell_blocks, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int width, const void* ell_cnt, const void* ell_cid,
             const void* ell_val, const void* tail_col, const void* col_ptr,
             const void* col_cid, const void* col_val, const void* w,
             const void* c, double c0, int n_cols, int n_tail, int threads,
             void* out, cudaStream_t s) {
#define K8_CASE(WW)                                                          \
  if (width == WW)                                                           \
    return launch<T, WW>(ell_cnt, ell_cid, ell_val, tail_col, col_ptr,      \
                         col_cid, col_val, w, c, c0, n_cols, n_tail,        \
                         threads, out, s);
  K8_CASE(1) K8_CASE(2) K8_CASE(3) K8_CASE(4) K8_CASE(5) K8_CASE(6)
  K8_CASE(7) K8_CASE(8)
#undef K8_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// f32 != 0: every value array is float32, else float64.  width (W, 1 to 8)
// names the instantiation; threads (a multiple of 32, at most 1024) the
// block size.  tail_col, col_ptr, col_cid and col_val are read only for
// the n_tail tail columns.  Returns the cudaGetLastError() code of the
// launch.
extern "C" int ltr_lp_col_wsum(int f32, const void* ell_cnt,
                               const void* ell_cid, const void* ell_val,
                               const void* tail_col, const void* col_ptr,
                               const void* col_cid, const void* col_val,
                               const void* w, const void* c, double c0,
                               int n_cols, int n_tail, int width,
                               int threads, void* out, void* stream) {
  if (n_cols <= 0) return 0;
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || n_tail < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch<float>(width, ell_cnt, ell_cid, ell_val, tail_col,
                               col_ptr, col_cid, col_val, w, c, c0, n_cols,
                               n_tail, threads, out, s)
             : dispatch<double>(width, ell_cnt, ell_cid, ell_val, tail_col,
                                col_ptr, col_cid, col_val, w, c, c0, n_cols,
                                n_tail, threads, out, s);
}
