// K7 lp_constr_segsum: the constraint values of the LP cone,
//   out[i] = sum_{e: cid_e = i} val_e * (u[col_e] * v[col_e]),
// i.e. A_lp(diag(u o v)) as a global (m,) vector, float64 or float32.
//
// The LP cone's entries (column, constraint, value) are sorted by constraint
// on the host into a CSR over constraints: the entries of constraint i are
// row_ptr[i] .. row_ptr[i+1] of (col, val), in the problem's own order.  Two
// modes:
//
//   single (mode 0):  out1[i] = sum val * (u[col] * v[col])
//   pair   (mode 2):  out1[i] = 2 * sum val * (u[col] * v[col])
//                     out2[i] =     sum val * (v[col] * v[col])
//                     (the ALM line-search pair with u = r_lp, v = d_lp: one
//                     read of the entries and of the gathered values)
//
// Replaces: ltr_lowrank_sdp_tpu/ops/coneops.py LPOps.constr_vals (:435), the
// product x = u * v, the gather x[col] and the EllSegSum over constraint ids
// (ops/gatherseg.py:129-155) in one pass.  The TPU version reduces through
// bucketed ELL gather tables because XLA scatters serialize there; here the
// segments are contiguous and need no table.
//
// Bound on the card: memory.  It must read row_ptr, col, val, u and v once
// and write (m,) or 2 (m,): 3 flops per 12 bytes of entry data, far below the
// FP64 ridge point.  u and v (n_lp doubles each) stay in L2.
//
// Design: one warp per constraint, lanes striding over its entries (coalesced
// col / val reads, scattered 8-byte gathers of u and v), one shuffle tree at
// the end, one lane writes.  No atomics, a fixed sum order, the same bits on
// every run; a constraint with no LP entry writes exactly 0.
//
// Value type: a template on T.  float32 loads, multiplies and accumulates in
// float32, as XLA does on the TPU; the value bytes halve.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

template <typename T>
__global__ void lp_constr_segsum_kernel(const int* __restrict__ row_ptr,
                                        const int* __restrict__ col,
                                        const T* __restrict__ val,
                                        const T* __restrict__ u,
                                        const T* __restrict__ v, int m,
                                        int mode, T* __restrict__ out1,
                                        T* __restrict__ out2) {
  const int lane = threadIdx.x & 31;
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= m) return;
  const int start = row_ptr[i];
  const int end = row_ptr[i + 1];
  T s1 = T(0);
  T s2 = T(0);
  for (int k = start + lane; k < end; k += 32) {
    const int c = col[k];
    const T a = val[k];
    const T vc = v[c];
    s1 += a * (u[c] * vc);
    if (mode == 2) s2 += a * (vc * vc);
  }
  s1 = warp_sum(s1);
  if (mode == 2) s2 = warp_sum(s2);
  if (lane == 0) {
    out1[i] = (mode == 2) ? T(2) * s1 : s1;
    if (mode == 2) out2[i] = s2;
  }
}

template <typename T>
int launch(const void* row_ptr, const void* col, const void* val,
           const void* u, const void* v, int m, int mode, void* out1,
           void* out2, void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((m + kWarpsPerBlock - 1) / kWarpsPerBlock);
  lp_constr_segsum_kernel<T><<<grid, block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const T*>(val), static_cast<const T*>(u),
      static_cast<const T*>(v), m, mode, static_cast<T*>(out1),
      static_cast<T*>(out2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 != 0: every value array is float32, else float64.  mode: 0 single,
// 2 pair (out2 required).  Returns the cudaGetLastError()
// code of the launch.
extern "C" int ltr_lp_constr_segsum(int f32, const void* row_ptr,
                                    const void* col, const void* val,
                                    const void* u, const void* v, int m,
                                    int mode, void* out1, void* out2,
                                    void* stream) {
  if (m <= 0) return 0;
  if ((mode != 0 && mode != 2) || (mode == 2 && out2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return f32 ? launch<float>(row_ptr, col, val, u, v, m, mode, out1, out2,
                             stream)
             : launch<double>(row_ptr, col, val, u, v, m, mode, out1, out2,
                              stream);
}
