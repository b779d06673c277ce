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
// FP64 ridge point.  At the solver's LP shapes (m = 2,400 constraints of
// about 25 entries) those bytes take 0.3 us at 3.35 TB/s, below one launch:
// the time is the launch and one chain of dependent loads (row_ptr, then
// col / val, then the gathers of u and v, then the reduction, then the
// store).
//
// Design: one warp a constraint, lane l taking the constraint's entries l,
// l + 32, ... counted from its first entry; the constraint's two row_ptr
// bounds are one load of lanes 0 and 1, handed out by shuffles.  Each round
// of 32 entries issues its col / val loads, then its u / v gathers, then the
// arithmetic.  The sum order is fixed: entry j of a constraint goes into
// slot j mod 32 (lane j mod 32), each slot adds its entries in round order,
// and the 32 slots are added by one halving tree (xor shuffles at distances
// 16, 8, 4, 2, 1).  Every product and sum is a round-to-nearest intrinsic
// (no fused multiply-add), so every call and the plain version of this
// order (kernels.lp_constr_segsum_order) give the same bits.  No atomics; a
// constraint with no LP entry writes exactly 0.  A warp leaves about a
// quarter of its lanes idle on a 25-entry constraint; lane groups of 4, 8
// or 16 lanes a constraint (a warp serving several) were built and timed on
// the solver's LP shapes: 16 lanes took the time of 32, 4 and 8 were
// slower, so only the warp remains.
//
// Value type: a template on T.  float32 loads, multiplies and accumulates in
// float32, as XLA does on the TPU; the value bytes halve.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // 4 warps, a constraint each
constexpr int kRound = 32;         // entries a round: one a slot (lane)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T, bool PAIR>
__global__ void __launch_bounds__(kThreads)
lp_constr_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                 const T* __restrict__ val, const T* __restrict__ u,
                 const T* __restrict__ v, int m, T* __restrict__ out1,
                 T* __restrict__ out2) {
  const int lane = threadIdx.x & 31;
  const long long i =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (i >= m) return;                // the whole warp
  int p = 0;
  if (lane <= 1) p = row_ptr[i + lane];
  const int start = __shfl_sync(kFull, p, 0);
  const int end = __shfl_sync(kFull, p, 1);
  T s1 = T(0), s2 = T(0);
  for (int base = start; base < end; base += kRound) {
    const int k = min(base + lane, end - 1);
    const int c = col[k];
    const T a = val[k];
    const T uc = u[c];
    const T vc = v[c];
    if (base + lane < end) {
      s1 = add(s1, mul(a, mul(uc, vc)));
      if (PAIR) s2 = add(s2, mul(a, mul(vc, vc)));
    }
  }
#pragma unroll
  for (int off = kRound / 2; off >= 1; off /= 2) {
    s1 = add(s1, __shfl_xor_sync(kFull, s1, off));
    if (PAIR) s2 = add(s2, __shfl_xor_sync(kFull, s2, off));
  }
  if (lane == 0) {
    out1[i] = PAIR ? T(2) * s1 : s1;
    if (PAIR) out2[i] = s2;
  }
}

template <typename T>
int launch(const void* row_ptr, const void* col, const void* val,
           const void* u, const void* v, int m, int mode, void* out1,
           void* out2, cudaStream_t s) {
  const int grid = static_cast<int>(
      (static_cast<long long>(m) * 32 + kThreads - 1) / kThreads);
  auto kernel = mode == 2 ? lp_constr_kernel<T, true>
                          : lp_constr_kernel<T, false>;
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const T*>(val), static_cast<const T*>(u),
      static_cast<const T*>(v), m, static_cast<T*>(out1),
      static_cast<T*>(out2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 != 0: every value array is float32, else float64.  mode: 0 single,
// 2 pair (out2 required).  Returns the cudaGetLastError() code of the
// launch.
extern "C" int ltr_lp_constr_segsum(int f32, const void* row_ptr,
                                    const void* col, const void* val,
                                    const void* u, const void* v, int m,
                                    int mode, void* out1, void* out2,
                                    void* stream) {
  if (m <= 0) return 0;
  if ((mode != 0 && mode != 2) || (mode == 2 && out2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(row_ptr, col, val, u, v, m, mode, out1, out2, s)
             : launch<double>(row_ptr, col, val, u, v, m, mode, out1, out2,
                              s);
}
