// K6 spmm_constr_csr: the constraint-weighted SpMM
//   out[i, :] = beta * Z[i, :] + sum_{slots k of row i} w[cid_k] * val_k * Y[col_k, :]
// i.e. out = beta * Z + (sum_i w_i A_i) Y, float64 or float32.
//
// The pattern is the full symmetric CSR of all constraint entries of the
// cone (both triangles, a diagonal entry once), built once on the host; a
// slot carries its column, its value and the id of the constraint it came
// from.  Entries of different constraints (or several of one constraint) at
// the same (row, col) stay separate slots, so the slot weight is always
// w[cid] * val.  Z is optional (null: out = the product alone).
//
// Replaces: ltr_lowrank_sdp_tpu/ops/gatherseg.py EllSpMM.apply_constr (:256,
// with _reduce :232), reached through ops/coneops.py ConeOps.apply_a
// (:376-380) and ConeOps.apply_w (:383); with Z it also carries the "+ x" of
// ConeOps.cg_normal_matvec (:293-330) and the "+ obj_coef C Y" of apply_w,
// so neither needs an elementwise add of its own.  The TPU version gathers
// w and Y through bucketed ELL tables and hoists the fixed factor's gathers
// out of the CG loop, because a gather there costs per index; here Y stays
// in L2 and nothing is hoisted.
//
// Bound on the card: memory.  It must read indptr, the per-slot col, val and
// cid, w, Y and Z once and write out once; two flops per slot and column is
// about one flop per 8 bytes, far below the FP64 ridge point.
//
// Design: one warp per output row, no atomics, a fixed sum order (CSR slot
// order), so the same bits on every run.  Rows can be long here (matrix
// completion at n = 10^4 has about 110 slots per row), so the warp first
// loads 32 slots at a time cooperatively (coalesced col / val / cid reads
// and one w gather per lane), then walks them with shuffles while the lanes
// stride over the r columns of each gathered Y row.  For r = 1 (the Lanczos
// matvec) the lanes instead own slots and a fixed shuffle tree adds them.
// A row with no slot writes beta * Z (or 0).
//
// Value type: a template on T.  float32 loads, multiplies and accumulates in
// float32, as XLA does on the TPU; the value bytes halve.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void spmm_constr_csr_kernel(const int* __restrict__ indptr,
                                       const int* __restrict__ col,
                                       const T* __restrict__ val,
                                       const int* __restrict__ cid,
                                       const T* __restrict__ w,
                                       const T* __restrict__ Y,
                                       const T* __restrict__ Z,
                                       T* __restrict__ out,
                                       int n, int r, T beta) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const int start = indptr[row];
  const int end = indptr[row + 1];
  const long long base = static_cast<long long>(row) * r;

  if (r == 1) {
    T acc = T(0);
    for (int k = start + lane; k < end; k += 32) {
      acc += (w[cid[k]] * val[k]) * Y[col[k]];
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(kFull, acc, off);
    }
    if (lane == 0) out[row] = (Z != nullptr) ? beta * Z[row] + acc : acc;
    return;
  }

  for (int c0 = 0; c0 < r; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < r;
    T acc = T(0);
    for (int k0 = start; k0 < end; k0 += 32) {
      const int k = k0 + lane;
      int my_col = 0;
      T my_wt = T(0);
      if (k < end) {
        my_col = col[k];
        my_wt = w[cid[k]] * val[k];
      }
      const int cnt = min(32, end - k0);
      for (int t = 0; t < cnt; ++t) {
        const int j = __shfl_sync(kFull, my_col, t);
        const T wt = __shfl_sync(kFull, my_wt, t);
        if (live) acc += wt * Y[static_cast<long long>(j) * r + c];
      }
    }
    if (live) {
      out[base + c] = (Z != nullptr) ? beta * Z[base + c] + acc : acc;
    }
  }
}

template <typename T>
int launch(const void* indptr, const void* col, const void* val,
           const void* cid, const void* w, const void* Y, const void* Z,
           void* out, int n, int r, double beta, void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  spmm_constr_csr_kernel<T><<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(col),
      static_cast<const T*>(val), static_cast<const int*>(cid),
      static_cast<const T*>(w), static_cast<const T*>(Y),
      static_cast<const T*>(Z), static_cast<T*>(out), n, r,
      static_cast<T>(beta));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 != 0: every value array is float32, else float64.  Z may be null.
// Returns the cudaGetLastError() code of the launch.
extern "C" int ltr_spmm_constr_csr(int f32, const void* indptr,
                                   const void* col, const void* val,
                                   const void* cid, const void* w,
                                   const void* Y, const void* Z, void* out,
                                   int n, int r, double beta, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  return f32 ? launch<float>(indptr, col, val, cid, w, Y, Z, out, n, r, beta,
                             stream)
             : launch<double>(indptr, col, val, cid, w, Y, Z, out, n, r,
                              beta, stream);
}
