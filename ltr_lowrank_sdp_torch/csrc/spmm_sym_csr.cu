// K1 spmm_sym_csr: out = alpha * C * Y (+ diag(d) * Y), float64 or float32.
//
// Replaces: ltr_lowrank_sdp_tpu/ops/gatherseg.py EllSpMM.apply (:248, with
// _reduce :232), reached through ConeOps.apply_c (coneops.py:344) and
// ConeOps.apply_w (coneops.py:383); the optional diagonal term is the
// diag_identity branch of ConeOps.apply_a (coneops.py:374-375), which the
// ADMM update also calls alone (admm.py:164; then C is skipped).
//
// C is the static symmetric objective, stored once as a full CSR (both
// triangles, the diagonal once) built on the host.  Y is (n, r) row-major.
//
// Bound on the card: memory.  Per call the kernel must read the CSR
// (indptr, indices, values), Y and d once and write out once; at two flops
// per stored entry and column it does about one flop per 8 bytes, far below
// the H100's FP64 ridge point, so time >= bytes / 3.35 TB/s.
//
// Design: one warp per output row; the lanes stride over the r columns, so
// each gathered neighbour row Y[j, :] is read as one coalesced segment and
// the row's indices and values are broadcast from L1.  No atomics and no
// shared memory: each output element is written by exactly one lane, and its
// sum runs in CSR order, so the result is the same on every run.  Rows are
// short (degree about 6 on a Delaunay graph), so the neighbour rows of one
// warp mostly come from L2 (the 50 MB L2 holds Y at the slice's widths).
//
// Value type: the kernel is a template on T.  float32 (the solver's
// --dtype float32) loads, multiplies and accumulates in float32, as XLA does
// on the TPU; the bytes of Y, the values and the output halve.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void spmm_sym_csr_kernel(const int* __restrict__ indptr,
                                    const int* __restrict__ indices,
                                    const T* __restrict__ vals,
                                    const T* __restrict__ Y,
                                    const T* __restrict__ d,
                                    T* __restrict__ out,
                                    int n, int r, T alpha) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const long long base = static_cast<long long>(row) * r;
  int start = 0;
  int end = 0;
  if (indptr != nullptr) {
    start = indptr[row];
    end = indptr[row + 1];
  }
  const T drow = (d != nullptr) ? d[row] : T(0);
  for (int c = lane; c < r; c += 32) {
    T o = T(0);
    if (indptr != nullptr) {
      T acc = T(0);
      for (int k = start; k < end; ++k) {
        acc += vals[k] * Y[static_cast<long long>(indices[k]) * r + c];
      }
      o = alpha * acc;
    }
    if (d != nullptr) o += drow * Y[base + c];
    out[base + c] = o;
  }
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* vals,
           const void* Y, const void* d, void* out, int n, int r,
           double alpha, void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  spmm_sym_csr_kernel<T><<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(vals), static_cast<const T*>(Y),
      static_cast<const T*>(d), static_cast<T*>(out), n, r,
      static_cast<T>(alpha));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 != 0: every value array is float32, else float64.  indptr/indices/vals
// may all be null (then only the diagonal term is applied); d may be null
// (then only the sparse term).  Returns the cudaGetLastError() code of the
// launch.
extern "C" int ltr_spmm_sym_csr(int f32, const void* indptr,
                                const void* indices, const void* vals,
                                const void* Y, const void* d, void* out,
                                int n, int r, double alpha, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  return f32 ? launch<float>(indptr, indices, vals, Y, d, out, n, r, alpha,
                             stream)
             : launch<double>(indptr, indices, vals, Y, d, out, n, r, alpha,
                              stream);
}
