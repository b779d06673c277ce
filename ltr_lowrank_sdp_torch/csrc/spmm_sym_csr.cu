// K1 spmm_sym_csr: out = alpha * C * Y (+ diag(d) * Y), float64.
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

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void spmm_sym_csr_kernel(const int* __restrict__ indptr,
                                    const int* __restrict__ indices,
                                    const double* __restrict__ vals,
                                    const double* __restrict__ Y,
                                    const double* __restrict__ d,
                                    double* __restrict__ out,
                                    int n, int r, double alpha) {
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
  const double drow = (d != nullptr) ? d[row] : 0.0;
  for (int c = lane; c < r; c += 32) {
    double o = 0.0;
    if (indptr != nullptr) {
      double acc = 0.0;
      for (int k = start; k < end; ++k) {
        acc += vals[k] * Y[static_cast<long long>(indices[k]) * r + c];
      }
      o = alpha * acc;
    }
    if (d != nullptr) o += drow * Y[base + c];
    out[base + c] = o;
  }
}

}  // namespace

// indptr/indices/vals may all be null (then only the diagonal term is
// applied); d may be null (then only the sparse term).  Returns the
// cudaGetLastError() code of the launch.
extern "C" int ltr_spmm_sym_csr(const void* indptr, const void* indices,
                                const void* vals, const void* Y,
                                const void* d, void* out, int n, int r,
                                double alpha, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  spmm_sym_csr_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const double*>(vals), static_cast<const double*>(Y),
      static_cast<const double*>(d), static_cast<double*>(out), n, r, alpha);
  return static_cast<int>(cudaGetLastError());
}
