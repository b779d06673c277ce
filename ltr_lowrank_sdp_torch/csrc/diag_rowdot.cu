// K2 diag_rowdot: o1 = (s * dv) o rowsum(U o V), and optionally
// o2 = dv o rowsum(V o V), float64.
//
// Replaces: the diag_identity branches of
//   ltr_lowrank_sdp_tpu/ops/coneops.py ConeOps.constr_vals (:231, :237-238)
//     -> s = 1, no second output: A(sym(U V^T)) for a MaxCut-family cone;
//   ConeOps.constr_vals_pair (:245, :252-255)
//     -> U = R, V = D, s = 2, second output: the ALM line-search pair
//        (A(2 sym(R D^T)), A(D D^T)) in one pass over R and D.
//
// Bound on the card: memory.  It reads U, V and dv once and writes one or
// two n-vectors; two to four flops per 16 bytes read, so time >=
// bytes / 3.35 TB/s.
//
// Design: one warp per row; the lanes stride over the r columns (coalesced
// row segments of U and V), then a shuffle-down tree reduces the partial
// sums to lane 0, which writes the row's outputs.  One pass serves both
// outputs of the pair, so D is read once.  No atomics: the same result on
// every run.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void diag_rowdot_kernel(const double* __restrict__ U,
                                   const double* __restrict__ V,
                                   const double* __restrict__ dv, double s,
                                   double* __restrict__ o1,
                                   double* __restrict__ o2, int n, int r) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp leaves together: one row per warp
  const long long base = static_cast<long long>(row) * r;
  double uv = 0.0;
  double vv = 0.0;
  for (int c = lane; c < r; c += 32) {
    const double v = V[base + c];
    uv += U[base + c] * v;
    vv += v * v;
  }
  for (int off = 16; off > 0; off >>= 1) {
    uv += __shfl_down_sync(0xffffffffu, uv, off);
    vv += __shfl_down_sync(0xffffffffu, vv, off);
  }
  if (lane == 0) {
    o1[row] = (s * dv[row]) * uv;
    if (o2 != nullptr) o2[row] = dv[row] * vv;
  }
}

}  // namespace

// o2 may be null (no second output).  Returns cudaGetLastError().
extern "C" int ltr_diag_rowdot(const void* U, const void* V, const void* dv,
                               double s, void* o1, void* o2, int n, int r,
                               void* stream) {
  if (n <= 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  diag_rowdot_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(U), static_cast<const double*>(V),
      static_cast<const double*>(dv), s, static_cast<double*>(o1),
      static_cast<double*>(o2), n, r);
  return static_cast<int>(cudaGetLastError());
}
