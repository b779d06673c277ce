// K5 coo_contract_segsum: the constraint values A(sym(U V^T)) of a cone with
// general sparse constraint matrices, float64.
//
// The cone's constraint entries are the upper triangles (row <= col) of the
// A_i, sorted by constraint id on the host, so the entries of constraint i
// are the segment seg_ptr[i] .. seg_ptr[i+1] of (rows, cols, coef), with
// coef_k = 2 a_k off the diagonal and a_k on it.  Three modes:
//
//   single (mode 0):  out1[i] = sum_k coef_k * 1/2 (<U[r_k], V[c_k]>
//                                                   + <U[c_k], V[r_k]>)
//   same   (mode 1):  out1[i] = sum_k coef_k * <U[r_k], U[c_k]>   (U is V)
//   pair   (mode 2):  out1[i] = sum_k coef_k * (<U[r_k], V[c_k]>
//                                               + <U[c_k], V[r_k]>)
//                     out2[i] = sum_k coef_k * <V[r_k], V[c_k]>
//                     (the ALM line-search pair with U = R, V = D: both
//                     outputs from one read of the gathered rows)
//
// Replaces: ltr_lowrank_sdp_tpu/ops/gatherseg.py EllSegSum.__call__ (:143)
// fused with the contraction that feeds it: ops/coneops.py
// ConeOps.constr_vals (:239-243, sparse and non-identity diag branches) with
// _SparseSym.contract (:87-102), and ConeOps.constr_vals_pair (:256-270).
// The TPU version gathers all rows, multiplies, and reduces through a
// bucketed ELL table because XLA scatters serialize there; none of that is
// carried over.
//
// Bound on the card: memory.  It must read seg_ptr, rows, cols, coef and the
// factors once and write (m,) or 2 (m,); it does about 2 r flops per 8 r
// gathered bytes, far below the H100's FP64 ridge point.  The gathered rows
// come from L2 when the factors fit its 50 MB.
//
// Design: one warp per constraint.  It takes the constraint's entries in
// turn, the lanes striding over the r columns of the gathered rows (coalesced
// row reads), every lane keeping partial sums that one shuffle tree adds at
// the end.  Each output is written by one lane: no atomics, a fixed sum
// order, the same bits on every run.  A constraint with no entry in the cone
// writes exactly 0; a diagonal entry (row == col) reads its row once.
// Segment lengths range from 1 (every matrix-completion constraint) to n (a
// trace constraint): a one-entry segment at r < 32 leaves lanes idle, and a
// long segment is one warp's dependent chain of index and row reads.  Both
// are accepted here and the times are recorded.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Adds entry (i, j)'s share over this lane's columns lane, lane + 32, ... to
// the running sums: s1 += ck * e1, s2 += ck * e2 (pair mode only).
__device__ __forceinline__ void add_entry(int mode,
                                          const double* __restrict__ U,
                                          const double* __restrict__ V,
                                          long long i, long long j, int r,
                                          int lane, double ck, double& s1,
                                          double& s2) {
  double a = 0.0;
  if (mode == 1) {
    for (int c = lane; c < r; c += 32) a += U[i + c] * U[j + c];
    s1 += ck * a;
  } else if (mode == 0) {
    if (i == j) {
      for (int c = lane; c < r; c += 32) a += U[i + c] * V[i + c];
      s1 += ck * a;
    } else {
      for (int c = lane; c < r; c += 32) {
        a += U[i + c] * V[j + c] + U[j + c] * V[i + c];
      }
      s1 += ck * (0.5 * a);
    }
  } else {
    double d = 0.0;
    if (i == j) {
      for (int c = lane; c < r; c += 32) {
        const double vi = V[i + c];
        a += 2.0 * (U[i + c] * vi);
        d += vi * vi;
      }
    } else {
      for (int c = lane; c < r; c += 32) {
        const double vi = V[i + c];
        const double vj = V[j + c];
        a += U[i + c] * vj + U[j + c] * vi;
        d += vi * vj;
      }
    }
    s1 += ck * a;
    s2 += ck * d;
  }
}

__global__ void coo_contract_segsum_kernel(const int* __restrict__ seg_ptr,
                                           const int* __restrict__ rows,
                                           const int* __restrict__ cols,
                                           const double* __restrict__ coef,
                                           const double* __restrict__ U,
                                           const double* __restrict__ V,
                                           int m, int r, int mode,
                                           double* __restrict__ out1,
                                           double* __restrict__ out2) {
  const int lane = threadIdx.x & 31;
  const long long seg =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (seg >= m) return;
  const int start = seg_ptr[seg];
  const int end = seg_ptr[seg + 1];
  double s1 = 0.0;
  double s2 = 0.0;
  for (int k = start; k < end; ++k) {
    add_entry(mode, U, V, static_cast<long long>(rows[k]) * r,
              static_cast<long long>(cols[k]) * r, r, lane, coef[k], s1, s2);
  }
  s1 = warp_sum(s1);
  if (mode == 2) s2 = warp_sum(s2);
  if (lane == 0) {
    out1[seg] = s1;
    if (mode == 2) out2[seg] = s2;
  }
}

}  // namespace

// mode: 0 single, 1 single with U is V (V is not read), 2 pair (out2
// required).  Returns the cudaGetLastError() code of the launch.
extern "C" int ltr_coo_contract_segsum(const void* seg_ptr, const void* rows,
                                       const void* cols, const void* coef,
                                       const void* U, const void* V, int m,
                                       int r, int mode, void* out1,
                                       void* out2, void* stream) {
  if (m <= 0) return 0;
  if (r <= 0 || mode < 0 || mode > 2 || (mode == 2 && out2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((m + kWarpsPerBlock - 1) / kWarpsPerBlock);
  coo_contract_segsum_kernel<<<grid, block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg_ptr), static_cast<const int*>(rows),
      static_cast<const int*>(cols), static_cast<const double*>(coef),
      static_cast<const double*>(U), static_cast<const double*>(V), m, r,
      mode, static_cast<double*>(out1), static_cast<double*>(out2));
  return static_cast<int>(cudaGetLastError());
}
