// K5 coo_contract_segsum: the constraint values A(sym(U V^T)) of a cone with
// general sparse constraint matrices, float64 or float32.
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
//
// Segment lengths range from 1 (every matrix-completion constraint) to n (the
// trace constraint of a Lovasz theta problem).  One warp walking a segment is
// a dependent chain of index and row reads, about a third of a microsecond
// per entry on an H100, that the rest of the grid waits for.  So the host
// cuts every segment of at least `long_thresh` entries into short chunks.
// The same launch gives each chunk a warp of its own (the blocks after those
// of the constraints), which writes the chunk's partial sums; a second, small
// launch adds the partials of each long segment in chunk order with a fixed
// tree.  The split is fixed by the layout, so the result does not depend on
// timing.  A layout with no long segment is one launch as before.  A
// one-entry segment at r < 32 leaves lanes idle, accepted here.
//
// Value type: a template on T.  float32 loads, multiplies and accumulates in
// float32, as XLA does on the TPU (the reference reduces these constraint
// values in the compute type; only the objective and the gap go through
// float64); the bytes of the factors, coef and the outputs halve.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Adds entry (i, j)'s share over this lane's columns lane, lane + 32, ... to
// the running sums: s1 += ck * e1, s2 += ck * e2 (pair mode only).
template <typename T>
__device__ __forceinline__ void add_entry(int mode,
                                          const T* __restrict__ U,
                                          const T* __restrict__ V,
                                          long long i, long long j, int r,
                                          int lane, T ck, T& s1,
                                          T& s2) {
  T a = T(0);
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
      s1 += ck * (T(0.5) * a);
    }
  } else {
    T d = T(0);
    if (i == j) {
      for (int c = lane; c < r; c += 32) {
        const T vi = V[i + c];
        a += T(2) * (U[i + c] * vi);
        d += vi * vi;
      }
    } else {
      for (int c = lane; c < r; c += 32) {
        const T vi = V[i + c];
        const T vj = V[j + c];
        a += U[i + c] * vj + U[j + c] * vi;
        d += vi * vj;
      }
    }
    s1 += ck * a;
    s2 += ck * d;
  }
}

// The whole warp walks entries start .. end in order and leaves the reduced
// sums in lane 0's s1 (and s2 in pair mode).
template <typename T>
__device__ __forceinline__ void walk_entries(
    int mode, const int* __restrict__ rows, const int* __restrict__ cols,
    const T* __restrict__ coef, const T* __restrict__ U,
    const T* __restrict__ V, int start, int end, int r, int lane,
    T& s1, T& s2) {
  s1 = T(0);
  s2 = T(0);
  for (int k = start; k < end; ++k) {
    add_entry(mode, U, V, static_cast<long long>(rows[k]) * r,
              static_cast<long long>(cols[k]) * r, r, lane, coef[k], s1, s2);
  }
  s1 = warp_sum(s1);
  if (mode == 2) s2 = warp_sum(s2);
}

// Blocks 0 .. seg_blocks - 1: one warp per constraint (a constraint that the
// host cut into chunks is left to the chunk warps).  The blocks after them:
// one warp per chunk, writing part1[chunk] (and part2[chunk]).  Both kinds
// of warp pick their entry range and their output slot first and then share
// one copy of the walk, which keeps the register count of the layout with no
// long segment.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
coo_contract_segsum_kernel(
    const int* __restrict__ seg_ptr, const int* __restrict__ rows,
    const int* __restrict__ cols, const T* __restrict__ coef,
    const T* __restrict__ U, const T* __restrict__ V, int m, int r,
    int mode, T* __restrict__ out1, T* __restrict__ out2,
    int seg_blocks, int long_thresh, const int* __restrict__ chunk_ptr,
    int n_chunks, T* __restrict__ part1, T* __restrict__ part2) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int start, end;
  long long slot;
  const bool is_chunk = static_cast<int>(blockIdx.x) >= seg_blocks;
  if (!is_chunk) {
    slot = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
    if (slot >= m) return;
    start = seg_ptr[slot];
    end = seg_ptr[slot + 1];
    if (n_chunks > 0 && end - start >= long_thresh) return;
  } else {
    slot = static_cast<long long>(blockIdx.x - seg_blocks) * kWarpsPerBlock +
           warp;
    if (slot >= n_chunks) return;
    start = chunk_ptr[2 * slot];
    end = chunk_ptr[2 * slot + 1];
  }
  T s1, s2;
  walk_entries(mode, rows, cols, coef, U, V, start, end, r, lane, s1, s2);
  if (lane == 0) {
    (is_chunk ? part1 : out1)[slot] = s1;
    if (mode == 2) (is_chunk ? part2 : out2)[slot] = s2;
  }
}

// One warp per long segment: the partials of its chunks long_ptr[l] ..
// long_ptr[l + 1], lanes striding over them, one shuffle tree.
template <typename T>
__global__ void coo_long_reduce_kernel(const int* __restrict__ long_seg,
                                       const int* __restrict__ long_ptr,
                                       int n_long, int mode,
                                       const T* __restrict__ part1,
                                       const T* __restrict__ part2,
                                       T* __restrict__ out1,
                                       T* __restrict__ out2) {
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (l >= n_long) return;
  const int start = long_ptr[l];
  const int end = long_ptr[l + 1];
  T s1 = T(0);
  T s2 = T(0);
  for (int c = start + lane; c < end; c += 32) {
    s1 += part1[c];
    if (mode == 2) s2 += part2[c];
  }
  s1 = warp_sum(s1);
  if (mode == 2) s2 = warp_sum(s2);
  if (lane == 0) {
    out1[long_seg[l]] = s1;
    if (mode == 2) out2[long_seg[l]] = s2;
  }
}

template <typename T>
int launch(const void* seg_ptr, const void* rows, const void* cols,
           const void* coef, const void* U, const void* V, int m, int r,
           int mode, void* out1, void* out2, int long_thresh,
           const void* chunk_ptr, int n_chunks, const void* long_seg,
           const void* long_ptr, int n_long, void* part1, void* part2,
           cudaStream_t s) {
  const int seg_blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int chunk_blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 block(kWarpsPerBlock * 32);
  coo_contract_segsum_kernel<T>
      <<<dim3(seg_blocks + chunk_blocks), block, 0, s>>>(
          static_cast<const int*>(seg_ptr), static_cast<const int*>(rows),
          static_cast<const int*>(cols), static_cast<const T*>(coef),
          static_cast<const T*>(U), static_cast<const T*>(V), m, r, mode,
          static_cast<T*>(out1), static_cast<T*>(out2), seg_blocks,
          long_thresh, static_cast<const int*>(chunk_ptr), n_chunks,
          static_cast<T*>(part1), static_cast<T*>(part2));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_chunks == 0) return err;
  coo_long_reduce_kernel<T><<<dim3((n_long + kWarpsPerBlock - 1) /
                                   kWarpsPerBlock),
                              block, 0, s>>>(
      static_cast<const int*>(long_seg), static_cast<const int*>(long_ptr),
      n_long, mode, static_cast<const T*>(part1),
      static_cast<const T*>(part2), static_cast<T*>(out1),
      static_cast<T*>(out2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 single, 1 single with U is V (V is not read), 2 pair (out2
// required).  chunk_ptr holds (start, end) per chunk; long_seg / long_ptr
// name the cut segments and their chunk ranges; part1 / part2 are scratch of
// n_chunks values (part2 in pair mode).  n_chunks == 0 is the layout with no
// long segment.  f32 != 0: coef, U, V, the outputs and the partials are
// float32, else float64.  Returns the cudaGetLastError() code of the
// launches.
extern "C" int ltr_coo_contract_segsum(
    int f32, const void* seg_ptr, const void* rows, const void* cols,
    const void* coef, const void* U, const void* V, int m, int r, int mode, void* out1,
    void* out2, int long_thresh, const void* chunk_ptr, int n_chunks,
    const void* long_seg, const void* long_ptr, int n_long, void* part1,
    void* part2, void* stream) {
  if (m <= 0) return 0;
  if (r <= 0 || mode < 0 || mode > 2 || (mode == 2 && out2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_chunks > 0 &&
      (chunk_ptr == nullptr || long_seg == nullptr || long_ptr == nullptr ||
       part1 == nullptr || n_long <= 0 || long_thresh <= 0 ||
       (mode == 2 && part2 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(seg_ptr, rows, cols, coef, U, V, m, r, mode,
                             out1, out2, long_thresh, chunk_ptr, n_chunks,
                             long_seg, long_ptr, n_long, part1, part2, s)
             : launch<double>(seg_ptr, rows, cols, coef, U, V, m, r, mode,
                              out1, out2, long_thresh, chunk_ptr, n_chunks,
                              long_seg, long_ptr, n_long, part1, part2, s);
}
