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
// Bound on the card: memory, but not the compulsory bytes.  It must read
// indptr and the per-slot col, val and cid from HBM once (16 bytes a slot in
// float64) and write out once; the gathered Y rows (r values a slot) come
// from L2, and at every shape the solver runs they are the larger traffic
// (theta n = 300, r = 141: 20 k slots, 0.3 MB of slot arrays, 22.6 MB of Y
// rows; a maximum stable set cone n = 1,024, r = 8: 17 MB of slot arrays,
// 68 MB of rows).  Two flops per slot and column is far below the ridge.
// A one-warp-per-row walk is a latency chain instead (slot index -> w and Y
// -> add, one slot after another, about 0.18 us each) on a grid that is
// too small to hide it when n is small and rows are long.
//
// Design.  A group of G lanes takes one slot at a time (G a power of two
// picked from r: 1 at r = 1, 8 at r = 8, 32 at r >= 17), so a warp holds
// P = 32 / G slots in flight and no lane idles at small r; a lane keeps CPL
// = ceil(r / G) column accumulators (at most 8: r <= 256 in one pass,
// wider r in passes of 256 columns).  A row's slots, counted from the
// row's own start, are cut into chunks of min(G, 8) steps of P slots (8
// slots at G = 32, 16 at G = 16, 32 below), and the chunks are dealt
// round-robin to kStrands = 8 strands: chunk c to strand c mod 8.  Lane l
// reads a chunk's slot l (column, and weight w[cid] * val) with coalesced
// loads and shuffles hand them to the groups, so no lane re-reads a slot;
// group q of a strand adds, in chunk and step order, the slots at offset
// t * P + q of its chunks, up to eight rows' loads in flight a lane before
// the adds (a slot past the row's end or a column past r is read at a
// clamped address and not added, so no load waits behind a branch).  The
// eight strand sums are added by one fixed balanced tree, ((s0 + s1) + (s2
// + s3)) + ((s4 + s5) + (s6 + s7)), and the P group sums of the result by
// an xor-shuffle tree.  Where a round of strands' chunks fits in eight
// loads a lane (G = 1, the Lanczos matvec at r = 1), a warp walks its
// strands side by side, one chunk of each a round; elsewhere strand by
// strand down the tree: the same terms in the same order.
//
// W warps share a row (W = 1, 2, 4 or 8, picked on the host from r and the
// layout's row count and longest row, kernels.k6_plan): warp j of the row
// takes strands 8 j / W .. 8 (j + 1) / W - 1, adds them by its part of the
// same tree in registers, and the W warps' partial rows meet in shared
// memory along the tree's upper levels.  So W changes which warp adds which
// subtree, never the subtrees: every W gives the same bits, a row's sum
// depends only on its own slots, r and the value type (a shard's kept row
// equals the full layout's row, bit for bit), there are no atomics and two
// calls agree.  An empty strand sums to +0.0, which leaves any sum
// unchanged.  A row with no slot writes beta * Z (or 0).  On an H100 this
// takes theta's n = 300, r = 141 product from 0.059 to 0.009 ms (W = 8)
// and a maximum stable set cone's n = 1,024, r = 8 one from 0.195 to 0.014
// ms (W = 4), both under torch.sparse.mm on a pre-weighted CSR.
//
// Value type: a template on T.  float32 loads, multiplies and accumulates in
// float32, as XLA does on the TPU; the value bytes halve.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kStrands = 8;       // fixed: part of every row's sum order
constexpr unsigned kFull = 0xffffffffu;

// Steps of 32 / G slots in a chunk: min(G, 8), so a chunk is 8 slots at G =
// 32, 16 at G = 16 and 32 below (part of every row's sum order).
__host__ __device__ constexpr int steps_per_chunk(int g) {
  return g < 8 ? g : 8;
}

// One row's walk: its slot range, r, this column pass's first column c0,
// the lane, its group q and its lane in the group lig.
template <typename T>
struct Slots {
  const int* __restrict__ col;
  const T* __restrict__ val;
  const int* __restrict__ cid;
  const T* __restrict__ w;
  const T* __restrict__ Y;
  int start, end, r, c0, lane, q, lig;
};

// Steps u0 .. u0 + U - 1 of a chunk that starts at slot k0 (slots k0 + (u0
// + u) P + q for group q): their columns and weights from the lanes that
// read them, every Y load before the first add (a slot past the row's end
// re-reads the last slot, a column past r column r - 1, and neither is
// added).
template <typename T, int G, int CPL, int U>
__device__ __forceinline__ void steps(const Slots<T>& a, int k0, int u0,
                                      int my_col, T my_wt, T (&acc)[CPL]) {
  constexpr int P = 32 / G;
  T y[U][CPL];
  T wt[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int src = (u0 + u) * P + a.q;
    const long long yb =
        static_cast<long long>(G == 1 ? my_col
                                      : __shfl_sync(kFull, my_col, src)) *
        a.r;
    wt[u] = G == 1 ? my_wt : __shfl_sync(kFull, my_wt, src);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      y[u][c] = a.Y[yb + min(a.c0 + a.lig + c * G, a.r - 1)];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (k0 + (u0 + u) * P + a.q < a.end) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if (a.c0 + a.lig + c * G < a.r) acc[c] += wt[u] * y[u][c];
      }
    }
  }
}

// Strand s of one row: group q adds its slots of chunks s, s + 8, ... into
// acc (this lane's columns c0 + lig + G c, c < CPL).  A chunk is kSteps(G)
// steps of P slots, at most 32 slots: lane l reads slot l's column and
// weight w[cid] * val (coalesced loads), and shuffles hand them to the
// groups; the steps run U = max(1, 8 / CPL) at a time, which keeps about
// eight rows' loads in flight a lane without crowding the registers.
template <typename T, int G, int CPL>
__device__ __forceinline__ void strand(const Slots<T>& a, int s,
                                       T (&acc)[CPL]) {
  constexpr int P = 32 / G;
  constexpr int S = steps_per_chunk(G);
  constexpr int kChunk = S * P;
  constexpr int U = (S < 8 / CPL) ? S : (8 / CPL > 0 ? 8 / CPL : 1);
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = T(0);
  for (int k0 = a.start + s * kChunk; k0 < a.end;
       k0 += kStrands * kChunk) {
    const int mine =
        a.lane < kChunk ? min(k0 + a.lane, a.end - 1) : a.end - 1;
    const int my_col = a.col[mine];
    const T my_wt = a.w[a.cid[mine]] * a.val[mine];
    if (U == S) {
      steps<T, G, CPL, U>(a, k0, 0, my_col, my_wt, acc);
    } else {
#pragma unroll 1
      for (int u0 = 0; u0 < S; u0 += U) {
        steps<T, G, CPL, U>(a, k0, u0, my_col, my_wt, acc);
      }
    }
  }
}

// The sum of strands s0 .. s0 + 2^L - 1 by the balanced tree.
template <typename T, int G, int CPL, int L>
struct Subtree {
  __device__ __forceinline__ static void run(const Slots<T>& a, int s0,
                                             T (&out)[CPL]) {
    T right[CPL];
    Subtree<T, G, CPL, L - 1>::run(a, s0, out);
    Subtree<T, G, CPL, L - 1>::run(a, s0 + (1 << (L - 1)), right);
#pragma unroll
    for (int c = 0; c < CPL; ++c) out[c] += right[c];
  }
};

template <typename T, int G, int CPL>
struct Subtree<T, G, CPL, 0> {
  __device__ __forceinline__ static void run(const Slots<T>& a, int s0,
                                             T (&out)[CPL]) {
    strand<T, G, CPL>(a, s0, out);
  }
};

// Strands s0 .. s0 + 2^L - 1 of one row, at one lane column or a few
// (CPL = 1, and at most 8 slots a lane a round): chunk s0 + i + 8 R of
// each strand i in round R, all their slot reads issued at once, then their
// steps; per-strand sums added by the same balanced tree as Subtree's.  The
// same terms in the same order as Subtree, with the loads of 2^L strands in
// flight instead of one (the Lanczos matvec at r = 1 walks 32-slot chunks).
template <typename T, int G, int CPL, int L>
__device__ __forceinline__ void rounds(const Slots<T>& a, int s0,
                                       T (&out)[CPL]) {
  constexpr int NS = 1 << L;
  constexpr int P = 32 / G;
  constexpr int S = steps_per_chunk(G);
  constexpr int kChunk = S * P;
  T acc[NS][CPL];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = T(0);
  }
  for (int b = a.start + s0 * kChunk; b < a.end; b += kStrands * kChunk) {
    int my_col[NS];
    T my_wt[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int mine = a.lane < kChunk
                           ? min(b + i * kChunk + a.lane, a.end - 1)
                           : a.end - 1;
      my_col[i] = a.col[mine];
      my_wt[i] = a.w[a.cid[mine]] * a.val[mine];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      steps<T, G, CPL, S>(a, b + i * kChunk, 0, my_col[i], my_wt[i], acc[i]);
    }
  }
#pragma unroll
  for (int h = 1; h < NS; h <<= 1) {
#pragma unroll
    for (int i = 0; i < NS; i += 2 * h) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] += acc[i + h][c];
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) out[c] = acc[0][c];
}

// Strands s0 .. s0 + 2^L - 1: by rounds where a round's loads fit (CPL = 1,
// 2^L S <= 8), else strand by strand down the tree.
template <typename T, int G, int CPL, int L>
__device__ __forceinline__ void part_sum(const Slots<T>& a, int s0,
                                         T (&out)[CPL]) {
  if constexpr (L > 0 && CPL == 1 && (steps_per_chunk(G) << L) <= 8) {
    rounds<T, G, CPL, L>(a, s0, out);
  } else {
    Subtree<T, G, CPL, L>::run(a, s0, out);
  }
}

// Block: kWarpsPerBlock / wpr rows, wpr (1, 2, 4 or 8) warps per row.
template <typename T, int G, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_constr_csr_kernel(const int* __restrict__ indptr,
                       const int* __restrict__ col,
                       const T* __restrict__ val,
                       const int* __restrict__ cid,
                       const T* __restrict__ w,
                       const T* __restrict__ Y,
                       const T* __restrict__ Z,
                       T* __restrict__ out,
                       int n, int r, T beta, int wpr) {
  __shared__ T red[kWarpsPerBlock][32 * CPL];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = warp % wpr;
  const int row = blockIdx.x * (kWarpsPerBlock / wpr) + warp / wpr;
  const bool live = row < n;
  Slots<T> a{col, val, cid, w, Y, 0, 0, r, 0, lane, lane / G, lane % G};
  if (live) {
    a.start = indptr[row];
    a.end = indptr[row + 1];
  }
  const long long base = static_cast<long long>(row) * r;
  // columns in passes of G CPL (one pass for r <= G CPL); the pass count is
  // the same for every thread of the block
  for (; a.c0 < r; a.c0 += G * CPL) {
    T tot[CPL];
    switch (wpr) {
      case 1: part_sum<T, G, CPL, 3>(a, 0, tot); break;
      case 2: part_sum<T, G, CPL, 2>(a, 4 * part, tot); break;
      case 4: part_sum<T, G, CPL, 1>(a, 2 * part, tot); break;
      default: part_sum<T, G, CPL, 0>(a, part, tot); break;
    }
    // the tree's upper levels across the row's warps: at level h, part p
    // (p a multiple of 2h) adds part p + h's subtree to its own
    for (int h = 1; h < wpr; h <<= 1) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) red[warp][c * 32 + lane] = tot[c];
      __syncthreads();
      if (part % (2 * h) == 0) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) tot[c] += red[warp + h][c * 32 + lane];
      }
      __syncthreads();
    }
    if (part == 0 && live) {
      // the P groups' sums, by an xor tree over the group bits
#pragma unroll
      for (int off = G; off < 32; off <<= 1) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          tot[c] += __shfl_xor_sync(kFull, tot[c], off);
        }
      }
      if (lane < G) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int cc = a.c0 + lane + c * G;
          if (cc < r) {
            out[base + cc] = (Z != nullptr) ? beta * Z[base + cc] + tot[c]
                                            : tot[c];
          }
        }
      }
    }
  }
}

template <typename T, int G, int CPL>
int launch(const void* indptr, const void* col, const void* val,
           const void* cid, const void* w, const void* Y, const void* Z,
           void* out, int n, int r, double beta, int wpr,
           cudaStream_t stream) {
  const int rows_per_block = kWarpsPerBlock / wpr;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block);
  spmm_constr_csr_kernel<T, G, CPL>
      <<<grid, dim3(kWarpsPerBlock * 32), 0, stream>>>(
          static_cast<const int*>(indptr), static_cast<const int*>(col),
          static_cast<const T*>(val), static_cast<const int*>(cid),
          static_cast<const T*>(w), static_cast<const T*>(Y),
          static_cast<const T*>(Z), static_cast<T*>(out), n, r,
          static_cast<T>(beta), wpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int g, int cpl, const void* indptr, const void* col,
             const void* val, const void* cid, const void* w, const void* Y,
             const void* Z, void* out, int n, int r, double beta, int wpr,
             cudaStream_t s) {
#define K6_CASE(GG, CC)                                                    \
  if (g == GG && cpl == CC)                                                \
    return launch<T, GG, CC>(indptr, col, val, cid, w, Y, Z, out, n, r,    \
                             beta, wpr, s);
  K6_CASE(1, 1) K6_CASE(2, 1) K6_CASE(4, 1) K6_CASE(8, 1) K6_CASE(16, 1)
  K6_CASE(32, 1) K6_CASE(32, 2) K6_CASE(32, 3) K6_CASE(32, 4)
  K6_CASE(32, 5) K6_CASE(32, 6) K6_CASE(32, 7) K6_CASE(32, 8)
#undef K6_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// f32 != 0: every value array is float32, else float64.  Z may be null.
// g (lanes per slot) and cpl (columns per lane) name the instantiation and
// wpr (1, 2, 4 or 8) the warps per row, all picked on the host
// (kernels.k6_plan); a pair that is not instantiated, or one that does not
// cover r in passes of 32 cpl columns, is refused.  Returns the
// cudaGetLastError() code of the launch.
extern "C" int ltr_spmm_constr_csr(int f32, const void* indptr,
                                   const void* col, const void* val,
                                   const void* cid, const void* w,
                                   const void* Y, const void* Z, void* out,
                                   int n, int r, double beta, int g, int cpl,
                                   int wpr, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  if ((wpr != 1 && wpr != 2 && wpr != 4 && wpr != 8) ||
      (g < 32 && r > g * cpl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch<float>(g, cpl, indptr, col, val, cid, w, Y, Z, out,
                               n, r, beta, wpr, s)
             : dispatch<double>(g, cpl, indptr, col, val, cid, w, Y, Z, out,
                                n, r, beta, wpr, s);
}
