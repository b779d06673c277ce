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
// Bound on the card: memory, and in practice the gathered rows.  The
// compulsory bytes are seg_ptr, rows, cols, coef and the factors read once
// and (m,) or 2 (m,) written; but every entry gathers two (U is V) or four
// (pair) rows of r values, mostly from L2: matrix completion n = 10^4, r =
// 19, pair mode gathers 336 MB for 22.9 MB compulsory, theta n = 300, r =
// 141 about 45 MB for 1 MB.  About 2 r flops per 8 r gathered bytes is far
// below the FP64 ridge point.  One warp per constraint left most of a
// warp's lanes idle at r < 32 and paid the dependent chain seg_ptr -> (row,
// col, coef) -> rows -> store once per constraint; at matrix completion's
// r = 19 its issue slots (shuffles, index loads), not L2, were the limit.
//
// Design for the short segments (fewer than long_thresh entries: every
// one-entry constraint of matrix completion, HALLaR and theta).  A group of
// G lanes serves one constraint, its lanes striding over the columns with
// CPL column terms each (at most 8 a pass): G a power of two picked from r
// (kernels.k5_plan): the smallest >= r up to r = 16 (2 at r = 2, 8 at r =
// 5..8), 16 lanes of two columns for 17 <= r <= 32, 32 lanes above.  A warp
// serves P = 32 / G constraints at once and each group KC (1 or 2, picked
// from the constraint count: KC never changes the bits), interleaved so
// that the groups' k-th constraints are neighbours: the warp loads the
// bounds of all of them with one coalesced load, and at each entry step the
// (row, col, coef) of all KC constraints and then all their rows, every
// load unconditional (a finished constraint re-reads a valid entry and adds
// nothing) so that none waits behind another's branch.  A group walks its
// constraint's entries in order; for each entry a lane forms the dot over
// its columns in column order and adds coef times it to the running sum,
// and a width-G xor-shuffle tree adds the lanes.  The order depends only on
// the segment, r and the value type: a shard's segment gives the full
// layout's bits, two calls agree, no atomics.  A constraint with no entry
// writes exactly 0.  The mode is a template argument, so `U is V` loads two
// rows an entry and pair mode four.
//
// Long segments (at least long_thresh entries: a trace constraint) are cut
// on the host into chunks of at most K5_CHUNK (8) entries, counted from the
// segment's start.  The same launch gives each chunk a warp of its own (the
// first blocks, so the longest walks start first), which walks it as one
// warp per constraint always did: lanes over the columns in strides of 32,
// the entries in order, one 32-lane shuffle tree; its lanes load the
// chunk's (row, col, coef) at once.  It writes the chunk's partial sums,
// and a second, small launch adds the partials of each long segment in
// chunk order with a fixed tree; it is a programmatic dependent launch, so
// it is scheduled while the first runs and waits for its partials with
// griddepcontrol.wait.  The short walk skips the long segments.  A layout
// with no long segment is one launch.
//
// Value type: a template on T.  float32 loads, multiplies and accumulates in
// float32, as XLA does on the TPU (the reference reduces these constraint
// values in the compute type; only the objective and the gap go through
// float64); the bytes of the factors, coef and the outputs halve.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// The sum over width lanes (a power of two) of v by an xor tree: every lane
// of the width ends with the same bits.
template <int W, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// Entry (i, j)'s terms over this lane's columns c0 + lig + S t (t < CPL,
// c < r; S the lanes that share an entry), in ascending column order: e1
// in a (the single or pair value before coef) and e2 in d (pair mode).  All
// four rows are loaded first, unconditionally (a column past r reads column
// r - 1 and is not added), so the loads of several entries can be in flight
// together; a diagonal entry (i == j) reads its row from L1 the second time.
template <int MODE, typename T, int S, int CPL>
__device__ __forceinline__ void entry_terms(const T* __restrict__ U,
                                            const T* __restrict__ V,
                                            long long i, long long j, int r,
                                            int lig, T& a, T& d) {
  a = T(0);
  d = T(0);
  for (int c0 = 0; c0 < r; c0 += S * CPL) {
    T ui[CPL], uj[CPL], vi[CPL], vj[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = min(c0 + lig + S * t, r - 1);
      ui[t] = U[i + c];
      uj[t] = U[j + c];
      if (MODE != 1) {
        vi[t] = V[i + c];
        vj[t] = V[j + c];
      }
    }
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      if (c0 + lig + S * t >= r) continue;
      if (MODE == 1) {
        a += ui[t] * uj[t];
      } else if (MODE == 0) {
        if (i == j) {
          a += ui[t] * vi[t];
        } else {
          a += ui[t] * vj[t] + uj[t] * vi[t];
        }
      } else if (i == j) {
        a += T(2) * (ui[t] * vi[t]);
        d += vi[t] * vi[t];
      } else {
        a += ui[t] * vj[t] + uj[t] * vi[t];
        d += vi[t] * vj[t];
      }
    }
  }
  if (MODE == 0 && i != j) a = T(0.5) * a;
}

// A long segment's chunk start .. end: the whole warp, lanes over the
// columns in strides of 32.  Lane t loads entry start + t's (row, col, coef)
// once; the warp then takes the entries in order, UNROLL entries' rows in
// flight at a time; lane 0 ends with the sums.
template <int MODE, typename T, int CPL, int UNROLL>
__device__ __forceinline__ void walk_chunk(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const T* __restrict__ coef, const T* __restrict__ U,
    const T* __restrict__ V, int start, int end, int r, int lane, T& s1,
    T& s2) {
  s1 = T(0);
  s2 = T(0);
  for (int k0 = start; k0 < end; k0 += 32) {
    const int kk = min(k0 + lane, end - 1);
    const int my_row = rows[kk];
    const int my_col = cols[kk];
    const T my_coef = coef[kk];
    const int cnt = min(32, end - k0);
    for (int t0 = 0; t0 < cnt; t0 += UNROLL) {
      T a[UNROLL], d[UNROLL], ck[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = min(t0 + u, cnt - 1);
        ck[u] = __shfl_sync(kFull, my_coef, t);
        entry_terms<MODE, T, 32, CPL>(
            U, V, static_cast<long long>(__shfl_sync(kFull, my_row, t)) * r,
            static_cast<long long>(__shfl_sync(kFull, my_col, t)) * r, r,
            lane, a[u], d[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (t0 + u < cnt) {
          s1 += ck[u] * a[u];
          if (MODE == 2) s2 += ck[u] * d[u];
        }
      }
    }
  }
  s1 = group_sum<32>(s1);
  if (MODE == 2) s2 = group_sum<32>(s2);
}

// A group's walk of its KC segments start[k] .. start[k] + len[k] - 1 (len
// -1: none), entries in order, into this lane's running sums s1, s2 (before
// the group's shuffle tree).  At entry e every constraint's (row, col, coef)
// and then every row load is issued before its first use (a finished
// constraint re-reads a valid entry and adds nothing).
template <int MODE, typename T, int G, int CPL, int KC>
__device__ __forceinline__ void walk_group(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const T* __restrict__ coef, const T* __restrict__ U,
    const T* __restrict__ V, const int (&start)[KC], const int (&len)[KC],
    int longest, int last, int r, int lig, T (&s1)[KC], T (&s2)[KC]) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    s1[k] = T(0);
    s2[k] = T(0);
  }
  for (int e = 0; e < longest; ++e) {
    int ri[KC], ci[KC];
    T ck[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int idx = min(start[k] + e, last);
      ri[k] = rows[idx];
      ci[k] = cols[idx];
      ck[k] = coef[idx];
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      T a, d;
      entry_terms<MODE, T, G, CPL>(U, V, static_cast<long long>(ri[k]) * r,
                                   static_cast<long long>(ci[k]) * r, r, lig,
                                   a, d);
      if (e < len[k]) {
        s1[k] += ck[k] * a;
        if (MODE == 2) s2[k] += ck[k] * d;
      }
    }
  }
}

// Blocks 0 .. chunk_blocks - 1 (first, so that the long segments' chunks,
// the longest walks, start first): one warp per chunk, writing part1[chunk]
// (and part2[chunk]).  The blocks after them: one warp per tile of P KC
// consecutive constraints, group q taking the tile's constraints q, q + P,
// ... (a segment of at least skip_len entries is left to the chunk warps).
template <int MODE, typename T, int G, int CPL, int KC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
coo_contract_segsum_kernel(
    const int* __restrict__ seg_ptr, const int* __restrict__ rows,
    const int* __restrict__ cols, const T* __restrict__ coef,
    const T* __restrict__ U, const T* __restrict__ V, int m, int r,
    int last, T* __restrict__ out1, T* __restrict__ out2, int chunk_blocks,
    int skip_len, const int* __restrict__ chunk_ptr, int n_chunks,
    T* __restrict__ part1, T* __restrict__ part2) {
  constexpr int P = 32 / G;
  constexpr int NC = P * KC;
  static_assert(NC <= 32, "a tile's bounds are one 32-lane load");
  // let a programmatic dependent (the long segments' reduce) be scheduled
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (static_cast<int>(blockIdx.x) < chunk_blocks) {
    const int chunk = blockIdx.x * kWarpsPerBlock + warp;
    if (chunk >= n_chunks) return;
    T s1, s2;
    walk_chunk<MODE, T, (G == 32 ? CPL : 1), KC>(
        rows, cols, coef, U, V, chunk_ptr[2 * chunk],
        chunk_ptr[2 * chunk + 1], r, lane, s1, s2);
    if (lane == 0) {
      part1[chunk] = s1;
      if (MODE == 2) part2[chunk] = s2;
    }
    return;
  }
  const int c0 =
      ((blockIdx.x - chunk_blocks) * kWarpsPerBlock + warp) * NC;
  if (c0 >= m) return;
  // lane l < NC: the bounds of the tile's constraint c0 + l
  int my_start = 0;
  int my_len = -1;                  // -1: no constraint, or a long one
  if (lane < NC && c0 + lane < m) {
    my_start = seg_ptr[c0 + lane];
    my_len = seg_ptr[c0 + lane + 1] - my_start;
    if (my_len >= skip_len) my_len = -1;
  }
  const int q = lane / G;
  const int lig = lane % G;
  int start[KC], len[KC];
  int longest = 0;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    start[k] = __shfl_sync(kFull, my_start, k * P + q);
    len[k] = __shfl_sync(kFull, my_len, k * P + q);
    longest = max(longest, len[k]);
  }
  T s1[KC], s2[KC];
  walk_group<MODE, T, G, CPL, KC>(rows, cols, coef, U, V, start, len, longest,
                                  last, r, lig, s1, s2);
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    s1[k] = group_sum<G>(s1[k]);
    if (MODE == 2) s2[k] = group_sum<G>(s2[k]);
    if (lig == 0 && len[k] >= 0) {
      const int i = c0 + k * P + q;
      out1[i] = s1[k];
      if (MODE == 2) out2[i] = s2[k];
    }
  }
}

// One warp per long segment: the partials of its chunks long_ptr[l] ..
// long_ptr[l + 1], lanes striding over them, one shuffle tree.  Launched as
// a programmatic dependent of the first kernel (Hopper), so that it is
// scheduled while the first one runs: griddepcontrol.wait holds it until
// that grid has finished and its partials are visible.
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
  // the layout is not the first kernel's output: read it before the wait
  int start = 0, end = 0, seg = 0;
  if (l < n_long) {
    start = long_ptr[l];
    end = long_ptr[l + 1];
    seg = long_seg[l];
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (l >= n_long) return;
  T s1 = T(0);
  T s2 = T(0);
  for (int c = start + lane; c < end; c += 32) {
    s1 += part1[c];
    if (mode == 2) s2 += part2[c];
  }
  s1 = group_sum<32>(s1);
  if (mode == 2) s2 = group_sum<32>(s2);
  if (lane == 0) {
    out1[seg] = s1;
    if (mode == 2) out2[seg] = s2;
  }
}

struct Args {
  const void *seg_ptr, *rows, *cols, *coef, *U, *V;
  int m, r, nnz;
  void *out1, *out2;
  int long_thresh;
  const void* chunk_ptr;
  int n_chunks;
  const void *long_seg, *long_ptr;
  int n_long;
  void *part1, *part2;
};

template <int MODE, typename T, int G, int CPL, int KC>
int launch(const Args& a, cudaStream_t s) {
  constexpr int NC = (32 / G) * KC;
  const int tiles = (a.m + NC - 1) / NC;
  const int tile_blocks = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int chunk_blocks =
      (a.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 block(kWarpsPerBlock * 32);
  // with no chunk, no segment is skipped: every one is walked by its group
  const int skip_len = a.n_chunks > 0 ? a.long_thresh : 0x7fffffff;
  coo_contract_segsum_kernel<MODE, T, G, CPL, KC>
      <<<dim3(chunk_blocks + tile_blocks), block, 0, s>>>(
          static_cast<const int*>(a.seg_ptr), static_cast<const int*>(a.rows),
          static_cast<const int*>(a.cols), static_cast<const T*>(a.coef),
          static_cast<const T*>(a.U), static_cast<const T*>(a.V), a.m, a.r,
          a.nnz - 1, static_cast<T*>(a.out1), static_cast<T*>(a.out2),
          chunk_blocks, skip_len, static_cast<const int*>(a.chunk_ptr),
          a.n_chunks, static_cast<T*>(a.part1), static_cast<T*>(a.part2));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || a.n_chunks == 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n_long + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cfg.blockDim = block;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, coo_long_reduce_kernel<T>, static_cast<const int*>(a.long_seg),
      static_cast<const int*>(a.long_ptr), a.n_long, MODE,
      static_cast<const T*>(a.part1), static_cast<const T*>(a.part2),
      static_cast<T*>(a.out1), static_cast<T*>(a.out2)));
}

template <typename T, int G, int CPL, int KC>
int launch_mode(int mode, const Args& a, cudaStream_t s) {
  if (mode == 0) return launch<0, T, G, CPL, KC>(a, s);
  if (mode == 1) return launch<1, T, G, CPL, KC>(a, s);
  return launch<2, T, G, CPL, KC>(a, s);
}

template <typename T>
int dispatch(int g, int cpl, int kc, int mode, const Args& a,
             cudaStream_t s) {
#define K5_CASE(GG, CC, KK)                  \
  if (g == GG && cpl == CC && kc == KK)      \
    return launch_mode<T, GG, CC, KK>(mode, a, s);
#define K5_CASE2(GG, CC) K5_CASE(GG, CC, 1) K5_CASE(GG, CC, 2)
  K5_CASE(1, 1, 1) K5_CASE2(2, 1) K5_CASE2(4, 1) K5_CASE2(8, 1)
  K5_CASE2(16, 1) K5_CASE2(16, 2) K5_CASE2(32, 2) K5_CASE2(32, 3)
  K5_CASE2(32, 4) K5_CASE(32, 5, 1) K5_CASE(32, 6, 1) K5_CASE(32, 7, 1)
  K5_CASE(32, 8, 1)
#undef K5_CASE2
#undef K5_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// mode: 0 single, 1 single with U is V (V is not read), 2 pair (out2
// required).  A segment of at least long_thresh entries is walked by the
// chunk warps: chunk_ptr holds (start, end) per chunk, long_seg / long_ptr
// name the cut segments and their chunk ranges, part1 / part2 are scratch
// of n_chunks values (part2 in pair mode); n_chunks == 0 is the layout with
// no long segment, whose every segment the tiles walk.  g (lanes per
// constraint), cpl (columns per lane and pass) and kc (constraints per
// group) name the instantiation, picked on the host (kernels.k5_plan); one
// that is not instantiated is refused.  f32 != 0: coef, U, V, the outputs
// and the partials are float32, else float64.  Returns the
// cudaGetLastError() code of the launches.
extern "C" int ltr_coo_contract_segsum(
    int f32, const void* seg_ptr, const void* rows, const void* cols,
    const void* coef, const void* U, const void* V, int m, int nnz, int r,
    int mode, void* out1, void* out2, int long_thresh, const void* chunk_ptr,
    int n_chunks, const void* long_seg, const void* long_ptr, int n_long,
    void* part1, void* part2, int g, int cpl, int kc, void* stream) {
  if (m <= 0) return 0;
  if (r <= 0 || mode < 0 || mode > 2 || (mode == 2 && out2 == nullptr) ||
      (g < 32 && r > g * cpl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_chunks > 0 &&
      (chunk_ptr == nullptr || long_seg == nullptr || long_ptr == nullptr ||
       part1 == nullptr || n_long <= 0 || long_thresh <= 0 ||
       (mode == 2 && part2 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{seg_ptr,  rows,      cols,     coef,     U,        V,
               m,        r,         nnz,      out1,     out2,     long_thresh,
               chunk_ptr, n_chunks, long_seg, long_ptr, n_long,   part1,
               part2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch<float>(g, cpl, kc, mode, a, s)
             : dispatch<double>(g, cpl, kc, mode, a, s);
}
