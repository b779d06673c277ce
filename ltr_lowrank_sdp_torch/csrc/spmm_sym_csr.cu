// K1 spmm_sym_csr: out = alpha * C * Y (+ diag(d) * Y), float64 or float32,
// where the row scale d is given, or formed in the kernel as dv * w.
//
// Replaces: ltr_lowrank_sdp_tpu/ops/gatherseg.py EllSpMM.apply (:248, with
// _reduce :232), reached through ConeOps.apply_c (coneops.py:344) and
// ConeOps.apply_w (coneops.py:383); the optional diagonal term is the
// diag_identity branch of ConeOps.apply_a (coneops.py:374-375), which the
// ADMM update also calls alone (admm.py:164; then C is skipped).  Its row
// scale diag_val * w is formed here (dv and w given), so no elementwise
// launch forms it first.
//
// C is the static symmetric objective, stored once as a full CSR (both
// triangles, the diagonal once) built on the host.  Y is (n, r) row-major.
//
// Bound on the card: memory.  Per call the kernel must read the CSR
// (indptr, indices, values), Y and the row scale once and write out once; at
// two flops per stored entry and column it does about one flop per 8 bytes,
// far below the H100's FP64 ridge point, so time >= bytes / 3.35 TB/s.  The
// gathered neighbour rows (r values an entry) come from L2.
//
// Design.  A group of G lanes (a power of two) takes one row, so a warp
// holds 32 / G rows; lane l of a group keeps NV vectors of V columns (V = 2
// doubles or 4 floats in one 16-byte load where r allows it, else 1 or 2),
// vector l + G j of the pass for j < NV: the G NV V columns of a pass cover
// r (G = 32 takes wider r in passes).  A group reads its row's (index,
// value) pairs in chunks of max(G, 8) entries, each lane max(1, 8 / G) of
// them with coalesced loads, and shuffles hand every pair to the group's
// lanes; a step issues the gathers of Y[index, :] for S entries before its
// first multiply-add, and a warp stops at its longest row's last entry.
// The plan (V, G, NV, S) is picked on the host (kernels.k1_plan, from
// timings on the H100: the fastest plan moves few bytes a step, S NV V
// values of 8 bytes or fewer than 64 a lane, because more registers cost
// resident warps).  Each output element adds its row's entries in CSR order
// into one accumulator by fused multiply-adds from 0 (as the one-warp-a-row
// kernel before it did), then scales by alpha and adds the diagonal term by
// one more fused multiply-add: a function of the row's entries alone, so
// every plan gives the same bits, and the bits of that earlier kernel.  The
// warps may take the rows in a host-built order (the reverse Cuthill-McKee
// order of C's graph): the rows of one block are then near one another and
// many of their gathers hit L1.  No atomics, no shared memory.  Blocks of
// 256 threads stride over the rows; the host caps the grid at the blocks
// that fit the card at once (CUDA's occupancy query,
// ltr_spmm_sym_csr_resident).  Without C the kernel is a streaming pass,
// out = d * Y, in the same vector loads.
//
// Value type: the kernel is a template on T.  float32 (the solver's
// --dtype float32) loads, multiplies and accumulates in float32, as XLA does
// on the TPU; the bytes of Y, the values and the output halve.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 8;          // entries a chunk reads at least
constexpr int kMaxInFlight = 32;   // gathered values a lane may hold at once
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

struct Args {
  const int* indptr;
  const int* indices;
  const void* vals;
  const void* Y;
  const void* d;      // the row scale, or its first factor when w is given
  const void* w;      // the row scale's second factor, or null
  const int* order;   // the rows in the order the warps take them, or null
  void* out;
  int n, r, grid;
  double alpha;
  int* resident;      // non-null: report occupancy instead of launching
};

template <typename T, int V, int G, int NV, int S>
__global__ void __launch_bounds__(kThreads)
spmm_sym_csr_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const T* __restrict__ vals, const T* __restrict__ Y,
                    const T* __restrict__ d, const T* __restrict__ w,
                    const int* __restrict__ order, T* __restrict__ out,
                    int n, int r, T alpha) {
  using P = Pack<T, V>;
  constexpr int kRows = 32 / G;                  // rows a warp
  constexpr int kPer = G < kAhead ? kAhead / G : 1;   // entries a lane
  constexpr int kChunk = G * kPer;               // entries a chunk
  // entries a step: their gathers are all in flight before its first add
  constexpr int kStep = kChunk < S ? kChunk : S;
  const int lane = threadIdx.x & 31;
  const int q = lane / G;                        // the group's row in warp
  const int lig = lane % G;                      // lane in the group
  const int src0 = q * G;                        // the group's first lane
  const int rv = r / V;                          // vectors a row
  const bool has_c = indptr != nullptr;
  const long long warps =
      static_cast<long long>(gridDim.x) * kWarps;
  for (long long wb = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
       wb * kRows < n; wb += warps) {
    const int slot = static_cast<int>(wb * kRows) + q;
    const bool live = slot < n;
    const int row = !live ? 0 : (order != nullptr ? order[slot] : slot);
    int start = 0, end = 0;
    if (has_c && live) {
      start = indptr[row];
      end = indptr[row + 1];
    }
    // the warp's longest row fixes its steps (shuffles need the whole warp)
    int longest = end - start;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      longest = max(longest, __shfl_xor_sync(kFull, longest, off));
    }
    T drow = T(0);
    if (d != nullptr && live) {
      drow = (w != nullptr) ? mul_rn(d[row], w[row]) : d[row];
    }
    const long long base = static_cast<long long>(row) * r;
    for (int v0 = 0; v0 < rv; v0 += G * NV) {
      T acc[NV][V];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[j][e] = T(0);
      }
      for (int c0 = 0; c0 < longest; c0 += kChunk) {
        const int k0 = start + c0;
        int my_idx[kPer];
        T my_val[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int k = k0 + lig + G * i;
          const bool ok = k < end;
          my_idx[i] = ok ? indices[k] : 0;
          my_val[i] = ok ? vals[k] : T(0);
        }
#pragma unroll
        for (int t0 = 0; t0 < kChunk; t0 += kStep) {
          if (c0 + t0 >= longest) break;
          P y[kStep][NV];
          T val[kStep];
#pragma unroll
          for (int u = 0; u < kStep; ++u) {
            const int t = t0 + u;
            const int idx =
                __shfl_sync(kFull, my_idx[t / G], src0 + t % G);
            val[u] = __shfl_sync(kFull, my_val[t / G], src0 + t % G);
            const bool ok = k0 + t < end;
            const P* yrow = reinterpret_cast<const P*>(
                Y + static_cast<long long>(idx) * r);
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              const int vi = v0 + lig + G * j;
              if (ok && vi < rv) {
                y[u][j] = yrow[vi];
              } else {
#pragma unroll
                for (int e = 0; e < V; ++e) y[u][j].v[e] = T(0);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kStep; ++u) {
            if (k0 + t0 + u < end) {
#pragma unroll
              for (int j = 0; j < NV; ++j) {
#pragma unroll
                for (int e = 0; e < V; ++e) {
                  acc[j][e] = fma_rn(val[u], y[u][j].v[e], acc[j][e]);
                }
              }
            }
          }
        }
      }
      if (!live) continue;
      const P* yself = reinterpret_cast<const P*>(Y + base);
      P* orow = reinterpret_cast<P*>(out + base);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int vi = v0 + lig + G * j;
        if (vi >= rv) continue;
        P o;
        if (d != nullptr) {
          const P ys = yself[vi];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            o.v[e] = has_c ? fma_rn(drow, ys.v[e], mul_rn(alpha, acc[j][e]))
                           : mul_rn(drow, ys.v[e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) o.v[e] = mul_rn(alpha, acc[j][e]);
        }
        orow[vi] = o;
      }
    }
  }
}

template <typename T, int V, int G, int NV, int S>
int launch(const Args& a, cudaStream_t s) {
  if (a.resident != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.resident, spmm_sym_csr_kernel<T, V, G, NV, S>, kThreads, 0));
  }
  const long long warps_needed =
      (static_cast<long long>(a.n) + 32 / G - 1) / (32 / G);
  long long blocks = (warps_needed + kWarps - 1) / kWarps;
  if (a.grid > 0 && blocks > a.grid) blocks = a.grid;
  spmm_sym_csr_kernel<T, V, G, NV, S><<<static_cast<int>(blocks), kThreads,
                                        0, s>>>(
      a.indptr, a.indices, static_cast<const T*>(a.vals),
      static_cast<const T*>(a.Y), static_cast<const T*>(a.d),
      static_cast<const T*>(a.w), a.order, static_cast<T*>(a.out), a.n, a.r,
      static_cast<T>(a.alpha));
  return static_cast<int>(cudaGetLastError());
}

// Instantiated: V 1 and 2 (and 4 for float32), NV 1, 2 and 4, S 2, 4 and
// 8, every G, where S NV V <= kMaxInFlight.
template <typename T>
int dispatch(int v, int g, int nv, int st, const Args& a, cudaStream_t s) {
#define K1_CASE(VV, GG, NN, SS)                                            \
  if constexpr (SS * NN * VV <= kMaxInFlight) {                            \
    if (v == VV && g == GG && nv == NN && st == SS)                        \
      return launch<T, VV, GG, NN, SS>(a, s);                              \
  }
#define K1_GROUPS(VV, NN, SS)                                              \
  K1_CASE(VV, 1, NN, SS) K1_CASE(VV, 2, NN, SS) K1_CASE(VV, 4, NN, SS)    \
  K1_CASE(VV, 8, NN, SS) K1_CASE(VV, 16, NN, SS) K1_CASE(VV, 32, NN, SS)
#define K1_STEPS(VV, NN) \
  K1_GROUPS(VV, NN, 2) K1_GROUPS(VV, NN, 4) K1_GROUPS(VV, NN, 8)
  K1_STEPS(1, 1) K1_STEPS(1, 2) K1_STEPS(1, 4)
  K1_STEPS(2, 1) K1_STEPS(2, 2) K1_STEPS(2, 4)
  if constexpr (sizeof(T) == 4) {
    K1_STEPS(4, 1) K1_STEPS(4, 2) K1_STEPS(4, 4)
  }
#undef K1_STEPS
#undef K1_GROUPS
#undef K1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int checked(int f32, int v, int g, int nv, int st, const Args& a,
            cudaStream_t s) {
  return f32 ? dispatch<float>(v, g, nv, st, a, s)
             : dispatch<double>(v, g, nv, st, a, s);
}

}  // namespace

// f32 != 0: every value array is float32, else float64.  indptr / indices
// / vals may all be null (then only the diagonal term is applied); d may be
// null (then only the sparse term); w non-null makes the row scale d * w,
// each product rounded once.  order (a permutation of the n rows, or null
// for 0 .. n-1) is the order in which the warps take the rows.  v (columns
// a vector load), g (lanes a row), nv (vectors a lane and pass) and st
// (entries a step) name the instantiation (kernels.k1_plan): v must divide
// r, and a plan with g < 32 must cover r in one pass.  grid > 0 caps the blocks, which then stride over the rows.
// Returns the cudaGetLastError() code of the launch.
extern "C" int ltr_spmm_sym_csr(int f32, const void* indptr,
                                const void* indices, const void* vals,
                                const void* order, const void* Y,
                                const void* d, const void* w, void* out,
                                int n, int r, double alpha, int v, int g,
                                int nv, int st, int grid, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  if (v < 1 || r % v != 0 || (g < 32 && r > g * nv * v) ||
      (indptr == nullptr && d == nullptr) || (w != nullptr && d == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const int*>(indptr),
               static_cast<const int*>(indices), vals, Y, d, w,
               static_cast<const int*>(order), out, n, r, grid, alpha,
               nullptr};
  return checked(f32, v, g, nv, st, a, static_cast<cudaStream_t>(stream));
}

// The blocks of the instantiation (f32, v, g, nv) that fit one SM of the
// current device at once, into *blocks.  Returns the query's cudaError.
extern "C" int ltr_spmm_sym_csr_resident(int f32, int v, int g, int nv,
                                         int st, int* blocks) {
  Args a{};
  a.resident = blocks;
  return checked(f32, v, g, nv, st, a, nullptr);
}
