// K2 diag_rowdot: o1 = (s * dv) o rowsum(U o V), and optionally
// o2 = dv o rowsum(V o V), float64 or float32.
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
// bytes / 3.35 TB/s.  At MaxCut's n = 2^14, r = 20 the 5.6 MB take 1.7 us,
// about the launch floor: what is left above it is the chain of dependent
// latencies of a row (its loads, its sum, its write).
//
// The sum order is fixed: that of a warp a row with 32 "virtual lanes",
// virtual lane l adding columns l, l + 32, ... from 0 by fused multiply-adds
// (uv = fma(U, V, uv), vv = fma(V, V, vv)), then a halving tree over the
// virtual lanes, offsets 16, 8, 4, 2, 1 (lane l adds lane l + offset).  It
// is the order of the one-warp-a-row kernel this design replaced, whose
// bits every plan keeps; kernels.diag_rowdot_order evaluates it on the
// host.
//
// Design: G lanes a row (the plan, kernels.k2_plan: 1 to 32 by r and the
// value type), so 32 / G rows share a warp.  Lane k of a group holds the J
// virtual lanes k, k + G, ..., k + (J - 1) G (J G >= min(r, 32); the
// virtual lanes past them hold no column and stay 0).  A lane issues all
// its loads of a 32-column pass before its arithmetic, forms each virtual
// lane's chain as above, adds its registers by the tree's levels at offsets
// 16 .. G (where offset o pairs its slots j and j + o / G; a slot past J is
// 0 and its addition, exact, is skipped: no chain is ever -0), and the
// group adds the last log2(G) levels by shuffles.  The grid is at most the
// blocks that fit the card at once (CUDA's occupancy query,
// ltr_diag_rowdot_resident), each taking 256 / G rows a step.  No atomics:
// the same bits on every run and from every plan.
//
// Value type: a template on T; float32 loads and accumulates in float32 (as
// XLA does on the TPU), which halves the bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T, int G, int J>
__global__ void __launch_bounds__(kThreads)
diag_rowdot_kernel(const T* __restrict__ U, const T* __restrict__ V,
                   const T* __restrict__ dv, T s, T* __restrict__ o1,
                   T* __restrict__ o2, int n, int r) {
  static_assert(J * G <= 32, "a group holds at most 32 virtual lanes");
  constexpr int kRows = kThreads / G;     // rows a block a step
  const int k = threadIdx.x % G;
  const int passes = (r + 31) / 32;
  // every thread of the block takes the same steps: the shuffles below
  // need the whole warp
  for (long long base = static_cast<long long>(blockIdx.x) * kRows; base < n;
       base += static_cast<long long>(gridDim.x) * kRows) {
    const long long row = base + threadIdx.x / G;
    const bool valid = row < n;
    const T* u = U + row * r;
    const T* v = V + row * r;
    T uv[J], vv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) uv[j] = vv[j] = T(0);
    for (int p = 0; p < passes; ++p) {
      T a[J], b[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = 32 * p + k + j * G;
        const bool in = valid && c < r;
        a[j] = in ? u[c] : T(0);
        b[j] = in ? v[c] : T(0);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (valid && 32 * p + k + j * G < r) {
          uv[j] = fma_rn(a[j], b[j], uv[j]);
          vv[j] = fma_rn(b[j], b[j], vv[j]);
        }
      }
    }
    // the tree's levels, offset o = 16, 8, 4, 2, 1: those of o >= G in
    // registers (slot j adds slot j + o / G), the last log2(G) across the
    // group
#pragma unroll
    for (int level = 0; level < 5; ++level) {
      const int o = 16 >> level;
      if (o >= G) {
#pragma unroll
        for (int j = 0; j < 16 / G; ++j) {
          if (j < o / G && j + o / G < J) {
            uv[j] = add_rn(uv[j], uv[j + o / G]);
            vv[j] = add_rn(vv[j], vv[j + o / G]);
          }
        }
      } else {
        uv[0] = add_rn(uv[0], __shfl_down_sync(kFull, uv[0], o, G));
        vv[0] = add_rn(vv[0], __shfl_down_sync(kFull, vv[0], o, G));
      }
    }
    if (valid && k == 0) {
      o1[row] = (s * dv[row]) * uv[0];
      if (o2 != nullptr) o2[row] = dv[row] * vv[0];
    }
  }
}

template <typename T, int G, int J>
int run(const void* U, const void* V, const void* dv, double s, void* o1,
        void* o2, int n, int r, int grid, void* stream, int* resident) {
  if (resident != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, diag_rowdot_kernel<T, G, J>, kThreads, 0));
  }
  diag_rowdot_kernel<T, G, J><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(U), static_cast<const T*>(V),
      static_cast<const T*>(dv), static_cast<T>(s), static_cast<T*>(o1),
      static_cast<T*>(o2), n, r);
  return static_cast<int>(cudaGetLastError());
}

// the instantiations: G lanes a row, J virtual lanes a lane (a power of
// two, at most 8 and at most 32 / G); kernels.k2_plans lists no other
template <typename T>
int dispatch(int lanes, int slots, const void* U, const void* V,
             const void* dv, double s, void* o1, void* o2, int n, int r,
             int grid, void* stream, int* resident) {
#define K2_CASE(GG, JJ)                                                    \
  if (lanes == GG && slots == JJ)                                          \
    return run<T, GG, JJ>(U, V, dv, s, o1, o2, n, r, grid, stream, resident);
  K2_CASE(1, 1) K2_CASE(1, 2) K2_CASE(1, 4) K2_CASE(1, 8)
  K2_CASE(2, 1) K2_CASE(2, 2) K2_CASE(2, 4) K2_CASE(2, 8)
  K2_CASE(4, 1) K2_CASE(4, 2) K2_CASE(4, 4) K2_CASE(4, 8)
  K2_CASE(8, 1) K2_CASE(8, 2) K2_CASE(8, 4)
  K2_CASE(16, 1) K2_CASE(16, 2)
  K2_CASE(32, 1)
#undef K2_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// f32 != 0: U, V, dv, o1, o2 are float32, else float64.  o2 may be null (no
// second output).  lanes (G) and slots (J) name the plan: J G >= min(r, 32)
// (kernels.k2_plan); grid blocks of 256 threads, 256 / G rows each a step.
// Returns cudaGetLastError().
extern "C" int ltr_diag_rowdot(int f32, const void* U, const void* V,
                               const void* dv, double s, void* o1, void* o2,
                               int n, int r, int lanes, int slots, int grid,
                               void* stream) {
  if (n <= 0) return 0;
  const int live = r < 32 ? r : 32;
  if (r < 0 || grid < 1 || lanes * slots < live) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return f32 ? dispatch<float>(lanes, slots, U, V, dv, s, o1, o2, n, r, grid,
                               stream, nullptr)
             : dispatch<double>(lanes, slots, U, V, dv, s, o1, o2, n, r, grid,
                                stream, nullptr);
}

// The blocks of plan (lanes, slots) that fit one SM of the current device
// at once, into *blocks.  Returns the CUDA error code.
extern "C" int ltr_diag_rowdot_resident(int f32, int lanes, int slots,
                                        int* blocks) {
  return f32 ? dispatch<float>(lanes, slots, nullptr, nullptr, nullptr, 0.0,
                               nullptr, nullptr, 0, 1, 1, nullptr, blocks)
             : dispatch<double>(lanes, slots, nullptr, nullptr, nullptr, 0.0,
                                nullptr, nullptr, 0, 1, 1, nullptr, blocks);
}
