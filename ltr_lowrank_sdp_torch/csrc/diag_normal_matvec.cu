// K3 diag_normal_matvec: y = x + (dv^2 o rowsum(x o F)) o F, float64 or
// float32.
//
// Replaces: the diag_identity branch of
// ltr_lowrank_sdp_tpu/ops/coneops.py ConeOps.cg_normal_matvec (:272,
// :285-292), the ADMM normal-equation operator x -> x + A*(A(sym(x F^T))) F
// (linSysProduct, lorads_admm.c:471-486) that every CG iteration applies.
//
// Bound on the card: memory.  It reads x, F and dv once and writes y once;
// four flops per 24 bytes moved, so time >= bytes / 3.35 TB/s.  At MaxCut's
// n = 2^14, r = 20 the 8.0 MB take 2.4 us in float64 (1.2 us in float32,
// below the launch floor): what is left above it is the chain of dependent
// latencies of a row (its loads, its dot, the broadcast, its write).
//
// The arithmetic is fixed: that of a warp a row with 32 "virtual lanes",
// virtual lane l adding columns l, l + 32, ... from 0 by fused multiply-adds
// (dot = fma(x, F, dot)), then a halving tree over the virtual lanes,
// offsets 16, 8, 4, 2, 1 (lane l adds lane l + offset); then coef = d (d
// dot) with d = dv[row], each product rounded, and y = fma(coef, F, x) for
// every column.  It is the arithmetic of the one-warp-a-row kernel this
// design replaced (nvcc contracted its dot += x * F and x + coef * F), whose
// bits every plan keeps; kernels.diag_normal_matvec_order evaluates it on
// the host.  The dot's order is K2's (diag_rowdot.cu) on (x, F).
//
// Design: K2's lane groups.  G lanes a row (the plan, kernels.k2_plan: 1 to
// 32 by r and the value type), so 32 / G rows share a warp.  Lane k of a
// group holds the J virtual lanes k, k + G, ..., k + (J - 1) G (J G >=
// min(r, 32); the virtual lanes past them hold no column and stay 0).  A
// lane loads dv and all its x and F values of a 32-column pass before its
// arithmetic, forms each virtual lane's chain, adds its registers by the
// tree's levels at offsets 16 .. G (offset o pairs its slots j and j + o /
// G; a slot past J is 0 and its addition, exact, is skipped: no chain is
// ever -0), and the group adds the last log2(G) levels by shuffles.  Lane 0
// of the group holds the dot; one shuffle hands it to the group, and each
// lane writes y for the columns it holds in registers: a lane keeps its
// first 16 / J passes of x and F there (one pass where r <= 32, an
// instantiation of its own), and reads a wider row's later passes again.
// The grid is at most
// the blocks that fit the card at once (CUDA's occupancy query,
// ltr_diag_normal_matvec_resident), each taking 256 / G rows a step.  No
// atomics: the same bits on every run and from every plan.
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
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

template <typename T, int G, int J, int H>
__global__ void __launch_bounds__(kThreads)
diag_normal_matvec_kernel(const T* __restrict__ x, const T* __restrict__ F,
                          const T* __restrict__ dv, T* __restrict__ y, int n,
                          int r) {
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
    const T* xr = x + row * r;
    const T* fr = F + row * r;
    const T d = valid ? dv[row] : T(0);
    // the first H passes' x and F, all loaded before any arithmetic and
    // kept for the write
    T dot[J], a[H][J], b[H][J];
#pragma unroll
    for (int p = 0; p < H; ++p) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = 32 * p + k + j * G;
        const bool in = valid && c < r;
        a[p][j] = in ? xr[c] : T(0);
        b[p][j] = in ? fr[c] : T(0);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) dot[j] = T(0);
#pragma unroll
    for (int p = 0; p < H; ++p) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (valid && 32 * p + k + j * G < r) {
          dot[j] = fma_rn(a[p][j], b[p][j], dot[j]);
        }
      }
    }
    for (int p = H; p < passes; ++p) {      // rows past 32 H columns
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = 32 * p + k + j * G;
        if (valid && c < r) dot[j] = fma_rn(xr[c], fr[c], dot[j]);
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
            dot[j] = add_rn(dot[j], dot[j + o / G]);
          }
        }
      } else {
        dot[0] = add_rn(dot[0], __shfl_down_sync(kFull, dot[0], o, G));
      }
    }
    const T coef = mul_rn(d, mul_rn(d, __shfl_sync(kFull, dot[0], 0, G)));
    if (!valid) continue;
    T* yr = y + row * r;
#pragma unroll
    for (int p = 0; p < H; ++p) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = 32 * p + k + j * G;
        if (c < r) yr[c] = fma_rn(coef, b[p][j], a[p][j]);
      }
    }
    for (int p = H; p < passes; ++p) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = 32 * p + k + j * G;
        if (c < r) yr[c] = fma_rn(coef, fr[c], xr[c]);
      }
    }
  }
}

template <typename T, int G, int J, int H>
int run(const void* x, const void* F, const void* dv, void* y, int n, int r,
        int grid, void* stream, int* resident) {
  if (resident != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, diag_normal_matvec_kernel<T, G, J, H>, kThreads, 0));
  }
  diag_normal_matvec_kernel<T, G, J, H><<<
      grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(F),
      static_cast<const T*>(dv), static_cast<T*>(y), n, r);
  return static_cast<int>(cudaGetLastError());
}

// the instantiations: G lanes a row, J virtual lanes a lane (a power of
// two, at most 8 and at most 32 / G); kernels.k2_plans lists no other.
// Each comes twice: for rows of one 32-column pass (H = 1) and for wider
// rows (wide), whose first 16 / J passes a lane keeps in registers (32
// values: 512 columns at J = 1, 64 at J = 8)
template <typename T>
int dispatch(int lanes, int slots, int wide, const void* x, const void* F,
             const void* dv, void* y, int n, int r, int grid, void* stream,
             int* resident) {
#define K3_CASE(GG, JJ)                                                    \
  if (lanes == GG && slots == JJ) {                                        \
    return wide ? run<T, GG, JJ, 16 / JJ>(x, F, dv, y, n, r, grid, stream, \
                                          resident)                        \
                : run<T, GG, JJ, 1>(x, F, dv, y, n, r, grid, stream,       \
                                    resident);                             \
  }
  K3_CASE(1, 1) K3_CASE(1, 2) K3_CASE(1, 4) K3_CASE(1, 8)
  K3_CASE(2, 1) K3_CASE(2, 2) K3_CASE(2, 4) K3_CASE(2, 8)
  K3_CASE(4, 1) K3_CASE(4, 2) K3_CASE(4, 4) K3_CASE(4, 8)
  K3_CASE(8, 1) K3_CASE(8, 2) K3_CASE(8, 4)
  K3_CASE(16, 1) K3_CASE(16, 2)
  K3_CASE(32, 1)
#undef K3_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// f32 != 0: x, F, dv, y are float32, else float64.  lanes (G) and slots (J)
// name the plan: J G >= min(r, 32) (kernels.k2_plan); grid blocks of 256
// threads, 256 / G rows each a step.  Returns cudaGetLastError().
extern "C" int ltr_diag_normal_matvec(int f32, const void* x, const void* F,
                                      const void* dv, void* y, int n, int r,
                                      int lanes, int slots, int grid,
                                      void* stream) {
  if (n <= 0 || r <= 0) return 0;
  const int live = r < 32 ? r : 32;
  if (grid < 1 || lanes * slots < live) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wide = r > 32;
  return f32 ? dispatch<float>(lanes, slots, wide, x, F, dv, y, n, r, grid,
                               stream, nullptr)
             : dispatch<double>(lanes, slots, wide, x, F, dv, y, n, r, grid,
                                stream, nullptr);
}

// The blocks of plan (lanes, slots) for rows of one pass (wide = 0) or more
// that fit one SM of the current device at once, into *blocks.  Returns the
// CUDA error code.
extern "C" int ltr_diag_normal_matvec_resident(int f32, int lanes, int slots,
                                               int wide, int* blocks) {
  return f32 ? dispatch<float>(lanes, slots, wide, nullptr, nullptr, nullptr,
                               nullptr, 0, 1, 1, nullptr, blocks)
             : dispatch<double>(lanes, slots, wide, nullptr, nullptr, nullptr,
                                nullptr, 0, 1, 1, nullptr, blocks);
}
