// K15 al_value: the augmented-Lagrangian value of HALLaR's inner subproblem
// from ax = [A(YY^T), <C, YY^T>] (m + 1 values, K5 on the union layout of A
// and C), float64 or float32, at one point or at both points of a machine
// step.  With r = ax[0:m] - b:
//
//   value = (ax[m] + <p, r>) + (beta / 2) <r, r>            (AL subproblem)
//   value = lam value_AL + 0.5 wsq                          (prox subproblem,
//                                                     wsq = ||Y - W||^2)
//   weights[0:m] = p + beta r, weights[m] = 1               (K6's weights for
//                                                  (C + A*(p + beta r)) Y)
//
// The pair takes ax at the candidate Yc and ax2 at the extrapolated point Zn
// and writes value[0] = fy (Yc's value), value[1] = fzn (Zn's) and Zn's
// weights: the four sums <p, r_Y>, <r_Y, r_Y>, <p, r_Z>, <r_Z, r_Z> from one
// read of b and p.  The single point (weights optional) serves the values
// outside the machine step.
//
// Replaces: ltr_lowrank_sdp_tpu/hallar/solver.py al_val_grad (:208-214, its
// value and the multiplier of its gradient) and prox_val_grad (:277-284);
// on the TPU part of the loop body's XLA fusions, in the port before it a
// subtraction, two cuBLAS dots, the scalar arithmetic and a concatenation.
//
// Bound on the card: bytes, the pair 4 m values read (ax, ax2, b, p) and m
// written, the single point 3 m and m.  At the path's m = 216,171 that is
// under 3 us of either, so the launch, the loads' latency and the
// cross-block sum are what a call costs.
//
// Design: one launch of kThreads-thread blocks (kernels.k15_blocks: a
// function of m and the value type alone).  The m values are cut into
// chunks of kVec (16 bytes: 2 float64, 4 float32); thread t of block q
// takes chunks g + k grid kThreads, g = q kThreads + t, in order, loaded as
// one 16-byte load each where every pointer is 16-byte aligned (else value
// by value; the order is the same).  A sum is the thread's terms in
// element order from 0, a xor-shuffle tree over the warp, a halving tree
// over the block's warp partials (one shared-memory level) into one
// partial a block, and the partials added in block order by the last block
// to take the ticket, one warp a sum (lane l adds partials l, l + 32, ...,
// then the warp's tree); that block also forms the values.  atomicInc
// wraps the ticket to 0, so a CUDA graph replays the launch with no memset.
// The pair is launched as a programmatic dependent of the kernel before it
// (K5's reduce on the machine step): b and p, which no step writes, are
// loaded before griddepcontrol.wait, the ax vectors after it, so the kernel
// before the pair must not write b or p.  The single point is launched
// plainly (its wait returns at once): its caller may have written b or p
// just before it.  Every operation,
// the sums' too, is an intrinsic without contraction into fused
// multiply-adds: the weights are the plain version's bits, and the sums
// differ from the plain version's only by their order.  wsq is read from
// the card (K14's sc).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 2;     // chunks a thread loaded before the wait
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

template <typename T> struct Vec;
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };

// chunk c of x (kVec values): one 16-byte load where the chunk is whole and
// aligned, else value by value, 0 past m
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x, int c,
                                           int m, bool vec,
                                           T (&out)[Vec<T>::n]) {
  constexpr int kVec = Vec<T>::n;
  const int i0 = c * kVec;
  if (vec && i0 + kVec <= m) {
    const typename Vec<T>::type v =
        *reinterpret_cast<const typename Vec<T>::type*>(x + i0);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = e[j];
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = i0 + j < m ? x[i0 + j] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ T warp_tree(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <typename T, bool PAIR>
struct Acc {
  static constexpr int NS = PAIR ? 4 : 2;
  T s[NS];
};

// one chunk's terms into the thread's sums (element order); weights from
// the last point
template <typename T, bool PAIR, bool WEIGHTS>
__device__ __forceinline__ void chunk_terms(
    const T (&pc)[Vec<T>::n], const T (&bc)[Vec<T>::n],
    const T* __restrict__ ax, const T* __restrict__ ax2, int c, int m,
    bool vec, T beta, T* __restrict__ weights, Acc<T, PAIR>& acc) {
  constexpr int kVec = Vec<T>::n;
  T a1[kVec], a2[kVec], wv[kVec];
  load_chunk(ax, c, m, vec, a1);
  if (PAIR) load_chunk(ax2, c, m, vec, a2);
  const int i0 = c * kVec;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (i0 + j >= m) break;
    const T r1 = sub_rn(a1[j], bc[j]);
    acc.s[0] = add_rn(acc.s[0], mul_rn(pc[j], r1));
    acc.s[1] = add_rn(acc.s[1], mul_rn(r1, r1));
    T rw = r1;
    if (PAIR) {
      const T r2 = sub_rn(a2[j], bc[j]);
      acc.s[2] = add_rn(acc.s[2], mul_rn(pc[j], r2));
      acc.s[3] = add_rn(acc.s[3], mul_rn(r2, r2));
      rw = r2;
    }
    wv[j] = add_rn(pc[j], mul_rn(beta, rw));
  }
  if (!WEIGHTS) return;
  if (vec && i0 + kVec <= m) {
    typename Vec<T>::type v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) e[j] = wv[j];
    *reinterpret_cast<typename Vec<T>::type*>(weights + i0) = v;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (i0 + j < m) weights[i0 + j] = wv[j];
    }
  }
}

template <typename T, bool PAIR, bool PROX, bool WEIGHTS>
__global__ void __launch_bounds__(kThreads)
al_value_kernel(const T* __restrict__ ax, const T* __restrict__ ax2,
                const T* __restrict__ b, const T* __restrict__ p, int m,
                int vec, double beta, double half_beta, double lam,
                const T* __restrict__ wsq, const T* __restrict__ wsq2,
                T* __restrict__ weights, T* __restrict__ value,
                T* __restrict__ part, unsigned* __restrict__ ticket) {
  using A = Acc<T, PAIR>;
  constexpr int NS = A::NS;
  constexpr int kVec = Vec<T>::n;
  static_assert(NS <= kWarps, "a warp a sum in the last block");
  __shared__ T warp_sh[NS][kWarps];
  __shared__ T tot[NS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = (m + kVec - 1) / kVec;
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  // b and p are fixed within an inner solve: loaded before the wait (a
  // no-op but for the pair, the one programmatic dependent launch)
  T pc[kChunks][kVec], bc[kChunks][kVec];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    load_chunk(p, first + k * stride, m, vec, pc[k]);
    load_chunk(b, first + k * stride, m, vec, bc[k]);
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  A acc;
#pragma unroll
  for (int s = 0; s < NS; ++s) acc.s[s] = T(0);
  const T tb = T(beta);
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = first + k * stride;
    if (c < chunks) {
      chunk_terms<T, PAIR, WEIGHTS>(pc[k], bc[k], ax, ax2, c, m, vec, tb,
                                    weights, acc);
    }
  }
  for (int c = first + kChunks * stride; c < chunks; c += stride) {
    T pr[kVec], br[kVec];
    load_chunk(p, c, m, vec, pr);
    load_chunk(b, c, m, vec, br);
    chunk_terms<T, PAIR, WEIGHTS>(pr, br, ax, ax2, c, m, vec, tb, weights,
                                  acc);
  }
  if (WEIGHTS && first == 0) weights[m] = T(1);
  // the block's partials: the warps' trees, then the warp partials' tree
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const T v = warp_tree(acc.s[s]);
    if (lane == 0) warp_sh[s][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      T x = lane < kWarps ? warp_sh[s][lane] : T(0);
#pragma unroll
      for (int o = kWarps / 2; o > 0; o >>= 1) {
        x = add_rn(x, __shfl_xor_sync(kFull, x, o));
      }
      if (lane == 0) part[s * gridDim.x + blockIdx.x] = x;
    }
    if (lane == 0) {
      __threadfence();
      last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
    }
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: warp s adds sum s's partials in block order
  if (warp < NS) {
    T x = T(0);
    for (int q = lane; q < static_cast<int>(gridDim.x); q += 32) {
      x = add_rn(x, __ldcg(part + warp * gridDim.x + q));
    }
    x = warp_tree(x);
    if (lane == 0) tot[warp] = x;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const T hb = T(half_beta);
#pragma unroll
  for (int q = 0; q < (PAIR ? 2 : 1); ++q) {
    const T* a = q == 0 ? ax : ax2;
    T v = add_rn(add_rn(a[m], tot[2 * q]), mul_rn(hb, tot[2 * q + 1]));
    if (PROX) {
      v = add_rn(mul_rn(T(lam), v), mul_rn(T(0.5), *(q == 0 ? wsq : wsq2)));
    }
    value[q] = v;
  }
}

struct Args {
  const void *ax, *ax2, *b, *p;
  int m, vec;
  double beta, half_beta, lam;
  const void *wsq, *wsq2;
  void *weights, *value, *part, *ticket;
  int blocks;
};

template <typename T, bool PAIR, bool PROX, bool WEIGHTS>
int launch(const Args& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = PAIR ? 1 : 0;    // only the pair a programmatic dependent
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, al_value_kernel<T, PAIR, PROX, WEIGHTS>,
      static_cast<const T*>(a.ax), static_cast<const T*>(a.ax2),
      static_cast<const T*>(a.b), static_cast<const T*>(a.p), a.m, a.vec,
      a.beta, a.half_beta, a.lam, static_cast<const T*>(a.wsq),
      static_cast<const T*>(a.wsq2), static_cast<T*>(a.weights),
      static_cast<T*>(a.value), static_cast<T*>(a.part),
      static_cast<unsigned*>(a.ticket)));
}

template <typename T>
int dispatch(int prox, int pair, const Args& a, cudaStream_t s) {
  if (pair) {
    return prox ? launch<T, true, true, true>(a, s)
                : launch<T, true, false, true>(a, s);
  }
  const bool w = a.weights != nullptr;
  if (prox) {
    return w ? launch<T, false, true, true>(a, s)
             : launch<T, false, true, false>(a, s);
  }
  return w ? launch<T, false, false, true>(a, s)
           : launch<T, false, false, false>(a, s);
}

bool aligned16(const void* x) {
  return (reinterpret_cast<unsigned long long>(x) & 15u) == 0;
}

}  // namespace

// f32 != 0: float32 values, else float64.  prox != 0: wsq (and for the pair
// wsq2), device scalars, are read and a value is lam value_AL + wsq / 2.
// pair != 0: ax2 (m + 1 values) is the second point, value gets two values
// and weights (required) are the second point's, launched as a
// programmatic dependent of the kernel before it on the stream, which must
// not write b or p; else value gets one and weights ((m + 1) values or
// null) are ax's, launched plainly.  half_beta is the host's 0.5 *
// beta.  part: 4 blocks values of scratch (2 blocks for one point); ticket:
// one unsigned, 0 on entry and on return.  Returns the launch's error code.
extern "C" int ltr_al_value(int f32, int prox, int pair, const void* ax,
                            const void* ax2, const void* b, const void* p,
                            int m, double beta, double half_beta, double lam,
                            const void* wsq, const void* wsq2, void* weights,
                            void* value, void* part, void* ticket, int blocks,
                            void* stream) {
  if (m < 0 || blocks <= 0 || (prox && wsq == nullptr) ||
      (pair && (ax2 == nullptr || weights == nullptr ||
                (prox && wsq2 == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = aligned16(ax) && aligned16(b) && aligned16(p) &&
                   (!pair || aligned16(ax2)) &&
                   (weights == nullptr || aligned16(weights));
  const Args a{ax, ax2, b, p, m, vec ? 1 : 0, beta, half_beta, lam, wsq,
               wsq2, weights, value, part, ticket, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch<float>(prox, pair, a, s)
             : dispatch<double>(prox, pair, a, s);
}
