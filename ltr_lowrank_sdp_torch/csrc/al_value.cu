// K15 al_value: the augmented-Lagrangian value of HALLaR's inner subproblem
// from ax = [A(YY^T), <C, YY^T>] (m + 1 values, K5 on the union layout of A
// and C), float64 or float32.  With r = ax[0:m] - b:
//
//   value = (ax[m] + <p, r>) + (beta / 2) <r, r>            (AL subproblem)
//   value = lam value_AL + 0.5 wsq                          (prox subproblem,
//                                                     wsq = ||Y - W||^2)
//   weights[0:m] = p + beta r, weights[m] = 1               (optional: K6's
//                                        weights for (C + A*(p + beta r)) Y)
//
// Replaces: ltr_lowrank_sdp_tpu/hallar/solver.py al_val_grad (:208-214, its
// value and the multiplier of its gradient) and prox_val_grad (:277-284);
// on the TPU part of the loop body's XLA fusions, in the port before it a
// subtraction, two cuBLAS dots, the scalar arithmetic and a concatenation.
//
// Design: one launch of kThreads-thread blocks over the m values
// (kernels.fused_blocks(m + 1), a function of m alone), each thread taking
// its strided entries in order; the two sums by a fixed tree a block and
// the block partials added in block order by the last block to take the
// ticket (atomicInc wraps it to 0: graph replays need no memset), which
// also forms the value.  Every operation outside the sums is the intrinsic
// of the plain version's PyTorch operation (no fused multiply-add), so only
// the sums' order parts the two.  wsq is read from the card.
//
// Bound on the card: bytes, about 3 m values read and m written.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__device__ __forceinline__ void block_sums2(T a, T b, T* sh) {
  const int t = threadIdx.x;
  sh[t] = a;
  sh[kThreads + t] = b;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (t < off) {
      sh[t] += sh[t + off];
      sh[kThreads + t] += sh[kThreads + t + off];
    }
    __syncthreads();
  }
}

template <typename T, bool PROX, bool WEIGHTS>
__global__ void __launch_bounds__(kThreads)
al_value_kernel(const T* __restrict__ ax, const T* __restrict__ b,
                const T* __restrict__ p, int m, double beta,
                double half_beta, double lam, const T* __restrict__ wsq,
                T* __restrict__ weights, T* __restrict__ value,
                T* __restrict__ part, unsigned* __restrict__ ticket) {
  __shared__ T sh[2 * kThreads];
  __shared__ bool last;
  T pr = T(0);
  T rr = T(0);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < m;
       i += gridDim.x * kThreads) {
    const T pi = p[i];
    const T r = sub_rn(ax[i], b[i]);
    pr += pi * r;
    rr += r * r;
    if (WEIGHTS) weights[i] = add_rn(pi, mul_rn(T(beta), r));
  }
  if (WEIGHTS && blockIdx.x == 0 && threadIdx.x == 0) weights[m] = T(1);
  block_sums2(pr, rr, sh);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = sh[0];
    part[gridDim.x + blockIdx.x] = sh[kThreads];
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  pr = T(0);
  rr = T(0);
  for (int k = threadIdx.x; k < static_cast<int>(gridDim.x); k += kThreads) {
    pr += __ldcg(part + k);
    rr += __ldcg(part + gridDim.x + k);
  }
  __syncthreads();
  block_sums2(pr, rr, sh);
  if (threadIdx.x == 0) {
    T v = add_rn(add_rn(ax[m], sh[0]), mul_rn(T(half_beta), sh[kThreads]));
    if (PROX) v = add_rn(mul_rn(T(lam), v), mul_rn(T(0.5), *wsq));
    *value = v;
  }
}

template <typename T, bool PROX, bool WEIGHTS>
int launch(const void* ax, const void* b, const void* p, int m, double beta,
           double half_beta, double lam, const void* wsq, void* weights,
           void* value, void* part, void* ticket, int blocks,
           cudaStream_t s) {
  al_value_kernel<T, PROX, WEIGHTS><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(ax), static_cast<const T*>(b),
      static_cast<const T*>(p), m, beta, half_beta, lam,
      static_cast<const T*>(wsq), static_cast<T*>(weights),
      static_cast<T*>(value), static_cast<T*>(part),
      static_cast<unsigned*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int prox, const void* ax, const void* b, const void* p, int m,
             double beta, double half_beta, double lam, const void* wsq,
             void* weights, void* value, void* part, void* ticket, int blocks,
             cudaStream_t s) {
  const bool w = weights != nullptr;
  if (prox) {
    return w ? launch<T, true, true>(ax, b, p, m, beta, half_beta, lam, wsq,
                                     weights, value, part, ticket, blocks, s)
             : launch<T, true, false>(ax, b, p, m, beta, half_beta, lam, wsq,
                                      weights, value, part, ticket, blocks,
                                      s);
  }
  return w ? launch<T, false, true>(ax, b, p, m, beta, half_beta, lam, wsq,
                                    weights, value, part, ticket, blocks, s)
           : launch<T, false, false>(ax, b, p, m, beta, half_beta, lam, wsq,
                                     weights, value, part, ticket, blocks, s);
}

}  // namespace

// f32 != 0: float32 values, else float64.  prox != 0: wsq (a device
// scalar) is read and the value is lam value_AL + wsq / 2.  weights: (m + 1)
// values or null.  half_beta is the host's 0.5 * beta.  part: 2 blocks
// values of scratch; ticket: one unsigned, 0 on entry and on return.
extern "C" int ltr_al_value(int f32, int prox, const void* ax, const void* b,
                            const void* p, int m, double beta,
                            double half_beta, double lam, const void* wsq,
                            void* weights, void* value, void* part,
                            void* ticket, int blocks, void* stream) {
  if (m < 0 || blocks <= 0 || (prox && wsq == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch<float>(prox, ax, b, p, m, beta, half_beta, lam, wsq,
                               weights, value, part, ticket, blocks, s)
             : dispatch<double>(prox, ax, b, p, m, beta, half_beta, lam, wsq,
                                weights, value, part, ticket, blocks, s);
}
