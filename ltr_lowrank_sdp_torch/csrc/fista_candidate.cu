// K14 fista_candidate: the candidate of one step of HALLaR's inner FISTA,
// float64 or float32.  With X = Z - gz / L (n x r, N = n r values):
//
//   (a)  scale = min(1, sqrt(tau) * (1 / max(||X||_F, 1e-30)))
//   (b)  Yc = X scale                        (the projection on the ball)
//        tn = (1 + sqrt(1 + 4 tk^2)) / 2
//        Zn = Yc + ((tk - 1) / tn) (Yc - Y)  (the extrapolated point)
//        sc = [<gz, Yc - Z>, ||Yc - Z||^2, ||Yc - Z||, ||Yc||,
//              ||Yc - W||^2, ||Zn - W||^2, tn]    (W: prox subproblem only,
//                                                  else 0, 0)
//
// Replaces: ltr_lowrank_sdp_tpu/hallar/solver.py _make_fista's body
// (:221-247: the candidate of bt_cond :226-232 and the update :239-247) with
// _Ops.project (:198-202), and the prox body of _make_aipp (:291-318).  XLA
// fuses that body into a few loops inside one lax.while_loop on the TPU; the
// port ran it as some 30 small PyTorch launches a step.
//
// Design.  Two launches, because the scale needs the whole norm before any
// Yc exists.  Each is a grid of kThreads-thread blocks over the N values
// (kernels.fused_blocks: a function of N alone), thread t of block b taking
// values b kThreads + t + k grid kThreads in order.  A sum is each thread's
// terms in that order, a fixed tree over the block's threads into one
// partial a block, and the partials added in block order by the last block
// to take the ticket (atomicInc wraps it back to 0, so a CUDA graph replays
// it; no memset): the same bits on every call.  L and tk are read from the
// card (they change between a graph's replays); the elementwise operations
// are the intrinsics of PyTorch's own operations (__d*_rn: no contraction
// into fused multiply-adds), so Yc and Zn are the plain version's bits but
// for the norm's order.  Sums are in the value type, as the reference's
// jnp.vdot and jnp.linalg.norm.
//
// Bound on the card: bytes.  (a) reads Z and gz, (b) Z, gz, Y (and W) and
// writes Yc and Zn: about 7 N values, with a few flops a value.

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
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

// The block's sums of v[s] (NS sums) by a fixed tree: thread 0 ends with
// them in sh[s * kThreads].
template <typename T, int NS>
__device__ __forceinline__ void block_sums(const T (&v)[NS], T* sh) {
  const int t = threadIdx.x;
#pragma unroll
  for (int s = 0; s < NS; ++s) sh[s * kThreads + t] = v[s];
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (t < off) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        sh[s * kThreads + t] += sh[s * kThreads + t + off];
      }
    }
    __syncthreads();
  }
}

// Writes this block's partials (part[s * gridDim.x + block]), takes the
// ticket, and in the last block to take it leaves the totals in
// sh[s * kThreads] (thread 0 reads them): the partials in block order,
// thread t adding t, t + kThreads, ..., then the fixed tree.  Returns
// whether this block is the last one.
template <typename T, int NS>
__device__ bool reduce_last(const T (&v)[NS], T* sh, T* part,
                            unsigned* ticket) {
  __shared__ bool last;
  block_sums<T, NS>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) part[s * gridDim.x + blockIdx.x] = sh[s * kThreads];
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  T w[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    w[s] = T(0);
    for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
      w[s] += __ldcg(part + s * gridDim.x + b);
    }
  }
  __syncthreads();
  block_sums<T, NS>(w, sh);
  return true;
}

template <typename T>
__device__ __forceinline__ T shifted(const T* Z, const T* gz, T L, int i) {
  return sub_rn(Z[i], div_rn(gz[i], L));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_kernel(const T* __restrict__ Z, const T* __restrict__ gz,
            const T* __restrict__ Lp, int N, double sqrt_tau,
            T* __restrict__ scale, T* __restrict__ part,
            unsigned* __restrict__ ticket) {
  __shared__ T sh[kThreads];
  const T L = *Lp;
  T v[1] = {T(0)};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < N;
       i += gridDim.x * kThreads) {
    const T x = shifted(Z, gz, L, i);
    v[0] += x * x;
  }
  if (reduce_last<T, 1>(v, sh, part, ticket) && threadIdx.x == 0) {
    const T nrm = sqrt_rn(sh[0]);
    const T s = mul_rn(div_rn(T(1), fmax(nrm, T(1e-30))), T(sqrt_tau));
    *scale = fmin(s, T(1));
  }
}

template <typename T, bool PROX>
__global__ void __launch_bounds__(kThreads)
step_kernel(const T* __restrict__ Z, const T* __restrict__ gz,
            const T* __restrict__ Y, const T* __restrict__ W,
            const T* __restrict__ Lp, const T* __restrict__ tkp,
            const T* __restrict__ scalep, int N, T* __restrict__ Yc,
            T* __restrict__ Zn, T* __restrict__ part,
            unsigned* __restrict__ ticket, T* __restrict__ sc) {
  constexpr int NS = PROX ? 5 : 3;
  __shared__ T sh[NS * kThreads];
  const T L = *Lp;
  const T tk = *tkp;
  const T s = *scalep;
  const T tn = mul_rn(
      T(0.5), add_rn(T(1), sqrt_rn(add_rn(T(1), mul_rn(mul_rn(T(4), tk), tk)))));
  const T a = div_rn(sub_rn(tk, T(1)), tn);
  T v[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) v[k] = T(0);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < N;
       i += gridDim.x * kThreads) {
    const T z = Z[i];
    const T g = gz[i];
    const T yc = mul_rn(sub_rn(z, div_rn(g, L)), s);
    const T zn = add_rn(yc, mul_rn(a, sub_rn(yc, Y[i])));
    Yc[i] = yc;
    Zn[i] = zn;
    const T d = sub_rn(yc, z);
    v[0] += g * d;
    v[1] += d * d;
    v[2] += yc * yc;
    if (PROX) {
      const T w = W[i];
      const T ey = sub_rn(yc, w);
      const T ez = sub_rn(zn, w);
      v[NS - 2] += ey * ey;
      v[NS - 1] += ez * ez;
    }
  }
  if (reduce_last<T, NS>(v, sh, part, ticket) && threadIdx.x == 0) {
    sc[0] = sh[0];
    sc[1] = sh[kThreads];
    sc[2] = sqrt_rn(sh[kThreads]);
    sc[3] = sqrt_rn(sh[2 * kThreads]);
    sc[4] = PROX ? sh[(NS - 2) * kThreads] : T(0);
    sc[5] = PROX ? sh[(NS - 1) * kThreads] : T(0);
    sc[6] = tn;
  }
}

template <typename T>
int launch(int prox, const void* Z, const void* gz, const void* Y,
           const void* W, const void* L, const void* tk, int N,
           double sqrt_tau, void* scale, void* Yc, void* Zn, void* part,
           void* ticket, void* sc, int blocks, cudaStream_t s) {
  norm_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(Z), static_cast<const T*>(gz),
      static_cast<const T*>(L), N, sqrt_tau, static_cast<T*>(scale),
      static_cast<T*>(part), static_cast<unsigned*>(ticket));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  auto k = prox ? step_kernel<T, true> : step_kernel<T, false>;
  k<<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(Z), static_cast<const T*>(gz),
      static_cast<const T*>(Y), static_cast<const T*>(W),
      static_cast<const T*>(L), static_cast<const T*>(tk),
      static_cast<const T*>(scale), N, static_cast<T*>(Yc),
      static_cast<T*>(Zn), static_cast<T*>(part),
      static_cast<unsigned*>(ticket), static_cast<T*>(sc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 != 0: every value operand is float32, else float64.  prox != 0: W is
// read and sc[4], sc[5] are its sums.  L, tk: device scalars.  scale: one
// value of scratch; part: 5 blocks values of scratch; ticket: one unsigned,
// 0 on entry and on return.  Returns the cudaGetLastError() code.
extern "C" int ltr_fista_candidate(int f32, int prox, const void* Z,
                                   const void* gz, const void* Y,
                                   const void* W, const void* L,
                                   const void* tk, int N, double sqrt_tau,
                                   void* scale, void* Yc, void* Zn,
                                   void* part, void* ticket, void* sc,
                                   int blocks, void* stream) {
  if (N <= 0 || blocks <= 0 || (prox && W == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(prox, Z, gz, Y, W, L, tk, N, sqrt_tau, scale,
                             Yc, Zn, part, ticket, sc, blocks, s)
             : launch<double>(prox, Z, gz, Y, W, L, tk, N, sqrt_tau, scale,
                              Yc, Zn, part, ticket, sc, blocks, s);
}
