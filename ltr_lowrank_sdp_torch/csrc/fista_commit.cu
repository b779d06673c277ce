// K16 fista_commit: the backtracking decision and the FISTA update of one
// step of HALLaR's inner loop, in place on the loop's state, float64 or
// float32.  From the scalars as they stood before the step (fz, L, tk, k,
// done), the candidate's sc (K14: <gz, d>, ||d||^2, ||d||, ||Yc||, -, -, tn
// with d = Yc - Z) and the values fy at Yc and fzn at Zn (K15):
//
//   ub     = (fz + <gz, d>) + (0.5 L) ||d||^2
//   grow   = fy > ub + 1e-12 and L < 1e12
//   go     = not done and k < maxiter
//   commit = go and not grow;  grow = go and grow
//   commit:  Y = Yc, Z = Zn, gz = lam2 S (+ Zn - W for a prox subproblem),
//            tk = tn, L = max(L / L_inc, L0), k = k + 1, fz = fzn,
//            done = L ||d|| <= tol (1 + ||Yc||)
//   grow:    L = L L_inc
//
// with S = (C + A*(p + beta r)) Zn (K6) and lam2 = 2 lam (2 for the AL
// subproblem), as the reference forms the gradient.
//
// Replaces: ltr_lowrank_sdp_tpu/hallar/solver.py, the backtracking test of
// _make_fista (:231-232) and the loop's state update (:239-247), as the
// port's machine step takes one of them a step (the same in the prox body
// of _make_aipp); in the port before it eight torch.where selects and the
// scalar arithmetic, some 25 launches.
//
// Design: one launch of kThreads-thread blocks over the n r values
// (kernels.fused_blocks).  Every block reads the scalars first and takes
// the same decisions; on a commit it writes its values of Y, Z and gz.
// Only the last block to take the ticket writes the scalars: every other
// block has read them by then, so no block reads a scalar another has
// replaced.  The ticket wraps to 0 (atomicInc), so a CUDA graph replays the
// launch with no memset.  Every operation is the intrinsic of the plain
// version's PyTorch operation (no fused multiply-add): the same bits as
// the plain version on the same inputs.
//
// Bound on the card: bytes; on a commit Yc, Zn, S (and W) read and Y, Z,
// gz written, about 6 n r values; on a grow nothing but the scalars.

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

template <typename T, bool PROX>
__global__ void __launch_bounds__(kThreads)
fista_commit_kernel(T* __restrict__ Y, T* __restrict__ Z, T* __restrict__ gz,
                    T* __restrict__ tkp, T* __restrict__ Lp,
                    long long* __restrict__ kp,
                    unsigned char* __restrict__ donep, T* __restrict__ fzp,
                    const T* __restrict__ Yc, const T* __restrict__ Zn,
                    const T* __restrict__ sc, const T* __restrict__ fyp,
                    const T* __restrict__ fznp, const T* __restrict__ S,
                    const T* __restrict__ W, int N, double lam2,
                    long long maxiter, double L_inc, double L0, double tol,
                    unsigned* __restrict__ ticket) {
  __shared__ bool last;
  // the scalars as they stood before the step, read by every block first
  const T L = *Lp;
  const T fz = *fzp;
  const long long k = *kp;
  const bool done = *donep != 0;
  const T ub = add_rn(add_rn(fz, sc[0]), mul_rn(mul_rn(T(0.5), L), sc[1]));
  const bool test = (*fyp > add_rn(ub, T(1e-12))) && (L < T(1e12));
  const bool go = !done && k < maxiter;
  const bool commit = go && !test;
  const bool grow = go && test;
  if (commit) {
    const T l2 = T(lam2);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < N;
         i += gridDim.x * kThreads) {
      const T zn = Zn[i];
      T g = mul_rn(l2, S[i]);
      if (PROX) g = add_rn(g, sub_rn(zn, W[i]));
      Y[i] = Yc[i];
      Z[i] = zn;
      gz[i] = g;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  if (commit) {
    const T crit = mul_rn(L, sc[2]);
    const bool stop = crit <= mul_rn(T(tol), add_rn(T(1), sc[3]));
    *Lp = fmax(div_rn(L, T(L_inc)), T(L0));
    *tkp = sc[6];
    *kp = k + 1;
    *donep = stop ? 1 : 0;
    *fzp = *fznp;
  } else if (grow) {
    *Lp = mul_rn(L, T(L_inc));
  }
}

template <typename T>
int launch(int prox, void* Y, void* Z, void* gz, void* tk, void* L, void* k,
           void* done, void* fz, const void* Yc, const void* Zn,
           const void* sc, const void* fy, const void* fzn, const void* S,
           const void* W, int N, double lam2, long long maxiter,
           double L_inc, double L0, double tol, void* ticket, int blocks,
           cudaStream_t s) {
  auto kern = prox ? fista_commit_kernel<T, true>
                   : fista_commit_kernel<T, false>;
  kern<<<blocks, kThreads, 0, s>>>(
      static_cast<T*>(Y), static_cast<T*>(Z), static_cast<T*>(gz),
      static_cast<T*>(tk), static_cast<T*>(L), static_cast<long long*>(k),
      static_cast<unsigned char*>(done), static_cast<T*>(fz),
      static_cast<const T*>(Yc), static_cast<const T*>(Zn),
      static_cast<const T*>(sc), static_cast<const T*>(fy),
      static_cast<const T*>(fzn), static_cast<const T*>(S),
      static_cast<const T*>(W), N, lam2, maxiter, L_inc, L0, tol,
      static_cast<unsigned*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 != 0: float32 values, else float64.  prox != 0: W is read.  Y, Z, gz
// (N values each) and the scalars tk, L, fz (values), k (int64), done (one
// byte, a torch.bool) are updated in place; Yc, Zn, sc (7 values), fy,
// fzn, S are read.  lam2 is the host's lam * 2.0.  ticket: one unsigned, 0
// on entry and on return.
extern "C" int ltr_fista_commit(int f32, int prox, void* Y, void* Z,
                                void* gz, void* tk, void* L, void* k,
                                void* done, void* fz, const void* Yc,
                                const void* Zn, const void* sc,
                                const void* fy, const void* fzn,
                                const void* S, const void* W, int N,
                                double lam2, long long maxiter, double L_inc,
                                double L0, double tol, void* ticket,
                                int blocks, void* stream) {
  if (N <= 0 || blocks <= 0 || (prox && W == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(prox, Y, Z, gz, tk, L, k, done, fz, Yc, Zn, sc,
                             fy, fzn, S, W, N, lam2, maxiter, L_inc, L0, tol,
                             ticket, blocks, s)
             : launch<double>(prox, Y, Z, gz, tk, L, k, done, fz, Yc, Zn,
                              sc, fy, fzn, S, W, N, lam2, maxiter, L_inc, L0,
                              tol, ticket, blocks, s);
}
