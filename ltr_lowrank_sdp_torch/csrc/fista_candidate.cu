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
// Bound on the card: neither bytes nor operations.  (a) and (b) read Z, gz,
// Y (and W) and write Yc and Zn, about 5 N values, a few flops each: at the
// path's N <= 21,000 under a microsecond of either.  The time is the chain
// of dependent latencies: the loads, the norm's reduction over every value
// before any Yc exists, the second reduction, and the launches.
//
// Two plans, picked on the host from N alone (kernels.k14_plan):
//
// The cluster plan (N up to kernels.K14_CLUSTER_MAX_N): one launch of one
// thread-block cluster of kClusterCtas CTAs (16, a non-portable cluster
// size) of kClusterThreads threads.  Thread t of CTA rank q takes the values
// g + k kClusterCtas kClusterThreads, g = q kClusterThreads + t, k < V, and
// keeps its Z, gz, Y (and W) in registers from its first load to its last
// store.
// Every sum is the thread's terms in k order from 0, a xor-shuffle tree over
// the warp, a halving tree over the CTA's warp partials (one shared-memory
// level), and the CTA partials added in rank order from 0 through
// distributed shared memory: for the norm every CTA reads every CTA's
// partial after a cluster barrier and adds them itself, so all hold the
// same bits of the scale; for the three (AL) or five (prox) sums of (b)
// every CTA stores its partials into rank 0's shared memory before a second
// barrier, and rank 0 writes sc.  No global partials, no ticket, no fence.
// Every operation, the sums' too, is an intrinsic without contraction into
// fused multiply-adds: Yc and Zn are the plain version's operations, and
// kernels.fista_candidate_order evaluates the whole call on the host bit
// for bit.
//
// The two-launch plan (above that N): (a) then (b), each a grid of
// kThreads-thread blocks over the N values (kernels.fused_blocks: a
// function of N alone), thread t of block b taking values b kThreads + t +
// k grid kThreads in order.  A sum is each thread's terms in that order, a
// fixed tree over the block's threads into one partial a block, and the
// partials added in block order by the last block to take the ticket
// (atomicInc wraps it back to 0, so a CUDA graph replays it; no memset).
//
// In both, L and tk are read from the card (they change between a graph's
// replays); the elementwise operations are the intrinsics of PyTorch's own
// operations (__d*_rn), so Yc and Zn are the plain version's bits but for
// the norm's order.  Sums are in the value type, as the reference's
// jnp.vdot and jnp.linalg.norm.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kClusterCtas = 16;
constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
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

// The sums of v[s] over the warp by a xor-shuffle tree, then over the CTA's
// warps by a halving tree: warp 0's lane 0 stores the CTA's partial of sum s
// at out + s * out_stride (local or distributed shared memory).
// warp_sh: NS kClusterWarps values of shared memory.
template <typename T, int NS>
__device__ __forceinline__ void cta_sums(T (&v)[NS], T* warp_sh, T* out,
                                         int out_stride) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v[s] = add_rn(v[s], __shfl_xor_sync(kFull, v[s], o));
    }
    if (lane == 0) warp_sh[s * kClusterWarps + warp] = v[s];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    T x = lane < kClusterWarps ? warp_sh[s * kClusterWarps + lane] : T(0);
#pragma unroll
    for (int o = kClusterWarps / 2; o > 0; o >>= 1) {
      x = add_rn(x, __shfl_xor_sync(kFull, x, o));
    }
    if (lane == 0) out[s * out_stride] = x;
  }
}

template <typename T, bool PROX, int V>
__global__ void __launch_bounds__(kClusterThreads, 1)
cluster_kernel(const T* __restrict__ Z, const T* __restrict__ gz,
               const T* __restrict__ Y, const T* __restrict__ W,
               const T* __restrict__ Lp, const T* __restrict__ tkp, int N,
               double sqrt_tau, T* __restrict__ Yc, T* __restrict__ Zn,
               T* __restrict__ sc) {
  constexpr int NS = PROX ? 5 : 3;
  constexpr int C = kClusterCtas;
  constexpr int kStride = C * kClusterThreads;
  __shared__ T warp_sh[NS][kClusterWarps];
  __shared__ T norm_part;          // this CTA's partial of ||X||^2
  __shared__ T step_part[NS][C];   // rank 0's: every CTA's partials of (b)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int first = rank * kClusterThreads + threadIdx.x;
  const T L = *Lp;
  const T tk = *tkp;
  T x[V], z[V], g[V], y[V], w[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = first + k * kStride;
    const bool in = i < N;
    z[k] = in ? Z[i] : T(0);
    g[k] = in ? gz[i] : T(0);
    y[k] = in ? Y[i] : T(0);
    w[k] = in && PROX ? W[i] : T(0);
  }
  // (a): the norm, every CTA adding the CTA partials in rank order
  T v[1] = {T(0)};
#pragma unroll
  for (int k = 0; k < V; ++k) {
    x[k] = sub_rn(z[k], div_rn(g[k], L));
    if (first + k * kStride < N) v[0] = add_rn(v[0], mul_rn(x[k], x[k]));
  }
  cta_sums<T, 1>(v, &warp_sh[0][0], &norm_part, 0);
  cluster.sync();
  T part[C];
#pragma unroll
  for (int q = 0; q < C; ++q) part[q] = *cluster.map_shared_rank(&norm_part, q);
  T ss = T(0);
#pragma unroll
  for (int q = 0; q < C; ++q) ss = add_rn(ss, part[q]);
  const T nrm = sqrt_rn(ss);
  const T scale =
      fmin(mul_rn(div_rn(T(1), fmax(nrm, T(1e-30))), T(sqrt_tau)), T(1));
  // (b): Yc, Zn and their sums, the CTA partials into rank 0's step_part
  const T tn = mul_rn(
      T(0.5), add_rn(T(1), sqrt_rn(add_rn(T(1), mul_rn(mul_rn(T(4), tk), tk)))));
  const T a = div_rn(sub_rn(tk, T(1)), tn);
  T u[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) u[s] = T(0);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = first + k * kStride;
    if (i < N) {
      const T yc = mul_rn(x[k], scale);
      const T zn = add_rn(yc, mul_rn(a, sub_rn(yc, y[k])));
      Yc[i] = yc;
      Zn[i] = zn;
      const T d = sub_rn(yc, z[k]);
      u[0] = add_rn(u[0], mul_rn(g[k], d));
      u[1] = add_rn(u[1], mul_rn(d, d));
      u[2] = add_rn(u[2], mul_rn(yc, yc));
      if (PROX) {
        const T ey = sub_rn(yc, w[k]);
        const T ez = sub_rn(zn, w[k]);
        u[NS - 2] = add_rn(u[NS - 2], mul_rn(ey, ey));
        u[NS - 1] = add_rn(u[NS - 1], mul_rn(ez, ez));
      }
    }
  }
  cta_sums<T, NS>(u, &warp_sh[0][0],
                  cluster.map_shared_rank(&step_part[0][rank], 0), C);
  cluster.sync();
  if (rank != 0 || threadIdx.x != 0) return;
  T tot[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    tot[s] = T(0);
#pragma unroll
    for (int q = 0; q < C; ++q) tot[s] = add_rn(tot[s], step_part[s][q]);
  }
  sc[0] = tot[0];
  sc[1] = tot[1];
  sc[2] = sqrt_rn(tot[1]);
  sc[3] = sqrt_rn(tot[2]);
  sc[4] = PROX ? tot[NS - 2] : T(0);
  sc[5] = PROX ? tot[NS - 1] : T(0);
  sc[6] = tn;
}

struct Args {
  int prox;
  const void *Z, *gz, *Y, *W, *L, *tk;
  int N;
  double sqrt_tau;
  void *scale, *Yc, *Zn, *part, *ticket, *sc;
  int blocks, cluster, vals;
};

template <typename T>
int launch_two(const Args& a, cudaStream_t s) {
  norm_kernel<T><<<a.blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a.Z), static_cast<const T*>(a.gz),
      static_cast<const T*>(a.L), a.N, a.sqrt_tau, static_cast<T*>(a.scale),
      static_cast<T*>(a.part), static_cast<unsigned*>(a.ticket));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  auto k = a.prox ? step_kernel<T, true> : step_kernel<T, false>;
  k<<<a.blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a.Z), static_cast<const T*>(a.gz),
      static_cast<const T*>(a.Y), static_cast<const T*>(a.W),
      static_cast<const T*>(a.L), static_cast<const T*>(a.tk),
      static_cast<const T*>(a.scale), a.N, static_cast<T*>(a.Yc),
      static_cast<T*>(a.Zn), static_cast<T*>(a.part),
      static_cast<unsigned*>(a.ticket), static_cast<T*>(a.sc));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PROX, int V>
int launch_cluster(const Args& a, cudaStream_t s) {
  auto kern = cluster_kernel<T, PROX, V>;
  // 16 CTAs is a non-portable cluster size: allowed once per device
  static bool allowed[64] = {};
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  if (dev < 64 && !allowed[dev]) {
    err = static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    if (err != 0) return err;
    allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterCtas);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(a.Z), static_cast<const T*>(a.gz),
      static_cast<const T*>(a.Y), static_cast<const T*>(a.W),
      static_cast<const T*>(a.L), static_cast<const T*>(a.tk), a.N,
      a.sqrt_tau, static_cast<T*>(a.Yc), static_cast<T*>(a.Zn),
      static_cast<T*>(a.sc)));
}

template <typename T, bool PROX>
int launch_vals(const Args& a, cudaStream_t s) {
  switch (a.vals) {
    case 1: return launch_cluster<T, PROX, 1>(a, s);
    case 2: return launch_cluster<T, PROX, 2>(a, s);
    case 4: return launch_cluster<T, PROX, 4>(a, s);
    case 8: return launch_cluster<T, PROX, 8>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const Args& a, cudaStream_t s) {
  if (a.cluster == 0) return launch_two<T>(a, s);
  if (a.cluster != kClusterCtas ||
      static_cast<long long>(a.N) >
          static_cast<long long>(kClusterCtas) * kClusterThreads * a.vals) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return a.prox ? launch_vals<T, true>(a, s) : launch_vals<T, false>(a, s);
}

}  // namespace

// f32 != 0: every value operand is float32, else float64.  prox != 0: W is
// read and sc[4], sc[5] are its sums.  L, tk: device scalars.  cluster: 0
// for the two-launch plan on `blocks` blocks, whose scratch is scale (one
// value), part (5 blocks values) and ticket (one unsigned, 0 on entry and on
// return); else the cluster plan on `cluster` = 16 CTAs of `vals` values a
// thread (1, 2, 4 or 8; N at most 16 512 vals), which takes no scratch.
// Returns the cudaGetLastError() code.
extern "C" int ltr_fista_candidate(int f32, int prox, const void* Z,
                                   const void* gz, const void* Y,
                                   const void* W, const void* L,
                                   const void* tk, int N, double sqrt_tau,
                                   void* scale, void* Yc, void* Zn,
                                   void* part, void* ticket, void* sc,
                                   int blocks, int cluster, int vals,
                                   void* stream) {
  if (N <= 0 || (cluster == 0 && blocks <= 0) || (prox && W == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{prox, Z, gz, Y, W, L, tk, N, sqrt_tau, scale, Yc, Zn,
               part, ticket, sc, blocks, cluster, vals};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(a, s) : launch<double>(a, s);
}
