// K11 gatv2_softmax_agg_bwd: the backward pass of K9 (gatv2_softmax_agg.cu),
// float32.  Given dout (n, H C), the gradient of K9's output, it returns the
// gradients of K9's five inputs.  Per slot e = j -> i of the destination CSR
// (self-loops included) and head h, with msg = w_src[j] + w_dst[i] + we[e]:
//
//   alpha_e  = exp(s_e - lse[i,h])                  (recomputed from K9's lse)
//   dalpha_e = keep[e,h] * <dout[i,h,:], w_src[j,h,:]>
//   D_i      = <dout[i,h,:], out[i,h,:]>  (= sum_e alpha_e dalpha_e, keep or not)
//   ds_e     = alpha_e * (dalpha_e - D_i)
//   dmsg_e   = ds_e * att[h,:] * leaky'(msg_e)       (leaky' = 1 where msg >= 0)
//
//   d_w_dst[i]  = sum_e dmsg_e                  d_we[e]  = dmsg_e (a real edge)
//   d_w_src[j]  = sum_{e: src e = j} alpha_e keep[e,h] dout[i] + dmsg_e
//   d_we_loop   = sum over the self-loop slots of dmsg_e
//   d_att[h,:]  = sum_e ds_e * leaky(msg_e)
//
// Replaces: the VJP that jax.value_and_grad (train.py:250) takes of
// ltr_lowrank_sdp_tpu/models/gatv2.py segment_softmax (:26-33) and the
// gather / segment_sum aggregation of GATv2Conv.__call__ (:64-96): the
// transposes of its gathers (segment sums over sources and destinations) and
// of its segment sums (gathers), over four materialised (E, H, C) tensors.
//
// Bound on the card: memory.  It must read the inputs of K9 once (the edge
// terms `we`, E rows of 4 H C bytes, are the bulk), lse, out and dout, and
// write d_we (E rows of 4 H C bytes), d_w_src and d_w_dst: about 40 flops
// per edge row element, far below the FP32 ridge point.
//
// Precision: the per-slot arithmetic runs in float64 on the float32 inputs.
// d_w_dst, d_we_loop and d_att are sums of ds_e terms that cancel (sum_e
// ds_e = 0 over a destination's slots): in float32, rounding ds_e to 1e-7 of
// dalpha or D leaves 1e-4 of such a result, and where every slot's msg has
// one sign the exact result is 0.  In float64 the kernel gives the float64
// evaluation of its inputs to float32 output rounding; the device is bound by
// bytes here, not by its FP64 rate.
//
// Design: three launches, no atomics, the same bits on every call.
//  1. One warp per destination (a fixed grid walks them with a stride), with
//     K9's lane layout: lph lanes per head, P channels per lane (a template
//     from 1 to 8, H C <= 256), the head dots reduced by xor shuffles within
//     the head's lanes.  It recomputes the scores, alpha and dmsg of each
//     slot; d_w_dst[i] and the rows d_we[e] are owned by the warp and written
//     once.  The source-side term of each slot goes to buf (E', H C) in slot
//     order.  d_att and d_we_loop are summed per lane and combined over the
//     block's warps in warp order, through a float64 shared array of
//     8 x 2 x 32 P values (32 KiB at P = 8, under the 48 KiB of static shared
//     memory), into one partial per block.
//  2. One warp per source node walks a CSR over sources (src_ptr, src_slot:
//     the slots of each source in increasing slot order) and sums its buf
//     rows in that order into d_w_src, lanes striding over the H C channels.
//  3. One block of 2 H C threads sums the block partials in block order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double leaky(double v, double slope) {
  return v >= 0.0 ? v : slope * v;
}

__device__ __forceinline__ double head_sum(double v, int lph) {
  for (int off = lph >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

template <int P>
__global__ void gatv2_bwd_dst_kernel(
    const int* __restrict__ indptr, const int* __restrict__ src,
    const int* __restrict__ erow, const float* __restrict__ w_src,
    const float* __restrict__ w_dst, const float* __restrict__ we,
    const float* __restrict__ we_loop, const float* __restrict__ att,
    const float* __restrict__ keep, const float* __restrict__ lse,
    const float* __restrict__ out, const float* __restrict__ dout, int n,
    int n_real, int heads, int ch, int lph, double slope,
    float* __restrict__ d_w_dst, float* __restrict__ d_we,
    float* __restrict__ buf, double* __restrict__ part) {
  constexpr int kRowMax = 32 * P;          // the widest row of this P
  static_assert(kWarpsPerBlock * 2 * kRowMax * sizeof(double) <= 48 * 1024,
                "static shared memory of a block");
  __shared__ double sm[kWarpsPerBlock][2 * kRowMax];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hc = heads * ch;
  const int head = lane / lph;
  const int q = (lane % lph) * P;
  const bool live = head < heads;
  const int c0 = head * ch + q;
  const int cnt = live ? max(0, min(P, ch - q)) : 0;
  double a[P], elv[P], datt[P], dloop[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool ok = p < cnt;
    a[p] = ok ? att[c0 + p] : 0.0;
    elv[p] = ok ? we_loop[c0 + p] : 0.0;
    datt[p] = 0.0;
    dloop[p] = 0.0;
  }
  const long long stride =
      static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long i =
           static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
       i < n; i += stride) {
    double xd[P], g[P], acc[P];
    double go_o = 0.0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool ok = p < cnt;
      xd[p] = ok ? w_dst[i * hc + c0 + p] : 0.0;
      g[p] = ok ? dout[i * hc + c0 + p] : 0.0;
      go_o += g[p] * (ok ? out[i * hc + c0 + p] : 0.f);
      acc[p] = 0.0;
    }
    const double dd = head_sum(go_o, lph);
    const double ls = live ? lse[i * heads + head] : 0.0;
    const int beg = indptr[i];
    const int end = indptr[i + 1];
    for (int base = beg; base < end; base += 32) {
      const int cnt_e = min(32, end - base);
      int my_src = 0;
      int my_row = 0;
      if (lane < cnt_e) {
        my_src = src[base + lane];
        my_row = erow[base + lane];
      }
      for (int k = 0; k < cnt_e; ++k) {
        const int j = __shfl_sync(kFull, my_src, k);
        const int r = __shfl_sync(kFull, my_row, k);
        const long long e = base + k;
        const float* xs_row = w_src + static_cast<long long>(j) * hc + c0;
        const float* ev_row = we + static_cast<long long>(r) * hc + c0;
        double xs[P], msg[P], lk[P];
        double s = 0.0;
        double gx = 0.0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const bool ok = p < cnt;
          xs[p] = ok ? xs_row[p] : 0.f;
          const double ev = ok ? (r < n_real ? ev_row[p] : elv[p]) : 0.0;
          msg[p] = xs[p] + xd[p] + ev;
          lk[p] = leaky(msg[p], slope);
          s += a[p] * lk[p];
          gx += g[p] * xs[p];
        }
        s = head_sum(s, lph);
        const double alpha = exp(s - ls);
        const double kp = keep && live ? keep[e * heads + head] : 1.0;
        const double da = kp * head_sum(gx, lph);
        const double ds = alpha * (da - dd);
        const double ak = alpha * kp;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (p < cnt) {
            const double t = ds * a[p] * (msg[p] >= 0.0 ? 1.0 : slope);
            datt[p] += ds * lk[p];
            acc[p] += t;
            if (r < n_real) {
              d_we[static_cast<long long>(r) * hc + c0 + p] =
                  static_cast<float>(t);
            } else {
              dloop[p] += t;
            }
            buf[e * hc + c0 + p] = static_cast<float>(ak * g[p] + t);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p < cnt) d_w_dst[i * hc + c0 + p] = static_cast<float>(acc[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p < cnt) {
      sm[warp][c0 + p] = datt[p];
      sm[warp][hc + c0 + p] = dloop[p];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * hc; c += blockDim.x) {
    double t = 0.0;
    for (int w = 0; w < kWarpsPerBlock; ++w) t += sm[w][c];
    part[static_cast<long long>(blockIdx.x) * 2 * hc + c] = t;
  }
}

template <int P>
__global__ void gatv2_bwd_src_kernel(const int* __restrict__ src_ptr,
                                     const int* __restrict__ src_slot,
                                     const float* __restrict__ buf, int n,
                                     int hc, float* __restrict__ d_w_src) {
  const int lane = threadIdx.x & 31;
  const long long j =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= n) return;
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  const int beg = src_ptr[j];
  const int end = src_ptr[j + 1];
  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);
    const int my_slot = lane < cnt ? src_slot[base + lane] : 0;
    for (int k = 0; k < cnt; ++k) {
      const long long e = __shfl_sync(kFull, my_slot, k);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int c = lane + 32 * p;
        if (c < hc) acc[p] += buf[e * hc + c];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = lane + 32 * p;
    if (c < hc) d_w_src[j * hc + c] = acc[p];
  }
}

__global__ void gatv2_bwd_partials_kernel(const double* __restrict__ part,
                                          int n_parts, int hc,
                                          float* __restrict__ d_att,
                                          float* __restrict__ d_we_loop) {
  const int c = threadIdx.x;   // 0 .. 2 * hc - 1
  if (c >= 2 * hc) return;
  double t = 0.0;
  for (int b = 0; b < n_parts; ++b) t += part[b * 2 * hc + c];
  if (c < hc) {
    d_att[c] = static_cast<float>(t);
  } else {
    d_we_loop[c - hc] = static_cast<float>(t);
  }
}

template <int P>
int launch(const void* indptr, const void* src, const void* erow,
           const void* src_ptr, const void* src_slot, const void* w_src,
           const void* w_dst, const void* we, const void* we_loop,
           const void* att, const void* keep, const void* lse,
           const void* out, const void* dout, int n, int n_real, int heads,
           int ch, int lph, float slope, void* d_w_src, void* d_w_dst,
           void* d_we, void* d_we_loop, void* d_att, void* buf, void* part,
           cudaStream_t s) {
  const int hc = heads * ch;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int n_parts = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  if (n > 0) {
    gatv2_bwd_dst_kernel<P><<<n_parts, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(src),
        static_cast<const int*>(erow), static_cast<const float*>(w_src),
        static_cast<const float*>(w_dst), static_cast<const float*>(we),
        static_cast<const float*>(we_loop), static_cast<const float*>(att),
        static_cast<const float*>(keep), static_cast<const float*>(lse),
        static_cast<const float*>(out), static_cast<const float*>(dout), n,
        n_real, heads, ch, lph, static_cast<double>(slope),
        static_cast<float*>(d_w_dst), static_cast<float*>(d_we),
        static_cast<float*>(buf), static_cast<double*>(part));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // H C <= 32 P, so P channels per lane also cover a row here
    gatv2_bwd_src_kernel<P>
        <<<(n + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarpsPerBlock * 32, 0,
           s>>>(static_cast<const int*>(src_ptr),
                static_cast<const int*>(src_slot),
                static_cast<const float*>(buf), n, hc,
                static_cast<float*>(d_w_src));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gatv2_bwd_partials_kernel<<<1, 2 * hc, 0, s>>>(
      static_cast<const double*>(part), n > 0 ? n_parts : 0, hc,
      static_cast<float*>(d_att), static_cast<float*>(d_we_loop));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// indptr (n+1), src / erow (E'): K9's destination CSR; src_ptr (n+1) /
// src_slot (E'): the same slots as a CSR over sources; w_src, w_dst (n, H C),
// we (n_real, H C), we_loop (H C), att (H, C), keep (E', H) or null, lse
// (n, H), out and dout (n, H C) float32.  Outputs: d_w_src, d_w_dst (n, H C),
// d_we (n_real, H C), d_we_loop (H C), d_att (H, C) float32; scratch buf
// (E', H C) float32 and part (kMaxBlocks, 2 H C) float64.  heads and channels
// as K9 takes them (ltr_gatv2_softmax_agg); the wrapper checks shapes.
// Returns the cudaGetLastError() code of the launches.
extern "C" int ltr_gatv2_softmax_agg_bwd(
    const void* indptr, const void* src, const void* erow,
    const void* src_ptr, const void* src_slot, const void* w_src,
    const void* w_dst, const void* we, const void* we_loop, const void* att,
    const void* keep, const void* lse, const void* out, const void* dout,
    int n, int n_real, int heads, int channels, float slope, void* d_w_src,
    void* d_w_dst, void* d_we, void* d_we_loop, void* d_att, void* buf,
    void* part, void* stream) {
  int hp = 1;
  while (hp < heads) hp <<= 1;
  if (heads < 1 || hp > 32 || channels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lph = 32 / hp;
  const int per_lane = (channels + lph - 1) / lph;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LTR_K11_CASE(P)                                                       \
  case P:                                                                     \
    return launch<P>(indptr, src, erow, src_ptr, src_slot, w_src, w_dst, we, \
                     we_loop, att, keep, lse, out, dout, n, n_real, heads,   \
                     channels, lph, slope, d_w_src, d_w_dst, d_we, d_we_loop, \
                     d_att, buf, part, s);
  switch (per_lane) {
    LTR_K11_CASE(1)
    LTR_K11_CASE(2)
    LTR_K11_CASE(3)
    LTR_K11_CASE(4)
    LTR_K11_CASE(5)
    LTR_K11_CASE(6)
    LTR_K11_CASE(7)
    LTR_K11_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LTR_K11_CASE
}
