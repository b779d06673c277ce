// K11 gatv2_softmax_agg_bwd: the backward pass of K9 (gatv2_softmax_agg.cu),
// float32.  Given dout (n, 64), the gradient of K9's output, it returns the
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
// terms `we`, E rows of 256 bytes, are the bulk), lse, out and dout, and
// write d_we (E rows of 256 bytes), d_w_src and d_w_dst: about 40 flops per
// 256-byte edge row, far below the FP32 ridge point.
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
//  1. One warp per destination (a fixed grid walks them with a stride), two
//     channels per lane as in K9.  It recomputes the scores, alpha and dmsg
//     of each slot; d_w_dst[i] and the rows d_we[e] are owned by the warp and
//     written once.  The source-side term of each slot goes to buf (E', 64)
//     in slot order.  d_att and d_we_loop are summed per lane and combined
//     over the block's warps in warp order into one partial per block.
//  2. One warp per source node walks a CSR over sources (src_ptr, src_slot:
//     the slots of each source in increasing slot order) and sums its buf
//     rows in that order into d_w_src.
//  3. One block sums the block partials in block order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChannels = 64;   // H * C: two channels per lane
constexpr int kMaxBlocks = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double leaky(double v, double slope) {
  return v >= 0.0 ? v : slope * v;
}

__device__ __forceinline__ double head_sum(double v, int lanes_per_head) {
  for (int off = lanes_per_head >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

__global__ void gatv2_bwd_dst_kernel(
    const int* __restrict__ indptr, const int* __restrict__ src,
    const int* __restrict__ erow, const float2* __restrict__ w_src,
    const float2* __restrict__ w_dst, const float2* __restrict__ we,
    const float2* __restrict__ we_loop, const float2* __restrict__ att,
    const float* __restrict__ keep, const float* __restrict__ lse,
    const float2* __restrict__ out, const float2* __restrict__ dout, int n,
    int n_real, int lanes_per_head, double slope,
    float2* __restrict__ d_w_dst, float2* __restrict__ d_we,
    float2* __restrict__ buf, double* __restrict__ part) {
  constexpr int kRow = kChannels / 2;   // float2 per row
  __shared__ double sm[kWarpsPerBlock][2 * kChannels];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int heads = 32 / lanes_per_head;
  const int head = lane / lanes_per_head;
  const float2 af = att[lane];
  const float2 elf = we_loop[lane];
  const double a0 = af.x, a1 = af.y;
  double datt0 = 0.0, datt1 = 0.0, dloop0 = 0.0, dloop1 = 0.0;
  const long long stride =
      static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long i =
           static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
       i < n; i += stride) {
    const float2 xd = w_dst[i * kRow + lane];
    const float2 go = dout[i * kRow + lane];
    const float2 o = out[i * kRow + lane];
    const double g0 = go.x, g1 = go.y;
    const double dd = head_sum(g0 * o.x + g1 * o.y, lanes_per_head);
    const double ls = lse[i * heads + head];
    double acc0 = 0.0, acc1 = 0.0;
    const int beg = indptr[i];
    const int end = indptr[i + 1];
    for (int base = beg; base < end; base += 32) {
      const int cnt = min(32, end - base);
      int my_src = 0;
      int my_row = 0;
      if (lane < cnt) {
        my_src = src[base + lane];
        my_row = erow[base + lane];
      }
      for (int k = 0; k < cnt; ++k) {
        const int j = __shfl_sync(kFull, my_src, k);
        const int r = __shfl_sync(kFull, my_row, k);
        const long long e = base + k;
        const float2 xs = w_src[static_cast<long long>(j) * kRow + lane];
        const float2 ev =
            r < n_real ? we[static_cast<long long>(r) * kRow + lane] : elf;
        const double m0 = static_cast<double>(xs.x) + xd.x + ev.x;
        const double m1 = static_cast<double>(xs.y) + xd.y + ev.y;
        const double l0 = leaky(m0, slope);
        const double l1 = leaky(m1, slope);
        const double s = head_sum(a0 * l0 + a1 * l1, lanes_per_head);
        const double alpha = exp(s - ls);
        const double kp = keep ? keep[e * heads + head] : 1.0;
        const double da =
            kp * head_sum(g0 * xs.x + g1 * xs.y, lanes_per_head);
        const double ds = alpha * (da - dd);
        const double t0 = ds * a0 * (m0 >= 0.0 ? 1.0 : slope);
        const double t1 = ds * a1 * (m1 >= 0.0 ? 1.0 : slope);
        datt0 += ds * l0;
        datt1 += ds * l1;
        acc0 += t0;
        acc1 += t1;
        if (r < n_real) {
          d_we[static_cast<long long>(r) * kRow + lane] =
              make_float2(static_cast<float>(t0), static_cast<float>(t1));
        } else {
          dloop0 += t0;
          dloop1 += t1;
        }
        const double ak = alpha * kp;
        buf[e * kRow + lane] = make_float2(static_cast<float>(ak * g0 + t0),
                                           static_cast<float>(ak * g1 + t1));
      }
    }
    d_w_dst[i * kRow + lane] =
        make_float2(static_cast<float>(acc0), static_cast<float>(acc1));
  }
  sm[warp][2 * lane] = datt0;
  sm[warp][2 * lane + 1] = datt1;
  sm[warp][kChannels + 2 * lane] = dloop0;
  sm[warp][kChannels + 2 * lane + 1] = dloop1;
  __syncthreads();
  if (threadIdx.x < 2 * kChannels) {
    double t = 0.0;
    for (int w = 0; w < kWarpsPerBlock; ++w) t += sm[w][threadIdx.x];
    part[static_cast<long long>(blockIdx.x) * 2 * kChannels + threadIdx.x] = t;
  }
}

__global__ void gatv2_bwd_src_kernel(const int* __restrict__ src_ptr,
                                     const int* __restrict__ src_slot,
                                     const float2* __restrict__ buf, int n,
                                     float2* __restrict__ d_w_src) {
  constexpr int kRow = kChannels / 2;
  const int lane = threadIdx.x & 31;
  const long long j =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= n) return;
  float acc0 = 0.f, acc1 = 0.f;
  const int beg = src_ptr[j];
  const int end = src_ptr[j + 1];
  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);
    const int my_slot = lane < cnt ? src_slot[base + lane] : 0;
    for (int k = 0; k < cnt; ++k) {
      const long long e = __shfl_sync(kFull, my_slot, k);
      const float2 v = buf[e * kRow + lane];
      acc0 += v.x;
      acc1 += v.y;
    }
  }
  d_w_src[j * kRow + lane] = make_float2(acc0, acc1);
}

__global__ void gatv2_bwd_partials_kernel(const double* __restrict__ part,
                                          int n_parts,
                                          float* __restrict__ d_att,
                                          float* __restrict__ d_we_loop) {
  const int c = threadIdx.x;   // 0 .. 2 * kChannels - 1
  double t = 0.0;
  for (int b = 0; b < n_parts; ++b) t += part[b * 2 * kChannels + c];
  if (c < kChannels) {
    d_att[c] = static_cast<float>(t);
  } else {
    d_we_loop[c - kChannels] = static_cast<float>(t);
  }
}

}  // namespace

// indptr (n+1), src / erow (E'): K9's destination CSR; src_ptr (n+1) /
// src_slot (E'): the same slots as a CSR over sources; w_src, w_dst (n, 64),
// we (n_real, 64), we_loop (64), att (H, C), keep (E', H) or null, lse (n, H),
// out and dout (n, 64) float32.  Outputs: d_w_src, d_w_dst (n, 64), d_we
// (n_real, 64), d_we_loop (64), d_att (H, C) float32; scratch buf (E', 64)
// float32 and part (kMaxBlocks, 128) float64.  heads * channels must be 64 and
// channels an even power of two; the wrapper checks shapes.  Returns the
// cudaGetLastError() code of the launches.
extern "C" int ltr_gatv2_softmax_agg_bwd(
    const void* indptr, const void* src, const void* erow,
    const void* src_ptr, const void* src_slot, const void* w_src,
    const void* w_dst, const void* we, const void* we_loop, const void* att,
    const void* keep, const void* lse, const void* out, const void* dout,
    int n, int n_real, int channels, float slope, void* d_w_src,
    void* d_w_dst, void* d_we, void* d_we_loop, void* d_att, void* buf,
    void* part, void* stream) {
  if (channels < 2 || channels > kChannels || (channels & (channels - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int n_parts = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  if (n > 0) {
    gatv2_bwd_dst_kernel<<<n_parts, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(src),
        static_cast<const int*>(erow), static_cast<const float2*>(w_src),
        static_cast<const float2*>(w_dst), static_cast<const float2*>(we),
        static_cast<const float2*>(we_loop), static_cast<const float2*>(att),
        static_cast<const float*>(keep), static_cast<const float*>(lse),
        static_cast<const float2*>(out), static_cast<const float2*>(dout), n,
        n_real, channels / 2, static_cast<double>(slope),
        static_cast<float2*>(d_w_dst),
        static_cast<float2*>(d_we), static_cast<float2*>(buf),
        static_cast<double*>(part));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gatv2_bwd_src_kernel<<<(n + kWarpsPerBlock - 1) / kWarpsPerBlock,
                           kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int*>(src_ptr), static_cast<const int*>(src_slot),
        static_cast<const float2*>(buf), n, static_cast<float2*>(d_w_src));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gatv2_bwd_partials_kernel<<<1, 2 * kChannels, 0, s>>>(
      static_cast<const double*>(part), n > 0 ? n_parts : 0,
      static_cast<float*>(d_att), static_cast<float*>(d_we_loop));
  return static_cast<int>(cudaGetLastError());
}
