// K9 gatv2_softmax_agg: the attention and aggregation of one GATv2 layer,
// float32.  For every destination node i and head h, over the edges e = j -> i
// of i (self-loops included):
//
//   s_e      = sum_c att[h,c] * leaky_0.2(w_src[j,h,c] + w_dst[i,h,c] + we[e,h,c])
//   alpha_e  = exp(s_e - max_e' s_e') / (sum_e' exp(s_e' - max_e' s_e') + 1e-16)
//   out[i,h,:] = sum_e alpha_e * keep[e,h] * w_src[j,h,:]
//
// keep (E', H), optional, is the dropout keep-scale of training (0 or
// 1 / (1 - p) per slot and head, in the CSR's slot order); without it every
// keep is 1.  lse (n, H), optional, receives max_e s_e + log(sum_e exp(s_e -
// max) + 1e-16), so that alpha_e = exp(s_e - lse): the backward kernel K11
// (gatv2_softmax_agg_bwd.cu) recomputes alpha from it.  The serve path passes
// neither.
//
// The edges come as a CSR over destinations: the edges of node i are
// indptr[i] .. indptr[i+1] of (src, erow), in the order of the edge list with
// the self-loops appended.  erow < n_real is the row of the edge's own term in
// `we`; erow = n_real names the one row shared by every self-loop (`we_loop`,
// the projection of the mean edge feature), which is passed once and never
// copied per node.
//
// Replaces: ltr_lowrank_sdp_tpu/models/gatv2.py GATv2Conv.__call__ (:64-96):
// the per-edge gathers w_src[src] + w_dst[dst] (+ lin_edge), the LeakyReLU and
// the att dot, segment_softmax (:26-33, a segment max, an exp, a segment sum
// and a gather back) and the segment_sum aggregation (:94-96).  The TPU
// version materialises four (E, H, C) tensors and two sorted segment
// reductions; here every edge is read once and nothing per edge is written.
//
// Bound on the card: memory.  It must read the w_src rows it gathers (at most
// N rows of 4 H C bytes, reused through L2), w_dst, the edge terms `we` (E
// rows of 4 H C bytes: 635 MB on the largest dataset graph at H C = 64, the
// bulk of the traffic), the CSR and write out: about 12 flops per edge row
// element, far below the FP32 ridge point.
//
// Design: one warp per destination node.  The H heads of a row split the
// warp's lanes into groups of lph = 32 / (H rounded up to a power of two)
// lanes; lane q of head h holds channels q*P .. q*P + P - 1 of the head (those
// below C), P = ceil(C / lph) a template from 1 to 8, so H * C <= 256 (lanes
// past the last head idle).  Each lane forms its part of the att dot, and
// xor shuffles within the head's power-of-two lane group add the parts, for
// any C (12, 20 or 24 channels as well as 64).  The lanes load 32 (src, erow)
// pairs at a time and broadcast them by shuffles.  The softmax is an online
// (running-max) softmax in one pass over the edges: the accumulators are
// rescaled whenever the running max grows.  No atomics: the same bits on
// every call.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// kTrain compiles the keep-scale and the lse output in; the serve path's
// instance has neither, so it keeps its registers and its speed.
template <int P, bool kTrain>
__global__ void gatv2_softmax_agg_kernel(
    const int* __restrict__ indptr, const int* __restrict__ src,
    const int* __restrict__ erow, const float* __restrict__ w_src,
    const float* __restrict__ w_dst, const float* __restrict__ we,
    const float* __restrict__ we_loop, const float* __restrict__ att,
    const float* __restrict__ keep, int n, int n_real, int heads, int ch,
    int lph, float slope, float* __restrict__ out, float* __restrict__ lse) {
  const int lane = threadIdx.x & 31;
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const int hc = heads * ch;
  const int head = lane / lph;
  const int q = (lane % lph) * P;          // first channel within the head
  const bool live = head < heads;
  const int c0 = head * ch + q;             // first channel within the row
  const int cnt = live ? max(0, min(P, ch - q)) : 0;
  float xd[P], a[P], el[P], acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool ok = p < cnt;
    xd[p] = ok ? w_dst[i * hc + c0 + p] : 0.f;
    a[p] = ok ? att[c0 + p] : 0.f;
    el[p] = ok ? we_loop[c0 + p] : 0.f;
    acc[p] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
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
      const float* xs_row = w_src + static_cast<long long>(j) * hc + c0;
      const float* ev_row = we + static_cast<long long>(r) * hc + c0;
      float xs[P];
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const bool ok = p < cnt;
        xs[p] = ok ? xs_row[p] : 0.f;
        const float ev = ok ? (r < n_real ? ev_row[p] : el[p]) : 0.f;
        s += a[p] * leaky(xs[p] + xd[p] + ev, slope);
      }
      for (int off = lph >> 1; off > 0; off >>= 1) {
        s += __shfl_xor_sync(kFull, s, off);
      }
      const float m_new = fmaxf(m, s);
      // a segment whose scores are all -inf adds 0, as the reference's
      // isfinite guard on the segment max does
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float scale = expf(m - mu);
      const float pe = expf(s - mu);
      const float pk =
          kTrain && keep && live
              ? pe * keep[static_cast<long long>(base + k) * heads + head]
              : pe;
      l = l * scale + pe;
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = acc[p] * scale + pk * xs[p];
      m = m_new;
    }
  }
  const float inv = 1.f / (l + 1e-16f);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p < cnt) out[i * hc + c0 + p] = acc[p] * inv;
  }
  if (kTrain && lse && live && q == 0) {
    lse[i * heads + head] = (m == -INFINITY ? 0.f : m) + logf(l + 1e-16f);
  }
}

template <int P>
int launch(const void* indptr, const void* src, const void* erow,
           const void* w_src, const void* w_dst, const void* we,
           const void* we_loop, const void* att, const void* keep, int n,
           int n_real, int heads, int ch, int lph, float slope, void* out,
           void* lse, cudaStream_t s) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  auto kernel = keep || lse ? gatv2_softmax_agg_kernel<P, true>
                            : gatv2_softmax_agg_kernel<P, false>;
  kernel<<<grid, block, 0, s>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(src),
      static_cast<const int*>(erow), static_cast<const float*>(w_src),
      static_cast<const float*>(w_dst), static_cast<const float*>(we),
      static_cast<const float*>(we_loop), static_cast<const float*>(att),
      static_cast<const float*>(keep), n, n_real, heads, ch, lph, slope,
      static_cast<float*>(out), static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// heads in 1 .. 32 and channels per head with ceil(channels / lph) <= 8,
// lph = 32 / (heads rounded up to a power of two): heads * channels <= 256
// for a power-of-two head count.  The wrapper checks shapes.  keep and lse
// may be null.  Returns the cudaGetLastError() code of the launch.
extern "C" int ltr_gatv2_softmax_agg(const void* indptr, const void* src,
                                     const void* erow, const void* w_src,
                                     const void* w_dst, const void* we,
                                     const void* we_loop, const void* att,
                                     const void* keep, int n, int n_real,
                                     int heads, int channels, float slope,
                                     void* out, void* lse, void* stream) {
  if (n <= 0) return 0;
  int hp = 1;
  while (hp < heads) hp <<= 1;
  if (heads < 1 || hp > 32 || channels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lph = 32 / hp;
  const int per_lane = (channels + lph - 1) / lph;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LTR_K9_CASE(P)                                                       \
  case P:                                                                    \
    return launch<P>(indptr, src, erow, w_src, w_dst, we, we_loop, att,     \
                     keep, n, n_real, heads, channels, lph, slope, out, lse, \
                     s);
  switch (per_lane) {
    LTR_K9_CASE(1)
    LTR_K9_CASE(2)
    LTR_K9_CASE(3)
    LTR_K9_CASE(4)
    LTR_K9_CASE(5)
    LTR_K9_CASE(6)
    LTR_K9_CASE(7)
    LTR_K9_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LTR_K9_CASE
}
