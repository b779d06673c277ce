// K9 gatv2_softmax_agg: the attention and aggregation of one GATv2 layer,
// float32.  For every destination node i and head h, over the edges e = j -> i
// of i (self-loops included):
//
//   s_e      = sum_c att[h,c] * leaky_0.2(w_src[j,h,c] + w_dst[i,h,c] + we[e,h,c])
//   alpha_e  = exp(s_e - max_e' s_e') / (sum_e' exp(s_e' - max_e' s_e') + 1e-16)
//   out[i,h,:] = sum_e alpha_e * w_src[j,h,:]
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
// N rows of 256 bytes, reused through L2), w_dst, the edge terms `we` (E rows
// of 256 bytes: 635 MB on the largest dataset graph, the bulk of the
// traffic), the CSR and write out: about 12 flops per 256-byte edge row, far
// below the FP32 ridge point.
//
// Design: one warp per destination node, two channels per lane (64 = H * C
// channels), the C / 2 lanes of one head reduce the att dot by xor shuffles.
// The lanes load 32 (src, erow) pairs at a time and broadcast them by
// shuffles.  The softmax is an online (running-max) softmax in one pass over
// the edges: the accumulators are rescaled whenever the running max grows.
// No atomics: the same bits on every call.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChannels = 64;   // H * C: two channels per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

__global__ void gatv2_softmax_agg_kernel(
    const int* __restrict__ indptr, const int* __restrict__ src,
    const int* __restrict__ erow, const float2* __restrict__ w_src,
    const float2* __restrict__ w_dst, const float2* __restrict__ we,
    const float2* __restrict__ we_loop, const float2* __restrict__ att, int n,
    int n_real, int lanes_per_head, float slope, float2* __restrict__ out) {
  constexpr int kRow = kChannels / 2;   // float2 per row
  const int lane = threadIdx.x & 31;
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const float2 xd = w_dst[i * kRow + lane];
  const float2 a = att[lane];
  const float2 el = we_loop[lane];
  float m = -INFINITY;
  float l = 0.f;
  float acc0 = 0.f;
  float acc1 = 0.f;
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
      const float2 xs = w_src[static_cast<long long>(j) * kRow + lane];
      const float2 ev =
          r < n_real ? we[static_cast<long long>(r) * kRow + lane] : el;
      float s = a.x * leaky(xs.x + xd.x + ev.x, slope) +
                a.y * leaky(xs.y + xd.y + ev.y, slope);
      for (int off = lanes_per_head >> 1; off > 0; off >>= 1) {
        s += __shfl_xor_sync(kFull, s, off);
      }
      const float m_new = fmaxf(m, s);
      // a segment whose scores are all -inf adds 0, as the reference's
      // isfinite guard on the segment max does
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float scale = expf(m - mu);
      const float p = expf(s - mu);
      l = l * scale + p;
      acc0 = acc0 * scale + p * xs.x;
      acc1 = acc1 * scale + p * xs.y;
      m = m_new;
    }
  }
  const float inv = 1.f / (l + 1e-16f);
  out[i * kRow + lane] = make_float2(acc0 * inv, acc1 * inv);
}

}  // namespace

// heads * channels must be 64 and channels (per head) an even power of two
// up to 64; the wrapper checks shapes.  Returns the cudaGetLastError() code
// of the launch.
extern "C" int ltr_gatv2_softmax_agg(const void* indptr, const void* src,
                                     const void* erow, const void* w_src,
                                     const void* w_dst, const void* we,
                                     const void* we_loop, const void* att,
                                     int n, int n_real, int channels,
                                     float slope, void* out, void* stream) {
  if (n <= 0) return 0;
  if (channels < 2 || channels > kChannels || (channels & (channels - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gatv2_softmax_agg_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(src),
      static_cast<const int*>(erow), static_cast<const float2*>(w_src),
      static_cast<const float2*>(w_dst), static_cast<const float2*>(we),
      static_cast<const float2*>(we_loop), static_cast<const float2*>(att), n,
      n_real, channels / 2, slope, static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}
