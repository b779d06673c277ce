// K10 graph_pool: the three graph poolings of the GNN encoder, float32.  For
// every graph b over its contiguous node range graph_ptr[b] .. graph_ptr[b+1]
// of x (N, D) and the attention scores (N,):
//
//   out[b, 0:D]   = sum_i x[i] / max(count_b, 1)                     (mean)
//   out[b, D:2D]  = max_i x[i], 0 where that is not finite           (max)
//   out[b, 2D:3D] = sum_i softmax_b(score)_i * x[i], the softmax with
//                   + 1e-16 in its denominator                        (attention)
//
// Replaces: ltr_lowrank_sdp_tpu/models/net.py GNNEncoder.__call__ (:89-94: the
// count, segment_sum and segment_max poolings with their isfinite guard) and
// models/layers.py AttentionPooling.__call__ (:93-99: the segment max, exp,
// segment sum, gather back and weighted segment_sum).  The tanh-MLP that
// makes the scores stays a matrix product outside.
//
// Bound on the card: memory.  It must read x and the scores once and write
// (B, 3D): a handful of flops per 4-byte element.
//
// Design: at inference B = 1 and N reaches 85,080, so one block per graph
// would leave the card idle.  The host cuts every graph into chunks of at
// most kChunk nodes (a chunk never spans two graphs).  The first launch runs
// one block per chunk: each warp walks every 8th node of the chunk, lanes over
// channels, with an online (running-max) softmax; the eight warps are then
// combined in warp order through shared memory into one partial per chunk
// (max score, exp-sum, weighted sum, sum, max).  The second launch runs one
// block per graph and combines its chunks' partials in chunk order.  No
// atomics: the same bits on every call.  A graph with no node writes zeros.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxPerLane = 4;     // D <= 128
constexpr int kMaxD = 32 * kMaxPerLane;

// partial layout per chunk: [m, l, wsum (D), xsum (D), xmax (D)]
__device__ __forceinline__ int part_width(int d) { return 2 + 3 * d; }

__global__ void graph_pool_chunks_kernel(const int* __restrict__ chunk_start,
                                         const int* __restrict__ chunk_end,
                                         const float* __restrict__ x,
                                         const float* __restrict__ score,
                                         int d, float* __restrict__ part) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_w[kWarps][kMaxD];
  __shared__ float sm_s[kWarps][kMaxD];
  __shared__ float sm_x[kWarps][kMaxD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const int beg = chunk_start[c];
  const int end = chunk_end[c];
  float m = -INFINITY;
  float l = 0.f;
  float ws[kMaxPerLane];
  float xs[kMaxPerLane];
  float xm[kMaxPerLane];
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    ws[k] = 0.f;
    xs[k] = 0.f;
    xm[k] = -INFINITY;
  }
  for (int node = beg + warp; node < end; node += kWarps) {
    const float s = score[node];
    const float m_new = fmaxf(m, s);
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float scale = expf(m - mu);
    const float p = expf(s - mu);
    l = l * scale + p;
    const float* row = x + static_cast<long long>(node) * d;
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
      const int ch = lane + 32 * k;
      if (ch < d) {
        const float v = row[ch];
        ws[k] = ws[k] * scale + p * v;
        xs[k] += v;
        xm[k] = fmaxf(xm[k], v);
      }
    }
    m = m_new;
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int ch = lane + 32 * k;
    if (ch < d) {
      sm_w[warp][ch] = ws[k];
      sm_s[warp][ch] = xs[k];
      sm_x[warp][ch] = xm[k];
    }
  }
  __syncthreads();
  float mt = -INFINITY;
  for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w]);
  const float mu = mt == -INFINITY ? 0.f : mt;
  float* out = part + static_cast<long long>(c) * part_width(d);
  for (int ch = threadIdx.x; ch < d; ch += blockDim.x) {
    float w_sum = 0.f;
    float x_sum = 0.f;
    float x_max = -INFINITY;
    for (int w = 0; w < kWarps; ++w) {
      w_sum += sm_w[w][ch] * expf(sm_m[w] - mu);
      x_sum += sm_s[w][ch];
      x_max = fmaxf(x_max, sm_x[w][ch]);
    }
    out[2 + ch] = w_sum;
    out[2 + d + ch] = x_sum;
    out[2 + 2 * d + ch] = x_max;
  }
  if (threadIdx.x == 0) {
    float l_sum = 0.f;
    for (int w = 0; w < kWarps; ++w) l_sum += sm_l[w] * expf(sm_m[w] - mu);
    out[0] = mt;
    out[1] = l_sum;
  }
}

__global__ void graph_pool_combine_kernel(const int* __restrict__ graph_ptr,
                                          const int* __restrict__ chunk_ptr,
                                          const float* __restrict__ part,
                                          int d, float* __restrict__ out) {
  const int b = blockIdx.x;
  const int c0 = chunk_ptr[b];
  const int c1 = chunk_ptr[b + 1];
  const float count = static_cast<float>(graph_ptr[b + 1] - graph_ptr[b]);
  const int pw = part_width(d);
  float* o = out + static_cast<long long>(b) * 3 * d;
  for (int ch = threadIdx.x; ch < d; ch += blockDim.x) {
    float m = -INFINITY;
    float l = 0.f;
    float w_sum = 0.f;
    float x_sum = 0.f;
    float x_max = -INFINITY;
    for (int c = c0; c < c1; ++c) {
      const float* p = part + static_cast<long long>(c) * pw;
      const float mc = p[0];
      const float m_new = fmaxf(m, mc);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float f_old = expf(m - mu);
      const float f_new = expf(mc - mu);
      l = l * f_old + p[1] * f_new;
      w_sum = w_sum * f_old + p[2 + ch] * f_new;
      x_sum += p[2 + d + ch];
      x_max = fmaxf(x_max, p[2 + 2 * d + ch]);
      m = m_new;
    }
    o[ch] = x_sum / fmaxf(count, 1.f);
    o[d + ch] = isfinite(x_max) ? x_max : 0.f;
    o[2 * d + ch] = w_sum / (l + 1e-16f);
  }
}

}  // namespace

// graph_ptr (B+1), chunk_ptr (B+1: the chunks of graph b), chunk_start /
// chunk_end (n_chunks), x (N, d), score (N,), part (n_chunks, 2 + 3 d)
// scratch, out (B, 3 d).  d <= 128.  Returns the cudaGetLastError() code of
// the launches.
extern "C" int ltr_graph_pool(const void* graph_ptr, const void* chunk_ptr,
                              const void* chunk_start, const void* chunk_end,
                              const void* x, const void* score, int n_graphs,
                              int n_chunks, int d, void* part, void* out,
                              void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (n_graphs <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    graph_pool_chunks_kernel<<<n_chunks, kWarps * 32, 0, s>>>(
        static_cast<const int*>(chunk_start),
        static_cast<const int*>(chunk_end), static_cast<const float*>(x),
        static_cast<const float*>(score), d, static_cast<float*>(part));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = d < 32 ? 32 : ((d + 31) / 32) * 32;
  graph_pool_combine_kernel<<<n_graphs, threads, 0, s>>>(
      static_cast<const int*>(graph_ptr), static_cast<const int*>(chunk_ptr),
      static_cast<const float*>(part), d, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
