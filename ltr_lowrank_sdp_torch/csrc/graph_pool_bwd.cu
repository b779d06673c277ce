// K12 graph_pool_bwd: the backward pass of K10 (graph_pool.cu), float32.
// Given dout (B, 3D), the gradient of K10's output [mean | max | attention],
// it returns dx (N, D) and dscore (N,).  For node i of graph b, with the
// attention weight w_i = exp(score_i - mu_b) / (l_b + 1e-16) from K10's
// stats, keep_i its dropout keep-scale (1 without one) and dattn = dout[b,
// 2D:3D]:
//
//   dx[i,c]   = dout[b,c] / max(count_b, 1)                            (mean)
//             + dout[b,D+c] / ties[b,c]   where x[i,c] == max_b[c]       (max)
//             + keep_i * w_i * dattn[c]                                (attention)
//   dscore[i] = w_i * (keep_i * <dattn, x[i]> - <dattn, out[b,2D:3D]>)
//
// The max's gradient is split equally among the nodes that tie at the max
// (ties, counted by K10), as jax.ops.segment_max's gradient splits it; the
// softmax term uses sum_k w_k keep_k <dattn, x[k]> = <dattn, attention
// output>, so no second pass over the graph is needed.
//
// Replaces: the VJP that jax.value_and_grad (train.py:250) takes of
// ltr_lowrank_sdp_tpu/models/layers.py AttentionPooling.__call__ (:88-99: the
// segment max, exp, segment sum, gather back, dropout and weighted
// segment_sum) and of models/net.py GNNEncoder.__call__ (:89-96: the count,
// segment_sum and segment_max poolings).
//
// Bound on the card: memory.  It must read x, the scores (and keep) once and
// write dx and dscore; the per-graph rows are a few hundred bytes.
//
// Design: K10's chunk layout (at most 256 nodes of one graph per chunk), one
// block per chunk, each warp walks every 8th node, lanes over channels; the
// per-graph terms are loaded once per warp.  Every output element is written
// by one thread, the dot products are reduced by xor shuffles in a fixed
// order: the same bits on every call.
//
// Width: each lane holds kPerLane channels of a row (lane, lane + 32, ...),
// a template instantiated for kPerLane = 4 (D <= 128) and 8 (D <= 256).
// Past 256 the warps walk their nodes once a column block of 256 (K10's
// split), the block's per-graph terms in registers; dscore's <dattn, x[i]>
// adds the blocks' warp sums in block order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxD = 256;         // 8 channels per lane
constexpr int kChunkNodes = 256;   // K10's chunk: at most 256 nodes
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int kPerLane>
__global__ void graph_pool_bwd_kernel(
    const int* __restrict__ graph_ptr, const int* __restrict__ chunk_start,
    const int* __restrict__ chunk_end, const int* __restrict__ chunk_graph,
    const float* __restrict__ x, const float* __restrict__ score,
    const float* __restrict__ keep, const float* __restrict__ out,
    const float* __restrict__ stats, const float* __restrict__ ties,
    const float* __restrict__ dout, int d, float* __restrict__ dx,
    float* __restrict__ dscore) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const int b = chunk_graph[c];
  const int beg = chunk_start[c];
  const int end = chunk_end[c];
  const float count = static_cast<float>(graph_ptr[b + 1] - graph_ptr[b]);
  const float* go = dout + static_cast<long long>(b) * 3 * d;
  const float* o = out + static_cast<long long>(b) * 3 * d;
  const float* tb = ties + static_cast<long long>(b) * d;
  float dmean[kPerLane];
  float dmax[kPerLane];
  float xmax[kPerLane];
  float dattn[kPerLane];
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int ch = lane + 32 * k;
    dmean[k] = dmax[k] = xmax[k] = dattn[k] = 0.f;
    if (ch < d) {
      dmean[k] = go[ch] / fmaxf(count, 1.f);
      dmax[k] = go[d + ch] / tb[ch];
      xmax[k] = o[d + ch];
      dattn[k] = go[2 * d + ch];
      dot += dattn[k] * o[2 * d + ch];
    }
  }
  dot = warp_sum(dot);
  const float mu = stats[2 * b];
  const float inv = 1.f / (stats[2 * b + 1] + 1e-16f);
  for (int node = beg + warp; node < end; node += kWarps) {
    const float w = expf(score[node] - mu) * inv;
    const float kp = keep ? keep[node] : 1.f;
    const float* row = x + static_cast<long long>(node) * d;
    float* drow = dx + static_cast<long long>(node) * d;
    float v[kPerLane];
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int ch = lane + 32 * k;
      v[k] = ch < d ? row[ch] : 0.f;
      a += dattn[k] * v[k];
    }
    a = warp_sum(a);
    const float kw = kp * w;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int ch = lane + 32 * k;
      if (ch < d) {
        drow[ch] = dmean[k] + (v[k] == xmax[k] ? dmax[k] : 0.f) +
                   kw * dattn[k];
      }
    }
    if (lane == 0) dscore[node] = w * (kp * a - dot);
  }
}

// D > 256: the same terms, column block by column block.  The per-graph
// terms of a block are loaded once a block of columns (a chunk is one
// graph's), the nodes walked inside it; each node's share of <dattn, x> is
// added up over the column blocks in a shared slot of its own (a chunk has
// at most 256 nodes, each always its warp's), and dscore written at the end.
__global__ void graph_pool_bwd_wide_kernel(
    const int* __restrict__ graph_ptr, const int* __restrict__ chunk_start,
    const int* __restrict__ chunk_end, const int* __restrict__ chunk_graph,
    const float* __restrict__ x, const float* __restrict__ score,
    const float* __restrict__ keep, const float* __restrict__ out,
    const float* __restrict__ stats, const float* __restrict__ ties,
    const float* __restrict__ dout, int d, float* __restrict__ dx,
    float* __restrict__ dscore) {
  constexpr int kPerLane = kMaxD / 32;
  __shared__ float node_a[kChunkNodes];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const int b = chunk_graph[c];
  const int beg = chunk_start[c];
  const int end = chunk_end[c];
  const float count = static_cast<float>(graph_ptr[b + 1] - graph_ptr[b]);
  const float* go = dout + static_cast<long long>(b) * 3 * d;
  const float* o = out + static_cast<long long>(b) * 3 * d;
  const float* tb = ties + static_cast<long long>(b) * d;
  const float mu = stats[2 * b];
  const float inv = 1.f / (stats[2 * b + 1] + 1e-16f);
  float dot = 0.f;
  for (int c0 = 0; c0 < d; c0 += kMaxD) {
    float dmean[kPerLane], dmax[kPerLane], xmax[kPerLane], dattn[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int ch = c0 + lane + 32 * k;
      dmean[k] = dmax[k] = xmax[k] = dattn[k] = 0.f;
      if (ch < d) {
        dmean[k] = go[ch] / fmaxf(count, 1.f);
        dmax[k] = go[d + ch] / tb[ch];
        xmax[k] = o[d + ch];
        dattn[k] = go[2 * d + ch];
        dot += dattn[k] * o[2 * d + ch];
      }
    }
    for (int node = beg + warp; node < end; node += kWarps) {
      const float w = expf(score[node] - mu) * inv;
      const float kw = (keep ? keep[node] : 1.f) * w;
      const float* row = x + static_cast<long long>(node) * d;
      float* drow = dx + static_cast<long long>(node) * d;
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int ch = c0 + lane + 32 * k;
        if (ch < d) {
          const float v = row[ch];
          a += dattn[k] * v;
          drow[ch] = dmean[k] + (v == xmax[k] ? dmax[k] : 0.f) +
                     kw * dattn[k];
        }
      }
      a = warp_sum(a);
      if (lane == 0) node_a[node - beg] = c0 == 0 ? a : node_a[node - beg] + a;
    }
  }
  dot = warp_sum(dot);
  __syncwarp();
  for (int node = beg + warp; node < end; node += kWarps) {
    if (lane == 0) {
      const float w = expf(score[node] - mu) * inv;
      const float kp = keep ? keep[node] : 1.f;
      dscore[node] = w * (kp * node_a[node - beg] - dot);
    }
  }
}

}  // namespace

// graph_ptr (B+1), chunk_start / chunk_end / chunk_graph (n_chunks): K10's
// chunk layout and the graph of each chunk; x (N, d), score (N,), keep (N,)
// or null; out (B, 3 d), stats (B, 2), ties (B, d): K10's outputs; dout
// (B, 3 d).  Outputs dx (N, d), dscore (N,).  Any d >= 1.  Returns the
// cudaGetLastError() code of the launch.
extern "C" int ltr_graph_pool_bwd(const void* graph_ptr,
                                  const void* chunk_start,
                                  const void* chunk_end,
                                  const void* chunk_graph, const void* x,
                                  const void* score, const void* keep,
                                  const void* out, const void* stats,
                                  const void* ties, const void* dout,
                                  int n_chunks, int d, void* dx, void* dscore,
                                  void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks <= 0) return 0;
  auto kernel = d <= 128   ? graph_pool_bwd_kernel<4>
                : d <= kMaxD ? graph_pool_bwd_kernel<8>
                             : graph_pool_bwd_wide_kernel;
  kernel<<<n_chunks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(graph_ptr),
      static_cast<const int*>(chunk_start), static_cast<const int*>(chunk_end),
      static_cast<const int*>(chunk_graph), static_cast<const float*>(x),
      static_cast<const float*>(score), static_cast<const float*>(keep),
      static_cast<const float*>(out), static_cast<const float*>(stats),
      static_cast<const float*>(ties), static_cast<const float*>(dout), d,
      static_cast<float*>(dx), static_cast<float*>(dscore));
  return static_cast<int>(cudaGetLastError());
}
