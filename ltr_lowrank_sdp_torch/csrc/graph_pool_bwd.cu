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
//   ds_i      = w_i * (keep_i * <dattn, x[i]> - <dattn, out[b,2D:3D]>)
//   dscore[i] = ds_i - [score_i == mu_b] * (sum_{k in b} ds_k) / T_b
//
// The max's gradient is split equally among the nodes that tie at the max
// (ties, counted by K10), as jax.ops.segment_max's gradient splits it; the
// softmax term uses sum_k w_k keep_k <dattn, x[k]> = <dattn, attention
// output>.  The last term is the gradient that JAX's VJP routes through the
// softmax's stabiliser score - segment_max(score) (layers.py:93): the
// graph's sum of ds, 0 in exact arithmetic and its rounding otherwise, taken
// from the T_b nodes whose score equals the graph's maximum mu_b (K10's
// stats).  Without it that rounding stays in every leaf behind the score.
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
// Design: two launches.  1. K10's chunk layout (at most 256 nodes of one
// graph per chunk), one block per chunk, each warp walks every 8th node,
// lanes over channels; the per-graph terms are loaded once per warp.  ds_i
// is formed in float64 (w_i, the dots' products and sums too), so the
// graph's sum of it is that of the float64 evaluation; the block writes its chunk's
// sum of ds (its warps' sums in warp order), its count of nodes at the
// score maximum and the first of them.  2. A warp a graph adds its chunks'
// sums in chunk order (lane-strided, then an xor tree) and their counts,
// and subtracts the share from the tied nodes: the first chunk's first
// node when there is one, else every node at the maximum of the chunks that
// hold some.  Every output element is written by one thread in a fixed
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

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The chunk's sum of ds (8 warp sums in warp order), its nodes at the score
// maximum and the first of them, written by thread 0.
struct ChunkTail {
  double* part_ds;
  int* part_tie;
  __device__ void write(int c, double ds_warp, int ties_warp, int first_warp,
                        int lane, int warp) {
    __shared__ double s_ds[kWarps];
    __shared__ int s_tie[kWarps], s_first[kWarps];
    if (lane == 0) {
      s_ds[warp] = ds_warp;
      s_tie[warp] = ties_warp;
      s_first[warp] = first_warp;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double t = 0.0;
      int n = 0, first = 0x7fffffff;
      for (int w = 0; w < kWarps; ++w) {
        t += s_ds[w];
        n += s_tie[w];
        first = min(first, s_first[w]);
      }
      part_ds[c] = t;
      part_tie[2 * c] = n;
      part_tie[2 * c + 1] = first;
    }
  }
};

template <int kPerLane>
__global__ void graph_pool_bwd_kernel(
    const int* __restrict__ graph_ptr, const int* __restrict__ chunk_start,
    const int* __restrict__ chunk_end, const int* __restrict__ chunk_graph,
    const float* __restrict__ x, const float* __restrict__ score,
    const float* __restrict__ keep, const float* __restrict__ out,
    const float* __restrict__ stats, const float* __restrict__ ties,
    const float* __restrict__ dout, int d, float* __restrict__ dx,
    float* __restrict__ dscore, ChunkTail tail) {
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
  double dot = 0.0;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int ch = lane + 32 * k;
    dmean[k] = dmax[k] = xmax[k] = dattn[k] = 0.f;
    if (ch < d) {
      dmean[k] = go[ch] / fmaxf(count, 1.f);
      dmax[k] = go[d + ch] / tb[ch];
      xmax[k] = o[d + ch];
      dattn[k] = go[2 * d + ch];
      dot += static_cast<double>(dattn[k]) * o[2 * d + ch];
    }
  }
  dot = warp_sum(dot);
  const float mu = stats[2 * b];
  const float inv = 1.f / (stats[2 * b + 1] + 1e-16f);
  const double l = static_cast<double>(stats[2 * b + 1]) + 1e-16;
  double ds_sum = 0.0;
  int n_top = 0, first = 0x7fffffff;
  for (int node = beg + warp; node < end; node += kWarps) {
    const float sc = score[node];
    const float w = expf(sc - mu) * inv;
    const float kp = keep ? keep[node] : 1.f;
    const float* row = x + static_cast<long long>(node) * d;
    float* drow = dx + static_cast<long long>(node) * d;
    float v[kPerLane];
    double a = 0.0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int ch = lane + 32 * k;
      v[k] = ch < d ? row[ch] : 0.f;
      a += static_cast<double>(dattn[k]) * v[k];
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
    const double ds = exp(static_cast<double>(sc) - mu) / l * (kp * a - dot);
    ds_sum += ds;
    if (sc == mu) {
      n_top += 1;
      first = min(first, node);
    }
    if (lane == 0) dscore[node] = static_cast<float>(ds);
  }
  tail.write(c, ds_sum, n_top, first, lane, warp);
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
    float* __restrict__ dscore, ChunkTail tail) {
  constexpr int kPerLane = kMaxD / 32;
  __shared__ double node_a[kChunkNodes];
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
  double dot = 0.0;
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
        dot += static_cast<double>(dattn[k]) * o[2 * d + ch];
      }
    }
    for (int node = beg + warp; node < end; node += kWarps) {
      const float w = expf(score[node] - mu) * inv;
      const float kw = (keep ? keep[node] : 1.f) * w;
      const float* row = x + static_cast<long long>(node) * d;
      float* drow = dx + static_cast<long long>(node) * d;
      double a = 0.0;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int ch = c0 + lane + 32 * k;
        if (ch < d) {
          const float v = row[ch];
          a += static_cast<double>(dattn[k]) * v;
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
  const double l = static_cast<double>(stats[2 * b + 1]) + 1e-16;
  double ds_sum = 0.0;
  int n_top = 0, first = 0x7fffffff;
  for (int node = beg + warp; node < end; node += kWarps) {
    const float sc = score[node];
    const float kp = keep ? keep[node] : 1.f;
    const double ds = exp(static_cast<double>(sc) - mu) / l *
                      (kp * node_a[node - beg] - dot);
    ds_sum += ds;
    if (sc == mu) {
      n_top += 1;
      first = min(first, node);
    }
    if (lane == 0) dscore[node] = static_cast<float>(ds);
  }
  tail.write(c, ds_sum, n_top, first, lane, warp);
}

// 2. A warp a graph: the stabiliser's term.  The chunks' sums of ds are
// added in chunk order (lane l the chunks l, l + 32, ..., then an xor
// tree), their counts at the maximum likewise; the share -sum / T goes to
// the first tied node when the graph has one, else to each node at the
// maximum, found by a walk over the chunks that hold some.
__global__ void graph_pool_bwd_max_path_kernel(
    const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_start,
    const int* __restrict__ chunk_end, const float* __restrict__ score,
    const float* __restrict__ stats, const double* __restrict__ part_ds,
    const int* __restrict__ part_tie, int n_graphs,
    float* __restrict__ dscore) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= n_graphs) return;
  const int c0 = chunk_ptr[b];
  const int c1 = chunk_ptr[b + 1];
  if (c0 == c1) return;                    // an empty graph
  double t = 0.0;
  int n = 0, first = 0x7fffffff;
  for (int c = c0 + lane; c < c1; c += 32) {
    t += part_ds[c];
    n += part_tie[2 * c];
    first = min(first, part_tie[2 * c + 1]);
  }
  t = warp_sum(t);
  for (int off = 16; off > 0; off >>= 1) {
    n += __shfl_xor_sync(kFull, n, off);
    first = min(first, __shfl_xor_sync(kFull, first, off));
  }
  if (n == 0) return;                      // no score equals mu (NaN)
  const double share = -t / n;
  if (n == 1) {
    if (lane == 0) dscore[first] = static_cast<float>(dscore[first] + share);
    return;
  }
  const float mu = stats[2 * b];
  for (int c = c0; c < c1; ++c) {
    if (part_tie[2 * c] == 0) continue;
    for (int node = chunk_start[c] + lane; node < chunk_end[c];
         node += 32) {
      if (score[node] == mu) {
        dscore[node] = static_cast<float>(dscore[node] + share);
      }
    }
  }
}

}  // namespace

// graph_ptr (B+1), chunk_ptr (B+1), chunk_start / chunk_end / chunk_graph
// (n_chunks): K10's chunk layout, each graph's chunks and the graph of each
// chunk; x (N, d), score (N,), keep (N,) or null; out (B, 3 d), stats (B,
// 2), ties (B, d): K10's outputs; dout (B, 3 d).  Outputs dx (N, d), dscore
// (N,).  Scratch: part_ds (n_chunks) float64 and part_tie (2 n_chunks)
// int32.  Any d >= 1.  Returns the cudaGetLastError() code of the launches.
extern "C" int ltr_graph_pool_bwd(const void* graph_ptr,
                                  const void* chunk_ptr,
                                  const void* chunk_start,
                                  const void* chunk_end,
                                  const void* chunk_graph, const void* x,
                                  const void* score, const void* keep,
                                  const void* out, const void* stats,
                                  const void* ties, const void* dout,
                                  int n_graphs, int n_chunks, int d,
                                  void* dx, void* dscore, void* part_ds,
                                  void* part_tie, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = d <= 128   ? graph_pool_bwd_kernel<4>
                : d <= kMaxD ? graph_pool_bwd_kernel<8>
                             : graph_pool_bwd_wide_kernel;
  const ChunkTail tail{static_cast<double*>(part_ds),
                       static_cast<int*>(part_tie)};
  kernel<<<n_chunks, kWarps * 32, 0, s>>>(
      static_cast<const int*>(graph_ptr),
      static_cast<const int*>(chunk_start), static_cast<const int*>(chunk_end),
      static_cast<const int*>(chunk_graph), static_cast<const float*>(x),
      static_cast<const float*>(score), static_cast<const float*>(keep),
      static_cast<const float*>(out), static_cast<const float*>(stats),
      static_cast<const float*>(ties), static_cast<const float*>(dout), d,
      static_cast<float*>(dx), static_cast<float*>(dscore), tail);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  graph_pool_bwd_max_path_kernel<<<(n_graphs + kWarps - 1) / kWarps,
                                   kWarps * 32, 0, s>>>(
      static_cast<const int*>(chunk_ptr),
      static_cast<const int*>(chunk_start), static_cast<const int*>(chunk_end),
      static_cast<const float*>(score), static_cast<const float*>(stats),
      static_cast<const double*>(part_ds), static_cast<const int*>(part_tie),
      n_graphs, static_cast<float*>(dscore));
  return static_cast<int>(cudaGetLastError());
}
