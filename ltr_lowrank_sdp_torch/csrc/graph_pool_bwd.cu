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
// Design: one launch, K10's layout.  A block takes one chunk of K10's (at
// most 256 nodes of one graph) and one column block of at most 256 columns
// (blockIdx.y, where D > 256).
// 1. The chunk's nodes first, one a thread: w_i and keep_i w_i in float32
//    (dx's factor, as before), exp(score_i - mu) / l in float64 (ds's), all
//    into shared memory, and the graph's <dattn, out[b,2D:3D]> in float64
//    (a thread per channel, a fixed tree).  The first rows are loaded
//    before these.
// 2. The node walk: sub-warps of L lanes a node (kernels.k10_lanes: L
//    lanes of CPL = 4 or 8 channels cover the column block), lane lam
//    holding channels 4 (lam + L t) + q, loaded as float4 where D is a
//    multiple of 4 (else as scalars, the same channels); node j of the
//    chunk is sub-warp j mod NS's, each sub-warp holding `depth` rows
//    loaded ahead of their arithmetic.  Each lane writes its channels of
//    dx (the formula above, elementwise: the bits of the kernel before this
//    design) and forms its part of <dattn, x[i]> in float64 (a fused
//    multiply-add a channel in channel order, then an xor tree over the
//    sub-warp); lane 0 hands the node's sum to shared memory.
// 3. Where D > 256, the column blocks of a chunk write their sums to
//    global scratch, and the last of them to take the chunk's ticket adds
//    them in column-block order: no node is walked twice.
// 4. A thread a node forms ds_i in float64 (so the graph's sum of it is
//    that of the float64 evaluation) and writes dscore; the block adds
//    the chunk's ds by a fixed tree and counts its nodes at the score
//    maximum (and the first of them).
// 5. The last chunk of the graph to take the graph's ticket adds the
//    chunks' sums in chunk order (a thread the chunks t, t + 256, ..., then
//    a fixed tree) and their counts, and subtracts the share from the tied
//    nodes: the first when there is one, else every node at the maximum of
//    the chunks that hold some.  The tickets are atomicIncs that wrap to 0
//    at the last block, so the next call (or a replay of a captured CUDA
//    graph, which gets tickets of its own) finds them at 0.
// Every sum's order depends on D alone: the load width and the depth (the
// plan, kernels.k10_plans) never change the bits, nor does the order in
// which blocks finish.  No atomics on values.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunkNodes = 256;   // K10's chunk: at most 256 nodes
constexpr int kMaxD = 256;         // columns a block
constexpr int kBuf = 32;           // floats of rows a lane loads ahead
constexpr unsigned kFull = 0xffffffffu;

static_assert(kChunkNodes == kThreads, "one node a thread");

struct Args {
  const int* graph_ptr;
  const int* chunk_ptr;
  const int* chunk_start;
  const int* chunk_end;
  const int* chunk_graph;
  const float* x;
  const float* score;
  const float* keep;
  const float* out;
  const float* stats;
  const float* ties;
  const float* dout;
  int n_graphs, n_chunks, d, ny, vec, depth;
  float* dx;
  float* dscore;
  double* part_ds;         // (n_chunks) the chunk's sum of ds
  int* part_tie;           // (n_chunks, 2) nodes at the maximum, the first
  double* part_a;          // (n_chunks, ny, 256) where ny > 1
  unsigned* ticket;        // (B) graphs, then (n_chunks) chunks where ny > 1
};

// the block's sum of v by a fixed tree (every thread gets it)
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __dadd_rn(v, __shfl_xor_sync(kFull, v, off));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return __dadd_rn(__dadd_rn(__dadd_rn(red[0], red[1]),
                             __dadd_rn(red[2], red[3])),
                   __dadd_rn(__dadd_rn(red[4], red[5]),
                             __dadd_rn(red[6], red[7])));
}

// the block's sum and min of two ints (every thread gets them)
__device__ __forceinline__ void block_count(int& n, int& first, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n += __shfl_xor_sync(kFull, n, off);
    first = min(first, __shfl_xor_sync(kFull, first, off));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = n;
    red[kWarps + (threadIdx.x >> 5)] = first;
  }
  __syncthreads();
  n = 0;
  first = 0x7fffffff;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    n += red[w];
    first = min(first, red[kWarps + w]);
  }
}

// channel (within the column block) of register k of lane lam of L lanes:
// the same for float4 and scalar loads
template <int L>
__device__ __forceinline__ int chan(int lam, int k) {
  return 4 * (lam + L * (k >> 2)) + (k & 3);
}

// the lane's CPL channels of one row
template <int L, int CPL>
__device__ __forceinline__ void load(float (&v)[CPL], const float* row,
                                     int vec, int lam, int dc) {
#pragma unroll
  for (int t = 0; t < CPL / 4; ++t) {
    const int c4 = 4 * (lam + L * t);
    if (vec == 4) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c4 < dc) f = *reinterpret_cast<const float4*>(row + c4);
      v[4 * t] = f.x;
      v[4 * t + 1] = f.y;
      v[4 * t + 2] = f.z;
      v[4 * t + 3] = f.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[4 * t + q] = c4 + q < dc ? row[c4 + q] : 0.f;
      }
    }
  }
}

// L lanes a node, CPL channels a lane (CPL * L covers a column block)
template <int L, int CPL>
__global__ void __launch_bounds__(kThreads, CPL == 4 ? 3 : 2)
graph_pool_bwd_kernel(const Args a) {
  constexpr int SW = 32 / L;             // sub-warps a warp
  constexpr int NS = kWarps * SW;        // sub-warps (strands) a block
  constexpr int DEPTH = kBuf / CPL;      // rows a lane can hold ahead
  __shared__ float sm_kw[kChunkNodes];   // keep_i w_i, float32 (dx)
  __shared__ double sm_e[kChunkNodes];   // exp(s_i - mu) / l, float64 (ds)
  __shared__ double sm_a[kChunkNodes];   // <dattn, x[i]>, this column block
  __shared__ double red[kWarps];
  __shared__ int ired[2 * kWarps];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lam = lane % L;
  const int sigma = warp * SW + lane / L;
  const int y = blockIdx.y;
  const int col0 = y * kMaxD;
  const int dc = min(kMaxD, a.d - col0);
  const long long d3 = 3LL * a.d;
  const int c = blockIdx.x;
  const int b = a.chunk_graph[c];
  const int beg = a.chunk_start[c];
  const int len = a.chunk_end[c] - beg;
  const float* xb = a.x + col0;
  const int step = NS * a.depth;

  // the first rows of this sub-warp, loaded before the per-node terms
  float v[DEPTH][CPL];
#pragma unroll
  for (int r = 0; r < DEPTH; ++r) {
    const int j = sigma + NS * r;
    if (r < a.depth && j < len) {
      load<L, CPL>(v[r], xb + static_cast<long long>(beg + j) * a.d, a.vec,
                   lam, dc);
    } else {
#pragma unroll
      for (int k = 0; k < CPL; ++k) v[r][k] = 0.f;
    }
  }

  // the graph's terms of this lane's channels
  const float count = static_cast<float>(a.graph_ptr[b + 1] -
                                         a.graph_ptr[b]);
  const float* go = a.dout + b * d3 + col0;
  const float* ob = a.out + b * d3 + col0;
  const float* tb = a.ties + static_cast<long long>(b) * a.d + col0;
  float dmean[CPL], dmax[CPL], xmax[CPL], dattn[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int ch = chan<L>(lam, k);
    dmean[k] = dmax[k] = xmax[k] = dattn[k] = 0.f;
    if (ch < dc) {
      dmean[k] = go[ch] / fmaxf(count, 1.f);
      dmax[k] = go[a.d + ch] / tb[ch];
      xmax[k] = ob[a.d + ch];
      dattn[k] = go[2 * a.d + ch];
    }
  }

  // 1. the chunk's nodes: w_i, keep_i w_i, exp(s_i - mu) / l
  const float mu = a.stats[2 * b];
  const float inv = 1.f / (a.stats[2 * b + 1] + 1e-16f);
  const double l = static_cast<double>(a.stats[2 * b + 1]) + 1e-16;
  float sc = 0.f, kp = 1.f;
  if (tid < len) {
    sc = a.score[beg + tid];
    kp = a.keep ? a.keep[beg + tid] : 1.f;
    const float w = expf(sc - mu) * inv;
    sm_kw[tid] = kp * w;
    sm_e[tid] = exp(static_cast<double>(sc) - mu) / l;
  }
  __syncthreads();

  // 2. the node walk: node j of the chunk is sub-warp j mod NS's; every
  // lane of the block takes the same steps (the sub-warps' shuffles need
  // the whole warp), a sub-warp past the chunk's end idle in them
  for (int base = 0; base < len; base += step) {
#pragma unroll
    for (int r = 0; r < DEPTH; ++r) {
      if (r < a.depth) {
        const int j = base + sigma + NS * r;
        const bool on = j < len;
        const float kw = on ? sm_kw[j] : 0.f;
        float dxv[CPL];
        double dot_x = 0.0;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          dxv[k] = dmean[k] + (v[r][k] == xmax[k] ? dmax[k] : 0.f) +
                   kw * dattn[k];
          dot_x = __fma_rn(static_cast<double>(dattn[k]),
                           static_cast<double>(v[r][k]), dot_x);
        }
        if (on) {
          float* drow = a.dx + static_cast<long long>(beg + j) * a.d + col0;
#pragma unroll
          for (int t = 0; t < CPL / 4; ++t) {
            const int c4 = 4 * (lam + L * t);
            if (a.vec == 4) {
              if (c4 < dc) {
                *reinterpret_cast<float4*>(drow + c4) =
                    make_float4(dxv[4 * t], dxv[4 * t + 1], dxv[4 * t + 2],
                                dxv[4 * t + 3]);
              }
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                if (c4 + q < dc) drow[c4 + q] = dxv[4 * t + q];
              }
            }
          }
        }
#pragma unroll
        for (int off = 1; off < L; off <<= 1) {
          dot_x = __dadd_rn(dot_x, __shfl_xor_sync(kFull, dot_x, off));
        }
        if (on && lam == 0) sm_a[j] = dot_x;
      }
    }
#pragma unroll
    for (int r = 0; r < DEPTH; ++r) {
      const int j = base + step + sigma + NS * r;
      if (r < a.depth && j < len) {
        load<L, CPL>(v[r], xb + static_cast<long long>(beg + j) * a.d, a.vec,
                     lam, dc);
      }
    }
  }
  __syncthreads();

  // 3. D > 256: the last column block of the chunk adds the blocks' sums
  double ax = tid < len ? sm_a[tid] : 0.0;
  if (a.ny > 1) {
    double* pa = a.part_a + static_cast<long long>(c) * a.ny * kChunkNodes;
    if (tid < len) pa[y * kChunkNodes + tid] = ax;
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const unsigned t =
          atomicInc(a.ticket + a.n_graphs + c, a.ny - 1);
      is_last = t == static_cast<unsigned>(a.ny - 1);
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (tid < len) {
      ax = __ldcg(pa + tid);
      for (int yy = 1; yy < a.ny; ++yy) {
        ax = __dadd_rn(ax, __ldcg(pa + yy * kChunkNodes + tid));
      }
    }
  }

  // 4. ds a node, the chunk's sum of it and its nodes at the maximum
  double dot = 0.0;       // <dattn, out[b, 2D:3D]>, all D columns
  {
    const float* gb = a.dout + b * d3 + 2 * a.d;
    const float* oa = a.out + b * d3 + 2 * a.d;
    for (int ch = tid; ch < a.d; ch += kThreads) {
      dot = __fma_rn(static_cast<double>(gb[ch]),
                     static_cast<double>(oa[ch]), dot);
    }
    dot = block_sum(dot, red);
  }
  double ds = 0.0;
  int n_top = 0, first = 0x7fffffff;
  if (tid < len) {
    ds = __dmul_rn(sm_e[tid], __dsub_rn(__dmul_rn(kp, ax), dot));
    a.dscore[beg + tid] = static_cast<float>(ds);
    if (sc == mu) {
      n_top = 1;
      first = beg + tid;
    }
  }
  const double ds_sum = block_sum(ds, red);
  block_count(n_top, first, ired);
  if (tid == 0) {
    a.part_ds[c] = ds_sum;
    a.part_tie[2 * c] = n_top;
    a.part_tie[2 * c + 1] = first;
  }

  // 5. the last chunk of graph b applies the stabiliser's term
  __threadfence();
  __syncthreads();
  const int c0 = a.chunk_ptr[b];
  const int nb = a.chunk_ptr[b + 1] - c0;
  if (tid == 0) {
    const unsigned t = atomicInc(a.ticket + b, nb - 1);
    is_last = t == static_cast<unsigned>(nb - 1);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  double tot = 0.0;
  int n_all = 0, first_all = 0x7fffffff;
  for (int k = tid; k < nb; k += kThreads) {
    tot = __dadd_rn(tot, __ldcg(a.part_ds + c0 + k));
    n_all += __ldcg(a.part_tie + 2 * (c0 + k));
    first_all = min(first_all, __ldcg(a.part_tie + 2 * (c0 + k) + 1));
  }
  tot = block_sum(tot, red);
  block_count(n_all, first_all, ired);
  if (n_all == 0) return;                  // no score equals mu (NaN)
  const double share = -tot / n_all;
  if (n_all == 1) {
    if (tid == 0) {
      a.dscore[first_all] =
          static_cast<float>(__ldcg(a.dscore + first_all) + share);
    }
    return;
  }
  for (int k = 0; k < nb; ++k) {
    if (__ldcg(a.part_tie + 2 * (c0 + k)) == 0) continue;
    const int node = a.chunk_start[c0 + k] + tid;
    if (node < a.chunk_end[c0 + k] && a.score[node] == mu) {
      a.dscore[node] = static_cast<float>(__ldcg(a.dscore + node) + share);
    }
  }
}

}  // namespace

// graph_ptr (B+1), chunk_ptr (B+1), chunk_start / chunk_end / chunk_graph
// (n_chunks): K10's chunk layout, each graph's chunks and the graph of each
// chunk; x (N, d), score (N,), keep (N,) or null; out (B, 3 d), stats (B,
// 2), ties (B, d): K10's outputs; dout (B, 3 d); lanes, cpl, vec, depth:
// a plan of K10's (kernels.k10_plans: lanes and cpl of d, vec 4 for
// float4 loads, which needs d a multiple of 4 and x, dx 16-byte aligned,
// depth rows loaded ahead); no plan changes the bits.  Outputs dx (N, d),
// dscore (N,).  Scratch: part_ds (n_chunks) float64, part_tie (2 n_chunks)
// int32, part_a (n_chunks, ny, 256) float64 with ny = ceil(d / 256) (null
// where ny = 1), ticket (B + n_chunks where ny > 1) unsigned, 0 at the call
// and again after it (one call at a time: one stream's eager calls, or one
// call site of a captured CUDA graph).  Any d >= 1.  Returns the launch's
// cudaGetLastError() code.
extern "C" int ltr_graph_pool_bwd(
    const void* graph_ptr, const void* chunk_ptr, const void* chunk_start,
    const void* chunk_end, const void* chunk_graph, const void* x,
    const void* score, const void* keep, const void* out, const void* stats,
    const void* ties, const void* dout, int n_graphs, int n_chunks, int d,
    int lanes, int cpl, int vec, int depth, void* dx, void* dscore,
    void* part_ds, void* part_tie, void* part_a, void* ticket,
    void* stream) {
  const int cols = d < kMaxD ? d : kMaxD;
  const int ny = (d + kMaxD - 1) / kMaxD;
  if (d < 1 || (vec != 1 && vec != 4) || (vec == 4 && d % 4 != 0) ||
      (cpl != 4 && cpl != 8) || lanes * cpl < cols ||
      (depth != 1 && depth != 2 && depth != 4 && depth != 8) ||
      depth * cpl > kBuf ||
      (n_chunks > 0 && (part_ds == nullptr || part_tie == nullptr ||
                        ticket == nullptr ||
                        (ny > 1 && part_a == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_graphs <= 0 || n_chunks <= 0) return 0;
  unsigned* tk = static_cast<unsigned*>(ticket);
  const Args a{static_cast<const int*>(graph_ptr),
               static_cast<const int*>(chunk_ptr),
               static_cast<const int*>(chunk_start),
               static_cast<const int*>(chunk_end),
               static_cast<const int*>(chunk_graph),
               static_cast<const float*>(x),
               static_cast<const float*>(score),
               static_cast<const float*>(keep),
               static_cast<const float*>(out),
               static_cast<const float*>(stats),
               static_cast<const float*>(ties),
               static_cast<const float*>(dout),
               n_graphs, n_chunks, d, ny, vec, depth,
               static_cast<float*>(dx), static_cast<float*>(dscore),
               static_cast<double*>(part_ds), static_cast<int*>(part_tie),
               static_cast<double*>(part_a), tk};
  const dim3 grid(n_chunks, ny);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K12_CASE(LL, CC)                                                   \
  if (lanes == LL && cpl == CC) {                                          \
    graph_pool_bwd_kernel<LL, CC><<<grid, kThreads, 0, s>>>(a);            \
    return static_cast<int>(cudaGetLastError());                           \
  }
  K12_CASE(1, 4) K12_CASE(2, 4) K12_CASE(4, 4) K12_CASE(8, 4)
  K12_CASE(16, 4) K12_CASE(32, 4) K12_CASE(32, 8)
#undef K12_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
