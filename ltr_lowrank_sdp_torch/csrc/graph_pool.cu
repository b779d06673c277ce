// K10 graph_pool: the three graph poolings of the GNN encoder, float32.  For
// every graph b over its contiguous node range graph_ptr[b] .. graph_ptr[b+1]
// of x (N, D) and the attention scores (N,):
//
//   out[b, 0:D]   = sum_i x[i] / max(count_b, 1)                     (mean)
//   out[b, D:2D]  = max_i x[i], 0 where that is not finite           (max)
//   out[b, 2D:3D] = sum_i softmax_b(score)_i * keep[i] * x[i], the softmax
//                   with + 1e-16 in its denominator                   (attention)
//
// keep (N,), optional, is the dropout keep-scale of training on the attention
// weights (0 or 1 / (1 - p)); without it every keep is 1.  Training also asks
// for stats (B, 2) = (mu_b, l_b), the max score (0 where it is not finite) and
// sum_i exp(score_i - mu_b), so that softmax_b(score)_i = exp(score_i - mu_b)
// / (l_b + 1e-16), and ties (B, D), the count of nodes at the max of each
// column: the backward kernel K12 (graph_pool_bwd.cu) reads both.
//
// Replaces: ltr_lowrank_sdp_tpu/models/net.py GNNEncoder.__call__ (:89-94: the
// count, segment_sum and segment_max poolings with their isfinite guard) and
// models/layers.py AttentionPooling.__call__ (:93-99: the segment max, exp,
// segment sum, gather back and weighted segment_sum).  The tanh-MLP that
// makes the scores stays a matrix product outside.
//
// Bound on the card: memory.  It must read x and the scores once and write
// (B, 3D): a handful of flops per 4-byte element.  At the serve checkpoint's
// D = 64 and 85,080 nodes that is 22 MB, 6.6 us at 3.35 TB/s.
//
// Design.  At inference B = 1 and N reaches 85,080, so one block per graph
// would leave the card idle: the host cuts every graph into chunks of at most
// kChunk = 256 nodes (a chunk never spans two graphs; kernels.K10_CHUNK, and
// K12's kChunkNodes, are the same 256), one block a chunk and column block.
//
// 1. The chunk's scores first: one per thread, a block max m_c, then each
//    node's weight p_i = exp(s_i - m_c) (times keep_i) into shared memory
//    and l_c = sum p_i by one fixed tree (xor tree in each warp, a fixed tree
//    over the 8 warps).  No running rescale: every node's weight is final
//    before any row is added, and the first rows are loaded before the
//    scores' reductions, so their latency hides behind them.
// 2. The node walk: sub-warps of L lanes a node (L = the power of two that
//    covers the column block four channels a lane, at most 32; 16 at D = 64,
//    so a warp takes two nodes a step), each lane CPL = 4 channels (8 where
//    a column block is wider than 128), loaded as float4 where D is a
//    multiple of 4 (else as scalars, the same channels in other lanes).
//    Node j of the chunk belongs to sub-warp j mod NS (NS = 8 * 32 / L) and
//    each sub-warp adds its nodes in order, holding `depth` rows (up to 32
//    floats a lane: 8 rows at CPL 4) loaded ahead of their arithmetic.  The
//    sub-warps of a warp are added by an xor tree, the 8 warps by a fixed
//    tree: the chunk's partial (m_c, l_c and per column the weighted sum,
//    the sum, the max and the count at the max) goes to global scratch.
// 3. The last block of a graph (and column block) to take a ticket combines
//    the graph's chunk partials in the same launch: the graph max M, then NS
//    strands, strand s adding chunks s, s + NS, ... in order, each rescaled
//    by exp(m_c - M), then the same two trees.  The ticket is an atomicInc
//    that wraps to 0 at the last block, so the next call (or a replay of a
//    captured CUDA graph, which gets tickets of its own) finds it at 0.
//
// Registers: at most 85 a thread at CPL 4 (three blocks an SM, so the
// 333 chunks of an 85,080-node graph run in one wave), 128 at CPL 8.
//
// Every sum is a round-to-nearest intrinsic (fused multiply-add where the
// weight meets the row), and the order depends on D alone: depth and the
// load width (the plan, kernels.k10_plans) never change the bits, nor does
// the order in which blocks finish.  No atomics on values.  A graph with no
// node gets a block of its own that writes zeros.
//
// Width: blockIdx.y splits D into column blocks of at most kMaxD = 256, each
// a block of its own over the chunk's nodes, reading its columns of the full
// rows in place.  The scores are one column shared by every column block:
// each computes the same (m_c, l_c) with the same bits and column block 0
// writes the graph's stats.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;        // nodes a chunk: one score a thread
constexpr int kMaxD = 256;         // columns a block
constexpr int kBuf = 32;           // floats of rows a lane loads ahead
constexpr unsigned kFull = 0xffffffffu;

static_assert(kChunk == kThreads, "one score a thread");

struct Args {
  const int* graph_ptr;
  const int* chunk_ptr;
  const int* chunk_start;
  const int* chunk_end;
  const int* chunk_graph;
  const int* empty;        // the graphs with no node
  const float* x;
  const float* score;
  const float* keep;
  int n_chunks, d, dp, pw, vec, depth, ny;
  float* part;             // (n_chunks, pw): [m, l, -, -] a column block,
                           // then w (dp), s (dp), x (dp), c (dp)
  unsigned* ticket;        // (B, ny), 0 between calls
  float* out;
  float* stats;
  float* ties;
};

// (max, count at the max) of two (max, count) pairs
__device__ __forceinline__ void merge_max(float& xm, float& xc, float om,
                                          float oc) {
  const float c = om == xm ? __fadd_rn(xc, oc) : xc;
  xc = om > xm ? oc : c;
  xm = fmaxf(xm, om);
}

// channel (within the column block) of register k of lane lam of L lanes
template <int L>
__device__ __forceinline__ int chan(int vec, int lam, int k) {
  return vec == 4 ? 4 * (lam + L * (k >> 2)) + (k & 3) : lam + L * k;
}

// the lane's CPL channels of one row (or of one partial's column segment)
template <int L, int CPL, bool CG>
__device__ __forceinline__ void load(float (&v)[CPL], const float* row,
                                     int vec, int lam, int dc) {
  if (vec == 4) {
#pragma unroll
    for (int t = 0; t < CPL / 4; ++t) {
      const int c4 = 4 * (lam + L * t);
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c4 < dc) {
        const float4* p = reinterpret_cast<const float4*>(row + c4);
        f = CG ? __ldcg(p) : *p;
      }
      v[4 * t] = f.x;
      v[4 * t + 1] = f.y;
      v[4 * t + 2] = f.z;
      v[4 * t + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int ch = lam + L * k;
      v[k] = ch < dc ? (CG ? __ldcg(row + ch) : row[ch]) : 0.f;
    }
  }
}

__device__ __forceinline__ float tree8(const float (&w)[kWarps][kMaxD],
                                       int ch) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(w[0][ch], w[1][ch]), __fadd_rn(w[2][ch], w[3][ch])),
      __fadd_rn(__fadd_rn(w[4][ch], w[5][ch]), __fadd_rn(w[6][ch], w[7][ch])));
}

__device__ __forceinline__ float tree8(const float* w) {
  return __fadd_rn(__fadd_rn(__fadd_rn(w[0], w[1]), __fadd_rn(w[2], w[3])),
                   __fadd_rn(__fadd_rn(w[4], w[5]), __fadd_rn(w[6], w[7])));
}

// the block's max of v (every thread gets it)
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

// the block's sum of v by a fixed tree (every thread gets it)
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return tree8(red);
}

// the four running columns of a lane: weighted sum, sum, max, count at max
template <int CPL>
struct Acc {
  float w[CPL], s[CPL], x[CPL], c[CPL];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      w[k] = 0.f;
      s[k] = 0.f;
      x[k] = -INFINITY;
      c[k] = 0.f;
    }
  }

  // the sub-warps of a warp (lanes lam, lam + L, ... hold the same
  // channels), by an xor tree
  template <int L, bool kTrain>
  __device__ __forceinline__ void reduce_subwarps() {
#pragma unroll
    for (int off = L; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        w[k] = __fadd_rn(w[k], __shfl_xor_sync(kFull, w[k], off));
        s[k] = __fadd_rn(s[k], __shfl_xor_sync(kFull, s[k], off));
        const float om = __shfl_xor_sync(kFull, x[k], off);
        if (kTrain) {
          merge_max(x[k], c[k], om, __shfl_xor_sync(kFull, c[k], off));
        } else {
          x[k] = fmaxf(x[k], om);
        }
      }
    }
  }
};

// sub-warp 0 of each warp hands its columns to shared memory
template <int L, int CPL, bool kTrain>
__device__ __forceinline__ void stage(const Acc<CPL>& acc, int vec, int lam,
                                      int dc, int warp,
                                      float (&sm_w)[kWarps][kMaxD],
                                      float (&sm_s)[kWarps][kMaxD],
                                      float (&sm_x)[kWarps][kMaxD],
                                      float* sm_c) {
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int ch = chan<L>(vec, lam, k);
    if (ch >= dc) continue;
    sm_w[warp][ch] = acc.w[k];
    sm_s[warp][ch] = acc.s[k];
    sm_x[warp][ch] = acc.x[k];
    if (kTrain) sm_c[warp * kMaxD + ch] = acc.c[k];
  }
}

// L lanes a node, CPL channels a lane (CPL * L covers a column block)
template <int L, int CPL, bool kTrain>
__global__ void __launch_bounds__(kThreads, CPL == 4 ? 3 : 2)
graph_pool_kernel(const Args a) {
  constexpr int SW = 32 / L;             // sub-warps a warp
  constexpr int NS = kWarps * SW;        // sub-warps (strands) a block
  constexpr int DEPTH = kBuf / CPL;      // rows a lane can hold ahead
  __shared__ float sm_p[kChunk];
  __shared__ float red[kWarps];
  __shared__ float sm_w[kWarps][kMaxD];
  __shared__ float sm_s[kWarps][kMaxD];
  __shared__ float sm_x[kWarps][kMaxD];
  __shared__ float sm_c[kTrain ? kWarps * kMaxD : 1];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lam = lane % L;
  const int sw = lane / L;
  const int sigma = warp * SW + sw;
  const int y = blockIdx.y;
  const int col0 = y * kMaxD;
  const int dc = min(kMaxD, a.d - col0);
  const long long d3 = 3LL * a.d;

  if (static_cast<int>(blockIdx.x) >= a.n_chunks) {     // an empty graph
    const int b = a.empty[blockIdx.x - a.n_chunks];
    float* o = a.out + b * d3 + col0;
    for (int ch = tid; ch < dc; ch += kThreads) {
      o[ch] = 0.f;
      o[a.d + ch] = 0.f;
      o[2 * a.d + ch] = 0.f;
      if (kTrain && a.ties) {
        a.ties[static_cast<long long>(b) * a.d + col0 + ch] = 0.f;
      }
    }
    if (kTrain && a.stats && y == 0 && tid == 0) {
      a.stats[2 * b] = 0.f;
      a.stats[2 * b + 1] = 0.f;
    }
    return;
  }

  const int c = blockIdx.x;
  const int b = a.chunk_graph[c];
  const int beg = a.chunk_start[c];
  const int len = a.chunk_end[c] - beg;
  const float* xb = a.x + col0;
  const int step = NS * a.depth;

  // the first rows of this sub-warp, loaded before the scores' reductions
  float v[DEPTH][CPL];
#pragma unroll
  for (int r = 0; r < DEPTH; ++r) {
    const int j = sigma + NS * r;
    if (r < a.depth && j < len) {
      load<L, CPL, false>(v[r], xb + static_cast<long long>(beg + j) * a.d,
                          a.vec, lam, dc);
    }
  }

  // 1. the chunk's scores: its max, each node's weight, their sum
  const float s = tid < len ? a.score[beg + tid] : -INFINITY;
  const float mc = block_max(s, red);
  const float mu = isfinite(mc) ? mc : 0.f;
  const float p = tid < len ? expf(s - mu) : 0.f;
  sm_p[tid] = kTrain && a.keep && tid < len ? __fmul_rn(p, a.keep[beg + tid])
                                            : p;
  const float lc = block_sum(p, red);   // its barriers publish sm_p

  // 2. the node walk: node j of the chunk is sub-warp j mod NS's
  Acc<CPL> acc;
  acc.reset();
  for (int j0 = sigma; j0 < len; j0 += step) {
#pragma unroll
    for (int r = 0; r < DEPTH; ++r) {
      const int j = j0 + NS * r;
      if (r < a.depth && j < len) {
        const float wj = sm_p[j];
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          acc.w[k] = __fmaf_rn(wj, v[r][k], acc.w[k]);
          acc.s[k] = __fadd_rn(acc.s[k], v[r][k]);
          if (kTrain) {
            merge_max(acc.x[k], acc.c[k], v[r][k], 1.f);
          } else {
            acc.x[k] = fmaxf(acc.x[k], v[r][k]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < DEPTH; ++r) {
      const int j = j0 + step + NS * r;
      if (r < a.depth && j < len) {
        load<L, CPL, false>(v[r],
                            xb + static_cast<long long>(beg + j) * a.d,
                            a.vec, lam, dc);
      }
    }
  }
  // (a lane's registers past its columns hold zeros and the max of zeros:
  // they are never staged)

  // the sub-warps of a warp, then the warps: the chunk's partial
  acc.template reduce_subwarps<L, kTrain>();
  if (sw == 0) stage<L, CPL, kTrain>(acc, a.vec, lam, dc, warp, sm_w, sm_s,
                                     sm_x, sm_c);
  __syncthreads();
  float* prow = a.part + static_cast<long long>(c) * a.pw;
  const int h = 4 * a.ny;            // the column blocks' (m, l) first
  for (int ch = tid; ch < dc; ch += kThreads) {
    float x_max = sm_x[0][ch];
    float x_cnt = kTrain ? sm_c[ch] : 0.f;
    for (int w = 1; w < kWarps; ++w) {
      if (kTrain) {
        merge_max(x_max, x_cnt, sm_x[w][ch], sm_c[w * kMaxD + ch]);
      } else {
        x_max = fmaxf(x_max, sm_x[w][ch]);
      }
    }
    prow[h + col0 + ch] = tree8(sm_w, ch);
    prow[h + a.dp + col0 + ch] = tree8(sm_s, ch);
    prow[h + 2 * a.dp + col0 + ch] = x_max;
    if (kTrain) prow[h + 3 * a.dp + col0 + ch] = x_cnt;
  }
  if (tid == 0) {     // each column block its own copy: no block reads
    prow[4 * y] = mc;     // another's before that one has taken its ticket
    prow[4 * y + 1] = lc;
  }

  // 3. the last block of graph b (column block y) combines its chunks
  __threadfence();
  __syncthreads();
  const int c0 = a.chunk_ptr[b];
  const int nb = a.chunk_ptr[b + 1] - c0;
  if (tid == 0) {
    const unsigned t =
        atomicInc(a.ticket + static_cast<long long>(b) * a.ny + y, nb - 1);
    is_last = t == static_cast<unsigned>(nb - 1);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* part0 = a.part + static_cast<long long>(c0) * a.pw;
  float gm = -INFINITY;
  for (int k = tid; k < nb; k += kThreads) {
    gm = fmaxf(gm, __ldcg(part0 + static_cast<long long>(k) * a.pw + 4 * y));
  }
  gm = block_max(gm, red);
  const float gmu = isfinite(gm) ? gm : 0.f;
  acc.reset();
  float lsum = 0.f;
  // strand sigma adds chunks sigma, sigma + NS, ... in order
#pragma unroll 2
  for (int k = sigma; k < nb; k += NS) {
    const float* q = part0 + static_cast<long long>(k) * a.pw;
    float vw[CPL], vs[CPL], vx[CPL], vc[CPL];
    load<L, CPL, true>(vw, q + h + col0, a.vec, lam, dc);
    load<L, CPL, true>(vs, q + h + a.dp + col0, a.vec, lam, dc);
    load<L, CPL, true>(vx, q + h + 2 * a.dp + col0, a.vec, lam, dc);
    if (kTrain) {
      load<L, CPL, true>(vc, q + h + 3 * a.dp + col0, a.vec, lam, dc);
    }
    const float m_k = __ldcg(q + 4 * y);
    const float f = expf((isfinite(m_k) ? m_k : 0.f) - gmu);
    lsum = __fmaf_rn(__ldcg(q + 4 * y + 1), f, lsum);
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      acc.w[r] = __fmaf_rn(vw[r], f, acc.w[r]);
      acc.s[r] = __fadd_rn(acc.s[r], vs[r]);
      if (kTrain) {
        merge_max(acc.x[r], acc.c[r], vx[r], vc[r]);
      } else {
        acc.x[r] = fmaxf(acc.x[r], vx[r]);
      }
    }
  }
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
    lsum = __fadd_rn(lsum, __shfl_xor_sync(kFull, lsum, off));
  }
  acc.template reduce_subwarps<L, kTrain>();
  __syncthreads();     // block_max's readers of red are done
  if (sw == 0) {
    if (lam == 0) red[warp] = lsum;
    stage<L, CPL, kTrain>(acc, a.vec, lam, dc, warp, sm_w, sm_s, sm_x, sm_c);
  }
  __syncthreads();
  const float l = tree8(red);
  const float count = static_cast<float>(a.graph_ptr[b + 1] - a.graph_ptr[b]);
  float* o = a.out + b * d3 + col0;
  for (int ch = tid; ch < dc; ch += kThreads) {
    float x_max = sm_x[0][ch];
    float x_cnt = kTrain ? sm_c[ch] : 0.f;
    for (int w = 1; w < kWarps; ++w) {
      if (kTrain) {
        merge_max(x_max, x_cnt, sm_x[w][ch], sm_c[w * kMaxD + ch]);
      } else {
        x_max = fmaxf(x_max, sm_x[w][ch]);
      }
    }
    o[ch] = tree8(sm_s, ch) / fmaxf(count, 1.f);
    o[a.d + ch] = isfinite(x_max) ? x_max : 0.f;
    o[2 * a.d + ch] = tree8(sm_w, ch) / (l + 1e-16f);
    if (kTrain && a.ties) {
      a.ties[static_cast<long long>(b) * a.d + col0 + ch] = x_cnt;
    }
  }
  if (kTrain && a.stats && y == 0 && tid == 0) {
    a.stats[2 * b] = gmu;
    a.stats[2 * b + 1] = l;
  }
}

template <int L, int CPL>
int launch(bool train, const Args& a, dim3 grid, cudaStream_t s) {
  auto kernel = train ? graph_pool_kernel<L, CPL, true>
                      : graph_pool_kernel<L, CPL, false>;
  kernel<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// graph_ptr (B+1), chunk_ptr (B+1: the chunks of graph b), chunk_start /
// chunk_end / chunk_graph (n_chunks), empty (n_empty: the graphs with no
// node), x (N, d), score (N,), keep (N,) or null; lanes (1, 2, ..., 32: the
// sub-warp, kernels.k10_lanes of d) and cpl (4, or 8 where a column block
// is wider than 128: kernels.k10_cpl), vec (4: float4 loads, which needs d a
// multiple of 4 and x 16-byte aligned; 1: scalar loads), depth (rows loaded
// ahead: 1, 2, 4, or 8 with cpl 4): no choice of vec or depth changes the
// bits.  part (n_chunks, 4 ny + 4 dp) scratch with ny = ceil(d / 256) and
// dp = d rounded up to a multiple of 4 (kernels.k10_part_width), ticket (B,
// ny) unsigned scratch that is 0 at the call and again after it (one call at
// a time: one stream's eager calls, or one call site of a captured CUDA
// graph); out (B, 3 d), stats (B, 2) or null, ties (B, d) or null.  Any d
// >= 1.  Returns the launch's cudaGetLastError() code.
extern "C" int ltr_graph_pool(const void* graph_ptr, const void* chunk_ptr,
                              const void* chunk_start, const void* chunk_end,
                              const void* chunk_graph, const void* empty,
                              int n_empty, const void* x, const void* score,
                              const void* keep, int n_graphs, int n_chunks,
                              int d, int lanes, int cpl, int vec, int depth,
                              void* part, void* ticket, void* out,
                              void* stats, void* ties, void* stream) {
  const int cols = d < kMaxD ? d : kMaxD;
  if (d < 1 || (vec != 1 && vec != 4) || (vec == 4 && d % 4 != 0) ||
      (cpl != 4 && cpl != 8) || lanes * cpl < cols ||
      (depth != 1 && depth != 2 && depth != 4 && depth != 8) ||
      depth * cpl > kBuf ||
      (n_chunks > 0 && (part == nullptr || ticket == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_graphs <= 0 || n_chunks + n_empty <= 0) return 0;
  const int ny = (d + kMaxD - 1) / kMaxD;
  const int dp = (d + 3) / 4 * 4;
  const Args a{static_cast<const int*>(graph_ptr),
               static_cast<const int*>(chunk_ptr),
               static_cast<const int*>(chunk_start),
               static_cast<const int*>(chunk_end),
               static_cast<const int*>(chunk_graph),
               static_cast<const int*>(empty),
               static_cast<const float*>(x),
               static_cast<const float*>(score),
               static_cast<const float*>(keep),
               n_chunks, d, dp, 4 * ny + 4 * dp, vec, depth, ny,
               static_cast<float*>(part), static_cast<unsigned*>(ticket),
               static_cast<float*>(out), static_cast<float*>(stats),
               static_cast<float*>(ties)};
  const bool train = keep || stats || ties;
  const dim3 grid(n_chunks + n_empty, ny);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K10_CASE(LL, CC) \
  if (lanes == LL && cpl == CC) return launch<LL, CC>(train, a, grid, s);
  K10_CASE(1, 4) K10_CASE(2, 4) K10_CASE(4, 4) K10_CASE(8, 4)
  K10_CASE(16, 4) K10_CASE(32, 4) K10_CASE(32, 8)
#undef K10_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
