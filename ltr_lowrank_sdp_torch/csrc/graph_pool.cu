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
// (B, 3D): a handful of flops per 4-byte element.
//
// Design: at inference B = 1 and N reaches 85,080, so one block per graph
// would leave the card idle.  The host cuts every graph into chunks of at
// most kChunk nodes (a chunk never spans two graphs).  The first launch runs
// one block per chunk: each warp walks every 8th node of the chunk, lanes over
// channels, with an online (running-max) softmax; the eight warps are then
// combined in warp order through shared memory into one partial per chunk
// (max score, exp-sum, weighted sum, sum, max, count at the max).  The second launch runs one
// block per graph and combines its chunks' partials in chunk order.  No
// atomics: the same bits on every call.  A graph with no node writes zeros.
//
// Width: the first launch's blocks also split D into column blocks of at
// most kMaxD = 256 (blockIdx.y), each a block of its own over the chunk's
// nodes, reading its columns of the full rows in place.  The attention score
// is one column shared by every column block: each computes the same
// softmax (m, l) with the same bits, and column block 0 writes it; the max
// and its ties, the sums and the keep-scale follow the column.  Each lane
// holds kPerLane channels of its column block (lane, lane + 32, ...), a
// template instantiated for kPerLane = 4 (D <= 128) and 8 (D > 128).  The
// chunk kernel's shared arrays come to 8 warps x kPerLane x 32 channels x 4
// bytes each, 32 KiB for the four of training at a 256-column block, under
// the 48 KiB of static shared memory a block may use.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxD = 256;         // 8 channels per lane

// partial layout per chunk: [m, l, wsum (D), xsum (D), xmax (D)], and xcnt
// (D) in training; the serve path keeps the shorter stride
template <bool kTrain>
__device__ __forceinline__ int part_width(int d) {
  return 2 + (kTrain ? 4 : 3) * d;
}

// (max, count at the max) of two (max, count) pairs
__device__ __forceinline__ void merge_max(float& xm, float& xc, float om,
                                          float oc) {
  if (om > xm) {
    xm = om;
    xc = oc;
  } else if (om == xm) {
    xc += oc;
  }
}

// kTrain compiles the keep-scale, the tie counts and the stats in; the serve
// path's instances have none of them, so they keep their registers, shared
// memory and speed.
template <int kPerLane, bool kTrain>
__global__ void graph_pool_chunks_kernel(const int* __restrict__ chunk_start,
                                         const int* __restrict__ chunk_end,
                                         const float* __restrict__ x,
                                         const float* __restrict__ score,
                                         const float* __restrict__ keep,
                                         int d, float* __restrict__ part) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  constexpr int kD = 32 * kPerLane;
  static_assert((kTrain ? 4 : 3) * kWarps * kD * sizeof(float) <= 48 * 1024,
                "static shared memory of a block");
  __shared__ float sm_w[kWarps][kD];
  __shared__ float sm_s[kWarps][kD];
  __shared__ float sm_x[kWarps][kD];
  __shared__ float sm_c[kTrain ? kWarps : 1][kTrain ? kD : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const int col0 = blockIdx.y * kMaxD;     // this block's first column
  const int dc = min(kMaxD, d - col0);     // and its columns
  const int beg = chunk_start[c];
  const int end = chunk_end[c];
  float m = -INFINITY;
  float l = 0.f;
  float ws[kPerLane];
  float xs[kPerLane];
  float xm[kPerLane];
  float xc[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    ws[k] = 0.f;
    xs[k] = 0.f;
    xm[k] = -INFINITY;
    xc[k] = 0.f;
  }
  for (int node = beg + warp; node < end; node += kWarps) {
    const float s = score[node];
    const float m_new = fmaxf(m, s);
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    const float scale = expf(m - mu);
    const float p = expf(s - mu);
    const float pk = kTrain && keep ? p * keep[node] : p;
    l = l * scale + p;
    const float* row = x + static_cast<long long>(node) * d + col0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int ch = lane + 32 * k;
      if (ch < dc) {
        const float v = row[ch];
        ws[k] = ws[k] * scale + pk * v;
        xs[k] += v;
        if (kTrain) {
          merge_max(xm[k], xc[k], v, 1.f);
        } else {
          xm[k] = fmaxf(xm[k], v);
        }
      }
    }
    m = m_new;
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int ch = lane + 32 * k;
    if (ch < dc) {
      sm_w[warp][ch] = ws[k];
      sm_s[warp][ch] = xs[k];
      sm_x[warp][ch] = xm[k];
      if (kTrain) sm_c[warp][ch] = xc[k];
    }
  }
  __syncthreads();
  float mt = -INFINITY;
  for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w]);
  const float mu = mt == -INFINITY ? 0.f : mt;
  float* out = part + static_cast<long long>(c) * part_width<kTrain>(d) +
               col0;
  for (int ch = threadIdx.x; ch < dc; ch += blockDim.x) {
    float w_sum = 0.f;
    float x_sum = 0.f;
    float x_max = -INFINITY;
    float x_cnt = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      w_sum += sm_w[w][ch] * expf(sm_m[w] - mu);
      x_sum += sm_s[w][ch];
      if (kTrain) {
        merge_max(x_max, x_cnt, sm_x[w][ch], sm_c[w][ch]);
      } else {
        x_max = fmaxf(x_max, sm_x[w][ch]);
      }
    }
    out[2 + ch] = w_sum;
    out[2 + d + ch] = x_sum;
    out[2 + 2 * d + ch] = x_max;
    if (kTrain) out[2 + 3 * d + ch] = x_cnt;
  }
  if (threadIdx.x == 0 && blockIdx.y == 0) {
    float l_sum = 0.f;
    for (int w = 0; w < kWarps; ++w) l_sum += sm_l[w] * expf(sm_m[w] - mu);
    out[0] = mt;
    out[1] = l_sum;
  }
}

template <bool kTrain>
__global__ void graph_pool_combine_kernel(const int* __restrict__ graph_ptr,
                                          const int* __restrict__ chunk_ptr,
                                          const float* __restrict__ part,
                                          int d, float* __restrict__ out,
                                          float* __restrict__ stats,
                                          float* __restrict__ ties) {
  const int b = blockIdx.x;
  const int c0 = chunk_ptr[b];
  const int c1 = chunk_ptr[b + 1];
  const float count = static_cast<float>(graph_ptr[b + 1] - graph_ptr[b]);
  const int pw = part_width<kTrain>(d);
  float* o = out + static_cast<long long>(b) * 3 * d;
  for (int ch = threadIdx.x; ch < d; ch += blockDim.x) {
    float m = -INFINITY;
    float l = 0.f;
    float w_sum = 0.f;
    float x_sum = 0.f;
    float x_max = -INFINITY;
    float x_cnt = 0.f;
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
      if (kTrain) {
        merge_max(x_max, x_cnt, p[2 + 2 * d + ch], p[2 + 3 * d + ch]);
      } else {
        x_max = fmaxf(x_max, p[2 + 2 * d + ch]);
      }
      m = m_new;
    }
    o[ch] = x_sum / fmaxf(count, 1.f);
    o[d + ch] = isfinite(x_max) ? x_max : 0.f;
    o[2 * d + ch] = w_sum / (l + 1e-16f);
    if (kTrain && ties) ties[static_cast<long long>(b) * d + ch] = x_cnt;
    if (kTrain && stats && ch == 0) {
      stats[2 * b] = m == -INFINITY ? 0.f : m;
      stats[2 * b + 1] = l;
    }
  }
}

}  // namespace

// graph_ptr (B+1), chunk_ptr (B+1: the chunks of graph b), chunk_start /
// chunk_end (n_chunks), x (N, d), score (N,), keep (N,) or null, part
// (n_chunks, 2 + 4 d) scratch (the serve path uses 2 + 3 d of each row's
// room), out (B, 3 d), stats (B, 2) or null, ties (B, d) or null.  Any d >=
// 1.  Returns the cudaGetLastError() code of the launches.
extern "C" int ltr_graph_pool(const void* graph_ptr, const void* chunk_ptr,
                              const void* chunk_start, const void* chunk_end,
                              const void* x, const void* score,
                              const void* keep, int n_graphs, int n_chunks,
                              int d, void* part, void* out, void* stats,
                              void* ties, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_graphs <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool train = keep || stats || ties;
  if (n_chunks > 0) {
    auto chunks = d <= 128 ? (train ? graph_pool_chunks_kernel<4, true>
                                    : graph_pool_chunks_kernel<4, false>)
                           : (train ? graph_pool_chunks_kernel<8, true>
                                    : graph_pool_chunks_kernel<8, false>);
    const dim3 grid(n_chunks, (d + kMaxD - 1) / kMaxD);
    chunks<<<grid, kWarps * 32, 0, s>>>(
        static_cast<const int*>(chunk_start),
        static_cast<const int*>(chunk_end), static_cast<const float*>(x),
        static_cast<const float*>(score), static_cast<const float*>(keep), d,
        static_cast<float*>(part));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = d < 32 ? 32 : d > 1024 ? 1024 : ((d + 31) / 32) * 32;
  auto combine = train ? graph_pool_combine_kernel<true>
                       : graph_pool_combine_kernel<false>;
  combine<<<n_graphs, threads, 0, s>>>(
      static_cast<const int*>(graph_ptr), static_cast<const int*>(chunk_ptr),
      static_cast<const float*>(part), d, static_cast<float*>(out),
      static_cast<float*>(stats), static_cast<float*>(ties));
  return static_cast<int>(cudaGetLastError());
}
