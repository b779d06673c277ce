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
// max) + 1e-16), so that alpha_e = exp(s_e - lse), and scores (E', H),
// optional, receives every s_e in the CSR's slot order: the backward kernel
// K11 (gatv2_softmax_agg_bwd.cu) forms alpha from the two.  K11 takes this
// kernel's own float32 s_e rather than its own evaluation of them: sum_e ds_e
// = 0 over a destination's slots holds to rounding only where K11's alpha
// are the ones that made out, and an s_e evaluated in another order or
// precision parts from this one by the rounding of its H C-term sum (at 128
// channels a head that tripled the error of d_w_dst).  The serve path passes
// none of the three.
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
// The sum order, fixed by the shapes.  A node's edges are cut into tiles of
// kTile = 4 consecutive edges counted from its first edge.  A tile's scores
// give its max m_t (exact in any order) and p_e = exp(s_e - m_t); the tile's
// sums l_t = sum p_e and a_t = sum p_e keep_e w_src[j] are the fixed tree
// (e0 + e1) + (e2 + e3) of terms rounded one by one; the tiles are merged
// into the running (m, l, acc) in tile order, one rescale a tile (two exps)
// instead of one an edge.  A score is each lane's P channels fused in order,
// then an xor tree over the head's lanes.  Every operation is written as an
// explicit round-to-nearest intrinsic, so no instance contracts it
// differently: every launch plan below gives the same bits.
//
// The launch plan (kernels.k9_plan, from heads and channels alone): lph lanes
// a head (a power of two) with P = 4 channels a lane (8 past 128 channels a
// head); hpg = 32 / lph heads a group and ceil(heads / hpg) groups a node, one
// warp each, so every width whose heads have at most 256 channels runs (a
// group's heads never need anything from another group's: each head's
// softmax is its own).  A group narrower than the warp cuts it into S
// sub-warps (S = 32 / its lanes rounded up to a power of two, at most 4) that
// take different edges of one tile, 4 / S each, and add their tile sums by
// the xor tree that is the tile's tree.  B tiles' (src, erow) pairs and then
// their w_src / we rows are loaded before any arithmetic on them (clamped,
// valid addresses; only the adds are guarded), with float4 / float2 loads
// where a head's channels (and so every lane's first channel) are a multiple
// of 4 / 2 and the pointers aligned (V = 4, 2; V = 1 scalar otherwise).  No
// atomics: the same bits on every call.  The training instance (kTrain: the
// keep-scale and lse) and the serve instance are separate, so serve does not
// pay training's registers.

#include <cuda_runtime.h>
#include <math.h>


namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 4;                   // edges a tile
constexpr unsigned kFull = 0xffffffffu;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

// P floats from p (V at a time, p aligned to V floats): vector k whose
// first channel is at or past cnt reads vector 0 instead (a valid address),
// which the caller never adds.
template <int V, int P>
__device__ __forceinline__ void load_row(const float* __restrict__ p, int cnt,
                                         float (&dst)[P]) {
  using T = typename Vec<V>::T;
#pragma unroll
  for (int k = 0; k < P / V; ++k) {
    const int off = k * V < cnt ? k * V : 0;
    const T v = __ldg(reinterpret_cast<const T*>(p + off));
    const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
    for (int c = 0; c < V; ++c) dst[k * V + c] = f[c];
  }
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : __fmul_rn(slope, v);
}

// The sum over a tile of one term an edge (a sub-warp holds ES = kTile / S
// edges): the local part of (e0 + e1) + (e2 + e3), then the xor tree over
// the S sub-warps of L lanes that completes it.
template <int ES, int S>
__device__ __forceinline__ float tile_sum(const float (&t)[ES]) {
  float v;
  if constexpr (ES == 4) {
    v = __fadd_rn(__fadd_rn(t[0], t[1]), __fadd_rn(t[2], t[3]));
  } else if constexpr (ES == 2) {
    v = __fadd_rn(t[0], t[1]);
  } else {
    v = t[0];
  }
#pragma unroll
  for (int off = 32 / S; off < 32; off <<= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

template <int V, int P, int S, int B, bool kTrain>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) gatv2_softmax_agg_kernel(
    const int* __restrict__ indptr, const int* __restrict__ src,
    const int* __restrict__ erow, const float* __restrict__ w_src,
    const float* __restrict__ w_dst, const float* __restrict__ we,
    const float* __restrict__ we_loop, const float* __restrict__ att,
    const float* __restrict__ keep, int n, int n_real, int heads, int ch,
    int lph, int hpg, int groups, float slope, float* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ scores) {
  constexpr int L = 32 / S;                // lanes a sub-warp
  constexpr int ES = kTile / S;            // edges of a tile a sub-warp takes
  const int lane = threadIdx.x & 31;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(n) * groups) return;
  const long long i = w / groups;
  const int g = static_cast<int>(w % groups);
  const int hc = heads * ch;
  const int sub = lane / L;
  const int lin = lane % L;
  const int hl = lin / lph;
  const int q = (lin % lph) * P;           // first channel within the head
  const int head = g * hpg + hl;
  const bool live = hl < hpg && head < heads;
  const int cnt = live ? max(0, min(P, ch - q)) : 0;
  const int c0 = cnt > 0 ? head * ch + q : 0;   // a valid channel
  const int hs = live ? head : 0;              // a valid head
  float xd[P], a[P], acc[P];
  load_row<V, P>(w_dst + i * hc + c0, cnt, xd);
  load_row<V, P>(att + c0, cnt, a);
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  const int beg = indptr[i];
  const int end = indptr[i + 1];
  for (int base = beg; base < end; base += 32) {
    const int cnt_e = min(32, end - base);
    const int mine = base + min(lane, cnt_e - 1);
    const int my_src = src[mine];
    const int my_row = erow[mine];
    const int tiles = (cnt_e + kTile - 1) / kTile;
    for (int t0 = 0; t0 < tiles; t0 += B) {     // uniform across the warp
      // the batch's rows, all loaded before their arithmetic
      float xs[B][ES][P], ev[B][ES][P], kp[B][ES];
#pragma unroll
      for (int b = 0; b < B; ++b) {
#pragma unroll
        for (int j = 0; j < ES; ++j) {
          const int k = min((t0 + b) * kTile + sub * ES + j, cnt_e - 1);
          const int jj = __shfl_sync(kFull, my_src, k);
          const int r = __shfl_sync(kFull, my_row, k);
          const float* ev_row =
              r < n_real ? we + static_cast<long long>(r) * hc : we_loop;
          load_row<V, P>(w_src + static_cast<long long>(jj) * hc + c0, cnt,
                         xs[b][j]);
          load_row<V, P>(ev_row + c0, cnt, ev[b][j]);
          kp[b][j] = kTrain && keep
                         ? keep[static_cast<long long>(base + k) * heads + hs]
                         : 1.f;
        }
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        float s[ES];
#pragma unroll
        for (int j = 0; j < ES; ++j) {
          float v = 0.f;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (p < cnt) {
              const float msg = __fadd_rn(__fadd_rn(xs[b][j][p], xd[p]),
                                          ev[b][j][p]);
              v = __fmaf_rn(a[p], leaky(msg, slope), v);
            }
          }
          for (int off = lph >> 1; off > 0; off >>= 1) {
            v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
          }
          const int te = (t0 + b) * kTile + sub * ES + j;
          s[j] = te < cnt_e ? v : -INFINITY;
          if (kTrain && scores && live && q == 0 && te < cnt_e) {
            scores[static_cast<long long>(base + te) * heads + head] = v;
          }
        }
        // the tile's max over its four edges, on every sub-warp
        float mt = s[0];
#pragma unroll
        for (int j = 1; j < ES; ++j) mt = fmaxf(mt, s[j]);
#pragma unroll
        for (int off = L; off < 32; off <<= 1) {
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
        }
        // a segment whose scores are all -inf adds 0, as the reference's
        // isfinite guard on the segment max does (a tile past the node's
        // edges is such a tile, on every lane of the warp)
        const float mu_t = mt == -INFINITY ? 0.f : mt;
        float pe[ES], pk[ES];
#pragma unroll
        for (int j = 0; j < ES; ++j) {
          pe[j] = expf(s[j] - mu_t);
          pk[j] = kTrain && keep ? __fmul_rn(pe[j], kp[b][j]) : pe[j];
        }
        const float lt = tile_sum<ES, S>(pe);
        float at[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float t[ES];
#pragma unroll
          for (int j = 0; j < ES; ++j) t[j] = __fmul_rn(pk[j], xs[b][j][p]);
          at[p] = tile_sum<ES, S>(t);
        }
        if (mt != -INFINITY) {
          const float m_new = fmaxf(m, mt);
          const float scale = expf(m - m_new);
          const float f_t = expf(mu_t - m_new);
          l = __fadd_rn(__fmul_rn(l, scale), __fmul_rn(lt, f_t));
#pragma unroll
          for (int p = 0; p < P; ++p) {
            acc[p] = __fadd_rn(__fmul_rn(acc[p], scale), __fmul_rn(at[p], f_t));
          }
          m = m_new;
        }
      }
    }
  }
  const float inv = __frcp_rn(__fadd_rn(l, 1e-16f));
  if (sub == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p < cnt) out[i * hc + c0 + p] = __fmul_rn(acc[p], inv);
    }
    if (kTrain && lse && live && q == 0) {
      lse[i * heads + head] = (m == -INFINITY ? 0.f : m) + logf(l + 1e-16f);
    }
  }
}

// A head of more than 256 channels: one warp a (node, head), the head's
// channels walked in passes of kPass = 256 (8 a lane).  A tile's scores are
// each lane's passes fused in order, then the xor tree over the 32 lanes;
// its sums are the narrow kernel's tree; the running acc of each pass lives
// in the warp's own row of out (read, rescaled and written back a tile: no
// register bound on the width), and the tile's w_src rows are read again
// for the sums.
constexpr int kPass = 256;

template <int V, bool kTrain>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gatv2_softmax_agg_wide_kernel(
    const int* __restrict__ indptr, const int* __restrict__ src,
    const int* __restrict__ erow, const float* __restrict__ w_src,
    const float* __restrict__ w_dst, const float* __restrict__ we,
    const float* __restrict__ we_loop, const float* __restrict__ att,
    const float* __restrict__ keep, int n, int n_real, int heads, int ch,
    float slope, float* __restrict__ out, float* __restrict__ lse,
    float* __restrict__ scores) {
  constexpr int P = 8;
  const int lane = threadIdx.x & 31;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(n) * heads) return;
  const long long i = w / heads;
  const int head = static_cast<int>(w % heads);
  const int hc = heads * ch;
  const int passes = (ch + kPass - 1) / kPass;
  const long long row0 = static_cast<long long>(head) * ch;
  float* orow = out + i * hc + row0;
  float m = -INFINITY;
  float l = 0.f;
  const int beg = indptr[i];
  const int end = indptr[i + 1];
  for (int base = beg; base < end; base += 32) {
    const int cnt_e = min(32, end - base);
    const int mine = base + min(lane, cnt_e - 1);
    const int my_src = src[mine];
    const int my_row = erow[mine];
    for (int t0 = 0; t0 < cnt_e; t0 += kTile) {
      const float* xs_row[kTile];
      const float* ev_row[kTile];
      float kp[kTile], s[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int k = min(t0 + j, cnt_e - 1);
        const int jj = __shfl_sync(kFull, my_src, k);
        const int r = __shfl_sync(kFull, my_row, k);
        xs_row[j] = w_src + static_cast<long long>(jj) * hc + row0;
        ev_row[j] =
            (r < n_real ? we + static_cast<long long>(r) * hc : we_loop) +
            row0;
        kp[j] = kTrain && keep
                    ? keep[static_cast<long long>(base + k) * heads + head]
                    : 1.f;
        s[j] = 0.f;
      }
      for (int c = 0; c < passes; ++c) {
        const int q = c * kPass + lane * P;
        const int cnt = max(0, min(P, ch - q));
        const int qc = cnt > 0 ? q : 0;
        float xd[P], a[P], xs[kTile][P], ev[kTile][P];
        load_row<V, P>(w_dst + i * hc + row0 + qc, cnt, xd);
        load_row<V, P>(att + row0 + qc, cnt, a);
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          load_row<V, P>(xs_row[j] + qc, cnt, xs[j]);
          load_row<V, P>(ev_row[j] + qc, cnt, ev[j]);
        }
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (p < cnt) {
              const float msg = __fadd_rn(__fadd_rn(xs[j][p], xd[p]),
                                          ev[j][p]);
              s[j] = __fmaf_rn(a[p], leaky(msg, slope), s[j]);
            }
          }
        }
      }
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s[j] = __fadd_rn(s[j], __shfl_xor_sync(kFull, s[j], off));
        }
        if (kTrain && scores && lane == 0 && t0 + j < cnt_e) {
          scores[static_cast<long long>(base + t0 + j) * heads + head] = s[j];
        }
        s[j] = t0 + j < cnt_e ? s[j] : -INFINITY;
        mt = fmaxf(mt, s[j]);
      }
      if (mt == -INFINITY) continue;       // uniform across the warp
      float pe[kTile], pk[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        pe[j] = expf(s[j] - mt);
        pk[j] = kTrain && keep ? __fmul_rn(pe[j], kp[j]) : pe[j];
      }
      const float lt = tile_sum<kTile, 1>(pe);
      const float m_new = fmaxf(m, mt);
      const float scale = expf(m - m_new);
      const float f_t = expf(mt - m_new);
      for (int c = 0; c < passes; ++c) {
        const int q = c * kPass + lane * P;
        const int cnt = max(0, min(P, ch - q));
        const int qc = cnt > 0 ? q : 0;
        float xs[kTile][P];
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          load_row<V, P>(xs_row[j] + qc, cnt, xs[j]);
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float t[kTile];
#pragma unroll
          for (int j = 0; j < kTile; ++j) t[j] = __fmul_rn(pk[j], xs[j][p]);
          const float at = tile_sum<kTile, 1>(t);
          if (p < cnt) {
            const float old = m == -INFINITY ? 0.f : orow[q + p];
            orow[q + p] = __fadd_rn(__fmul_rn(old, scale), __fmul_rn(at, f_t));
          }
        }
      }
      l = __fadd_rn(__fmul_rn(l, scale), __fmul_rn(lt, f_t));
      m = m_new;
    }
  }
  const float inv = __frcp_rn(__fadd_rn(l, 1e-16f));
  __syncwarp();          // the row's values, written by other lanes of it
  for (int q = lane; q < ch; q += 32) {
    orow[q] = m == -INFINITY ? 0.f : __fmul_rn(orow[q], inv);
  }
  if (kTrain && lse && lane == 0) {
    lse[i * heads + head] = (m == -INFINITY ? 0.f : m) + logf(l + 1e-16f);
  }
}

struct Args {
  const void *indptr, *src, *erow, *w_src, *w_dst, *we, *we_loop, *att,
      *keep;
  int n, n_real, heads, ch, lph, hpg, groups;
  float slope;
  void *out, *lse, *scores;
};

template <int V, int P, int S, int B, bool kTrain>
int launch(const Args& a, cudaStream_t s) {
  const long long warps = static_cast<long long>(a.n) * a.groups;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  gatv2_softmax_agg_kernel<V, P, S, B, kTrain><<<grid, block, 0, s>>>(
      static_cast<const int*>(a.indptr), static_cast<const int*>(a.src),
      static_cast<const int*>(a.erow), static_cast<const float*>(a.w_src),
      static_cast<const float*>(a.w_dst), static_cast<const float*>(a.we),
      static_cast<const float*>(a.we_loop), static_cast<const float*>(a.att),
      static_cast<const float*>(a.keep), a.n, a.n_real, a.heads, a.ch, a.lph,
      a.hpg, a.groups, a.slope, static_cast<float*>(a.out),
      static_cast<float*>(a.lse), static_cast<float*>(a.scores));
  return static_cast<int>(cudaGetLastError());
}

template <int V, int P, int S, int B>
int launch_mode(bool train, const Args& a, cudaStream_t s) {
  return train ? launch<V, P, S, B, true>(a, s)
               : launch<V, P, S, B, false>(a, s);
}

template <int V>
int launch_wide(bool train, const Args& a, cudaStream_t s) {
  const long long warps = static_cast<long long>(a.n) * a.heads;
  const dim3 grid(
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  auto kernel = train ? gatv2_softmax_agg_wide_kernel<V, true>
                      : gatv2_softmax_agg_wide_kernel<V, false>;
  kernel<<<grid, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const int*>(a.indptr), static_cast<const int*>(a.src),
      static_cast<const int*>(a.erow), static_cast<const float*>(a.w_src),
      static_cast<const float*>(a.w_dst), static_cast<const float*>(a.we),
      static_cast<const float*>(a.we_loop), static_cast<const float*>(a.att),
      static_cast<const float*>(a.keep), a.n, a.n_real, a.heads, a.ch,
      a.slope, static_cast<float*>(a.out), static_cast<float*>(a.lse),
      static_cast<float*>(a.scores));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// heads >= 1 and channels >= 1 a head; (lph, hpg, groups) the lanes a head,
// heads a group and groups a node, and (v, p, s, b) the instantiation
// (kernels.k9_plan): every instantiated plan of a shape gives the same bits.
// A head of more than 256 channels takes the wide kernel (p = 0 names it:
// lph = 32, hpg = 1, groups = heads, s = b = 1).
// keep, lse and scores may be null (all null: the serve instance).  The
// wrapper checks shapes and alignment.  Returns the cudaGetLastError() code
// of the launch.
extern "C" int ltr_gatv2_softmax_agg(
    const void* indptr, const void* src, const void* erow, const void* w_src,
    const void* w_dst, const void* we, const void* we_loop, const void* att,
    const void* keep, int n, int n_real, int heads, int channels, int lph,
    int hpg, int groups, int v, int p, int s, int b, float slope, void* out,
    void* lse, void* scores, void* stream) {
  if (n <= 0) return 0;
  // the plan must cover the row: p channels a lane over lph lanes reach the
  // head, hpg heads of lph lanes fit a sub-warp, the groups every head
  if (heads < 1 || channels < 1 || lph < 1 || 32 % lph != 0 || hpg < 1 ||
      s < 1 || 32 % s != 0 || hpg * lph > 32 / s ||
      (p > 0 && p * lph < channels) || groups * hpg < heads ||
      channels % v != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{indptr, src, erow, w_src, w_dst, we, we_loop, att, keep,
               n, n_real, heads, channels, lph, hpg, groups, slope, out, lse,
               scores};
  const bool train = keep || lse || scores;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p == 0) {
    if (channels <= kPass || groups != heads) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return v == 4 ? launch_wide<4>(train, a, st)
                  : v == 2 ? launch_wide<2>(train, a, st)
                           : launch_wide<1>(train, a, st);
  }
#define K9_CASE(VV, PP, SS, BB)                              \
  if (v == VV && p == PP && s == SS && b == BB) {            \
    return launch_mode<VV, PP, SS, BB>(train, a, st);        \
  }
  // the planned launches (b = 1, or 2 at four sub-warps) and their
  // variants: fewer sub-warps, one tile a batch at four, scalar loads
  K9_CASE(4, 4, 1, 1) K9_CASE(4, 4, 2, 1) K9_CASE(4, 4, 4, 2)
  K9_CASE(4, 4, 4, 1) K9_CASE(4, 8, 1, 1)
  K9_CASE(2, 4, 1, 1) K9_CASE(2, 4, 2, 1) K9_CASE(2, 4, 4, 2)
  K9_CASE(2, 8, 1, 1)
  K9_CASE(1, 4, 1, 1) K9_CASE(1, 4, 2, 1) K9_CASE(1, 4, 4, 2)
  K9_CASE(1, 8, 1, 1)
#undef K9_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
