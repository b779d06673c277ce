// K11 gatv2_softmax_agg_bwd: the backward pass of K9 (gatv2_softmax_agg.cu),
// float32.  Given dout (n, H C), the gradient of K9's output, it returns the
// gradients of K9's five inputs.  Per slot e = j -> i of the destination CSR
// (self-loops included) and head h, with msg = w_src[j] + w_dst[i] + we[e]:
//
//   alpha_e  = exp(s_e - lse[i,h])    (K9's lse and K9's own float32 s_e)
//   dalpha_e = keep[e,h] * <dout[i,h,:], w_src[j,h,:]>
//   D_i      = <dout[i,h,:], out[i,h,:]>  (= sum_e alpha_e dalpha_e, keep or not)
//   ds_e     = alpha_e * (dalpha_e - D_i) - [s_e = max_i] sum_e' ds_e' / T_i
//   dmsg_e   = ds_e * att[h,:] * leaky'(msg_e)       (leaky' = 1 where msg >= 0)
//
//   d_w_dst[i]  = sum_e dmsg_e                  d_we[e]  = dmsg_e (a real edge)
//   d_w_src[j]  = sum_{e: src e = j} alpha_e keep[e,h] dout[i] + dmsg_e
//   d_we_loop   = sum over the self-loop slots of dmsg_e
//   d_att[h,:]  = sum_e ds_e * leaky(msg_e)
//
// The last term of ds_e is the gradient that JAX's VJP routes through the
// softmax's stabiliser s - segment_max(s) (gatv2.py:28): destination i's
// sum of the first terms, 0 in exact arithmetic and the rounding of D_i and
// lse otherwise, taken from the T_i slots whose score is i's largest (K9's
// float32 scores).  Without it that rounding stays in d_w_dst, d_att and
// every leaf behind them.
//
// Replaces: the VJP that jax.value_and_grad (train.py:250) takes of
// ltr_lowrank_sdp_tpu/models/gatv2.py segment_softmax (:26-33) and the
// gather / segment_sum aggregation of GATv2Conv.__call__ (:64-96): the
// transposes of its gathers (segment sums over sources and destinations) and
// of its segment sums (gathers), over four materialised (E, H, C) tensors.
//
// Bound on the card: memory.  It must read the inputs of K9 once (the edge
// terms `we`, E rows of 4 H C bytes, are the bulk), lse, out and dout, and
// write d_we (E rows of 4 H C bytes), d_w_src and d_w_dst: about 40 flops
// per edge row element, far below the FP32 ridge point.  The source-side
// sum needs, per slot, a term that only the destination pass can form; an
// (E', H C) float32 row of it per slot, written and read back, was 1.3 GB
// of traffic the bound does not count (657 MB allocated per call on the
// largest dataset graph).
//
// Precision: the per-slot arithmetic runs in float64 on the float32 inputs.
// d_w_dst, d_we_loop and d_att are sums of ds_e terms that cancel (sum_e
// ds_e = 0 over a destination's slots): in float32, rounding ds_e to 1e-7 of
// dalpha or D leaves 1e-4 of such a result, and where every slot's msg has
// one sign the exact result is 0.  In float64 the kernel gives the float64
// evaluation of its inputs to float32 output rounding; the device is bound by
// bytes here, not by its FP64 rate.  The one exception is s_e: the sums
// cancel only where alpha_e are the weights K9 aggregated with, so K9 hands
// its own float32 scores on (one float a slot and head) and alpha_e is exp
// of them less K9's lse (a float64 s_e evaluated here doubled to
// quintupled the error of those sums against the float64 chain).  d_w_src's
// terms do not cancel that way, so the destination pass hands them on in
// float32: alpha_e keep_e and ds_e, one float2 per slot and head, and the
// signs of msg_e, one bit per channel.
//
// Design: two launches, no atomics, the same bits on every call.
//  1. The destination pass: one warp per destination, a grid of the blocks
//     that fit the card at once (kernels.k11_max_blocks, from the occupancy
//     query ltr_gatv2_softmax_agg_bwd_resident) walking them with a stride.  The warp is
//     cut into S sub-warps of L = 32 / S lanes (kernels.k11_plan: S = 4 or
//     2 where K9's layout would leave a lane one or two channels, else 1);
//     a sub-warp takes one slot a step, with K9's head split inside it (hw
//     = lph / S lanes a head, P channels a lane, the head dots reduced by
//     xor shuffles within the head's lanes).  So the per-slot work (its
//     indices, exp, head sums, stores) is spread over fewer lanes, each
//     with more channels.  The lanes load 32 (src, erow) pairs at a time;
//     then, for a batch of 4 / P steps, every w_src / we row and keep value
//     is loaded (at a valid address: a loop slot's row is we_loop) one
//     batch ahead, while the previous batch's messages (kept in float64),
//     head sums and exps are formed.  (Loading ahead in the source
//     pass as well was slower at the training shape.)
//     The values a lane uses at every slot (att, w_dst[i], dout[i]) are
//     widened to float64 once per destination.  It writes the rows d_we[e]
//     (each owned by one sub-warp, written once) and, per slot, the float2
//     (alpha keep, ds) of each head and the slot's msg signs, L bits a
//     channel slot p of the sub-warp's lanes (one __ballot_sync a p).  The
//     sub-warps' sums for d_w_dst[i], and at the end for d_att and
//     d_we_loop, are added by an xor tree over the sub-warps; d_att and
//     d_we_loop are then combined over the block's warps in warp order into
//     one partial per block.
//  2. The source pass: one warp per source node, same lanes, walks a CSR
//     over sources (src_ptr, and per slot src_slot and src_dst, in
//     increasing slot order: sub-warp s takes slots s, s + S, ...) and sums
//     (alpha keep) dout[i] + ds att leaky'(sign) in float64 into d_w_src,
//     the sub-warps' sums added as above.  Its last ceil(2 H C / 32) blocks
//     add the destination pass's block partials instead: warp w the
//     partials w, w + 8, ... in order, then the 8 warp sums in order, lanes
//     over 32 columns.
// Widths: a call takes one group of heads whose lanes fit a warp (a power
// of two of heads, at most 8 channels a lane); a wider layer is cut into
// such groups on the host (kernels.k11_groups), one call each, reading and
// writing the group's columns of the full rows in place (ld, lds), so no
// input is copied.  Each head's terms are its own: the split, fixed by the
// shape, changes no bit.
// Scratch: E' (8 H + 4 ceil(P L / 32)) bytes and the partials, against E' 4
// H C for a row a slot: 103 MB instead of 657 MB on the largest dataset
// graph.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;

// Steps a batch whose rows are loaded before their arithmetic: 4 float64
// messages a lane (4 steps at P = 1, 2 at P = 2, 1 beyond).  Larger
// batches cost more registers than they hide latency.
template <int P>
__host__ __device__ constexpr int batch_steps() {
  return 4 / P < 1 ? 1 : 4 / P;
}

// 32-bit words of msg signs a slot: P fields of L = 32 / S lane bits.
template <int P, int S>
__host__ __device__ constexpr int sign_words() {
  return (P * (32 / S) + 31) / 32;
}

// The sum over the w lanes of a head (w a power of two) by an xor tree.
__device__ __forceinline__ double head_sum(double v, int w) {
  for (int off = w >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// The sum of a lane's value over the S sub-warps (lanes lane mod 32 / S),
// by an xor tree: every sub-warp ends with the same bits.
template <int S>
__device__ __forceinline__ double sub_sum(double v) {
#pragma unroll
  for (int off = 32 / S; off < 32; off <<= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// A lane's place: sub-warp `sub` of S (L = 32 / S lanes) takes one slot a
// step; in it, K9's head split (hw = lph / S lanes a head) and P channels a
// lane, channels c0 .. c0 + cnt - 1 of the row.
template <int P, int S>
struct Lanes {
  int lane, sub, lin, hw, head, hs, c0, cnt, cl;
  bool live, leader;
  __device__ Lanes(int heads, int ch, int lph) {
    lane = threadIdx.x & 31;
    sub = lane / (32 / S);
    lin = lane % (32 / S);
    hw = lph / S;
    head = lin / hw;
    const int q = (lin % hw) * P;
    live = head < heads;
    hs = live ? head : 0;                // a valid head for the loads
    c0 = head * ch + q;
    cnt = live ? max(0, min(P, ch - q)) : 0;
    cl = cnt > 0 ? c0 : 0;               // a valid channel for the loads
    leader = live && lin % hw == 0;
  }
  __device__ int chan(int p) const { return p < cnt ? c0 + p : cl; }
};

template <int P, int S>
__global__ void __launch_bounds__(kThreads) gatv2_bwd_dst_kernel(
    const int* __restrict__ indptr, const int* __restrict__ src,
    const int* __restrict__ erow, const float* __restrict__ w_src,
    const float* __restrict__ w_dst, const float* __restrict__ we,
    const float* __restrict__ we_loop, const float* __restrict__ att,
    const float* __restrict__ keep, const float* __restrict__ lse,
    const float* __restrict__ scores, const float* __restrict__ out,
    const float* __restrict__ dout, int n, int n_real, int heads, int ch,
    int lph, int ld, int lds, double slope,
    float* __restrict__ d_w_dst, float* __restrict__ d_we,
    float2* __restrict__ akds, unsigned* __restrict__ bits,
    double* __restrict__ part) {
  constexpr int L = 32 / S;
  constexpr int B = batch_steps<P>();
  constexpr int W = sign_words<P, S>();
  constexpr int kRowMax = L * P;           // the widest row of this P, S
  static_assert(kWarpsPerBlock * 2 * kRowMax * sizeof(double) <= 48 * 1024,
                "static shared memory of a block");
  __shared__ double sm[kWarpsPerBlock][2 * kRowMax];
  const int warp = threadIdx.x >> 5;
  const int hc = heads * ch;
  const Lanes<P, S> ln(heads, ch, lph);
  // values used at every slot are widened to float64 once, not per slot
  double a[P], datt[P], dloop[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a[p] = p < ln.cnt ? att[ln.c0 + p] : 0.f;
    datt[p] = 0.0;
    dloop[p] = 0.0;
  }
  const long long stride =
      static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long i =
           static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
       i < n; i += stride) {
    double xd[P], g[P], acc[P];
    double go_o = 0.0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      xd[p] = w_dst[i * ld + ln.chan(p)];
      g[p] = dout[i * ld + ln.chan(p)];
      if (p < ln.cnt) go_o += g[p] * out[i * ld + ln.chan(p)];
      acc[p] = 0.0;
    }
    const double dd = head_sum(go_o, ln.hw);
    const double ls = lse[i * lds + ln.hs];
    const int beg = indptr[i];
    const int end = indptr[i + 1];
    // the stabiliser's term: the destination's sum of ds, its largest score,
    // how many slots reach it and the first of them (this lane's head)
    double tot = 0.0, smax = -INFINITY;
    int nmax = 0, kmax = 0x7fffffff;
    for (int base = beg; base < end; base += 32) {
      const int cnt_e = min(32, end - base);
      const int mine = base + min(ln.lane, cnt_e - 1);
      const int my_src = src[mine];
      const int my_row = erow[mine];
      const int steps = (cnt_e + S - 1) / S;
      // a batch's rows, loaded one batch ahead of its arithmetic
      struct Rows {
        float xs[B][P], ev[B][P], kp[B], sc[B];
        int rr[B];
      };
      auto load = [&](Rows& q, int t0) {
#pragma unroll
        for (int b = 0; b < B; ++b) {
          // step t, sub-warp s: the group's slot t S + s
          const int k = min((t0 + b) * S + ln.sub, cnt_e - 1);
          const int j = __shfl_sync(kFull, my_src, k);
          const int r = __shfl_sync(kFull, my_row, k);
          q.rr[b] = r;
          const float* xs_row = w_src + static_cast<long long>(j) * ld;
          const float* ev_row =
              r < n_real ? we + static_cast<long long>(r) * ld : we_loop;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            q.xs[b][p] = xs_row[ln.chan(p)];
            q.ev[b][p] = ev_row[ln.chan(p)];
          }
          q.kp[b] = keep ? keep[static_cast<long long>(base + k) * lds +
                                ln.hs]
                         : 1.f;
          q.sc[b] = scores[static_cast<long long>(base + k) * lds + ln.hs];
        }
      };
      Rows cur, ahead;
      load(cur, 0);
      for (int t0 = 0; t0 < steps; t0 += B) {
        if (t0 + B < steps) load(ahead, t0 + B);   // uniform across the warp
        const auto& xs = cur.xs;
        const auto& ev = cur.ev;
        const auto& kp = cur.kp;
        const auto& rr = cur.rr;
        double msg[B][P], s[B], gx[B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          s[b] = cur.sc[b];
          gx[b] = 0.0;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const double x = xs[b][p];
            msg[b][p] = x + xd[p] + static_cast<double>(ev[b][p]);
            if (p < ln.cnt) gx[b] += g[p] * x;
          }
        }
#pragma unroll
        for (int b = 0; b < B; ++b) gx[b] = head_sum(gx[b], ln.hw);
#pragma unroll
        for (int b = 0; b < B; ++b) {
          if (t0 + b >= steps) continue;     // uniform across the warp
          const int k = (t0 + b) * S + ln.sub;
          const bool valid = k < cnt_e;      // uniform across a sub-warp
          const long long e = base + k;
          const int r = rr[b];
          const double alpha = exp(s[b] - ls);
          const double ds = alpha * (kp[b] * gx[b] - dd);
          if (valid) {
            tot += ds;
            if (s[b] > smax) {
              smax = s[b];
              nmax = 1;
              kmax = static_cast<int>(e);
            } else if (s[b] == smax) {
              nmax += 1;
              kmax = min(kmax, static_cast<int>(e));
            }
          }
          unsigned word[W];
#pragma unroll
          for (int w = 0; w < W; ++w) word[w] = 0u;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const bool pos = msg[b][p] >= 0.0;
            const unsigned m = __ballot_sync(kFull, pos);
            // this sub-warp's L bits, at bit p L of the slot's sign string
            const unsigned f =
                S == 1 ? m : (m >> (ln.sub * L)) & ((1u << (L & 31)) - 1u);
            word[p * L / 32] |= f << (p * L % 32);
            if (valid && p < ln.cnt) {
              const double t = ds * a[p] * (pos ? 1.0 : slope);
              datt[p] += ds * (pos ? msg[b][p] : slope * msg[b][p]);
              acc[p] += t;
              if (r < n_real) {
                d_we[static_cast<long long>(r) * ld + ln.c0 + p] =
                    static_cast<float>(t);
              } else {
                dloop[p] += t;
              }
            }
          }
          if (valid) {
#pragma unroll
            for (int w = 0; w < W; ++w) {
              if (ln.lin == w) bits[e * W + w] = word[w];
            }
            if (ln.leader) {
              akds[e * heads + ln.head] = make_float2(
                  static_cast<float>(alpha * kp[b]), static_cast<float>(ds));
            }
          }
        }
        cur = ahead;
      }
    }
    // the sub-warps' sums and maxima (every sub-warp ends with the same),
    // then -tot / nmax added to the ds of each slot at the maximum, by
    // sub-warp 0 (its d_w_dst, d_att and d_we_loop terms, its d_we row and
    // its (alpha keep, ds)); the slot's row is loaded again
    tot = sub_sum<S>(tot);
#pragma unroll
    for (int off = 32 / S; off < 32; off <<= 1) {
      const double os = __shfl_xor_sync(kFull, smax, off);
      const int on = __shfl_xor_sync(kFull, nmax, off);
      const int ok = __shfl_xor_sync(kFull, kmax, off);
      if (os > smax) {
        smax = os;
        nmax = on;
        kmax = ok;
      } else if (os == smax) {
        nmax += on;
        kmax = min(kmax, ok);
      }
    }
    __syncwarp();
    const double share = nmax > 0 ? -tot / nmax : 0.0;
    auto correct = [&](int e, bool mine) {
      const int ee = mine ? e : beg;      // a valid slot for the loads
      const long long j = src[ee];
      const int r = erow[ee];
      const float* ev_row =
          r < n_real ? we + static_cast<long long>(r) * ld : we_loop;
      double msg[P];
      double gx = 0.0;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const double x = w_src[j * ld + ln.chan(p)];
        msg[p] = x + xd[p] + static_cast<double>(ev_row[ln.chan(p)]);
        if (p < ln.cnt) gx += g[p] * x;
      }
      gx = head_sum(gx, ln.hw);
      const long long es = static_cast<long long>(ee) * lds + ln.hs;
      const double kp = keep ? keep[es] : 1.f;
      const double alpha = exp(static_cast<double>(scores[es]) - ls);
      const double ds = alpha * (kp * gx - dd) + share;
      if (!mine || ln.sub != 0) return;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (p >= ln.cnt) continue;
        const bool pos = msg[p] >= 0.0;
        const double lk = a[p] * (pos ? 1.0 : slope);
        acc[p] += share * lk;
        datt[p] += share * (pos ? msg[p] : slope * msg[p]);
        if (r < n_real) {
          d_we[static_cast<long long>(r) * ld + ln.c0 + p] =
              static_cast<float>(ds * lk);
        } else {
          dloop[p] += share * lk;
        }
      }
      if (ln.leader) {
        akds[static_cast<long long>(ee) * heads + ln.head] = make_float2(
            static_cast<float>(alpha * kp), static_cast<float>(ds));
      }
    };
    const bool mine = ln.live && nmax > 0;
    if (beg == end) {
      // no slot: nothing to correct
    } else if (!__any_sync(kFull, mine && nmax > 1)) {
      correct(kmax, mine);
    } else {
      for (int e = beg; e < end; ++e) {   // ties: every slot at the maximum
        correct(e, mine && static_cast<double>(
                               scores[static_cast<long long>(e) * lds +
                                      ln.hs]) == smax);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const double v = sub_sum<S>(acc[p]);
      if (ln.sub == 0 && p < ln.cnt) {
        d_w_dst[i * ld + ln.c0 + p] = static_cast<float>(v);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const double v = sub_sum<S>(datt[p]);
    const double u = sub_sum<S>(dloop[p]);
    if (ln.sub == 0 && p < ln.cnt) {
      sm[warp][ln.c0 + p] = v;
      sm[warp][hc + ln.c0 + p] = u;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * hc; c += blockDim.x) {
    double t = 0.0;
    for (int w = 0; w < kWarpsPerBlock; ++w) t += sm[w][c];
    part[static_cast<long long>(blockIdx.x) * 2 * hc + c] = t;
  }
}

// Blocks src_blocks .. : the destination pass's n_parts block partials
// (n_parts, 2 H C) -> d_att (H C), d_we_loop (H C), 32 columns a block.
__device__ __forceinline__ void combine_partials(
    const double* __restrict__ part, int n_parts, int hc, int cb,
    float* __restrict__ d_att, float* __restrict__ d_we_loop) {
  __shared__ double sw[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = cb * 32 + lane;
  const int cc = min(col, 2 * hc - 1);
  double t = 0.0;
  for (int b = warp; b < n_parts; b += kWarpsPerBlock) {
    t += part[static_cast<long long>(b) * 2 * hc + cc];
  }
  sw[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && col < 2 * hc) {
    double s = 0.0;
    for (int w = 0; w < kWarpsPerBlock; ++w) s += sw[w][lane];
    if (col < hc) {
      d_att[col] = static_cast<float>(s);
    } else {
      d_we_loop[col - hc] = static_cast<float>(s);
    }
  }
}

template <int P, int S>
__global__ void __launch_bounds__(kThreads) gatv2_bwd_src_kernel(
    const int* __restrict__ src_ptr, const int* __restrict__ src_slot,
    const int* __restrict__ src_dst, const float2* __restrict__ akds,
    const unsigned* __restrict__ bits, const float* __restrict__ dout,
    const float* __restrict__ att, int n, int heads, int ch, int lph,
    int ld, double slope, int src_blocks, float* __restrict__ d_w_src,
    const double* __restrict__ part, int n_parts,
    float* __restrict__ d_att, float* __restrict__ d_we_loop) {
  constexpr int L = 32 / S;
  constexpr int B = batch_steps<P>();
  constexpr int W = sign_words<P, S>();
  const int hc = heads * ch;
  if (static_cast<int>(blockIdx.x) >= src_blocks) {
    combine_partials(part, n_parts, hc, blockIdx.x - src_blocks, d_att,
                     d_we_loop);
    return;
  }
  const long long j =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= n) return;
  const Lanes<P, S> ln(heads, ch, lph);
  double a[P], acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a[p] = p < ln.cnt ? att[ln.c0 + p] : 0.f;
    acc[p] = 0.0;
  }
  const int beg = src_ptr[j];
  const int end = src_ptr[j + 1];
  for (int base = beg; base < end; base += 32) {
    const int cnt_e = min(32, end - base);
    const int mine = base + min(ln.lane, cnt_e - 1);
    const int my_slot = src_slot[mine];
    const int my_dst = src_dst[mine];
    const int steps = (cnt_e + S - 1) / S;
    for (int t0 = 0; t0 < steps; t0 += B) {
      float2 ad[B];
      unsigned sg[B][P];
      float gd[B][P];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int k = min((t0 + b) * S + ln.sub, cnt_e - 1);
        const long long e = __shfl_sync(kFull, my_slot, k);
        const long long i = __shfl_sync(kFull, my_dst, k);
        ad[b] = akds[e * heads + ln.hs];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          sg[b][p] = bits[e * W + (p * L + ln.lin) / 32];
          gd[b][p] = dout[i * ld + ln.chan(p)];
        }
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if ((t0 + b) * S + ln.sub >= cnt_e) continue;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const bool pos = (sg[b][p] >> ((p * L + ln.lin) % 32)) & 1u;
          acc[p] += static_cast<double>(ad[b].x) * gd[b][p] +
                    static_cast<double>(ad[b].y) * a[p] * (pos ? 1.0 : slope);
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const double v = sub_sum<S>(acc[p]);
    if (ln.sub == 0 && p < ln.cnt) {
      d_w_src[j * ld + ln.c0 + p] = static_cast<float>(v);
    }
  }
}

// One head of more than 256 channels (a call with heads = 1): its channels
// walked in passes of kPass = 256, 8 a lane.  The destination pass: a warp
// a destination (by stride over the grid), first every slot's score and
// <dout[i], w_src[j]> (each lane's passes in order, then the xor tree), the
// slot's (alpha keep, ds) written to akds in float64 (a double2 a slot);
// then pass by pass over the slots
// again, the messages' signs (8 words a pass, one a channel of each lane),
// d_we, and the pass's d_w_dst[i] summed in registers; d_att and d_we_loop
// summed into the warp's own row of part (2 ch float64, zeroed by the warp
// first), so part has a row a warp.  The source pass: a warp a source, pass
// by pass over its slots.  The sums' order is fixed by the width alone.
constexpr int kPass = 256;
constexpr int kWideP = 8;

__global__ void __launch_bounds__(kThreads) gatv2_bwd_dst_wide_kernel(
    const int* __restrict__ indptr, const int* __restrict__ src,
    const int* __restrict__ erow, const float* __restrict__ w_src,
    const float* __restrict__ w_dst, const float* __restrict__ we,
    const float* __restrict__ we_loop, const float* __restrict__ att,
    const float* __restrict__ keep, const float* __restrict__ lse,
    const float* __restrict__ scores, const float* __restrict__ out,
    const float* __restrict__ dout, int n, int n_real, int ch, int ld,
    int lds, double slope,
    float* __restrict__ d_w_dst, float* __restrict__ d_we,
    double2* __restrict__ akds, unsigned* __restrict__ bits,
    double* __restrict__ part) {
  constexpr int P = kWideP;
  const int lane = threadIdx.x & 31;
  const long long wid =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int passes = (ch + kPass - 1) / kPass;
  const int W = passes * P;                 // sign words a slot
  double* prow = part + wid * 2 * ch;       // this warp's d_att | d_we_loop
  for (int c = lane; c < 2 * ch; c += 32) prow[c] = 0.0;
  __syncwarp();          // zeroed by other lanes than the ones that add
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long i = wid; i < n; i += stride) {
    double go_o = 0.0;
    for (int c = lane * P; c < ch; c += kPass) {
      for (int p = 0; p < P && c + p < ch; ++p) {
        go_o += static_cast<double>(dout[i * ld + c + p]) *
                static_cast<double>(out[i * ld + c + p]);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      go_o += __shfl_xor_sync(kFull, go_o, off);
    }
    const double dd = go_o;
    const double ls = lse[i * lds];
    const int beg = indptr[i];
    const int end = indptr[i + 1];
    double tot = 0.0, smax = -INFINITY;
    int nmax = 0;
    for (int e = beg; e < end; ++e) {       // the slots' (alpha keep, ds)
      const long long j = src[e];
      double gx = 0.0;
      for (int c = lane * P; c < ch; c += kPass) {
        for (int p = 0; p < P && c + p < ch; ++p) {
          gx += static_cast<double>(dout[i * ld + c + p]) *
                static_cast<double>(w_src[j * ld + c + p]);
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        gx += __shfl_xor_sync(kFull, gx, off);
      }
      const double kp = keep ? keep[static_cast<long long>(e) * lds] : 1.0;
      const double alpha =
          exp(static_cast<double>(scores[static_cast<long long>(e) * lds]) -
              ls);
      const double ds = alpha * (kp * gx - dd);
      if (lane == 0) akds[e] = make_double2(alpha * kp, ds);
      const double sc = scores[static_cast<long long>(e) * lds];
      tot += ds;
      if (sc > smax) {
        smax = sc;
        nmax = 1;
      } else if (sc == smax) {
        nmax += 1;
      }
    }
    __syncwarp();
    // the stabiliser's term, before the slots' ds are used: -tot / nmax
    // added to the ds of each slot at the destination's largest score
    if (lane == 0 && nmax > 0) {
      for (int e = beg; e < end; ++e) {
        if (static_cast<double>(scores[static_cast<long long>(e) * lds]) ==
            smax) {
          akds[e].y += -tot / nmax;
        }
      }
    }
    __syncwarp();
    for (int c0 = 0; c0 < ch; c0 += kPass) {
      const int c = c0 + lane * P;
      double acc[P], datt[P], dloop[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = datt[p] = dloop[p] = 0.0;
      for (int e = beg; e < end; ++e) {
        const long long j = src[e];
        const int r = erow[e];
        const float* ev_row = r < n_real ? we + static_cast<long long>(r) * ld
                                         : we_loop;
        const double ds = akds[e].y;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const bool ok = c + p < ch;
          const int cc = ok ? c + p : 0;
          const double msg = static_cast<double>(w_src[j * ld + cc]) +
                             static_cast<double>(w_dst[i * ld + cc]) +
                             static_cast<double>(ev_row[cc]);
          const bool pos = msg >= 0.0;
          const unsigned m = __ballot_sync(kFull, pos);
          if (lane == 0) {
            bits[static_cast<long long>(e) * W + c0 / kPass * P + p] = m;
          }
          if (ok) {
            const double t =
                ds * static_cast<double>(att[cc]) * (pos ? 1.0 : slope);
            datt[p] += ds * (pos ? msg : slope * msg);
            acc[p] += t;
            if (r < n_real) {
              d_we[static_cast<long long>(r) * ld + cc] = static_cast<float>(t);
            } else {
              dloop[p] += t;
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (c + p < ch) {
          d_w_dst[i * ld + c + p] = static_cast<float>(acc[p]);
          prow[c + p] += datt[p];
          prow[ch + c + p] += dloop[p];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) gatv2_bwd_src_wide_kernel(
    const int* __restrict__ src_ptr, const int* __restrict__ src_slot,
    const int* __restrict__ src_dst, const double2* __restrict__ akds,
    const unsigned* __restrict__ bits, const float* __restrict__ dout,
    const float* __restrict__ att, int n, int ch, int ld, double slope,
    int src_blocks, float* __restrict__ d_w_src,
    const double* __restrict__ part, int n_parts,
    float* __restrict__ d_att, float* __restrict__ d_we_loop) {
  constexpr int P = kWideP;
  if (static_cast<int>(blockIdx.x) >= src_blocks) {
    combine_partials(part, n_parts, ch, blockIdx.x - src_blocks, d_att,
                     d_we_loop);
    return;
  }
  const int lane = threadIdx.x & 31;
  const long long j =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= n) return;
  const int W = (ch + kPass - 1) / kPass * P;
  const int beg = src_ptr[j];
  const int end = src_ptr[j + 1];
  for (int c0 = 0; c0 < ch; c0 += kPass) {
    const int c = c0 + lane * P;
    double acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.0;
    for (int k = beg; k < end; ++k) {
      const long long e = src_slot[k];
      const long long i = src_dst[k];
      const double2 ad = akds[e];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (c + p < ch) {
          const bool pos =
              (bits[e * W + c0 / kPass * P + p] >> lane) & 1u;
          acc[p] += ad.x * dout[i * ld + c + p] +
                    ad.y * att[c + p] * (pos ? 1.0 : slope);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (c + p < ch) d_w_src[j * ld + c + p] = static_cast<float>(acc[p]);
    }
  }
}

struct Args {
  const void *indptr, *src, *erow, *src_ptr, *src_slot, *src_dst, *w_src,
      *w_dst, *we, *we_loop, *att, *keep, *lse, *scores, *out, *dout;
  int n, n_real, heads, ch, lph, ld, lds;
  float slope;
  int dst_blocks;
  void *d_w_src, *d_w_dst, *d_we, *d_we_loop, *d_att, *akds, *bits, *part;
};

template <int P, int S>
int launch(const Args& a, cudaStream_t s) {
  const int hc = a.heads * a.ch;
  const int dst_blocks = a.n > 0 ? a.dst_blocks : 0;
  if (a.n > 0) {
    gatv2_bwd_dst_kernel<P, S><<<dst_blocks, kThreads, 0, s>>>(
        static_cast<const int*>(a.indptr), static_cast<const int*>(a.src),
        static_cast<const int*>(a.erow), static_cast<const float*>(a.w_src),
        static_cast<const float*>(a.w_dst), static_cast<const float*>(a.we),
        static_cast<const float*>(a.we_loop),
        static_cast<const float*>(a.att), static_cast<const float*>(a.keep),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.scores),
        static_cast<const float*>(a.out),
        static_cast<const float*>(a.dout), a.n, a.n_real, a.heads, a.ch,
        a.lph, a.ld, a.lds, static_cast<double>(a.slope),
        static_cast<float*>(a.d_w_dst),
        static_cast<float*>(a.d_we), static_cast<float2*>(a.akds),
        static_cast<unsigned*>(a.bits), static_cast<double*>(a.part));
    const cudaError_t err2 = cudaGetLastError();
    if (err2 != cudaSuccess) return static_cast<int>(err2);
  }
  const int src_blocks = (a.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int combine_blocks = (2 * hc + 31) / 32;
  gatv2_bwd_src_kernel<P, S><<<src_blocks + combine_blocks, kThreads, 0, s>>>(
      static_cast<const int*>(a.src_ptr), static_cast<const int*>(a.src_slot),
      static_cast<const int*>(a.src_dst), static_cast<const float2*>(a.akds),
      static_cast<const unsigned*>(a.bits),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.att),
      a.n, a.heads, a.ch, a.lph, a.ld, static_cast<double>(a.slope),
      src_blocks,
      static_cast<float*>(a.d_w_src), static_cast<const double*>(a.part),
      dst_blocks, static_cast<float*>(a.d_att),
      static_cast<float*>(a.d_we_loop));
  return static_cast<int>(cudaGetLastError());
}

// resident != null: the blocks of this instantiation's destination pass
// that fit one SM at once, from CUDA's occupancy query (the host sizes that
// pass's grid, and its partials, from it); else the two launches.
template <int P, int S>
int run(const Args& a, int* resident, cudaStream_t s) {
  if (resident != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, gatv2_bwd_dst_kernel<P, S>, kThreads, 0));
  }
  return launch<P, S>(a, s);
}

// A head of more than 256 channels (p = 0): the wide kernels, whose part
// has a row a warp of the destination pass.
int run_wide(const Args& a, int* resident, cudaStream_t s) {
  if (resident != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, gatv2_bwd_dst_wide_kernel, kThreads, 0));
  }
  if (a.heads != 1 || a.ch <= kPass) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dst_blocks = a.n > 0 ? a.dst_blocks : 0;
  if (a.n > 0) {
    gatv2_bwd_dst_wide_kernel<<<dst_blocks, kThreads, 0, s>>>(
        static_cast<const int*>(a.indptr), static_cast<const int*>(a.src),
        static_cast<const int*>(a.erow), static_cast<const float*>(a.w_src),
        static_cast<const float*>(a.w_dst), static_cast<const float*>(a.we),
        static_cast<const float*>(a.we_loop),
        static_cast<const float*>(a.att), static_cast<const float*>(a.keep),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.scores),
        static_cast<const float*>(a.out),
        static_cast<const float*>(a.dout), a.n, a.n_real, a.ch, a.ld, a.lds,
        static_cast<double>(a.slope), static_cast<float*>(a.d_w_dst),
        static_cast<float*>(a.d_we), static_cast<double2*>(a.akds),
        static_cast<unsigned*>(a.bits), static_cast<double*>(a.part));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int src_blocks = (a.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int combine_blocks = (2 * a.ch + 31) / 32;
  gatv2_bwd_src_wide_kernel<<<src_blocks + combine_blocks, kThreads, 0, s>>>(
      static_cast<const int*>(a.src_ptr), static_cast<const int*>(a.src_slot),
      static_cast<const int*>(a.src_dst), static_cast<const double2*>(a.akds),
      static_cast<const unsigned*>(a.bits),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.att),
      a.n, a.ch, a.ld, static_cast<double>(a.slope), src_blocks,
      static_cast<float*>(a.d_w_src), static_cast<const double*>(a.part),
      dst_blocks * kWarpsPerBlock, static_cast<float*>(a.d_att),
      static_cast<float*>(a.d_we_loop));
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int p, int s, const Args& a, int* resident, cudaStream_t st) {
  if (p == 0 && s == 1) return run_wide(a, resident, st);
#define K11_CASE(PP, SS) \
  if (p == PP && s == SS) return run<PP, SS>(a, resident, st);
  K11_CASE(1, 1) K11_CASE(2, 1) K11_CASE(3, 1) K11_CASE(4, 1)
  K11_CASE(5, 1) K11_CASE(6, 1) K11_CASE(7, 1) K11_CASE(8, 1)
  K11_CASE(1, 2) K11_CASE(2, 2) K11_CASE(3, 2) K11_CASE(4, 2)
  K11_CASE(1, 4) K11_CASE(2, 4) K11_CASE(3, 4) K11_CASE(4, 4)
#undef K11_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// indptr (n+1), src / erow (E'): K9's destination CSR; src_ptr (n+1) /
// src_slot / src_dst (E'): the same slots as a CSR over sources, with each
// slot's destination; w_src, w_dst (n, H C), we (n_real, H C), we_loop
// (H C), att (H, C), keep (E', H) or null, lse (n, H) and scores (E', H)
// (K9's), out and dout (n, H C) float32.  Outputs: d_w_src, d_w_dst (n, H C), d_we (n_real, H C),
// d_we_loop (H C), d_att (H, C) float32.  p (channels a lane) and s
// (slots a warp step) name the instantiation (kernels.k11_plan); scratch:
// akds (E', H) float2, bits (E', ceil(p 32 / s / 32)) 32-bit words and part
// (dst_blocks, 2 H C) float64: the destination pass runs dst_blocks blocks
// (kernels.k11_max_blocks), one partial each.  heads (a power of two, at
// most 32) and channels (lph / s lanes of at most 8 channels a head) are one
// group of heads (kernels.k11_groups): every row pointer, att, keep, lse and
// scores point at the group's first head, ld is the full row stride (all
// heads x channels) of the (n, .) and (n_real, .) rows and lds the full head
// count (the stride of keep, lse and scores); the wrapper checks shapes.
// Returns the cudaGetLastError() code of the launches.
extern "C" int ltr_gatv2_softmax_agg_bwd(
    const void* indptr, const void* src, const void* erow,
    const void* src_ptr, const void* src_slot, const void* src_dst,
    const void* w_src, const void* w_dst, const void* we,
    const void* we_loop, const void* att, const void* keep, const void* lse,
    const void* scores, const void* out, const void* dout, int n, int n_real,
    int heads,
    int channels, int ld, int lds, float slope, int p,
    int s, int dst_blocks, void* d_w_src, void* d_w_dst, void* d_we,
    void* d_we_loop, void* d_att, void* akds, void* bits, void* part,
    void* stream) {
  int hp = 1;
  while (hp < heads) hp <<= 1;
  const int lph = hp <= 32 ? 32 / hp : 0;
  // the plan must cover the row: s divides the head's lanes, p channels a
  // lane of them reach the head's channels (p = 0: the wide kernels)
  if (heads < 1 || hp > 32 || channels < 1 || s < 1 || lph % s != 0 ||
      (p > 0 && p * (lph / s) < channels) || (n > 0 && dst_blocks < 1) ||
      ld < heads * channels || lds < heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{indptr, src, erow, src_ptr, src_slot, src_dst, w_src, w_dst,
               we, we_loop, att, keep, lse, scores, out, dout, n, n_real,
               heads, channels, lph, ld, lds, slope, dst_blocks, d_w_src,
               d_w_dst, d_we, d_we_loop, d_att, akds, bits, part};
  return dispatch(p, s, a, nullptr, static_cast<cudaStream_t>(stream));
}

// The blocks of instantiation (p, s)'s destination pass that fit one SM of
// the current device at once, into *blocks.  Returns the query's cudaError.
extern "C" int ltr_gatv2_softmax_agg_bwd_resident(int p, int s, int* blocks) {
  return dispatch(p, s, Args{}, blocks, nullptr);
}
