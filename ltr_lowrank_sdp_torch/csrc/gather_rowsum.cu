// K13 gather_rowsum: the sum of index-gathered rows, float32.
//
//   out[0, j] = sum_i Y[idx[i], j]        Y (N, R), idx (M,) int32, out (1, R)
//
// Replaces: scripts/pallas_gather_probe.py kern (:41-56, the repo's one
// pl.pallas_call, :57): Y held whole in VMEM, a grid over index tiles of
// 8,192 that gathers each tile's rows with jnp.take and adds their column sum
// into a (1, R) VMEM scratch carried from grid step to grid step, float32.
//
// Bound on the card: memory.  The compulsory traffic is idx, Y and out once
// (about 2.1 MB at the probe's defaults N = 8,192, M = 262,144, R = 32).
//
// Two plans of one function (kernels.k13_plan picks one by their bytes).
//
// The counts plan computes the sum without the gather:
//   sum_i Y[idx[i]] = sum_k c_k Y[k],   c_k = #{i : idx[i] = k}.
// Phase 1 forms the N int32 counts: integer additions give the same counts
// in any order, so atomics on them keep the result's bits fixed (no value
// goes through an atomic).  Two ways to cut the same-address traffic, both
// instantiated (a plan each): a block-private histogram in shared memory
// where N fits (N <= kMaxSmemBins), flushed by one global atomic a non-zero
// bin, or warp-aggregated global atomics (lanes holding equal indices are
// found by __match_any_sync and the lowest of them adds their number).  An
// index outside [0, N) adds nothing.  Phase 2 reads Y once (1 MB at the
// defaults): rows are cut into chunks of kSteps * S rows, S = 256 / L
// strands of L = min(32, next_pow2(R)) lanes (C = ceil(R / L) columns a
// lane); strand s of a chunk adds rows s, s + S, ... of it in order, each
// term float(c_k) * Y[k, j] rounded once and added in float32 (a row with
// c_k = 0 adds nothing, as the gather never reads it); the strands are
// added pairwise, (0 + 1) + (2 + 3) ..., by shuffles in a warp and through
// shared memory across the 8 warps, into one partial row a chunk.  A block
// loads its first chunk's rows of Y before the counts are ready, so those
// loads overlap phase 1.  The block that reads a chunk's counts sets them
// to 0 again, and the last block to take a ticket (atomicInc, which wraps
// back to 0) stages the chunk partials through shared memory, adds them in
// chunk order and writes out, so the scratch is ready for the next call
// without a memset.  kernels.gather_rowsum_order evaluates this order on
// the host.  Two launches: the pass is a programmatic dependent launch that
// starts while the histogram runs and waits for it (griddepcontrol.wait)
// after its loads of Y.  Both counts plans give the same bits.  float(c_k)
// is exact up to 2^24.  What is left above the bound is a chain of
// dependent steps: the index loads, the flush, the counts read, the
// ticket, the staged partials.
//
// The gather plan (this kernel's first design): the first launch gives each
// block one contiguous tile of indices (at most 1,056 blocks, tiles of at
// least 256 indices) and writes one partial row a block, and a second
// launch of one block adds the partials in block order.  In a block, each
// of the 8 warps walks every 8th index group of the tile; lanes run over
// columns (L and C as above), so at R = 32 one warp reads one 128-byte row
// an index, and at R = 8 four rows at once (32 / L index groups).  The
// groups of a warp are added by a butterfly of shuffles, the warps in warp
// order through shared memory.  It gathers M x R x 4 bytes from L2 (33.5 MB
// at the defaults), so the counts plan takes over wherever its bytes, 4 (M
// + N (R + 2)), are fewer than the gather's, 4 M (R + 1).
//
// No atomics on values: every plan gives the same bits on every call.
// float32 accumulation, as the TPU kernel's scratch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 256;            // 8 columns a lane
constexpr int kSteps = 8;             // rows a strand a chunk
constexpr int kBatch = 8;             // indices a thread loads at once
constexpr int kStage = 8192;          // partials the last block stages
// the shared histogram's bins at most: 192 KB, with the pass's 32 KB within
// a block's 227 KB
constexpr int kMaxSmemBins = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- gather --

template <int C>
__global__ void gather_rowsum_tiles_kernel(const float* __restrict__ Y,
                                           const int* __restrict__ idx, int M,
                                           int R, int L, int tile,
                                           float* __restrict__ part) {
  __shared__ float warp_sum[kWarps][kMaxR];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / L;                 // index groups per warp
  const int g = lane / L;
  const int c0 = lane % L;
  float acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0.0f;
  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long end = start + tile < M ? start + tile : M;
  for (long long i = start + warp * groups + g; i < end;
       i += kWarps * groups) {
    const float* row = Y + static_cast<long long>(__ldg(idx + i)) * R;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int col = c0 + k * L;
      if (col < R) acc[k] += __ldg(row + col);
    }
  }
  // lanes c0, c0 + L, ... hold the same columns: add them
  for (int off = 16; off >= L; off >>= 1) {
#pragma unroll
    for (int k = 0; k < C; ++k)
      acc[k] += __shfl_xor_sync(kFull, acc[k], off);
  }
  if (lane < L) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int col = c0 + k * L;
      if (col < R) warp_sum[warp][col] = acc[k];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < R; col += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w][col];
    part[static_cast<long long>(blockIdx.x) * R + col] = s;
  }
}

__global__ void gather_rowsum_combine_kernel(const float* __restrict__ part,
                                             int n_blocks, int R,
                                             float* __restrict__ out) {
  for (int col = threadIdx.x; col < R; col += blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b)
      s += part[static_cast<long long>(b) * R + col];
    out[col] = s;
  }
}

// ---------------------------------------------------------------- counts --

// Phase 1: a block adds its share of the indices into counts, warp by warp
// kBatch * 32 indices at a time (every lane of a warp takes the same steps:
// __match_any_sync needs them all).  SMEM: through the block's histogram
// `bins` (N ints of shared memory).
template <bool SMEM>
__device__ __forceinline__ void histogram(const int* __restrict__ idx, int M,
                                          int N, int* __restrict__ counts,
                                          int* bins) {
  const int lane = threadIdx.x & 31;
  if constexpr (SMEM) {
    for (int k = threadIdx.x; k < N; k += kThreads) bins[k] = 0;
    __syncthreads();
  }
  const long long stride =
      static_cast<long long>(gridDim.x) * kThreads * kBatch;
  for (long long w0 = static_cast<long long>(blockIdx.x) * kThreads * kBatch +
                      (threadIdx.x & ~31);
       w0 < M; w0 += stride) {
    int key[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long i = w0 + b * kThreads + lane;
      key[b] = i < M ? __ldg(idx + i) : -1;
      if (static_cast<unsigned>(key[b]) >= static_cast<unsigned>(N))
        key[b] = -1;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if constexpr (SMEM) {
        if (key[b] >= 0) atomicAdd(bins + key[b], 1);
      } else {
        const unsigned peers = __match_any_sync(kFull, key[b]);
        if (key[b] >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(counts + key[b], __popc(peers));
      }
    }
  }
  if constexpr (SMEM) {
    __syncthreads();
    // a warp's atomics on 32 neighbouring counts: one request a line
#pragma unroll 8
    for (int k = threadIdx.x; k < N; k += kThreads) {
      const int c = bins[k];
      if (c != 0) atomicAdd(counts + k, c);
    }
  }
}

__host__ __device__ long long n_chunks(int N, int L) {
  const long long rows = static_cast<long long>(kSteps) * (kThreads / L);
  return (N + rows - 1) / rows;
}

// Phase 2's loads of Y for one chunk: rows r0 + s + i S of this thread's
// strand s (independent of the counts, so issued before they are ready).
template <int C>
__device__ __forceinline__ void load_rows(const float* __restrict__ Y,
                                          int N, int R, int L,
                                          long long chunk,
                                          float (&v)[kSteps][C]) {
  const int S = kThreads / L;
  const int s = threadIdx.x / L;
  const int c0 = threadIdx.x % L;
  const long long r0 = chunk * kSteps * S;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const long long row = r0 + s + i * S;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int col = c0 + k * L;
      v[i][k] = (row < N && col < R) ? __ldg(Y + row * R + col) : 0.0f;
    }
  }
}

// Phase 2, one chunk whose rows v holds: its partial row part[chunk], its
// counts set to 0.
template <int C>
__device__ __forceinline__ void chunk_partial(
    const float (&v)[kSteps][C], int* __restrict__ counts, int N, int R,
    int L, long long chunk, float* __restrict__ part,
    float (*wsum)[kMaxR]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = kThreads / L;                // strands
  const int s = threadIdx.x / L;
  const int c0 = threadIdx.x % L;
  const long long r0 = chunk * kSteps * S;
  int cnt[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const long long row = r0 + s + i * S;
    cnt[i] = row < N ? __ldcg(counts + row) : 0;
  }
  float acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const float c = __int2float_rn(cnt[i]);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (cnt[i] != 0) acc[k] = __fadd_rn(acc[k], __fmul_rn(c, v[i][k]));
    }
  }
  // the strands of a warp, pairwise: strand s adds strand s + h (xor: the
  // same bits, as the addition commutes)
  for (int h = L; h < 32; h <<= 1) {
#pragma unroll
    for (int k = 0; k < C; ++k)
      acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(kFull, acc[k], h));
  }
  if (lane < L) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int col = c0 + k * L;
      if (col < R) wsum[warp][col] = acc[k];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < R; col += kThreads) {
    part[chunk * R + col] = __fadd_rn(
        __fadd_rn(__fadd_rn(wsum[0][col], wsum[1][col]),
                  __fadd_rn(wsum[2][col], wsum[3][col])),
        __fadd_rn(__fadd_rn(wsum[4][col], wsum[5][col]),
                  __fadd_rn(wsum[6][col], wsum[7][col])));
  }
  // every count of the chunk has been read: 0 for the next call
  for (int t = threadIdx.x; t < kSteps * S; t += kThreads) {
    if (r0 + t < N) counts[r0 + t] = 0;
  }
  __syncthreads();          // wsum is free again
}

// Phase 2: the chunks by a stride of the grid (v holds the rows of the
// first, chunk blockIdx.x), then the ticket; the last block adds the chunk
// partials in chunk order.
template <int C>
__device__ __forceinline__ void pass(const float* __restrict__ Y,
                                     int* __restrict__ counts, int N, int R,
                                     int L, float* __restrict__ part,
                                     unsigned* __restrict__ ticket,
                                     float* __restrict__ out,
                                     float (&v)[kSteps][C]) {
  // the warps' sums of a chunk, then the partials the last block stages
  __shared__ float buf[kStage];
  __shared__ bool is_last;
  static_assert(kWarps * kMaxR <= kStage, "the warps' sums fit the stage");
  float(*wsum)[kMaxR] = reinterpret_cast<float(*)[kMaxR]>(buf);
  const long long chunks = n_chunks(N, L);
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    if (c != blockIdx.x) load_rows<C>(Y, N, R, L, c, v);
    chunk_partial<C>(v, counts, N, R, L, c, part, wsum);
  }
  if (threadIdx.x == 0) {
    __threadfence();                  // this block's partials, then the ticket
    is_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the chunk partials in chunk order: staged through shared memory by all
  // threads, kStage floats at a time, then added column by column
  const long long total = chunks * R;
  const int rows = kStage / R;
  float s = 0.0f;
  for (long long c0 = 0; c0 < chunks; c0 += rows) {
    const int n = static_cast<int>(
        total - c0 * R < rows * R ? total - c0 * R : rows * R);
    float staged[kStage / kThreads];      // every load issued at once
#pragma unroll
    for (int q = 0; q < kStage / kThreads; ++q) {
      const int t = threadIdx.x + q * kThreads;
      staged[q] = t < n ? __ldcg(part + c0 * R + t) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kStage / kThreads; ++q) {
      const int t = threadIdx.x + q * kThreads;
      if (t < n) buf[t] = staged[q];
    }
    __syncthreads();
    if (threadIdx.x < R) {
      for (int c = 0; c < n / R; ++c)
        s = __fadd_rn(s, buf[c * R + threadIdx.x]);
    }
    __syncthreads();
  }
  if (threadIdx.x < R) out[threadIdx.x] = s;
}

// Two launches: the histogram lets the pass start at once (programmatic
// dependent launch); the pass loads its first chunk's rows of Y, then
// waits for the histogram's grid to finish (griddepcontrol.wait).
template <bool SMEM>
__global__ void __launch_bounds__(kThreads)
counts_hist_kernel(const int* __restrict__ idx, int M, int N,
                   int* __restrict__ counts) {
  extern __shared__ int bins[];
  asm volatile("griddepcontrol.launch_dependents;");
  histogram<SMEM>(idx, M, N, counts, bins);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
counts_pass_kernel(const float* __restrict__ Y, int* __restrict__ counts,
                   int N, int R, int L, float* __restrict__ part,
                   unsigned* __restrict__ ticket, float* __restrict__ out) {
  float v[kSteps][C];
  load_rows<C>(Y, N, R, L, blockIdx.x, v);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  pass<C>(Y, counts, N, R, L, part, ticket, out, v);
}

struct Args {
  const float* Y;
  const int* idx;
  int N, M, R, L, grid;
  int* counts;
  float* part;
  unsigned* ticket;
  float* out;
};

int smem_bytes(bool smem, int N) {
  return smem ? N * static_cast<int>(sizeof(int)) : 0;
}

// the dynamic shared memory a launch asks for: above 48 KB with the static
// (the pass's 32 KB), only after this
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 0 ? cudaFuncSetAttribute(
                         kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes)
                   : cudaSuccess;
}

template <int C, bool SMEM>
int run_counts(const Args& a, cudaStream_t s) {
  const int bytes = smem_bytes(SMEM, a.N);
  cudaError_t err = allow_smem(counts_hist_kernel<SMEM>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  counts_hist_kernel<SMEM><<<a.grid, kThreads, bytes, s>>>(a.idx, a.M, a.N,
                                                           a.counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = n_chunks(a.N, a.L);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks < a.grid ? static_cast<int>(chunks) : a.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, counts_pass_kernel<C>, a.Y, a.counts, a.N, a.R, a.L, a.part,
      a.ticket, a.out));
}

template <bool SMEM>
int dispatch_counts(int C, const Args& a, cudaStream_t s) {
  switch (C) {
#define K13_CASE(c) \
  case c:           \
    return run_counts<c, SMEM>(a, s);
    K13_CASE(1) K13_CASE(2) K13_CASE(3) K13_CASE(4)
    K13_CASE(5) K13_CASE(6) K13_CASE(7) K13_CASE(8)
#undef K13_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int lanes(int R) {
  int L = 1;
  while (L < R && L < 32) L <<= 1;
  return L;
}

}  // namespace

// mode 0: the gather plan, grid blocks of tile indices each, partials in
// part (grid x R floats).  Modes 1-2: the counts plan, 1 + smem (smem: the
// histogram in shared memory, N <= kMaxSmemBins); grid blocks for the
// histogram and the pass (the pass uses at most one a chunk), part one
// partial row a chunk, counts (N ints) and ticket (one unsigned) 0 at the
// call and 0 again after it: the caller's scratch, used by one call at a
// time.  Returns the launches' cudaError.
extern "C" int ltr_gather_rowsum(const void* Y, const void* idx, int N, int M,
                                 int R, int mode, int grid, int tile,
                                 void* part, void* counts, void* ticket,
                                 void* out, void* stream) {
  if (R < 1 || R > kMaxR || N < 1 || M < 0 || grid < 1 || mode < 0 ||
      mode > 2 || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = lanes(R);
  const int C = (R + L - 1) / L;
  const float* y = static_cast<const float*>(Y);
  const int* ix = static_cast<const int*>(idx);
  float* p = static_cast<float*>(part);
  if (mode > 0) {
    const bool smem = mode == 2;
    if (counts == nullptr || ticket == nullptr || (smem && N > kMaxSmemBins))
      return static_cast<int>(cudaErrorInvalidValue);
    const Args a{y, ix, N, M, R, L, grid, static_cast<int*>(counts), p,
                 static_cast<unsigned*>(ticket), static_cast<float*>(out)};
    return smem ? dispatch_counts<true>(C, a, s)
                : dispatch_counts<false>(C, a, s);
  }
  if (tile < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
#define LTR_K13_CASE(c)                                                    \
  case c:                                                                  \
    gather_rowsum_tiles_kernel<c><<<grid, kWarps * 32, 0, s>>>(            \
        y, ix, M, R, L, tile, p);                                          \
    break;
    LTR_K13_CASE(1)
    LTR_K13_CASE(2)
    LTR_K13_CASE(3)
    LTR_K13_CASE(4)
    LTR_K13_CASE(5)
    LTR_K13_CASE(6)
    LTR_K13_CASE(7)
    LTR_K13_CASE(8)
#undef LTR_K13_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rowsum_combine_kernel<<<1, kMaxR, 0, s>>>(
      p, grid, R, static_cast<float*>(out));
  err = cudaGetLastError();
  return static_cast<int>(err);
}
