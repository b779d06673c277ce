// K4 sym_contract_sum: <C, sym(U V^T)> as a float64 scalar on the device,
//   sum_k coef_k * 1/2 (<U[r_k], V[c_k]> + <U[c_k], V[r_k]>)
// over the upper-triangle entries (r_k, c_k) of C, coef_k = 2 c_k off the
// diagonal and c_k on it (or coef_k * <U[r_k], U[c_k]> when U is V).
//
// Replaces: ltr_lowrank_sdp_tpu/ops/coneops.py ConeOps.obj_value (:332),
// sparse branch :342 -> _SparseSym.contract (:87-102) followed by
// ops/compsum.py csum (:78); and HALLaR's _Ops.CX (hallar/solver.py:184).
//
// Bound on the card: memory.  It reads the entry lists (rows, cols, coef)
// and U, V once; the gathers of U / V rows it does per entry hit L2 (the
// factors fit in the 50 MB L2 at the solver's widths), so the least time is
// the bytes of the inputs over 3.35 TB/s.  At HALLaR's size (3,000 entries,
// r = 2..7) that is 0.1 us, far below one launch: there the kernel is its
// launch and one chain of dependent loads, and two launches (the partials,
// then their sum) cost twice that.  One warp per entry with the lanes over
// r columns left 25-30 of 32 lanes idle at r = 2..7 and walked a large C
// one entry latency after another.
//
// Design.  The entries, counted from entry 0, are cut into chunks of
// kChunk = 256: one block step, 32 consecutive entries a warp.  Lane l of a
// warp loads its entry l's (row, col, coef) with coalesced loads; a group
// of G lanes (G = min(32, next_pow2(r)), kernels.lane_group) takes one
// entry at a time, each lane holding CPL = ceil(r / G) <= 8 columns (passes
// of 256 columns beyond), so the warp has P = 32 / G entries in flight a
// step and walks its 32 entries in G steps, the gathered rows of a batch
// of steps (32 values a lane with U is V, 16 without) issued before any
// arithmetic (a column past r or an entry past nnz reads a clamped, valid
// address and is not added).
// Each lane adds coef_k times its column terms of entry k into one running
// sum, entry by entry; an xor-shuffle tree over the 32 lanes gives the
// warp's sum and a fixed tree over the 8 warps the chunk's float64 partial.
// So a chunk's partial depends on its entries and r alone.
//
// One launch.  Blocks take chunks by a stride of the grid, which the host
// sizes to the card (kernels.k4_plan: a block a chunk up to the blocks that
// fit the card at once, from the occupancy query
// ltr_sym_contract_sum_resident).  Each block writes its chunks' partials to global
// scratch, fences, and takes a ticket (atomicInc, which wraps the counter
// back to 0 at the last block, so the next call, or the next replay of a
// captured CUDA graph, finds it at 0 without a memset).  The block that
// takes the last ticket combines the partials in chunk order by one fixed
// tree: thread t of the 256 adds chunks t, t + 256, ... in order, an xor
// tree in each warp, a fixed tree over the 8 warps.  (Keeping the partials
// in the shared memory of one thread-block cluster and combining them
// through distributed shared memory was slower than the ticket at the sizes
// where a cluster holds them, 12 and 40 chunks.)  No value goes through an
// atomic; the result's bits depend on the entries, r and the value type
// only -- never on the grid -- and two calls agree.
//
// Value type: U, V and coef are float64 or float32 (a template on T).  Every
// product is formed in float64 from the loaded values (exact for float32
// operands) and every sum runs in float64; the result is a float64 scalar.
// This is the contract of the reference's csum on float32
// (ops/compsum.py:78-92: cast to float64, then reduce), which the caller
// rounds back to the compute type.  One caller asks for the other contract:
// HALLaR's float32 <C, YY^T> (hallar/solver.py:184-186) is a plain jnp.sum
// in float32, so with ACC32 (float32 values only) the products and every
// sum are float32 and so is the result, in the same order as above, each
// product and sum rounded on its own (round-to-nearest intrinsics, no fused
// multiply-add): kernels.sym_contract_sum_plain(acc32=True) follows the
// same order and gives the same bits on the CPU.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;    // entries a chunk: 32 a warp
constexpr unsigned kFull = 0xffffffffu;

// Steps of a batch whose gathers are issued together: 32 row values a lane
// with U is V (two rows an entry), 16 without (four rows an entry).
template <bool SAME, int G, int CPL>
__host__ __device__ constexpr int batch_steps() {
  constexpr int b = (SAME ? 16 : 4) / CPL;
  return b < 1 ? 1 : (b > G ? G : b);
}

// acc + x * y: in float64 as the compiler contracts it; in float32 (ACC32)
// the product and the sum each rounded, as the plain version forms them.
__device__ __forceinline__ double mad(double acc, double x, double y) {
  return acc + x * y;
}
__device__ __forceinline__ float mad(float acc, float x, float y) {
  return __fadd_rn(acc, __fmul_rn(x, y));
}

// x * y + z * w, the same way.
__device__ __forceinline__ double dot2(double x, double y, double z,
                                       double w) {
  return x * y + z * w;
}
__device__ __forceinline__ float dot2(float x, float y, float z, float w) {
  return __fadd_rn(__fmul_rn(x, y), __fmul_rn(z, w));
}

// A: the type of the products and sums, double, or float under ACC32.
template <typename T, bool SAME, int G, int CPL, bool ACC32>
__global__ void __launch_bounds__(kThreads)
sym_contract_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                    const T* __restrict__ coef, const T* __restrict__ U,
                    const T* __restrict__ V, int nnz, int r, int n_chunks,
                    void* __restrict__ part_raw,
                    unsigned* __restrict__ ticket, void* __restrict__ out_raw) {
  using A = typename std::conditional<ACC32, float, double>::type;
  A* __restrict__ part = static_cast<A*>(part_raw);
  A* __restrict__ out = static_cast<A*>(out_raw);
  constexpr int P = 32 / G;           // entries a warp step
  constexpr int B = batch_steps<SAME, G, CPL>();
  __shared__ A wsum[2][kWarps];        // by chunk parity: one barrier a chunk
  __shared__ int is_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = lane / G;
  const int lig = lane % G;
  const int last = nnz - 1;
  int slot = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x, ++slot) {
    const int e0 = c * kChunk + warp * 32;
    const int mine = min(e0 + lane, last);
    const int my_row = rows[mine];
    const int my_col = cols[mine];
    const A my_coef = static_cast<A>(coef[mine]);
    A acc = 0;
    for (int s0 = 0; s0 < G; s0 += B) {
      long long bi[B], bj[B];
      A d[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int t = min(s0 + b, G - 1) * P + q;   // the warp's entry t
        bi[b] = static_cast<long long>(__shfl_sync(kFull, my_row, t)) * r;
        bj[b] = static_cast<long long>(__shfl_sync(kFull, my_col, t)) * r;
        d[b] = 0;
      }
      for (int c0 = 0; c0 < r; c0 += G * CPL) {
        T ui[B][CPL], uj[B][CPL], vi[B][CPL], vj[B][CPL];
#pragma unroll
        for (int b = 0; b < B; ++b) {
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            const int col = min(c0 + lig + G * k, r - 1);
            ui[b][k] = U[bi[b] + col];
            uj[b][k] = U[bj[b] + col];
            if (!SAME) {
              vi[b][k] = V[bi[b] + col];
              vj[b][k] = V[bj[b] + col];
            }
          }
        }
#pragma unroll
        for (int b = 0; b < B; ++b) {
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            if (c0 + lig + G * k >= r) continue;
            if (SAME) {
              d[b] = mad(d[b], static_cast<A>(ui[b][k]),
                         static_cast<A>(uj[b][k]));
            } else {
              d[b] += dot2(static_cast<A>(ui[b][k]), static_cast<A>(vj[b][k]),
                           static_cast<A>(uj[b][k]), static_cast<A>(vi[b][k]));
            }
          }
        }
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int t = (s0 + b) * P + q;
        const A ck = __shfl_sync(kFull, my_coef, min(t, 31));
        // (x + x) / 2 == x exactly: a diagonal entry needs no case of its own
        if (s0 + b < G && e0 + t <= last) {
          acc = mad(acc, ck, SAME ? d[b] : static_cast<A>(0.5) * d[b]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(kFull, acc, off);
    }
    A* ws = wsum[slot & 1];
    if (lane == 0) ws[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      part[c] = ((ws[0] + ws[1]) + (ws[2] + ws[3])) +
                ((ws[4] + ws[5]) + (ws[6] + ws[7]));
    }
  }
  __syncthreads();     // wsum is free again
  if (threadIdx.x == 0) {
    __threadfence();                  // this block's partials, then the ticket
    is_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the fixed combine: thread t adds chunks t, t + 256, ... in order, an
  // xor tree in each warp, a balanced tree over the 8 warps
  A s = 0;
  for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
    s += __ldcg(part + c);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) wsum[0][warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    const A* ws = wsum[0];
    out[0] = ((ws[0] + ws[1]) + (ws[2] + ws[3])) +
             ((ws[4] + ws[5]) + (ws[6] + ws[7]));
  }
}

struct Args {
  const void *rows, *cols, *coef, *U, *V;
  int nnz, r, grid;
  void *part, *ticket, *out;
  int* resident;   // non-null: report occupancy instead of launching
};

template <typename T, bool SAME, int G, int CPL, bool ACC32>
int launch(const Args& a, cudaStream_t s) {
  if (a.resident != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.resident, sym_contract_kernel<T, SAME, G, CPL, ACC32>, kThreads,
        0));
  }
  const int n_chunks = (a.nnz + kChunk - 1) / kChunk;
  sym_contract_kernel<T, SAME, G, CPL, ACC32><<<a.grid, kThreads, 0, s>>>(
      static_cast<const int*>(a.rows), static_cast<const int*>(a.cols),
      static_cast<const T*>(a.coef), static_cast<const T*>(a.U),
      static_cast<const T*>(a.V), a.nnz, a.r, n_chunks, a.part,
      static_cast<unsigned*>(a.ticket), a.out);
  return static_cast<int>(cudaGetLastError());
}

// float64 values always sum in float64; float32 values in float64, or in
// float32 with acc32
template <typename T, int G, int CPL>
int launch_mode(int same, int acc32, const Args& a, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (acc32) {
      return same ? launch<T, true, G, CPL, true>(a, s)
                  : launch<T, false, G, CPL, true>(a, s);
    }
  } else if (acc32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return same ? launch<T, true, G, CPL, false>(a, s)
              : launch<T, false, G, CPL, false>(a, s);
}

template <typename T>
int dispatch(int g, int cpl, int same, int acc32, const Args& a,
             cudaStream_t s) {
#define K4_CASE(GG, CC) \
  if (g == GG && cpl == CC) return launch_mode<T, GG, CC>(same, acc32, a, s);
  K4_CASE(1, 1) K4_CASE(2, 1) K4_CASE(4, 1) K4_CASE(8, 1) K4_CASE(16, 1)
  K4_CASE(32, 1) K4_CASE(32, 2) K4_CASE(32, 3) K4_CASE(32, 4)
  K4_CASE(32, 5) K4_CASE(32, 6) K4_CASE(32, 7) K4_CASE(32, 8)
#undef K4_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// f32: 0 for float64 coef, U and V, 1 for float32 ones summed in float64, 2
// for float32 ones summed in float32 (ACC32); out is a float64 scalar, or a
// float32 one with f32 = 2, and part holds one sum of that type a chunk.
// V may equal U (pass same = 1 to read U only).  g (lanes an entry) and cpl
// (columns a lane and pass) name the instantiation
// (kernels.lane_group); grid blocks take the ceil(nnz / 256) chunks by
// stride.  part (one double a chunk) and ticket (an unsigned that is 0 at
// the call and is 0 again after it) are the caller's scratch, used by one
// call at a time: one stream's eager calls, or one call site of one
// captured CUDA graph.  Returns the launch's cudaGetLastError() code.
extern "C" int ltr_sym_contract_sum(int f32, const void* rows,
                                    const void* cols, const void* coef,
                                    const void* U, const void* V, int nnz,
                                    int r, int same, int g, int cpl,
                                    int grid, void* part, void* ticket,
                                    void* out, void* stream) {
  if (r <= 0 || nnz < 0 || grid <= 0 || (g < 32 && r > g * cpl) ||
      part == nullptr || ticket == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{rows, cols, coef, U, V, nnz, r, grid, part, ticket, out,
               nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch<float>(g, cpl, same, f32 == 2, a, s)
             : dispatch<double>(g, cpl, same, 0, a, s);
}

// The blocks of the instantiation (f32 as above, same, g, cpl) that fit one
// SM of the current device at once, into *blocks.  Returns the query's
// cudaError.
extern "C" int ltr_sym_contract_sum_resident(int f32, int same, int g,
                                             int cpl, int* blocks) {
  Args a{};
  a.resident = blocks;
  return f32 ? dispatch<float>(g, cpl, same, f32 == 2, a, nullptr)
             : dispatch<double>(g, cpl, same, 0, a, nullptr);
}
