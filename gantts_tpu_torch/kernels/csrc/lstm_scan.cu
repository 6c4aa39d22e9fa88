// Hopper (sm_90a) kernels for the LSTM recurrence: one or two directions of
// one layer in one launch.
//
// Two launches replace the TPU kernels of gantts_tpu/kernels/lstm_scan.py:
//
//   lstm_fwd_scan  the recurrence of `_lstm_fwd_kernel`, `_plstm_fwd_kernel`
//                  and `_bilstm_fwd_kernel`, from xp = x @ W_ih (the
//                  projection is sru_proj_gemm, the counterpart of
//                  `_proj_u`): gates = xp_t + b + h_{t-1} W_hh with f32
//                  accumulation, i, f, o sigmoid and g tanh, c = f c + i g,
//                  h = o tanh(c), both carries frozen past each row's
//                  length; y (zero there), c (f32) and the activated gates
//                  g4 are stored per step.
//
//   lstm_bwd_scan  the BPTT of `_lstm_bwd_kernel` and `_bilstm_bwd_kernel`:
//                  walks each direction opposite to its forward traversal,
//                  forms the gate adjoints from the stored g4 and c, stores
//                  them as dxp, carries dh = (1 - m) dh + dxp_t W_hh^T and
//                  dc, and writes per-row partials of the bias gradient that
//                  the caller sums (deterministic, no atomics).  dW_hh, dx
//                  and dW_ih are library matmuls outside, as the JAX package
//                  leaves them to XLA.
//
// What bounds them.  Each step needs all of h_{t-1} (B x H) and all of W_hh
// (H x 4H: 2 MB in bf16 at H=512), and the steps are strictly sequential.
// The TPU kernel keeps W_hh resident in VMEM.  No SM holds 2 MB (227 KB of
// shared memory), and streaming W_hh from L2 every step would read 2 MB per
// block per step.  The work of one step is small (B=20, H=512: 84 MFLOP for
// both directions), so a step's latency, not bandwidth or FLOPs, bounds the
// kernel: T x (one exchange between SMs, one barrier, the cell).
//
// Both kernels, bf16 with H = 256 or 512 and B <= 24 (the training steps'
// shapes): one thread-block cluster of 16 blocks (the non-portable size)
// per direction, each block owning U = H / 16 hidden units, 512 threads.
// The hardware schedules a cluster's blocks together, so neither a
// cooperative launch nor a global barrier counter is needed, and a block
// can copy into the shared memory of the others (distributed shared
// memory).  W_hh never leaves registers: each block's slice of the product
// is held in the layout of mma.sync's A fragments, which wgmma also takes,
// for the whole launch (64 registers a thread at H=512).  Each step's exchange is one bulk copy (cp.async.bulk,
// shared::cta to shared::cluster) from every block into every other, whose
// bytes complete a transaction barrier (mbarrier) in the receiving block;
// each block waits on its own barrier of the step's parity, so no step
// holds a cluster-wide barrier.  Each thread's cell takes two adjacent
// units of one row b, with its carries in registers, and its inputs for
// the next step, which do not depend on the recurrence, are copied by
// cp.async into slots only it reads while the current step runs; the
// outputs' stores are never waited for.
//
// The forward (`lstm_fwd_cluster_kernel`), per block and step:
//
//   * The product gates^T = W^T h_{t-1}^T for the block's M = 4U gate
//     columns [i|f|g|o] (f32 accumulation, B padded to 24 rows, K = H) on
//     wgmma: each warpgroup runs one m64 x n24 tile over one split of K (2
//     m-tiles x 2 splits at H=512, 1 x 4 at H=256), A (W) from its warps'
//     registers, B (h) from the receive slots, which hold h in wgmma's
//     K-major layout without swizzle.  The same product on mma.sync, each
//     warp loading its own B fragments, took about 1.4 us a step: the 8
//     warps of a split read the same h from shared memory, 196 KB a step
//     per SM; a warpgroup reads it once.  The splits' partial sums meet in
//     shared memory after one block barrier and are added in the order of
//     their K ranges, so the result does not depend on timing.  A split
//     that gave each warp one source block's K range for all m-tiles, so
//     it could start as soon as that slice landed, would need 96
//     accumulators a thread beside W's 64 (128 is the limit at 512
//     threads).
//   * The cell: pre = (xp + b) + the sum, i, f, o sigmoid and g tanh (from
//     __expf and __fdividef, about 0.4 us a step less than libm's expf and
//     tanhf, within 1e-6 of them), c = f c + i g, h = o tanh(c), both
//     carries frozen past the row's length; y (zero there), c and the four
//     gates straight to global, and the carried h, rounded to bf16 as the
//     product takes it, into the block's send slice.
//   * After a second block barrier, warp w sends the slice's row groups
//     that hold the B real rows (1.5 KB at B=20, H=512) to block w's
//     receive slot for this block: an all-gather, about half the
//     backward's bytes.  Rows past B are zeroed once.
//   * What stays on the serial chain: the barrier wait, the product, two
//     block barriers, the cell, the bulk copies' flight.  On an H100 at
//     B=20, H=512 a step takes about 2.6 us with one or two directions.
//
// The backward (`lstm_bwd_cluster_kernel`), per block and step:
//
//   * Each thread's cell forms dgates_t from the carried dh and dc and the
//     stored g4, c and gy, stores it to dxp and, as bf16, to shared memory.
//     After one block barrier, warp w forms the partial dh^T = W_hh[wU:(w+
//     1)U, block's columns] dgates_t^T (its A fragments are the U rows block
//     w owns) and sends it to block w: a reduce-scatter, (B rounded up to 4)
//     x (U+2) f32 to each block.  Each block sums the 16 slices in the
//     order of their source.
//   * The receive slots, dgates_t and the input slots are double-buffered
//     by step parity: 206 KB of the 227 KB at H=512.
//   * What stays on the serial chain: the barrier wait, the sums, the cell,
//     one block barrier, the product (K/16 dependent mma steps), the bulk
//     copies' flight.  On an H100 at B=20, H=512 a step takes about 3.5 us
//     (2.2 us at B=1); a cluster barrier per step with per-thread remote
//     stores instead took 7.1 us, mostly the stores and the barrier's
//     release of every earlier store (dxp included).  The exchange alone,
//     16 slices of 2.7 KB into each block, takes about 1.55 us: distributed
//     shared memory's bandwidth, about 34 GB/s into an SM.
//
// float32 with B <= 24 and H = 256, 384 or 512 (the f32 paths' shapes: the
// vc bundle's LSTM at B=20 and VC synthesis's B=1) takes the flag design
// (`lstm_fwd_flag_kernel`, `lstm_bwd_flag_kernel`, below): 16 blocks cannot
// hold f32 W_hh (4 MB at H=512) and would cap the FMA product at 16 SMs (42
// MFLOP a step, at least 5.2 us at the H100's published f32 rate), so each
// direction is spread over H / U blocks of U = 8 units, each block's slice
// of W_hh held in registers for the launch.  With one direction (B >= 2)
// the rows are cut into two slices of ceil(B / 2), each with its own 64
// blocks, flags and scratch, since a row's recurrence never reads another
// row: 128 blocks of 8 units then do the FMAs a block of the forward's
// former 128 blocks of 4 units on all rows, and each stages half the bytes
// a step (the all-gather reads 2.6 MB of L2 a step, not 5.2); the
// backward's former 64 blocks of 8 on all rows did twice the product a
// block.  Two directions keep all rows in 64 blocks of 8 a direction (128
// SMs), one row keeps the forward at 128 blocks of 4.  Blocks exchange each
// step through global scratch and per-block step flags (a release store,
// acquire polls on exactly the flags a block needs) instead of a grid
// barrier; the forward all-gathers h_{t-1} (20 KB a block at B=20 in two
// slices), the backward reduce-scatters partial dh (20 KB a block, where
// the cooperative backward re-reads all of dgates_t, 160 KB); the cells'
// inputs are prefetched a step ahead by cp.async and their outputs stored
// after the flag.  On an NVIDIA H100 80GB HBM3 at 700 W, at T=512, B=20,
// H=512, one direction, a step takes 4.0 us forward and 4.6 us backward
// (4.9 and 5.9 before the slices), against an operations bound of 0.47 us
// each (PERF.md, the f32 LSTM findings).
//
// Values that carry their own step instead of a flag (each h or partial dh
// stored with a tag, polled directly, no release) were built and timed and
// are not used: a consumer cannot know when every word of a source has
// landed without polling each, and on the H100 the stores of one block
// became visible over about a microsecond, so the polls either re-read the
// whole exchange (5.2 MB of L2 a round) or waited on one probe word a
// source and then re-polled the stragglers: 6.5 to 7.2 us a forward step,
// 7.7 to 8.4 backward (8-byte words doubling the bytes), against the
// flags' 4.8 and 6.0.  The release's wait is the stores' landing, which a
// tag only moves to the consumer.
//
// Every other shape (f32 that the flag design's plan refuses, such as
// H=64; H other than 256 or 512 in bf16; B above 24) takes the cooperative
// design, chosen by shape in the launcher: a persistent kernel.
// Each direction's hidden units are spread over up to 64 blocks (8 units
// each at H=512).  A block keeps its slice of W_hh in shared memory for the
// whole launch (the columns of its units' four gates in the forward, the
// rows of its units in the backward: 32 KB in bf16), holds its units'
// carries in shared memory, and walks all of T.  Each step the blocks of
// one direction exchange what the next step needs through global memory
// (h_t in a small scratch, double-buffered by step parity, in the forward;
// dgates_t straight from dxp in the backward) and meet at a barrier: one
// counter per direction, counting arrivals monotonically over the launch,
// so it is never reset.  The two directions never wait on each other.  The
// barrier needs every block resident at once, so the launch is
// cooperative: cudaLaunchCooperativeKernel refuses a grid that could not
// be, and the caller raises.
//
// Per step a block stages the exchanged activations into shared memory and
// forms its slice of the product.  In bf16, when the slice is 8, 16 or 32
// columns wide and H a multiple of 16, the rows are staged in one pass of
// 16-byte cp.async copies and the product runs on the tensor cores
// (mma.sync m16n8k16, f32 accumulation); otherwise (f32 I/O, odd shapes)
// they are staged as f32 in chunks and each of 256 threads accumulates up
// to 32 rows for one column over a strided slice of k with FMA.  Partial
// sums are reduced through shared memory.  On an H100 at B=20, H=512, bf16,
// with both directions, a step takes about 7.3 us forward and 7.7 us in
// this design's backward: mostly latency, the barrier (about 1.2 us: store,
// fence, atomic, spin), the staging's round trip through L2 (each of a
// direction's 64 blocks reads all of h_{t-1} or dgates_t every step) and
// the cells' scattered loads issued after the product.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns a cudaError_t code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Loads of values that other blocks wrote during this launch go to L2
// (ld.global.cg), never to a line this SM's L1 may hold from before.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 load_cg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerDir = 64;
constexpr int kRows = 32;            // rows of the product per pass
constexpr int kAStride = kRows + 4;  // a warp's 4 k-rows hit distinct banks
constexpr int kChunk = 512;          // k values staged per pass

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// All blocks of one direction meet here; ``target`` is (number of barriers
// passed so far + 1) * blocks per direction.
__device__ __forceinline__ void dir_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (ld_acquire(count) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// part[kg][r][col] = sum over this thread's k of A[r][k] * W[k][col], for
// the nr (<= kRows) rows of A at src (I/O dtype, row stride ld, K columns)
// and the block's weight slice Ws[K][ncol].  Thread tid owns column
// tid % ncol and the k = kg, kg + nkg, ... of each chunk, kg = tid / ncol.
template <typename T>
__device__ int slice_product(const T* src, size_t ld, int K, const T* Ws,
                             int ncol, float* As, float* part, int nr) {
  const int tid = threadIdx.x;
  const int nkg = kThreads / ncol;
  const int col = tid % ncol, kg = tid / ncol;
  const int nr4 = (nr + 3) & ~3;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    __syncthreads();  // the previous chunk and part are no longer read
    // Each thread stages whole k columns (all rows), so no index is
    // divided; every load of a column is issued before any is used.
    for (int kk = tid; kk < kc; kk += kThreads) {
      T v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) v[r] = load_cg(src + (size_t)r * ld + k0 + kk);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr4) As[kk * kAStride + r] = r < nr ? to_f32(v[r]) : 0.f;
    }
    __syncthreads();
    if (kg < nkg) {
      for (int k = kg; k < kc; k += nkg) {
        const float w = to_f32(Ws[(size_t)(k0 + k) * ncol + col]);
        const float4* a4 = reinterpret_cast<const float4*>(As + k * kAStride);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          if (4 * q < nr4) {
            const float4 a = a4[q];
            acc[4 * q] = fmaf(a.x, w, acc[4 * q]);
            acc[4 * q + 1] = fmaf(a.y, w, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(a.z, w, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(a.w, w, acc[4 * q + 3]);
          }
        }
      }
    }
  }
  if (kg < nkg) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr) part[(kg * kRows + r) * ncol + col] = acc[r];
  }
  __syncthreads();
  return nkg;
}

// The same product for bf16 on the tensor cores, mma.sync m16n8k16 with
// f32 accumulation: the block's weight slice is Wt[ncol][K + 8] (k
// contiguous, rows padded so a warp's fragment loads hit 32 banks), the A
// rows are staged as bf16 rows Ah[kRows][min(K, kChunkH) + 8] by 16-byte
// cp.async copies, all issued before any is waited for: one L2 round trip
// per step for up to 2048 k.  The (m16 x n8) output tiles (2 x ncol/8 at
// B=20) go one to a warp, and the warps left over split K: ``8 / tiles``
// partial sums per output, which is what the function returns.  Each warp
// alternates two accumulators so consecutive mma do not wait on each
// other.  The caller takes this path only for ncol in {8, 16, 32} and K
// and the row stride multiples of 16 (aligned copies, whole k-steps).
// Rows of Ah past nr are left stale: an output row depends on its own A
// row only, and those rows are dropped.
constexpr int kChunkH = 2048;

__host__ __device__ inline int a_stride_h(int K) {
  return (K < kChunkH ? K : kChunkH) + 8;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

// One m16n8k16 step of a warp's tile at k offset kk of the staged chunk.
__device__ __forceinline__ void mma_step(float (&c)[4],
                                         const __nv_bfloat16* ap,
                                         const __nv_bfloat16* bp, int as,
                                         int kk) {
  const uint32_t a[4] = {lds32(ap + kk), lds32(ap + 8 * as + kk),
                         lds32(ap + kk + 8), lds32(ap + 8 * as + kk + 8)};
  mma_bf16(c, a, lds32(bp + kk), lds32(bp + kk + 8));
}

__device__ int slice_product_mma(const __nv_bfloat16* src, size_t ld, int K,
                                 const __nv_bfloat16* Wt, int ncol,
                                 __nv_bfloat16* Ah, float* part, int nr) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ntiles = ncol >> 3, tiles = (nr > 16 ? 2 : 1) * ntiles;
  const int ks = (kThreads / 32) / tiles;
  const int tile = warp % tiles, split = warp / tiles;
  const int m0 = (tile / ntiles) * 16, n0 = (tile % ntiles) * 8;
  const int as = a_stride_h(K);
  const size_t sw = (size_t)K + 8;
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += kChunkH) {
    const int kc = min(kChunkH, K - k0), vpr = kc / 8;
    __syncthreads();  // the previous chunk and part are no longer read
    if (vpr <= kThreads) {
      const int rstep = kThreads / vpr, r0 = tid / vpr, q = tid - r0 * vpr;
      if (r0 < rstep)
        for (int r = r0; r < nr; r += rstep)
          cp_async16(Ah + r * as + q * 8, src + (size_t)r * ld + k0 + q * 8);
    } else {
      for (int r = 0; r < nr; ++r)
        for (int q = tid; q < vpr; q += kThreads)
          cp_async16(Ah + r * as + q * 8, src + (size_t)r * ld + k0 + q * 8);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const __nv_bfloat16* ap = Ah + (m0 + g) * as + t4 * 2;
    const __nv_bfloat16* bp = Wt + (n0 + g) * sw + k0 + t4 * 2;
    const int step = ks * 16;
    int kk = split * 16;
    for (; kk + step < kc; kk += 2 * step) {
      mma_step(c0, ap, bp, as, kk);
      mma_step(c1, ap, bp, as, kk + step);
    }
    if (kk < kc) mma_step(c0, ap, bp, as, kk);
  }
  float* p = part + split * kRows * ncol + n0 + t4 * 2;
  const int r = m0 + g;
  if (r < nr) p[r * ncol] = c0[0] + c1[0], p[r * ncol + 1] = c0[1] + c1[1];
  if (r + 8 < nr)
    p[(r + 8) * ncol] = c0[2] + c1[2], p[(r + 8) * ncol + 1] = c0[3] + c1[3];
  __syncthreads();
  return ks;
}

// The block's product by whichever path the launch chose (``mma`` is
// uniform over the grid); returns the number of partial sums per output.
template <typename T>
__device__ int product(const T* src, size_t ld, int K, const T* W, int ncol,
                       float* As, float* part, int nr, int mma) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (mma)
      return slice_product_mma(src, ld, K, W, ncol,
                               reinterpret_cast<__nv_bfloat16*>(As), part, nr);
  }
  return slice_product(src, ld, K, W, ncol, As, part, nr);
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// The weight slice: ncol columns of K values, as Ws[K][ncol] for the FMA
// product or Wt[ncol][K + 8] for the tensor cores; room for either.
template <typename T>
__host__ __device__ size_t w_bytes(int K, int ncol) {
  return align16(sizeof(T) * (size_t)ncol * (K + 8));
}

// Floats of the staged A region: f32 chunks for the FMA product, or bf16
// rows for the tensor cores (bf16 only), rounded to 16 bytes.
template <typename T>
__host__ __device__ size_t a_floats(int K) {
  const size_t fma = (size_t)kChunk * kAStride;
  const size_t mma = std::is_same<T, __nv_bfloat16>::value
                         ? ((size_t)kRows * a_stride_h(K) / 2 + 3) & ~(size_t)3
                         : 0;
  return fma > mma ? fma : mma;
}

// Bytes of shared memory: the weight slice, then the f32 regions: the
// staged A rows, the partial sums, and ``carries`` floats per cell.
template <typename T>
size_t smem_bytes(int K, int ncol, int hs, int B, int carries) {
  return w_bytes<T>(K, ncol) +
         sizeof(float) * (a_floats<T>(K) + (size_t)kThreads * kRows +
                          (size_t)carries * B * hs);
}

// ---------------------------------------------------------------------------
// Forward.  Layouts: xp and g4 (T, B, ndir*4H), direction d's [i|f|g|o]
// blocks at [d*4H, (d+1)*4H); y and c (T, B, ndir*H); W_hh (ndir, H, 4H);
// bias (ndir, 4H) f32; hx scratch (2, ndir, B, H) in the I/O dtype.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ whh,
                const float* __restrict__ bias,
                const int* __restrict__ lengths, T* __restrict__ y,
                float* __restrict__ c, T* __restrict__ g4, T* hx, unsigned* bar, int nt, int B, int H, int hs_max, int nb,
                int ndir, int rev_mask, int mma) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int d = blockIdx.x / nb, j0 = (blockIdx.x % nb) * hs_max;
  const int hs = min(hs_max, H - j0);
  const int ncol = 4 * hs_max;
  const int rev = (rev_mask >> d) & 1;
  const size_t G = (size_t)ndir * 4 * H, Y = (size_t)ndir * H;
  T* Ws = reinterpret_cast<T*>(smem);  // W_hh columns of the units' gates
  float* As = reinterpret_cast<float*>(smem + w_bytes<T>(H, ncol));
  float* part = As + a_floats<T>(H);
  float* hcar = part + kThreads * kRows;  // [B][hs_max]
  float* ccar = hcar + B * hs_max;

  // column col = g * hs_max + jj is W_hh[:, g*H + j0 + jj]
  const T* w = whh + (size_t)d * H * 4 * H;
  for (int i = tid; i < H * ncol; i += kThreads) {
    const int k = i / ncol, col = i - k * ncol;
    const int g = col / hs_max, jj = col - g * hs_max;
    const T v = jj < hs ? w[(size_t)k * 4 * H + g * H + j0 + jj]
                        : from_f32<T>(0.f);
    Ws[mma ? (size_t)col * (H + 8) + k : i] = v;
  }
  for (int i = tid; i < B * hs_max; i += kThreads) hcar[i] = ccar[i] = 0.f;
  __syncthreads();

  const float* bd = bias + (size_t)d * 4 * H;
  for (int s = 0; s < nt; ++s) {
    const int t = rev ? nt - 1 - s : s;
    const T* hprev = hx + ((size_t)((s + 1) & 1) * ndir + d) * B * H;
    T* hnext = hx + ((size_t)(s & 1) * ndir + d) * B * H;
    for (int r0 = 0; r0 < B; r0 += kRows) {
      const int nr = min(kRows, B - r0);
      const int nparts =
          s > 0 ? product(hprev + (size_t)r0 * H, (size_t)H, H, Ws, ncol, As,
                          part, nr, mma)
                : 0;
      for (int i = tid; i < nr * hs_max; i += kThreads) {
        const int r = i / hs_max, jj = i - r * hs_max;
        if (jj >= hs) continue;
        const int b = r0 + r, j = j0 + jj, cell = b * hs_max + jj;
        const size_t row = (size_t)t * B + b;
        const T* xr = xp + row * G + (size_t)d * 4 * H + j;
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float acc = 0.f;
          for (int q = 0; q < nparts; ++q)
            acc += part[(q * kRows + r) * ncol + g * hs_max + jj];
          pre[g] = (to_f32(xr[(size_t)g * H]) + bd[g * H + j]) + acc;
        }
        const float m = t < lengths[b] ? 1.f : 0.f;
        const float ig = sigmoidf(pre[0]), fg = sigmoidf(pre[1]);
        const float gg = tanhf(pre[2]), og = sigmoidf(pre[3]);
        const float c_new = fg * ccar[cell] + ig * gg;
        const float h_new = og * tanhf(c_new);
        const float h = m * h_new + (1.f - m) * hcar[cell];
        const float cv = m * c_new + (1.f - m) * ccar[cell];
        hcar[cell] = h;
        ccar[cell] = cv;
        y[row * Y + (size_t)d * H + j] = from_f32<T>(h_new * m);
        c[row * Y + (size_t)d * H + j] = cv;
        T* gr = g4 + row * G + (size_t)d * 4 * H + j;
        gr[0] = from_f32<T>(ig);
        gr[H] = from_f32<T>(fg);
        gr[2 * H] = from_f32<T>(gg);
        gr[3 * H] = from_f32<T>(og);
        hnext[(size_t)b * H + j] = from_f32<T>(h);
      }
    }
    if (s + 1 < nt) dir_barrier(bar + d, (unsigned)(s + 1) * nb);
  }
}

// ---------------------------------------------------------------------------
// Backward.  c (T, B, ndir*H) f32 and g4 (T, B, ndir*4H) from the forward;
// gy (T, B, ndir*H) the cotangent of y; dxp (T, B, ndir*4H) out; dbp
// (B, ndir*4H) f32 partials out.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const T* __restrict__ whh, const int* __restrict__ lengths,
                const float* __restrict__ c, const T* __restrict__ g4,
                const T* __restrict__ gy, T* dxp, float* __restrict__ dbp,
                unsigned* bar, int nt, int B, int H, int hs_max, int nb,
                int ndir, int rev_mask, int mma) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int d = blockIdx.x / nb, j0 = (blockIdx.x % nb) * hs_max;
  const int hs = min(hs_max, H - j0);
  const int ncol = hs_max;
  const int rev = (rev_mask >> d) & 1;
  const size_t G = (size_t)ndir * 4 * H, Y = (size_t)ndir * H;
  T* Ws = reinterpret_cast<T*>(smem);  // the units' rows of W_hh
  float* As = reinterpret_cast<float*>(smem + w_bytes<T>(4 * H, ncol));
  float* part = As + a_floats<T>(4 * H);
  float* dh = part + kThreads * kRows;  // [B][hs_max]
  float* dc = dh + B * hs_max;
  float* db = dc + B * hs_max;          // [B][hs_max][4]

  const T* w = whh + (size_t)d * H * 4 * H;
  for (int i = tid; i < 4 * H * hs_max; i += kThreads) {
    const int k = i / hs_max, jj = i - k * hs_max;
    const T v = jj < hs ? w[(size_t)(j0 + jj) * 4 * H + k] : from_f32<T>(0.f);
    Ws[mma ? (size_t)jj * (4 * H + 8) + k : i] = v;
  }
  for (int i = tid; i < B * hs_max; i += kThreads) {
    dh[i] = dc[i] = 0.f;
    db[4 * i] = db[4 * i + 1] = db[4 * i + 2] = db[4 * i + 3] = 0.f;
  }
  __syncthreads();

  for (int s = 0; s < nt; ++s) {
    // opposite to the forward traversal; tp is the forward's previous step
    const int t = rev ? s : nt - 1 - s;
    const int tp = rev ? t + 1 : t - 1;
    for (int i = tid; i < B * hs_max; i += kThreads) {
      const int b = i / hs_max, jj = i - b * hs_max;
      if (jj >= hs) continue;
      const int j = j0 + jj;
      const size_t row = (size_t)t * B + b;
      const float m = t < lengths[b] ? 1.f : 0.f;
      const T* gr = g4 + row * G + (size_t)d * 4 * H + j;
      const float ig = to_f32(gr[0]), fg = to_f32(gr[H]);
      const float gg = to_f32(gr[2 * H]), og = to_f32(gr[3 * H]);
      const float ct = c[row * Y + (size_t)d * H + j];
      const float cp = (tp >= 0 && tp < nt)
                           ? c[((size_t)tp * B + b) * Y + (size_t)d * H + j]
                           : 0.f;
      const float tc = tanhf(ct);
      const float da = m * (dh[i] + to_f32(gy[row * Y + (size_t)d * H + j]));
      const float do_ = da * tc;
      const float dc_new = da * og * (1.f - tc * tc) + m * dc[i];
      const float di = dc_new * gg, df = dc_new * cp, dg = dc_new * ig;
      const float dgi = di * ig * (1.f - ig);
      const float dgf = df * fg * (1.f - fg);
      const float dgg = dg * (1.f - gg * gg);
      const float dgo = do_ * og * (1.f - og);
      T* dr = dxp + row * G + (size_t)d * 4 * H + j;
      dr[0] = from_f32<T>(dgi);
      dr[H] = from_f32<T>(dgf);
      dr[2 * H] = from_f32<T>(dgg);
      dr[3 * H] = from_f32<T>(dgo);
      db[4 * i] += dgi;
      db[4 * i + 1] += dgf;
      db[4 * i + 2] += dgg;
      db[4 * i + 3] += dgo;
      dh[i] = (1.f - m) * dh[i];
      dc[i] = (1.f - m) * dc[i] + dc_new * fg;
    }
    if (s + 1 == nt) break;
    dir_barrier(bar + d, (unsigned)(s + 1) * nb);
    // dh += dgates_t W_hh^T for this block's units, dgates_t read from dxp
    for (int r0 = 0; r0 < B; r0 += kRows) {
      const int nr = min(kRows, B - r0);
      const int nparts =
          product(dxp + ((size_t)t * B + r0) * G + (size_t)d * 4 * H, G,
                  4 * H, Ws, ncol, As, part, nr, mma);
      for (int i = tid; i < nr * hs_max; i += kThreads) {
        const int r = i / hs_max, jj = i - r * hs_max;
        if (jj >= hs) continue;
        float acc = 0.f;
        for (int q = 0; q < nparts; ++q)
          acc += part[(q * kRows + r) * ncol + jj];
        dh[(r0 + r) * hs_max + jj] += acc;
      }
    }
    __syncthreads();  // dh is read under another thread mapping next step
  }
  for (int i = tid; i < B * hs_max; i += kThreads) {
    const int b = i / hs_max, jj = i - b * hs_max;
    if (jj >= hs) continue;
    float* out = dbp + (size_t)b * G + (size_t)d * 4 * H + j0 + jj;
#pragma unroll
    for (int g = 0; g < 4; ++g) out[(size_t)g * H] = db[4 * i + g];
  }
}

// ---------------------------------------------------------------------------
// Backward, one thread-block cluster per direction (see the note at the top
// of the file): bf16, H = 256 * MT, B <= kCMaxB.  Layouts as above.
// ---------------------------------------------------------------------------

constexpr int kCThreads = 512;  // 16 warps: warp w forms the slice block w owns
constexpr int kCBlocks = 16;    // blocks in a cluster: the non-portable size
constexpr int kCMaxB = 24;      // rows: three n8 tiles

// Shapes the cluster kernel takes; the launcher sends the rest to the
// cooperative one.
inline bool cluster_takes(int B, int H, int bf16) {
  return bf16 && (H == 256 || H == 512) && B >= 1 && B <= kCMaxB;
}

// Per block of U hidden units (H = 16 U): K = 4U gate columns, dgates_t
// rows of K + 8 bf16 (fragment loads hit 32 banks), partial slices of
// kCMaxB rows of U + 2 f32 (even, for float2 reads).
template <int U>
struct ClusterShape {
  static constexpr int K = 4 * U, BStride = K + 8, Row = U + 2;
  static constexpr int Slot = kCMaxB * Row;
};

// Dynamic shared memory: the receive slots of both step parities, the
// send slices, dgates_t of both parities, and each thread's cell inputs of
// both parities (c_t, c_{t-1} as float2; g4's four gates and gy as bf16x2).
template <int U>
constexpr size_t bwd_cluster_smem_bytes() {
  using S = ClusterShape<U>;
  return sizeof(float) * 3 * kCBlocks * S::Slot +
         sizeof(__nv_bfloat16) * 2 * kCMaxB * S::BStride +
         2 * kCThreads * (2 * sizeof(float2) + 5 * sizeof(uint32_t));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival on the barrier's current phase, which then also waits for
// ``bytes`` of transactions.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Returns once the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The address in block ``rank`` of the cluster of this block's shared
// address ``addr``.
__device__ __forceinline__ uint32_t peer_u32(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// One bulk copy of ``bytes`` (a multiple of 16) from this block's shared
// memory into a peer's, completing as transactions on the peer's barrier.
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A 4- or 8-byte cp.async from global into shared memory.
template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N)
               : "memory");
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

template <int U>
__global__ void __launch_bounds__(kCThreads, 1)
lstm_bwd_cluster_kernel(const __nv_bfloat16* __restrict__ whh,
                        const int* __restrict__ lengths,
                        const float* __restrict__ c,
                        const __nv_bfloat16* __restrict__ g4,
                        const __nv_bfloat16* __restrict__ gy,
                        __nv_bfloat16* __restrict__ dxp,
                        float* __restrict__ dbp, int nt, int B, int ndir,
                        int rev_mask) {
  using S = ClusterShape<U>;
  constexpr int H = kCBlocks * U, K = S::K, MT = U / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[2];  // a parity's slices arrived
  float* recv = reinterpret_cast<float*>(smem);  // [2][16 sources][Slot]
  float* send = recv + 2 * kCBlocks * S::Slot;   // [16 peers][Slot]
  // dgates_t [2][kCMaxB][BStride], then the inputs, [2][kCThreads] each
  __nv_bfloat16* Bs =
      reinterpret_cast<__nv_bfloat16*>(send + kCBlocks * S::Slot);
  float2* in_c = reinterpret_cast<float2*>(Bs + 2 * kCMaxB * S::BStride);
  float2* in_cp = in_c + 2 * kCThreads;
  uint32_t* in_g4 = reinterpret_cast<uint32_t*>(in_cp + 2 * kCThreads);
  uint32_t* in_gy = in_g4 + 2 * 4 * kCThreads;  // g4 is [2][4][kCThreads]
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.x / kCBlocks, j0 = rank * U;
  const int rev = (rev_mask >> d) & 1;
  const size_t G = (size_t)ndir * 4 * H, Y = (size_t)ndir * H;
  // the rows a slice carries, a multiple of 4 so that it is whole 16 bytes
  const uint32_t slice_bytes = ((B + 3) & ~3) * S::Row * sizeof(float);

  // Warp w's A fragments for the whole launch: W_hh rows (hidden units)
  // w U + [0, U), those block w owns, and this block's gate columns
  // k = 0..K-1 (gate k / U, unit j0 + k % U).  A fragment's k and k + 8
  // lie in one gate.
  const int u0 = warp * U;
  uint32_t a[MT][K / 16][4];
  {
    const __nv_bfloat16* w = whh + (size_t)d * H * 4 * H;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < K / 16; ++ks) {
        const int k = ks * 16 + 2 * t4;
        const __nv_bfloat16* r0 = w + (size_t)(u0 + mt * 16 + g) * 4 * H +
                                  (k / U) * H + j0 + k % U;
        const __nv_bfloat16* r8 = r0 + (size_t)8 * 4 * H;
        a[mt][ks][0] = ldg32(r0);
        a[mt][ks][1] = ldg32(r8);
        a[mt][ks][2] = ldg32(r0 + 8);
        a[mt][ks][3] = ldg32(r8 + 8);
      }
  }

  // This thread's cell: units jj and jj + 1 of row b.
  const int b = tid / (U / 2), jj = 2 * (tid % (U / 2)), j = j0 + jj;
  const bool cell = b < B;
  const int len = cell ? lengths[b] : 0;
  float dh[2] = {0.f, 0.f}, dc[2] = {0.f, 0.f};
  float db[4][2] = {};

  // Stage this thread's cell inputs of traversal step s (none depends on
  // the recurrence) with cp.async into the slots of parity p; only this
  // thread reads them.
  auto prefetch = [&](int s, int p) {
    if (!cell) return;
    const int t = rev ? s : nt - 1 - s, tp = rev ? t + 1 : t - 1;
    const size_t row = (size_t)t * B + b;
    const int i = p * kCThreads + tid;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cp_async_small<4>(in_g4 + (p * 4 + q) * kCThreads + tid,
                        g4 + row * G + (size_t)d * 4 * H + q * H + j);
    cp_async_small<4>(in_gy + i, gy + row * Y + (size_t)d * H + j);
    cp_async_small<8>(in_c + i, c + row * Y + (size_t)d * H + j);
    if (tp >= 0 && tp < nt)
      cp_async_small<8>(in_cp + i,
                        c + ((size_t)tp * B + b) * Y + (size_t)d * H + j);
    else
      in_cp[i] = make_float2(0.f, 0.f);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (tid == 0) {
    mbar_init(smem_u32(&full[0]), 1);
    mbar_init(smem_u32(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // armed for the first slices of each parity: one from every block
    mbar_expect_tx(smem_u32(&full[0]), kCBlocks * slice_bytes);
    mbar_expect_tx(smem_u32(&full[1]), kCBlocks * slice_bytes);
  }
  for (int i = tid; i < 2 * kCMaxB * S::BStride; i += kCThreads)
    Bs[i] = __float2bfloat16(0.f);  // rows past B stay zero
  prefetch(0, 0);
  // every block's barriers are set up before any slice is sent
  cluster.sync();

  for (int s = 0; s < nt; ++s) {
    const int t = rev ? s : nt - 1 - s, p = s & 1;
    if (s > 0) {
      const uint32_t bar = smem_u32(&full[p ^ 1]);
      mbar_wait(bar, ((s - 1) >> 1) & 1);  // step s-1's slices are in
      // Re-armed for step s+1's slices.  None can arrive before this
      // block has sent its step-s slices, after the barrier below.
      if (tid == 0) mbar_expect_tx(bar, kCBlocks * slice_bytes);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // step s's inputs
    if (s + 1 < nt) prefetch(s + 1, p ^ 1);
    __nv_bfloat16* bs = Bs + p * kCMaxB * S::BStride;
    if (cell) {
      if (s > 0) {  // the slices of the 16 blocks, summed in their order
        const float* part = recv + (p ^ 1) * kCBlocks * S::Slot +
                            b * S::Row + jj;
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int src = 0; src < kCBlocks; ++src) {
          const float2 v =
              *reinterpret_cast<const float2*>(part + src * S::Slot);
          acc.x += v.x;
          acc.y += v.y;
        }
        dh[0] += acc.x;
        dh[1] += acc.y;
      }
      const int i = p * kCThreads + tid;
      const float2 ig = bf2(in_g4[(p * 4) * kCThreads + tid]);
      const float2 fg = bf2(in_g4[(p * 4 + 1) * kCThreads + tid]);
      const float2 gg = bf2(in_g4[(p * 4 + 2) * kCThreads + tid]);
      const float2 og = bf2(in_g4[(p * 4 + 3) * kCThreads + tid]);
      const float2 gyv = bf2(in_gy[i]), ct = in_c[i], cp = in_cp[i];
      const float m = t < len ? 1.f : 0.f;
      float dg[4][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ie = e ? ig.y : ig.x, fe = e ? fg.y : fg.x;
        const float ge = e ? gg.y : gg.x, oe = e ? og.y : og.x;
        const float tc = tanhf(e ? ct.y : ct.x);
        const float da = m * (dh[e] + (e ? gyv.y : gyv.x));
        const float do_ = da * tc;
        const float dc_new = da * oe * (1.f - tc * tc) + m * dc[e];
        dg[0][e] = dc_new * ge * ie * (1.f - ie);
        dg[1][e] = dc_new * (e ? cp.y : cp.x) * fe * (1.f - fe);
        dg[2][e] = dc_new * ie * (1.f - ge * ge);
        dg[3][e] = do_ * oe * (1.f - oe);
        dh[e] = (1.f - m) * dh[e];
        dc[e] = (1.f - m) * dc[e] + dc_new * fe;
      }
      __nv_bfloat16* dr =
          dxp + ((size_t)t * B + b) * G + (size_t)d * 4 * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(dg[q][0], dg[q][1]);
        *reinterpret_cast<__nv_bfloat162*>(dr + (size_t)q * H) = v;
        *reinterpret_cast<__nv_bfloat162*>(bs + b * S::BStride + q * U +
                                           jj) = v;
        db[q][0] += dg[q][0];
        db[q][1] += dg[q][1];
      }
    }
    if (s + 1 == nt) break;
    __syncthreads();  // dgates_t is in bs

    // Warp w's partial dh^T: W_hh rows w U + [0, U) (rows of A) x 24 rows
    // of dgates_t (columns of the tile), from this block's K gate columns.
    float acc[MT][3][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 3; ++n)
        acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      uint32_t b0[3], b1[3];
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const __nv_bfloat16* bp =
            bs + (n * 8 + g) * S::BStride + ks * 16 + 2 * t4;
        b0[n] = lds32(bp);
        b1[n] = lds32(bp + 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 3; ++n)
          mma_bf16(acc[mt][n], a[mt][ks], b0[n], b1[n]);
    }
    // Into the slice for block ``warp``, [row][unit], once the copy of
    // step s-1 has read it; then one bulk copy into that block's slot for
    // this block, in its buffer of parity p.
    float* sl = send + warp * S::Slot;
    if (lane == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        float* o = sl + (n * 8 + 2 * t4) * S::Row + mt * 16 + g;
        o[0] = acc[mt][n][0];
        o[S::Row] = acc[mt][n][1];
        o[8] = acc[mt][n][2];
        o[S::Row + 8] = acc[mt][n][3];
      }
    // the slice, written by this proxy, is read by the copy engine's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      const uint32_t dst =
          smem_u32(recv + (p * kCBlocks + rank) * S::Slot);
      bulk_to_peer(peer_u32(dst, warp), smem_u32(sl), slice_bytes,
                   peer_u32(smem_u32(&full[p]), warp));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // a block leaves only once its copies have read its shared memory
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  if (cell) {
    float* out = dbp + (size_t)b * G + (size_t)d * 4 * H + j;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float2*>(out + (size_t)q * H) =
          make_float2(db[q][0], db[q][1]);
  }
}

// ---------------------------------------------------------------------------
// Forward, one thread-block cluster per direction (see the note at the top
// of the file): bf16, H = 16 U, B <= kCMaxB.  Layouts as the cooperative
// forward's, without the hx scratch and the barrier counters.
// ---------------------------------------------------------------------------

// Per block of U hidden units: M = 4U gate columns in MTiles m16 tiles,
// one to a warp, so the 4 warps of a warpgroup hold an m64 tile; the 16
// warps are MTiles x Splits, the Splits warps of an m-tile each taking H /
// Splits of K (KSteps k16 steps).  An h slice is wgmma's K-major operand
// without swizzle: core matrices of 8 rows x 8 bf16 (128 contiguous
// bytes), [row group][K chunk], kCMaxB rows of U.  A partial sum is
// kCMaxB rows of M + 4 f32 (the fragment stores hit 32 banks).
template <int U>
struct FwdClusterShape {
  static constexpr int H = kCBlocks * U, M = 4 * U, MTiles = M / 16;
  static constexpr int Splits = kCThreads / 32 / MTiles;
  static constexpr int KSteps = H / Splits / 16;
  static constexpr int Chunks = U / 8, Slice = kCMaxB * U;
  static constexpr int PRow = M + 4;
};

// Where element (row n, unit k) of an h slice lies, in bf16.
template <int U>
__device__ __forceinline__ int slice_at(int n, int k) {
  return ((n / 8 * (U / 8) + k / 8) * 8 + n % 8) * 8 + k % 8;
}

// A wgmma descriptor of a K-major operand without swizzle at shared
// address ``addr``: core matrices ``kstep`` bytes apart along K and
// ``nstep`` bytes apart along N.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t kstep,
                                                uint32_t nstep) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kstep >> 4) << 16) |
         ((uint64_t)(nstep >> 4) << 32);
}

// d (m64 x n24, f32) += a (m64 x k16 bf16, this warp's m16 rows in
// registers as mma.sync's A fragment) x b (k16 x n24, from ``desc``).
__device__ __forceinline__ void wgmma_n24(float (&d)[12],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// sigmoid and tanh from __expf and __fdividef, within about 1e-6 of libm's
// where a bf16 rounding is 4e-3.
__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}

// Dynamic shared memory: the receive slots of both step parities (16
// slices each), the send slice, the Splits partial sums, each thread's
// xp inputs of both parities (four gates as bf16x2) and its bias (four
// gates as float2: off the registers, which W's fragments nearly fill).
// The slots come first: wgmma's operands lie on 16 bytes.
template <int U>
constexpr size_t fwd_cluster_smem_bytes() {
  using S = FwdClusterShape<U>;
  return sizeof(__nv_bfloat16) * (2 * kCBlocks + 1) * S::Slice +
         sizeof(float) * S::Splits * kCMaxB * S::PRow +
         sizeof(uint32_t) * 2 * 4 * kCThreads +
         sizeof(float2) * 4 * kCThreads;
}

__device__ __forceinline__ uint32_t ldg_pair(const __nv_bfloat16* lo,
                                             const __nv_bfloat16* hi) {
  return (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(lo)) |
         ((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(hi)) << 16);
}

template <int U>
__global__ void __launch_bounds__(kCThreads, 1)
lstm_fwd_cluster_kernel(const __nv_bfloat16* __restrict__ xp,
                        const __nv_bfloat16* __restrict__ whh,
                        const float* __restrict__ bias,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ y, float* __restrict__ c,
                        __nv_bfloat16* __restrict__ g4, int nt, int B,
                        int ndir, int rev_mask) {
  using S = FwdClusterShape<U>;
  constexpr int H = S::H;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[2];  // a parity's slices arrived
  // recv [2][16 sources][Slice], then send [Slice]
  __nv_bfloat16* recv = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* send = recv + 2 * kCBlocks * S::Slice;
  float* part = reinterpret_cast<float*>(send + S::Slice);  // [Splits][B][PRow]
  uint32_t* in_xp =  // [2][4][kCThreads]
      reinterpret_cast<uint32_t*>(part + S::Splits * kCMaxB * S::PRow);
  float2* in_b = reinterpret_cast<float2*>(in_xp + 2 * 4 * kCThreads);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.x / kCBlocks, j0 = rank * U;
  const int rev = (rev_mask >> d) & 1;
  const size_t G = (size_t)ndir * 4 * H, Y = (size_t)ndir * H;
  // only the row groups that hold the B real rows are sent: 512 or 256
  // bytes a group of 8
  const uint32_t slice_bytes = (B + 7) / 8 * 8 * U * sizeof(__nv_bfloat16);

  // Warp (mt, split)'s A fragments of gates^T = W^T h^T for the whole
  // launch: rows m = mt 16 + [0, 16) of this block's gate columns (gate
  // m / U, unit j0 + m % U; a tile lies in one gate), columns the hidden
  // units k of the split's K range, which blocks split Q .. split Q + Q - 1
  // own (Q = 16 / Splits).  Warpgroup mt / 4 + split MTiles / 4 runs the
  // m64 tile of its four warps over that K range.
  const int mt = warp % S::MTiles, split = warp / S::MTiles;
  const int kbase = split * (H / S::Splits);
  uint32_t a[S::KSteps][4];
  {
    const __nv_bfloat16* w = whh + (size_t)d * H * 4 * H;
    const int m0 = mt * 16 + g, m8 = m0 + 8;
    const __nv_bfloat16* w0 = w + (m0 / U) * H + j0 + m0 % U;
    const __nv_bfloat16* w8 = w + (m8 / U) * H + j0 + m8 % U;
#pragma unroll
    for (int ks = 0; ks < S::KSteps; ++ks) {
      const size_t k = (size_t)(kbase + ks * 16 + 2 * t4) * 4 * H;
      constexpr size_t r1 = 4 * H, r8 = 8 * 4 * H;
      a[ks][0] = ldg_pair(w0 + k, w0 + k + r1);
      a[ks][1] = ldg_pair(w8 + k, w8 + k + r1);
      a[ks][2] = ldg_pair(w0 + k + r8, w0 + k + r8 + r1);
      a[ks][3] = ldg_pair(w8 + k + r8, w8 + k + r8 + r1);
    }
  }

  // This thread's cell: units jj and jj + 1 of row b, its carries and
  // length in registers, its bias in its slots of in_b.
  const int b = tid / (U / 2), jj = 2 * (tid % (U / 2)), j = j0 + jj;
  const bool cell = b < B;
  const int len = cell ? lengths[b] : 0;
  float h[2] = {0.f, 0.f}, cc[2] = {0.f, 0.f};
  if (cell)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      in_b[q * kCThreads + tid] = *reinterpret_cast<const float2*>(
          bias + (size_t)d * 4 * H + q * H + j);

  // Stage this thread's xp of traversal step s (it does not depend on the
  // recurrence) with cp.async into its slots of parity p.
  auto prefetch = [&](int s, int p) {
    if (!cell) return;
    const int t = rev ? nt - 1 - s : s;
    const __nv_bfloat16* xr =
        xp + ((size_t)t * B + b) * G + (size_t)d * 4 * H + j;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cp_async_small<4>(in_xp + (p * 4 + q) * kCThreads + tid,
                        xr + (size_t)q * H);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (tid == 0) {
    mbar_init(smem_u32(&full[0]), 1);
    mbar_init(smem_u32(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // armed for the first slices of each parity: one from every block
    mbar_expect_tx(smem_u32(&full[0]), kCBlocks * slice_bytes);
    mbar_expect_tx(smem_u32(&full[1]), kCBlocks * slice_bytes);
  }
  for (int i = tid; i < (2 * kCBlocks + 1) * S::Slice; i += kCThreads)
    recv[i] = __float2bfloat16(0.f);  // rows past B stay zero
  // the zeros are written before any peer's copy lands beside them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  prefetch(0, 0);
  // every block's barriers are set up before any slice is sent
  cluster.sync();

  for (int s = 0; s < nt; ++s) {
    const int t = rev ? nt - 1 - s : s, p = s & 1;
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // step s's xp
    if (s + 1 < nt) prefetch(s + 1, p ^ 1);
    if (s > 0) {
      // h_{s-1} from all 16 blocks, in the slots of parity p ^ 1
      const uint32_t bar = smem_u32(&full[p ^ 1]);
      mbar_wait(bar, ((s - 1) >> 1) & 1);
      // Re-armed for h_{s+1}.  No block sends it before its product of
      // step s + 1, which needs this block's h_s, sent below.
      if (tid == 0) mbar_expect_tx(bar, kCBlocks * slice_bytes);
      const uint32_t hs = smem_u32(recv + (p ^ 1) * kCBlocks * S::Slice);
      float acc[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) acc[i] = 0.f;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < S::KSteps; ++ks) {
        const int k = kbase + ks * 16;  // within the slice of block k / U
        wgmma_n24(acc, a[ks],
                  kmajor_desc(hs + 2 * slice_at<U>(0, k % U) +
                                  2 * (k / U) * S::Slice,
                              128, S::Chunks * 128));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      // the split's partial sum, [row][gate column]
      float* pp = part + split * kCMaxB * S::PRow + mt * 16 + g;
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const int r = n * 8 + 2 * t4;
        pp[r * S::PRow] = acc[4 * n];
        pp[(r + 1) * S::PRow] = acc[4 * n + 1];
        pp[r * S::PRow + 8] = acc[4 * n + 2];
        pp[(r + 1) * S::PRow + 8] = acc[4 * n + 3];
      }
    }
    // the copies of step s - 1 have read the send slice
    if (lane == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();  // the partial sums are in; the send slice is free

    if (cell) {
      // pre = (xp + b) + h_{t-1} W_hh, the partial sums added in the order
      // of their K ranges, so the result does not depend on timing
      float pre[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 x = bf2(in_xp[(p * 4 + q) * kCThreads + tid]);
        const float2 bq = in_b[q * kCThreads + tid];
        float2 sum = make_float2(0.f, 0.f);
        if (s > 0) {
#pragma unroll
          for (int sp = 0; sp < S::Splits; ++sp) {
            const float2 v = *reinterpret_cast<const float2*>(
                part + (sp * kCMaxB + b) * S::PRow + q * U + jj);
            sum.x += v.x;
            sum.y += v.y;
          }
        }
        pre[q][0] = (x.x + bq.x) + sum.x;
        pre[q][1] = (x.y + bq.y) + sum.y;
      }
      const float m = t < len ? 1.f : 0.f;
      float act[4][2], yv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ig = fast_sigmoid(pre[0][e]);
        const float fg = fast_sigmoid(pre[1][e]);
        const float gg = fast_tanh(pre[2][e]), og = fast_sigmoid(pre[3][e]);
        const float c_new = fg * cc[e] + ig * gg;
        const float h_new = og * fast_tanh(c_new);
        h[e] = m * h_new + (1.f - m) * h[e];
        cc[e] = m * c_new + (1.f - m) * cc[e];
        yv[e] = h_new * m;
        act[0][e] = ig, act[1][e] = fg, act[2][e] = gg, act[3][e] = og;
      }
      const size_t row = (size_t)t * B + b;
      const size_t o = row * Y + (size_t)d * H + j;
      *reinterpret_cast<__nv_bfloat162*>(y + o) =
          __floats2bfloat162_rn(yv[0], yv[1]);
      *reinterpret_cast<float2*>(c + o) = make_float2(cc[0], cc[1]);
      __nv_bfloat16* gr = g4 + row * G + (size_t)d * 4 * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<__nv_bfloat162*>(gr + (size_t)q * H) =
            __floats2bfloat162_rn(act[q][0], act[q][1]);
      // the carried h as the next product takes it, h.to(bf16)
      *reinterpret_cast<__nv_bfloat162*>(send + slice_at<U>(b, jj)) =
          __floats2bfloat162_rn(h[0], h[1]);
      // the slice, written by this proxy, is read by the copy engine's
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    if (s + 1 == nt) break;
    __syncthreads();  // h_s is in the send slice
    if (lane == 0) {  // warp w sends it to block w, slot (parity p, rank)
      const uint32_t dst = smem_u32(recv + (p * kCBlocks + rank) * S::Slice);
      bulk_to_peer(peer_u32(dst, warp), smem_u32(send), slice_bytes,
                   peer_u32(smem_u32(&full[p]), warp));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // a block leaves only once its copies have landed
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// float32, the flag design (see the note at the top of the file): f32 I/O,
// B <= kFMaxB, H split into H / U blocks of U units a direction, every
// block resident (a cooperative launch), W_hh's column slice of the
// block's 4U gate columns in registers for the launch.  The blocks of
// a direction exchange each step through global scratch and per-block
// step flags: a block stores its part, then releases its flag with the
// step count (``publish``); a block that needs the parts of step s waits
// with acquire loads on the flags of their sources (``wait_flags``) and
// stages them into shared memory with 16-byte cp.async.cg (L2, never a stale
// L1 line) by all its threads (``stage_f32``).  Flags count steps
// monotonically over a launch, so nothing is reset; the wrapper zeroes
// them before every launch (a memset node in a replayed CUDA graph), since
// the allocator and a graph hand a launch the flags of an earlier one.  The
// release orders the block's stores of the step before its flag (the block
// barrier before it makes every thread's stores the releasing thread's to
// order), the acquire orders the stage after it, and h and the partial dh
// are double-buffered by step parity: a block overwrites a buffer at step
// s + 2 only after every block of its slice released step s + 1, which
// each did after staging step s's.  A plan may also cut the B rows into
// RS = 2 slices, each run by its own H / U blocks a direction with its own
// flags and scratch (the slices never exchange: a row's recurrence needs
// only its own h and dh), so one direction fills 128 SMs at U = 8.  A
// block's rows are padded to Bp (B rounded up to 4 in one slice; a slice's
// ceil(B / 2) rows up to 2: 16-byte copies of U Bp floats, float2 reads of
// the products' operands).
// ---------------------------------------------------------------------------

constexpr int kFMaxB = 24;            // rows the flag design takes
// {units a block, row slices}, in order of preference: [forward,
// backward].  With one direction both take 128 blocks of 8 units in two
// row slices: against the forward's 128 blocks of 4 units and all rows,
// the same FMAs a block and half the bytes each block stages a step (the
// all-gather of h reads 2.6 MB of L2 a step, not 5.2); against the
// backward's 64 blocks of 8, half the product a block for the same bytes:
// 4.0 against 4.9 us a forward step, 4.6 against 5.9 backward at B=20,
// H=512 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, the f32 LSTM
// findings).  Two directions fill 128 SMs with 64 blocks of 8 a direction
// on all rows; one row leaves the forward at 128 blocks of 4.
constexpr int kFPlans[2][3][2] = {{{8, 2}, {4, 1}, {8, 1}},
                                  {{8, 2}, {8, 1}, {4, 1}}};
constexpr int kFMinBlocks = 64;       // blocks a direction, at least
constexpr size_t kFMaxSmem = 232448;  // shared memory a block may use
constexpr int kFSplits = 32;  // the forward product's K splits (k mod 32)
constexpr int kFMaxL = 16;    // k a forward thread takes: H / 32
constexpr int kFMaxH = 512;   // H the flag design takes, at most

__host__ __device__ inline int pad4(int B) { return (B + 3) & ~3; }

// Rows of a slice when B rows are cut into ``rs`` slices (the last may
// hold fewer), and the rows a block pads them to.
__host__ __device__ inline int slice_rows(int B, int rs) {
  return (B + rs - 1) / rs;
}
__host__ __device__ inline int padded_rows(int B, int rs) {
  return rs == 1 ? pad4(B) : (slice_rows(B, rs) + 1) & ~1;
}

// The kernels are instantiated for each U and each padded row count BP
// of a block (``padded_rows``), so that a thread's rows are a constant: the
// products' loops then hold no branch (a guard on a run-time row count cost
// about 1 us a step on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).  The
// forward's threads: U column groups of 4 gate columns x RG row groups of R
// rows x kFSplits K splits = 256; partial sums [kFSplits][BP][PC], rows of
// PC = 4U + U floats (the cells' reads of them hit 32 banks).  The
// backward's: KG = 32 U groups of columns of dh (k0 = kg + KG i, i < H / KG
// <= KrMax) x RG row groups = 256.
// Either keeps 64 floats of W_hh a thread in registers at H = 512.
template <int U, int BP>
struct FlagShape {
  static_assert(BP % 2 == 0 && BP <= kFMaxB, "rows in twos, at most 24");
  static_assert(BP % 4 == 0 || U == 8, "a row group's rows are even");
  static constexpr int RG = 8 / U, R = BP / RG, PC = 5 * U;
  static constexpr int KG = 32 * U, KrMax = kFMaxH / KG;
};

// Forward: h_{t-1} staged [H][Bp], the partial sums [32][Bp][5U], the xp
// slots [2][256] float4 (W_hh's slice lives in registers).
inline size_t flag_fwd_smem(int Bp, int H, int U) {
  return sizeof(float) * ((size_t)H * Bp + (size_t)kFSplits * Bp * 5 * U +
                          2 * 4 * kThreads);
}

// Backward: the partial-dh slices of this block's units from every block
// [H / U][Bp][U], dgates_t [4U][Bp], the cell input slots [2][2][256]
// float4 (W_hh's slice lives in registers).
inline size_t flag_bwd_smem(int Bp, int H, int U) {
  return sizeof(float) * ((size_t)H * Bp + (size_t)4 * U * Bp +
                          2 * 2 * 4 * kThreads);
}

struct FlagPlan {
  int U, rs;  // units a block (0: no plan), row slices
};

// The plan of the forward (way 0) or the backward (way 1): the first {U,
// RS} of kFPlans[way] where U divides H into 32 U (the threads' split of
// the products), H / U blocks a direction are at least kFMinBlocks, the
// ndir * RS * H / U blocks fit one an SM on ``sms`` SMs, every slice holds
// a row, and the shared memory fits; U = 0 where none does (the shape goes
// to the cooperative design).  kernels/lstm_scan.py ``_flag_plan`` is the
// same rule.
inline FlagPlan f32_flag_plan(int B, int H, int ndir, int bf16, int sms,
                              int way) {
  if (bf16 || B < 1 || B > kFMaxB || H > kFMaxH) return {0, 1};
  for (const auto& pl : kFPlans[way]) {
    const int U = pl[0], rs = pl[1], Bp = padded_rows(B, rs);
    if (H % (32 * U) || H / U < kFMinBlocks || ndir * rs * (H / U) > sms ||
        B < rs)
      continue;
    if ((way ? flag_bwd_smem(Bp, H, U) : flag_fwd_smem(Bp, H, U)) <=
        kFMaxSmem)
      return {U, rs};
  }
  return {0, 1};
}

// ... on the current device (U = -1 where it cannot be queried).
FlagPlan flag_plan(int B, int H, int ndir, int bf16, int way) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return {-1, 1};
  return f32_flag_plan(B, H, ndir, bf16, sms, way);
}

// A load the compiler may not repeat: W_hh's values held in registers for
// a launch are read once, not reloaded from global memory at each use.
__device__ __forceinline__ float ld_once(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Threads 0..nb-1 each wait until source block tid's flag reaches s, with
// acquire loads; the block barrier then orders every thread's later reads
// after those acquires.  Every block is resident (a cooperative launch), so
// a flag that has not come after 2^24 polls (seconds) never will: the
// kernel traps, and the launch fails instead of hanging the card.  (Each
// poller copying its own source's part as soon as its flag came, beside
// the waits for later ones, was slower on an NVIDIA H100 80GB HBM3 at
// 700 W: 20 to 40 copies a thread in series; PERF.md.)
__device__ __forceinline__ void wait_flags(const unsigned* flags, int d,
                                           int nb, int s) {
  if ((int)threadIdx.x < nb) {
    const unsigned* f = flags + d * nb + threadIdx.x;
    for (unsigned n = 0; ld_acquire(f) < (unsigned)s; ++n)
      if (n == (1u << 24)) __trap();
  }
  __syncthreads();
}

// Every thread's stores of the step are issued (block barrier); thread 0
// then releases the block's flag with the step count.
__device__ __forceinline__ void publish(unsigned* flag, unsigned v) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, v);
}

// ``pieces`` runs of ``per16`` 16-byte pieces, ``stride`` floats apart at
// src, copied back to back into dst by cp.async.cg by all the block's
// threads; returns once they and the whole block are done.
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int pieces, int per16,
                                          int stride) {
  for (int i = threadIdx.x; i < pieces * per16; i += kThreads) {
    const int q = i / per16, r = i - q * per16;
    cp_async16(dst + 4 * i, src + (size_t)q * stride + 4 * r);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Waits for this thread's cp.async groups but the newest when one more
// was issued after the one wanted.
__device__ __forceinline__ void wait_slots(bool newer) {
  if (newer)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Forward, per block (of row slice sl: rows r0 .. r0 + Bl - 1) and step
// s > 0:
//   wait for the H / U flags of the slice's step s - 1, stage its h_{s-1}
//   (hx, [H][Bp] f32: 40 KB at B=20 in one slice, 20 KB in two) into
//   shared memory;
//   the product: thread (split, rg, cg) sums h[k][rg r + q] W[k][cg 4 + e]
//   over k = split, split + 32, ..., W's 4 columns held in registers for
//   the launch, so that each h value read from shared memory feeds 4 FMAs
//   (a warp's shared loads, broadcasts or not, cost one wavefront per 4
//   bytes a lane, a quarter of the FMA pipes' rate: one column a thread
//   with W in shared memory read 5x its FMA time on an NVIDIA H100 80GB
//   HBM3 at 700 W, PERF.md);
//   the cell (thread b U + u, B U threads): pre = (xp + b) + the 32
//   splits' partial sums in split order, libm's expf / tanhf as the
//   cooperative kernel; h into hx (the parity of s), the flag released;
//   then y, c and g4 stored, off the chain.  xp of the next step is
//   prefetched into the thread's slot while the step runs.
template <int U, int BP>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_flag_kernel(const float* __restrict__ xp,
                     const float* __restrict__ whh,
                     const float* __restrict__ bias,
                     const int* __restrict__ lengths, float* __restrict__ y,
                     float* __restrict__ c, float* __restrict__ g4, float* hx,
                     unsigned* flags, int nt, int B, int H, int ndir,
                     int rev_mask, int rs) {
  using S = FlagShape<U, BP>;
  constexpr int Bp = BP, r = S::R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = H / U, tid = threadIdx.x;
  const int d = blockIdx.x / (nb * rs), sl = blockIdx.x / nb % rs;
  const int blk = blockIdx.x % nb, j0 = blk * U;
  const int ds = d * rs + sl;  // this slice's flags and scratch
  const int r0 = sl * slice_rows(B, rs), Bl = min(slice_rows(B, rs), B - r0);
  const int rev = (rev_mask >> d) & 1;
  const size_t G = (size_t)ndir * 4 * H, Y = (size_t)ndir * H;
  float* xs = reinterpret_cast<float*>(smem);  // h_{t-1}, [H][Bp]
  float* part = xs + (size_t)H * Bp;           // [kFSplits][Bp][PC]
  float4* xslot =  // [2][256]
      reinterpret_cast<float4*>(part + kFSplits * Bp * S::PC);

  // This thread's part of the product: gate columns cg 4 .. cg 4 + 3
  // (column g U + u is W_hh[:, g H + j0 + u]), rows rg r .. rg r + r - 1
  // of the Bp, k = split + 32 i for i < H / 32, W's values in registers
  // for the launch.
  const int cg = tid % U, rg = (tid / U) % S::RG, split = tid / (U * S::RG);
  const int nl = H / kFSplits;
  float wr[kFMaxL][4];
  {
    const float* w = whh + (size_t)d * H * 4 * H;
#pragma unroll
    for (int i = 0; i < kFMaxL; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 4 + e;
        wr[i][e] = i < nl ? ld_once(w + (size_t)(split + kFSplits * i) *
                                            4 * H + (col / U) * H + j0 +
                                        col % U)
                          : 0.f;
      }
  }

  const bool cell = tid < Bl * U;
  const int b = tid / U, u = tid % U, j = j0 + u;
  const int len = cell ? lengths[r0 + b] : 0;
  float bq[4] = {0.f, 0.f, 0.f, 0.f}, h = 0.f, cc = 0.f;
  if (cell)
#pragma unroll
    for (int q = 0; q < 4; ++q) bq[q] = bias[(size_t)d * 4 * H + q * H + j];
  auto prefetch = [&](int s, int p) {
    if (!cell) return;
    const int t = rev ? nt - 1 - s : s;
    const float* xr =
        xp + ((size_t)t * B + r0 + b) * G + (size_t)d * 4 * H + j;
    float* slot = reinterpret_cast<float*>(xslot + p * kThreads + tid);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cp_async_small<4>(slot + q, xr + (size_t)q * H);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto xslot_at = [&](int p, int i) { return xslot[p * kThreads + i]; };
  prefetch(0, 0);
  __syncthreads();

  for (int s = 0; s < nt; ++s) {
    const int t = rev ? nt - 1 - s : s, p = s & 1;
    if (s > 0) {
      const float* hx_src = hx + (size_t)((p ^ 1) * ndir * rs + ds) * H * Bp;
      wait_flags(flags, ds, nb, s);
      stage_f32(xs, hx_src, nb, U * Bp / 4, U * Bp);
    }
    if (s + 1 < nt) prefetch(s + 1, p ^ 1);
    if (s > 0) {
      float acc[r][4];
#pragma unroll
      for (int q = 0; q < r; ++q)
        acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
#pragma unroll
      for (int i = 0; i < kFMaxL; ++i) {  // forward product
        if (i >= nl) break;
        const float* hp = xs + (split + kFSplits * i) * Bp + rg * r;
#pragma unroll
        for (int q = 0; q < r; q += 2) {
          const float2 hv = *reinterpret_cast<const float2*>(hp + q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[q][e] = fmaf(hv.x, wr[i][e], acc[q][e]);
            acc[q + 1][e] = fmaf(hv.y, wr[i][e], acc[q + 1][e]);
          }
        }
      }
      float* pp = part + (split * Bp + rg * r) * S::PC + cg * 4;
#pragma unroll
      for (int q = 0; q < r; ++q)
        *reinterpret_cast<float4*>(pp + q * S::PC) =
            make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    }
    __syncthreads();  // the partial sums are in

    float act[4], yv = 0.f;
    if (cell) {
      wait_slots(s + 1 < nt);  // this step's xp is in its slot
      const float4 xv = xslot_at(p, tid);
      const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float sum = 0.f;
        if (s > 0)
#pragma unroll 8
          for (int sp = 0; sp < kFSplits; ++sp)
            sum += part[(sp * Bp + b) * S::PC + q * U + u];
        pre[q] = (xq[q] + bq[q]) + sum;
      }
      const float m = t < len ? 1.f : 0.f;
      act[0] = sigmoidf(pre[0]);
      act[1] = sigmoidf(pre[1]);
      act[2] = tanhf(pre[2]);
      act[3] = sigmoidf(pre[3]);
      const float c_new = act[1] * cc + act[0] * act[2];
      const float h_new = act[3] * tanhf(c_new);
      h = m * h_new + (1.f - m) * h;
      cc = m * c_new + (1.f - m) * cc;
      yv = h_new * m;
      hx[((size_t)(p * ndir * rs + ds) * H + j) * Bp + b] = h;
    }
    if (s + 1 < nt) publish(flags + ds * nb + blk, (unsigned)(s + 1));
    if (cell) {  // off the chain: nothing in this launch reads them
      const size_t row = (size_t)t * B + r0 + b;
      y[row * Y + (size_t)d * H + j] = yv;
      c[row * Y + (size_t)d * H + j] = cc;
      float* gr = g4 + row * G + (size_t)d * 4 * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) gr[(size_t)q * H] = act[q];
    }
  }
}

// Backward, per block (of row slice sl, as the forward's) and step s (a
// reduce-scatter, as the bf16 cluster kernel's):
//   s > 0: wait for the slice's flags of step s - 1 and stage this block's
//   units' slices of every block's partial dh (px, [2][ndir RS][H / U][Bp]
//   [H]: Bp runs of U floats from each, 40 KB at B=20 in one slice, 20 KB
//   in two, in place of the cooperative kernel's 160 KB of dgates_t); the
//   cell thread adds them to its carried
//   dh in a fixed order of their sources;
//   the cell forms dgates_t for the block's 4U columns (into shared memory
//   and, off the chain, dxp) from the prefetched g4, c_t, c_{t-1} and gy;
//   the product: the partial dh [Bp][H] = dgates_t W_hh[:, columns]^T,
//   thread (rg, kg) taking its columns k0 = kg + KG i (its W_hh values in
//   registers for the launch, each dgates_t value read feeding H / KG
//   FMAs) for B rows rg r .. rg r + r - 1; a warp's 32 consecutive k0
//   stored to px (the parity of s) as 128 contiguous bytes; the flag
//   released.
template <int U, int BP>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_flag_kernel(const float* __restrict__ whh,
                     const int* __restrict__ lengths,
                     const float* __restrict__ c,
                     const float* __restrict__ g4,
                     const float* __restrict__ gy, float* __restrict__ dxp,
                     float* __restrict__ dbp, float* px, unsigned* flags,
                     int nt, int B, int H, int ndir, int rev_mask, int rs) {
  using S = FlagShape<U, BP>;
  constexpr int C = 4 * U, Bp = BP, r = S::R, KrMax = S::KrMax;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = H / U, tid = threadIdx.x;
  const int d = blockIdx.x / (nb * rs), sl = blockIdx.x / nb % rs;
  const int blk = blockIdx.x % nb, j0 = blk * U;
  const int ds = d * rs + sl;  // this slice's flags and scratch
  const int r0 = sl * slice_rows(B, rs), Bl = min(slice_rows(B, rs), B - r0);
  const int rev = (rev_mask >> d) & 1;
  const size_t G = (size_t)ndir * 4 * H, Y = (size_t)ndir * H;
  const size_t HB = (size_t)H * Bp;
  float* xs = reinterpret_cast<float*>(smem);  // [nb][Bp][U]
  float* dg = xs + HB;                         // dgates_t, [C][Bp]
  float4* slot = reinterpret_cast<float4*>(dg + C * Bp);  // [2][2][256]

  // This thread's part of the product: columns k0 = kg + KG i (i < H /
  // KG) of the partial dh [Bp][H], its rows rg r .. rg r + r - 1, summed
  // over the C gate columns of dgates_t; W_hh[k0, column g U + u = g H + j0
  // + u] in registers for the launch.
  const int rg = tid / S::KG, kg = tid % S::KG;
  const int nkr = H / S::KG;
  float wt[KrMax][C];
  {
    const float* w = whh + (size_t)d * H * 4 * H;
#pragma unroll
    for (int i = 0; i < KrMax; ++i)
#pragma unroll
      for (int cl = 0; cl < C; ++cl)
        wt[i][cl] = i < nkr ? ld_once(w + (size_t)(kg + S::KG * i) * 4 * H +
                                      (cl / U) * H + j0 + cl % U)
                            : 0.f;
  }
  for (int i = tid; i < C * Bp; i += kThreads) dg[i] = 0.f;  // rows past B

  const bool cell = tid < Bl * U;
  const int b = tid / U, u = tid % U, j = j0 + u;
  const int len = cell ? lengths[r0 + b] : 0;
  float dh = 0.f, dcv = 0.f, db[4] = {0.f, 0.f, 0.f, 0.f};
  // slot [p][0]: the four gates; [p][1]: c_t, c_{t-1}, gy
  auto prefetch = [&](int s, int p) {
    if (!cell) return;
    const int t = rev ? s : nt - 1 - s, tp = rev ? t + 1 : t - 1;
    const size_t row = (size_t)t * B + r0 + b;
    float* sg = reinterpret_cast<float*>(slot + (2 * p) * kThreads + tid);
    float* sc = reinterpret_cast<float*>(slot + (2 * p + 1) * kThreads + tid);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cp_async_small<4>(sg + q, g4 + row * G + (size_t)d * 4 * H + q * H + j);
    cp_async_small<4>(sc, c + row * Y + (size_t)d * H + j);
    if (tp >= 0 && tp < nt)
      cp_async_small<4>(sc + 1, c + ((size_t)tp * B + r0 + b) * Y +
                                    (size_t)d * H + j);
    else
      sc[1] = 0.f;
    cp_async_small<4>(sc + 2, gy + row * Y + (size_t)d * H + j);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto gslot = [&](int p, int i) { return slot[(2 * p) * kThreads + i]; };
  auto cslot = [&](int p, int i) {
    const float4 v = slot[(2 * p + 1) * kThreads + i];
    return make_float3(v.x, v.y, v.z);
  };
  prefetch(0, 0);
  __syncthreads();

  for (int s = 0; s < nt; ++s) {
    const int t = rev ? s : nt - 1 - s, p = s & 1;
    if (s > 0) {
      const float* px_src =
          px + (size_t)((p ^ 1) * ndir * rs + ds) * nb * HB + j0;
      wait_flags(flags, ds, nb, s);
      stage_f32(xs, px_src, nb * Bp, U / 4, H);
    }
    if (s + 1 < nt) prefetch(s + 1, p ^ 1);
    float dgv[4] = {0.f, 0.f, 0.f, 0.f};
    if (cell) {
      if (s > 0) {  // the blocks' partial dh, in a fixed order: source q
        // into sum q % 4 (four chains, not one of nb adds), then the four
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        const float* xq = xs + b * U + u;
        for (int q = 0; q < nb; q += 4)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (q + e < nb) a[e] += xq[(q + e) * Bp * U];
        dh += (a[0] + a[1]) + (a[2] + a[3]);
      }
      wait_slots(s + 1 < nt);  // this step's inputs are in their slots
      const float4 gv = gslot(p, tid);
      const float3 cv = cslot(p, tid);
      const float ig = gv.x, fg = gv.y, gg = gv.z, og = gv.w;
      const float m = t < len ? 1.f : 0.f;
      const float tc = tanhf(cv.x);
      const float da = m * (dh + cv.z);
      const float do_ = da * tc;
      const float dc_new = da * og * (1.f - tc * tc) + m * dcv;
      const float di = dc_new * gg, df = dc_new * cv.y, dgg = dc_new * ig;
      dgv[0] = di * ig * (1.f - ig);
      dgv[1] = df * fg * (1.f - fg);
      dgv[2] = dgg * (1.f - gg * gg);
      dgv[3] = do_ * og * (1.f - og);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dg[(q * U + u) * Bp + b] = dgv[q];
        db[q] += dgv[q];
      }
      dh = (1.f - m) * dh;
      dcv = (1.f - m) * dcv + dc_new * fg;
    }
    if (s + 1 < nt) {
      __syncthreads();  // dgates_t is in dg
      float acc[KrMax][r];
#pragma unroll
      for (int i = 0; i < KrMax; ++i)
#pragma unroll
        for (int q = 0; q < r; ++q) acc[i][q] = 0.f;
#pragma unroll
      for (int cl = 0; cl < C; ++cl) {  // backward product
        const float* dp = dg + cl * Bp + rg * r;
#pragma unroll
        for (int q = 0; q < r; q += 2) {
          const float2 dv = *reinterpret_cast<const float2*>(dp + q);
#pragma unroll
          for (int i = 0; i < KrMax; ++i) {
            acc[i][q] = fmaf(dv.x, wt[i][cl], acc[i][q]);
            acc[i][q + 1] = fmaf(dv.y, wt[i][cl], acc[i][q + 1]);
          }
        }
      }
      // [b][k0]: a warp's 32 consecutive k0 of one b are 128 bytes
      float* out = px + ((size_t)(p * ndir * rs + ds) * nb + blk) * HB +
                   (size_t)rg * r * H + kg;
#pragma unroll
      for (int i = 0; i < KrMax; ++i)
        if (i < nkr)
#pragma unroll
          for (int q = 0; q < r; ++q)
            out[(size_t)q * H + S::KG * i] = acc[i][q];
      publish(flags + ds * nb + blk, (unsigned)(s + 1));
    }
    if (cell) {  // off the chain
      float* dr = dxp + ((size_t)t * B + r0 + b) * G + (size_t)d * 4 * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) dr[(size_t)q * H] = dgv[q];
    }
  }
  if (cell) {
    float* out = dbp + (size_t)(r0 + b) * G + (size_t)d * 4 * H + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) out[(size_t)q * H] = db[q];
  }
}

// The launch configuration of a cluster kernel, after its attributes: the
// shared memory beyond 48 KB and the non-portable cluster size (16).
template <typename Kernel>
cudaError_t cluster_config(Kernel kern, size_t smem, int ndir,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(ndir * kCBlocks));
  cfg->blockDim = dim3(kCThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// One launch of a cluster kernel, ``ndir`` clusters of 16 blocks.
template <typename... P, typename... A>
cudaError_t cluster_launch(void (*kern)(P...), size_t smem, int ndir,
                           cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config(kern, smem, ndir, stream, &cfg, attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many clusters of ``kern`` can be resident at once.
template <typename Kernel>
cudaError_t cluster_occupancy(Kernel kern, size_t smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config(kern, smem, 1, 0, &cfg, attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

template <int U>
cudaError_t cluster_bwd_launch(const __nv_bfloat16* whh, const int* lengths,
                               const float* c, const __nv_bfloat16* g4,
                               const __nv_bfloat16* gy, __nv_bfloat16* dxp,
                               float* dbp, int nt, int B, int ndir,
                               int rev_mask, cudaStream_t stream) {
  return cluster_launch(lstm_bwd_cluster_kernel<U>,
                        bwd_cluster_smem_bytes<U>(), ndir, stream, whh,
                        lengths, c, g4, gy, dxp, dbp, nt, B, ndir, rev_mask);
}

template <int U>
cudaError_t cluster_fwd_launch(const __nv_bfloat16* xp,
                               const __nv_bfloat16* whh, const float* bias,
                               const int* lengths, __nv_bfloat16* y, float* c,
                               __nv_bfloat16* g4, int nt, int B, int ndir,
                               int rev_mask, cudaStream_t stream) {
  return cluster_launch(lstm_fwd_cluster_kernel<U>,
                        fwd_cluster_smem_bytes<U>(), ndir, stream, xp, whh,
                        bias, lengths, y, c, g4, nt, B, ndir, rev_mask);
}

// Hidden units per block and blocks per direction.
inline int split_units(int H, int* hs) {
  *hs = (H + kMaxBlocksPerDir - 1) / kMaxBlocksPerDir;
  return (H + *hs - 1) / *hs;
}

cudaError_t cooperative_launch(const void* kern, int grid, size_t smem,
                               void** args, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return e;
  if (!coop || per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(kern, dim3((unsigned)grid), dim3(kThreads),
                                  args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The tensor-core product takes bf16 slices of 8, 16 or 32 columns and
// rows of a multiple of 16 values (16-byte copies, whole k-steps).
template <typename T>
int use_mma(int H, int ncol) {
  return std::is_same<T, __nv_bfloat16>::value && H % 16 == 0 &&
         (ncol == 8 || ncol == 16 || ncol == 32);
}

template <typename T>
int fwd_launch(const T* xp, const T* whh, const float* bias,
               const int* lengths, T* y, float* c, T* g4, T* hx,
               unsigned* bar, int nt, int B, int H, int ndir, int rev_mask,
               cudaStream_t stream) {
  int hs = 0;
  int nb = split_units(H, &hs);
  int mma = use_mma<T>(H, 4 * hs);
  void* args[] = {&xp, &whh, &bias, &lengths, &y,  &c,  &g4,   &hx,      &bar,
                  &nt, &B,   &H,    &hs,      &nb, &ndir, &rev_mask, &mma};
  return (int)cooperative_launch(
      reinterpret_cast<const void*>(&lstm_fwd_kernel<T>), ndir * nb,
      smem_bytes<T>(H, 4 * hs, hs, B, 2), args, stream);
}

template <typename T>
int bwd_launch(const T* whh, const int* lengths, const float* c, const T* g4,
               const T* gy, T* dxp, float* dbp, unsigned* bar, int nt, int B,
               int H, int ndir, int rev_mask, cudaStream_t stream) {
  int hs = 0;
  int nb = split_units(H, &hs);
  int mma = use_mma<T>(H, hs);
  void* args[] = {&whh, &lengths, &c,  &g4, &gy,   &dxp,      &dbp, &bar,
                  &nt,  &B,       &H,  &hs, &nb,   &ndir, &rev_mask, &mma};
  return (int)cooperative_launch(
      reinterpret_cast<const void*>(&lstm_bwd_kernel<T>), ndir * nb,
      smem_bytes<T>(4 * H, hs, hs, B, 6), args, stream);
}

// The flag kernel of the forward (way 0) or the backward (1) with U units
// a block, instantiated for each padded row count BP of a block: BP = 4,
// 8, ..., 24 (step 4) in one row slice, 2, 4, ..., 12 (step 2) in two.
template <int U, int Step, int... BP>
const void* flag_kernel_of(int way, int Bp) {
  static const void* const fwd[] = {
      reinterpret_cast<const void*>(&lstm_fwd_flag_kernel<U, BP>)...};
  static const void* const bwd[] = {
      reinterpret_cast<const void*>(&lstm_bwd_flag_kernel<U, BP>)...};
  return (way ? bwd : fwd)[Bp / Step - 1];
}

const void* flag_kernel(int way, FlagPlan pl, int B) {
  const int Bp = padded_rows(B, pl.rs);
  if (pl.rs == 2)
    return pl.U == 8 ? flag_kernel_of<8, 2, 2, 4, 6, 8, 10, 12>(way, Bp)
                     : nullptr;
  return pl.U == 4 ? flag_kernel_of<4, 4, 4, 8, 12, 16, 20, 24>(way, Bp)
                   : flag_kernel_of<8, 4, 4, 8, 12, 16, 20, 24>(way, Bp);
}

// The flag design's launches: ndir * RS * H / U blocks, cooperative (every
// block must be resident for the flag waits).
int flag_fwd_launch(FlagPlan pl, const float* xp, const float* whh,
                    const float* bias, const int* lengths, float* y,
                    float* c, float* g4, float* hx, unsigned* flags, int nt,
                    int B, int H, int ndir, int rev_mask,
                    cudaStream_t stream) {
  const void* kern = flag_kernel(0, pl, B);
  if (!kern) return (int)cudaErrorInvalidValue;
  int rs = pl.rs;
  void* args[] = {&xp,    &whh, &bias, &lengths, &y,    &c,        &g4, &hx,
                  &flags, &nt,  &B,    &H,       &ndir, &rev_mask, &rs};
  return (int)cooperative_launch(kern, ndir * rs * (H / pl.U),
                                 flag_fwd_smem(padded_rows(B, rs), H, pl.U),
                                 args, stream);
}

int flag_bwd_launch(FlagPlan pl, const float* whh, const int* lengths,
                    const float* c, const float* g4, const float* gy,
                    float* dxp, float* dbp, float* px, unsigned* flags,
                    int nt, int B, int H, int ndir, int rev_mask,
                    cudaStream_t stream) {
  const void* kern = flag_kernel(1, pl, B);
  if (!kern) return (int)cudaErrorInvalidValue;
  int rs = pl.rs;
  void* args[] = {&whh, &lengths, &c, &g4, &gy,   &dxp,     &dbp, &px,
                  &flags, &nt,    &B, &H,  &ndir, &rev_mask, &rs};
  return (int)cooperative_launch(kern, ndir * rs * (H / pl.U),
                                 flag_bwd_smem(padded_rows(B, rs), H, pl.U),
                                 args, stream);
}

// 1 the cluster kernels, 2 the flag design, 0 the cooperative kernels, -1
// when the device cannot be queried; ``way`` 0 the forward, 1 the backward.
int design_of(int B, int H, int ndir, int bf16, int way) {
  if (cluster_takes(B, H, bf16)) return 1;
  const int u = flag_plan(B, H, ndir, bf16, way).U;
  return u < 0 ? -1 : (u ? 2 : 0);
}

}  // namespace

extern "C" {

const char* lstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The forward's and the backward's design at a shape: 1 the cluster
// kernels, 2 the flag design, 0 the cooperative kernels (-1: the device
// could not be queried).  Only the cooperative and the flag designs read
// the scratch and the counters.
int lstm_fwd_design(int B, int H, int ndir, int bf16) {
  return design_of(B, H, ndir, bf16, 0);
}

int lstm_bwd_design(int B, int H, int ndir, int bf16) {
  return design_of(B, H, ndir, bf16, 1);
}

// The flag design's units a block at this shape on the current device for
// the forward (way 0) or the backward (1), 0 where it does not take the
// shape, -1 when the device cannot be queried; and its row slices.
int lstm_flag_units(int B, int H, int ndir, int bf16, int way) {
  return flag_plan(B, H, ndir, bf16, way).U;
}

int lstm_flag_slices(int B, int H, int ndir, int bf16, int way) {
  return flag_plan(B, H, ndir, bf16, way).rs;
}

// How many clusters of the forward's or the backward's cluster kernel at
// this H (256 or 512) can be resident at once on the current device, into
// ``clusters``.
int lstm_fwd_cluster_occupancy(int H, int* clusters) {
  if (H == 512)
    return (int)cluster_occupancy(lstm_fwd_cluster_kernel<32>,
                                  fwd_cluster_smem_bytes<32>(), clusters);
  if (H == 256)
    return (int)cluster_occupancy(lstm_fwd_cluster_kernel<16>,
                                  fwd_cluster_smem_bytes<16>(), clusters);
  return (int)cudaErrorInvalidValue;
}

int lstm_bwd_cluster_occupancy(int H, int* clusters) {
  if (H == 512)
    return (int)cluster_occupancy(lstm_bwd_cluster_kernel<32>,
                                  bwd_cluster_smem_bytes<32>(), clusters);
  if (H == 256)
    return (int)cluster_occupancy(lstm_bwd_cluster_kernel<16>,
                                  bwd_cluster_smem_bytes<16>(), clusters);
  return (int)cudaErrorInvalidValue;
}

int lstm_fwd_scan(const void* xp, const void* whh, const float* bias,
                  const int* lengths, void* y, float* c, void* g4, void* hx,
                  unsigned* bar, int T, int B, int H, int ndir, int rev_mask,
                  int bf16, void* stream) {
  if (T == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster_takes(B, H, bf16)) {
    typedef const __nv_bfloat16* P;
    return (int)(H == 512 ? cluster_fwd_launch<32> : cluster_fwd_launch<16>)(
        (P)xp, (P)whh, bias, lengths, (__nv_bfloat16*)y, c,
        (__nv_bfloat16*)g4, T, B, ndir, rev_mask, s);
  }
  if (!bf16) {
    const FlagPlan pl = flag_plan(B, H, ndir, bf16, 0);
    if (pl.U < 0) return (int)cudaErrorInvalidDevice;
    if (pl.U)
      return flag_fwd_launch(
          pl, (const float*)xp, (const float*)whh, bias, lengths, (float*)y, c,
          (float*)g4, (float*)hx, bar, T, B, H, ndir, rev_mask, s);
  }
  if (bf16)
    return fwd_launch<__nv_bfloat16>(
        (const __nv_bfloat16*)xp, (const __nv_bfloat16*)whh, bias, lengths,
        (__nv_bfloat16*)y, c, (__nv_bfloat16*)g4, (__nv_bfloat16*)hx, bar, T,
        B, H, ndir, rev_mask, s);
  return fwd_launch<float>((const float*)xp, (const float*)whh, bias, lengths,
                           (float*)y, c, (float*)g4, (float*)hx, bar, T, B, H,
                           ndir, rev_mask, s);
}

int lstm_bwd_scan(const void* whh, const int* lengths, const float* c,
                  const void* g4, const void* gy, void* dxp, float* dbp,
                  void* scratch, unsigned* bar, int T, int B, int H,
                  int ndir, int rev_mask, int bf16, void* stream) {
  if (T == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster_takes(B, H, bf16)) {
    typedef const __nv_bfloat16* P;
    return (int)(H == 512 ? cluster_bwd_launch<32>
                          : cluster_bwd_launch<16>)(
        (P)whh, lengths, c, (P)g4, (P)gy, (__nv_bfloat16*)dxp, dbp, T, B,
        ndir, rev_mask, s);
  }
  if (!bf16) {
    const FlagPlan pl = flag_plan(B, H, ndir, bf16, 1);
    if (pl.U < 0) return (int)cudaErrorInvalidDevice;
    if (pl.U)
      return flag_bwd_launch(
          pl, (const float*)whh, lengths, c, (const float*)g4, (const float*)gy,
          (float*)dxp, dbp, (float*)scratch, bar, T, B, H, ndir, rev_mask, s);
  }
  if (bf16)
    return bwd_launch<__nv_bfloat16>(
        (const __nv_bfloat16*)whh, lengths, c, (const __nv_bfloat16*)g4,
        (const __nv_bfloat16*)gy, (__nv_bfloat16*)dxp, dbp, bar, T, B, H, ndir,
        rev_mask, s);
  return bwd_launch<float>((const float*)whh, lengths, c, (const float*)g4,
                           (const float*)gy, (float*)dxp, dbp, bar, T, B, H,
                           ndir, rev_mask, s);
}

}  // extern "C"
