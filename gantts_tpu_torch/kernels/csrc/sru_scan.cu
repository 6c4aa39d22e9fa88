// Hopper (sm_90a) kernels for one direction of one SRU layer.
//
// Three launches replace the TPU kernels of gantts_tpu/kernels/sru_scan.py:
//
//   sru_proj_gemm  u = x @ W, the `_proj_u` half of `_psru_fwd_kernel`.
//                  (T*B, D) x (D, 4H) with f32 accumulation, u stored in the
//                  I/O dtype.  Bound by the tensor cores: 43 GFLOP per call
//                  at T=512, B=20, D=1024, H=512, 0.043 ms at the card's
//                  989 TFLOP/s.  bf16 I/O is a warp-specialized wgmma kernel
//                  (see "u = x @ W, bf16" below): TMA loads into a ring of
//                  shared-memory stages, two consumer warpgroups issuing
//                  wgmma m64n256k16 on a 128x256 block tile, persistent
//                  blocks.  f32 I/O stays off the tensor cores (TF32 would
//                  lose the exactness the f32 path promises): an FMA kernel
//                  on 128x256 (128x128, 64x128) tiles of 8x16 (8x8, 4x8)
//                  outputs a thread, fed by a 3-stage cp.async ring (x
//                  transposed to k-major on its way in), with K split
//                  across blocks where the tiles alone leave SMs idle (see
//                  "u = x @ W, f32" below), 43 GFLOP at 0.64 ms on the
//                  card's 67 TFLOP/s of f32 FMAs.  Rounding in bf16: the
//                  tensor cores sum the K products in f32 in their own
//                  order; each output is rounded once to bf16 (nearest
//                  even), as the plain version's f32-output matmul followed
//                  by a cast.
//
//   sru_fwd_scan   the scan half of `_psru_fwd_kernel` and all of
//                  `_fused_fwd_kernel`: bias add, gates, length mask, the
//                  recurrence c_t = fm_t * c_{t-1} + bm_t and the highway
//                  output, from a precomputed u, time-chunked as the
//                  backward (see "Forward scan" below).  Bound by bytes: u
//                  in on valid frames, h and c out, 63 MB at the step's
//                  shape in bf16, 0.019 ms at 3.35 TB/s.
//
//   sru_bwd_scan   `_fused_bwd_kernel`: the adjoint recurrence
//                  ghat_t = a_t + fm_{t+1} * ghat_{t+1} (a = gh m r g'(c)),
//                  the four du blocks and the f/r bias gradient, time-chunked
//                  (see "Backward scan" below).  Bound by bytes: u, c and gh
//                  in, du out, 97 MB at the step's shape in bf16, 0.029 ms at
//                  3.35 TB/s.
//
// The TPU's sequential grid forced a per-chunk carry array (`cb`) so that the
// backward could rebuild c_{t-1} at chunk edges.  Here c_{t-1} is read
// straight from the full f32 c array, so `cb` is dropped.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns a cudaError_t code (0 on success).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// u = x @ W, f32: FMA pipes fed by a cp.async ring
//
// What bounds it: the FMA pipes (67 TFLOP/s), since TF32 or 3xTF32 on the
// tensor cores would not keep the exact f32 products this path promises.
// 64x64 tiles of 4x4 outputs a thread read 8 scalar shared-memory words for
// every 16 FMAs and so were bound by shared-memory issue (14-22 TFLOP/s at
// M >= 608).  Here the shared-memory and copy instructions a FMA are cut by
// tiles of 8x8 or 8x16 outputs a thread read as 16-byte vectors:
//
//   * A block of 256 threads owns a BM x BN tile of C (F32Tile): its 8 warps
//     a 4 x 2 grid of warp tiles of 4 RM rows x 8 CN columns, a warp's lanes
//     a 4 x 8 grid (ly, lx).  A thread holds RM rows, 4 ly + r + 16 s (r < 4,
//     s < RM / 4), and CN columns, 4 lx + c + 32 t (c < 4, t < CN / 4), of its
//     warp tile in registers.  Three tiles (the wrapper's plan picks):
//     128 x 256 (8 x 16 a thread, 255 registers, one block an SM) for the
//     training steps' M, 128 x 128 (8 x 8, two blocks an SM) where there are
//     too few of those to fill the SMs several times, 64 x 128 (4 x 8) for
//     M <= 64.
//   * K in steps of kFBK = 32 through a ring of kFStages = 3 shared-memory
//     stages filled by cp.async (zero-filling what lies past M, N or K), two
//     stages in flight ahead of the products and one __syncthreads a stage.
//     (16 k and 4 stages, 32 and 2 or 4, and 64 and 2 all measured slower:
//     PERF.md, tools/torch_gemm_f32_ab.py --variants.)
//   * Both operands lie k-major in a stage, so that a thread reads its RM
//     rows of x and its CN columns of W at one k as float4s: RM / 4 + CN / 4
//     LDS.128 for RM CN FMAs (6 for 128 at 8 x 16), and each LDS.128 of a
//     warp touches 4 (x) or 8 (W) consecutive float4s: one wavefront, no
//     bank conflict.  The stage's k are unrolled, so ptxas issues the next
//     k's loads under the current FMAs (the register double buffer).
//   * W (K x N) is N-contiguous and lies as it does in memory (32 x BN),
//     copied in 16-byte pieces: N % 4 == 0 and 16-byte bases (the wrapper
//     pads an N that is not a multiple of 4).  x (M x K) is K-contiguous, so
//     its tile is transposed on its way in, with no registers involved: each
//     thread issues 4-byte cp.async, a warp copying 8 k of 4 rows (4 sectors
//     of 32 bytes in, and k rows BM + 4 floats apart in the stage, so that
//     the 32 words land in 32 distinct banks).  x needs no alignment beyond
//     its floats' and no padding of a ragged K (425, 177): the wrapper copies
//     nothing.
//   * Small M fills few SMs (16 tiles at M = 64, N = 2048, for 132 SMs), so
//     K is split across ``gridDim.z`` blocks of ``kps`` k-steps each, as the
//     wrapper's plan says.  Split z writes its partial tile to its own
//     M x N slice of a workspace; a second kernel adds the slices in order
//     of z.  The sum never depends on timing: two launches are
//     bit-identical.
//   * Rounding: each output is a chain of fmaf over its k in order (within
//     a split; the splits then added in order), with no other rounding.
// ---------------------------------------------------------------------------

constexpr int kFBK = 32, kFStages = 3;

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A tile shape: RM x CN outputs a thread, a WM x WN grid of warps, each
// warp's lanes a 4 x 8 grid.  The block tile is BM x BN.
template <int RM_, int CN_, int WM_, int WN_>
struct F32Tile {
  static constexpr int RM = RM_, CN = CN_, WM = WM_, WN = WN_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = WM * 4 * RM, BN = WN * 8 * CN;
  // floats between the k rows of x's stage: BM + 4, so that a warp's 4-byte
  // copies (8 k of 4 rows) land in 32 distinct banks
  static constexpr int kLdA = BM + 4;
  static constexpr int kAStage = kFBK * kLdA, kBStage = kFBK * BN;
  static constexpr int kSmem = kFStages * (kAStage + kBStage) * 4;
  // blocks an SM that the registers allow (RM * CN accumulators a thread):
  // one at 128, else two, at most 128 registers a thread (at three, 85, the
  // 4 x 8 tile spills)
  static constexpr int kMinBlocks = RM * CN >= 128 ? 1 : 2;
};

// C (or split z's slice of the workspace) = x[:, kb:ke] @ W[kb:ke], with
// kb = z * kps * kFBK and ke = min(K, kb + kps * kFBK); x's rows lie ldx
// floats apart.
template <typename S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
proj_gemm_f32(const float* __restrict__ A, const float* __restrict__ Bm,
              float* __restrict__ C, int M, int N, int K, int ldx, int kps) {
  constexpr int RM = S::RM, CN = S::CN, BN = S::BN, kLdA = S::kLdA;
  // x's copies: warps in kFBK / 8 groups, one per 8 k; each copy of a warp
  // takes 8 k of 4 rows, and copy q of a group row 4 (warps of the group) q
  // further
  constexpr int KG = kFBK / 8, RS = 4 * S::WM * S::WN / KG;
  static_assert(kFBK % 8 == 0 && (S::WM * S::WN) % KG == 0 && S::BM % RS == 0,
                "x's copies do not tile the stage");
  extern __shared__ float4 fsmem4[];
  float* const As = reinterpret_cast<float*>(fsmem4);
  float* const Bs = As + kFStages * S::kAStage;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * S::BM;
  const int kb = blockIdx.z * kps * kFBK;
  const int ke = min(K, kb + kps * kFBK);
  const int nk = ke > kb ? (ke - kb + kFBK - 1) / kFBK : 0;
  C += (size_t)blockIdx.z * M * N;

  // x's copies: copy q of warp w takes k = 8 (w % KG) + lane % 8 of row
  // RS q + 4 (w / KG) + lane / 8; W's: copy q takes the 16 bytes
  // c = tid + kThreads q of the stage, k = c / (BN / 4), columns
  // 4 (c % (BN / 4)) .. + 3.
  const int ak = 8 * (warp % KG) + lane % 8;
  const int am = 4 * (warp / KG) + lane / 8;
  auto load_stage = [&](int kt, int slot) {
    const int k0 = kb + kt * kFBK;
    float* as = As + slot * S::kAStage + ak * kLdA + am;
    float* bs = Bs + slot * S::kBStage;
    const bool kin = k0 + ak < K;
#pragma unroll
    for (int q = 0; q < S::BM / RS; ++q) {
      const int m = m0 + am + RS * q;
      const bool in = kin && m < M;
      cp_async4(smem_u32(as + RS * q),
                in ? A + (size_t)m * ldx + k0 + ak : A, in ? 4 : 0);
    }
#pragma unroll
    for (int q = 0; q < S::kBStage / 4 / S::kThreads; ++q) {
      const int c = tid + q * S::kThreads, k = k0 + c / (BN / 4);
      const int n = n0 + (c % (BN / 4)) * 4;
      const bool in = k < K && n < N;
      cp_async16(smem_u32(bs + 4 * c), in ? Bm + (size_t)k * N + n : Bm,
                 in ? 16 : 0);
    }
  };

  const int ly = lane / 8, lx = lane % 8;
  const int wrow = (warp / S::WN) * 4 * RM + 4 * ly;  // first row in the tile
  const int wcol = (warp % S::WN) * 8 * CN + 4 * lx;  // first column
  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kFStages - 2>();  // this thread's copies of stage kt
    // Everyone's copies of stage kt have landed, and everyone is done
    // reading stage kt - 1, whose slot the next load refills.
    __syncthreads();
    if (kt + kFStages - 1 < nk)
      load_stage(kt + kFStages - 1, (kt + kFStages - 1) % kFStages);
    cp_async_commit();
    const float* as = As + (kt % kFStages) * S::kAStage + wrow;
    const float* bs = Bs + (kt % kFStages) * S::kBStage + wcol;
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      float a[RM], b[CN];
#pragma unroll
      for (int s = 0; s < RM / 4; ++s) {
        const float4 v =
            *reinterpret_cast<const float4*>(as + k * kLdA + 16 * s);
        a[4 * s] = v.x;
        a[4 * s + 1] = v.y;
        a[4 * s + 2] = v.z;
        a[4 * s + 3] = v.w;
      }
#pragma unroll
      for (int t = 0; t < CN / 4; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(bs + k * BN + 32 * t);
        b[4 * t] = v.x;
        b[4 * t + 1] = v.y;
        b[4 * t + 2] = v.z;
        b[4 * t + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + wrow + (i % 4) + 16 * (i / 4);
    if (m >= M) continue;
#pragma unroll
    for (int t = 0; t < CN / 4; ++t) {
      const int n = n0 + wcol + 32 * t;
      if (n < N)
        *reinterpret_cast<float4*>(C + (size_t)m * N + n) =
            make_float4(acc[i][4 * t], acc[i][4 * t + 1], acc[i][4 * t + 2],
                        acc[i][4 * t + 3]);
    }
  }
}

// u = the splits' slices of ws added in order of split: n4 float4 a slice.
__global__ void __launch_bounds__(256)
proj_gemm_f32_split_sum(const float4* __restrict__ ws, float4* __restrict__ u,
                        size_t n4, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 s = ws[i];
    for (int z = 1; z < splits; ++z) {
      const float4 v = ws[z * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    u[i] = s;
  }
}

// The f32 GEMM's tile shapes, by (tile_m, tile_n), 256 threads each.
using F32Small = F32Tile<4, 8, 4, 2>;   // 64 x 128, 2 blocks an SM
using F32Wide = F32Tile<8, 8, 4, 2>;    // 128 x 128, 2 blocks an SM
using F32Wider = F32Tile<8, 16, 4, 2>;  // 128 x 256, 1 block an SM

template <typename S>
cudaError_t f32_gemm_opt_in() {
  return cudaFuncSetAttribute(proj_gemm_f32<S>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              S::kSmem);
}

// The SM count of the current device, and each f32 GEMM instance's
// shared-memory opt-in, once per device.
cudaError_t f32_gemm_setup(int* sms) {
  static int sms_of[64];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && sms_of[dev] != 0) {
    *sms = sms_of[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = f32_gemm_opt_in<F32Small>();
  if (e == cudaSuccess) e = f32_gemm_opt_in<F32Wide>();
  if (e == cudaSuccess) e = f32_gemm_opt_in<F32Wider>();
  if (e == cudaSuccess && dev < 64) sms_of[dev] = *sms;
  return e;
}

template <typename S>
void launch_f32_tile(const float* x, const float* w, float* out, int M, int N,
                     int K, int ldx, int splits, int kps, cudaStream_t s) {
  const dim3 grid((unsigned)((N + S::BN - 1) / S::BN),
                  (unsigned)((M + S::BM - 1) / S::BM), (unsigned)splits);
  proj_gemm_f32<S><<<grid, S::kThreads, S::kSmem, s>>>(x, w, out, M, N, K,
                                                       ldx, kps);
}

// The plan (tile shape, splits, kps) comes from the wrapper: splits blocks
// along K, kps k-steps of kFBK each, every split non-empty; ws holds
// splits * M * N floats when splits > 1.
cudaError_t launch_proj_gemm_f32(const float* x, const float* w, float* u,
                                 float* ws, int M, int N, int K, int ldx,
                                 int tile_m, int tile_n, int splits,
                                 int kps, cudaStream_t s) {
  const long long span = (long long)kps * kFBK;
  if (ldx < K || N % 4 != 0 || (uintptr_t)x % 4 != 0 ||
      (uintptr_t)w % 16 != 0 || (uintptr_t)u % 16 != 0 || splits < 1 ||
      kps < 0 || span * splits < K ||
      (splits > 1 && (span * (splits - 1) >= K || ws == nullptr ||
                      (uintptr_t)ws % 16 != 0)))
    return cudaErrorInvalidValue;
  void (*launch)(const float*, const float*, float*, int, int, int, int, int,
                 int, cudaStream_t) = nullptr;
#define F32_TILE(S) \
  if (tile_m == S::BM && tile_n == S::BN) launch = launch_f32_tile<S>;
  F32_TILE(F32Small)
  F32_TILE(F32Wide)
  F32_TILE(F32Wider)
#undef F32_TILE
  if (launch == nullptr) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  int sms;
  cudaError_t e = f32_gemm_setup(&sms);
  if (e != cudaSuccess) return e;
  launch(x, w, splits > 1 ? ws : u, M, N, K, ldx, splits, kps, s);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t n4 = (size_t)M * N / 4;
  const size_t blocks = (n4 + 255) / 256;
  proj_gemm_f32_split_sum<<<(unsigned)(blocks < (size_t)sms * 8 ? blocks
                                                                : sms * 8),
                            256, 0, s>>>((const float4*)ws, (float4*)u, n4,
                                         splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// u = x @ W, bf16: wgmma fed by TMA
//
// What bounds it: the tensor cores, and only wgmma reaches their full rate.
// The design, per block of 384 threads (three warpgroups):
//
//   * A 128x256 tile of C per block, K in steps of 64.  x (M, K) is
//     K-contiguous and W (K, N) N-contiguous; both are read as they lie, by
//     TMA boxes of 64 x 128 bytes with the 128-byte swizzle that wgmma's
//     descriptors expect (A K-major; B "transposed", MN-major, which wgmma
//     takes for 16-bit types).  A stage holds A's 128x64 box and four 64x64
//     boxes of B: 48 KB; four stages ring in shared memory.
//   * Warpgroup 2 is the producer: it gives its registers away (setmaxnreg)
//     and one thread keeps the ring full, waiting on each stage's "empty"
//     mbarrier and arming its "full" one with the stage's byte count.
//   * Warpgroups 0 and 1 are consumers, rows 0-63 and 64-127 of the tile:
//     per stage four wgmma m64n256k16, f32 accumulators in registers (128
//     a thread).  One wgmma group stays in flight: a stage is released once
//     the products of the next one have been issued.
//   * Blocks are persistent, one per SM, walking the tiles N-fastest (so the
//     132 tiles in flight share rows of x in L2); the producer runs ahead
//     into the next tile while the consumers store the last one.
//   * Epilogue: each accumulator pair is rounded to bf16x2 (nearest even);
//     the four threads of a quad exchange words by shuffles so that each
//     stores 8 consecutive columns with one 16-byte store.
//   * Ragged edges: TMA zero-fills what lies outside x and W (ragged M, N
//     and K), and the epilogue stores only rows < M and columns < N.  TMA
//     needs 16-byte row strides and bases: x's rows lie ``ldx`` elements
//     apart (a multiple of 8, at least K), N is a multiple of 8 and both
//     operands are 16-byte aligned.  A K that is not a multiple of 8 (the
//     first layer's 425) thus needs only x copied into rows of a wider
//     stride; W is read as it lies.
// ---------------------------------------------------------------------------

constexpr int kGBM = 128, kGBN = 256, kGBK = 64, kStages = 4;
constexpr int kGemmThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr int kATileBytes = kGBM * kGBK * 2;   // 16 KB
constexpr int kBBoxBytes = kGBK * 64 * 2;      // one 64x64 box of W, 8 KB
constexpr int kStageBytes = kATileBytes + 4 * kBBoxBytes;
constexpr int kGemmSmem = kStages * kStageBytes + 1024;  // + alignment slack

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  ``lbo`` and ``sbo`` in
// bytes: for K-major A, sbo is the stride between groups of 8 rows (lbo is
// unused); for MN-major B, lbo is the stride between 64-column atoms of N
// and sbo the stride between groups of 8 rows of K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64x256 f32, 128 a thread) += A (64x16, K-major) * B (16x256, MN-major);
// d is overwritten instead when scale_d is 0.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

__global__ void __launch_bounds__(kGemmThreads, 1)
proj_gemm_bf16(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b,
               __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages], empty_bar[kStages];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms
  const int tiles_n = (N + kGBN - 1) / kGBN;
  const int tiles = ((M + kGBM - 1) / kGBM) * tiles_n;
  const int nk = (K + kGBK - 1) / kGBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumerThreads) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kGBM, n0 = (tile % tiles_n) * kGBN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
          const uint32_t full = smem_u32(&full_bar[stage]);
          const uint32_t sa = smem + stage * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(sa, &map_a, full, kt * kGBK, m0);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            tma_load_2d(sa + kATileBytes + q * kBBoxBytes, &map_b, full,
                        n0 + 64 * q, kt * kGBK);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups 0 and 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = t % 32, quad = lane % 4;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kGBM, n0 = (tile % tiles_n) * kGBN;
      float d[128];  // the first product of a tile overwrites it (K > 0)
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(smem_u32(&full_bar[stage]), phase);
        const uint32_t sa = smem + stage * kStageBytes + wg * (64 * 128);
        const uint32_t sb = smem + stage * kStageBytes + kATileBytes;
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kGBK / 16; ++kk)
          wgmma_m64n256k16(d, smem_desc(sa + kk * 32, 16, 1024),
                           smem_desc(sb + kk * 16 * 128, kBBoxBytes, 1024),
                           kt > 0 || kk > 0);
        wgmma_commit();
        fence_acc(d);
        wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0) mbar_arrive(smem_u32(&empty_bar[prev]));
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (prev >= 0) mbar_arrive(smem_u32(&empty_bar[prev]));

      // Register i of a thread holds row (t / 32) * 16 + lane / 4 +
      // 8 * ((i / 2) % 2) and column 8 * (i / 4) + 2 * quad + i % 2 of the
      // warpgroup's 64x256 tile.
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + wg * 64 + (t / 32) * 16 + lane / 4 + 8 * hr;
#pragma unroll
        for (int g = 0; g < 8; ++g) {  // four 8-column chunks at a time
          uint32_t w[4], out[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[j] = pack_bf16x2(d[(4 * g + j) * 4 + hr * 2],
                               d[(4 * g + j) * 4 + hr * 2 + 1]);
          // After the exchange, out[s] is quad member s's pair of chunk
          // 4g + quad: this thread's eight consecutive columns.
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int src = (quad - k) & 3;
            const uint32_t v = __shfl_sync(0xffffffffu,
                                           pick4(w, (quad + k) & 3),
                                           (lane & ~3) | src);
#pragma unroll
            for (int s = 0; s < 4; ++s)
              if (s == src) out[s] = v;
          }
          const int col = n0 + (4 * g + quad) * 8;
          if (row < M && col < N)
            *reinterpret_cast<uint4*>(C + (size_t)row * N + col) =
                make_uint4(out[0], out[1], out[2], out[3]);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API; the runtime hands out its entry
// point, so the library needs no link against libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix, rows ``ld`` elements apart, read
// in boxes of (box_rows, 64) elements, 128 bytes a box row, with the
// 128-byte swizzle; what lies outside the matrix reads as zero.
bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols, int ld,
              int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_proj_gemm_bf16(const void* x, const void* w, void* u, int M,
                                  int N, int K, int ldx, cudaStream_t s) {
  if (ldx % 8 != 0 || ldx < K || N % 8 != 0 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)w % 16 != 0 || (uintptr_t)u % 16 != 0)
    return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  if (K == 0) return cudaMemsetAsync(u, 0, (size_t)M * N * 2, s);
  CUtensorMap map_a, map_b;
  if (!bf16_map(&map_a, x, M, K, ldx, kGBM) ||
      !bf16_map(&map_b, w, K, N, N, kGBK))
    return cudaErrorInvalidValue;
  // the SM count, and the shared-memory opt-in once per device
  static int sms_of[64];
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || sms_of[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(proj_gemm_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGemmSmem);
    if (e != cudaSuccess) return e;
    if (dev < 64) sms_of[dev] = sms;
  } else {
    sms = sms_of[dev];
  }
  const int tiles = ((M + kGBM - 1) / kGBM) * ((N + kGBN - 1) / kGBN);
  proj_gemm_bf16<<<tiles < sms ? tiles : sms, kGemmThreads, kGemmSmem, s>>>(
      map_a, map_b, (__nv_bfloat16*)u, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward scan, time-chunked
//
// What bounds it: bytes (u, c, gh in; du out), but only with enough loads in
// flight: Little's law asks for some 25 KB in flight per SM at 3.35 TB/s,
// and one thread per lane walking all of T (10,240 threads at the step's
// shape, ~2.4 warps per SM) keeps a few KB there.  The design multiplies the
// threads by splitting T:
//
//   * ghat is affine in its carry.  For a run of steps starting at s0 (in
//     the backward's traversal order s, step s visiting time t(s)),
//     ghat_s = loc_s + P_s * carry_in, where loc is the run's scan from a
//     zero carry, P_s the product of fm over the run's earlier steps, and
//     carry_in = fm_{s0-1} * ghat_{s0-1}.  A run's summary (E, F) =
//     (fm_last * loc_last, product of its fm) maps carry_in to the next
//     run's: carry_out = E + F * carry_in.
//   * A block (128 threads) owns kPairs * V consecutive h of one b, V = 2
//     lanes a thread (bf16x2 / float2 loads and stores) when H is even, else
//     1.  It walks T in windows of kWindow = 64 steps; in a window, thread
//     row p (of kChunks = 16) takes the kSub = 4 steps starting at
//     window + 4p.
//   * Pass 1: each thread issues the loads of its 4 steps together (u's
//     four blocks, c for the 4 steps and the next one, which is c_{t-1} of
//     the last, gh), forms a, fm, loc and P, writes du_r and du_x', which do
//     not depend on ghat, and keeps loc, P and the two coefficients of du_x~
//     and du_f in registers (32 of them at V = 2): nothing is read twice.
//     Runs of padded frames only (t >= len; a quarter of the step's
//     frames) are not read, only their zero du written.
//   * The 16 summaries go to shared memory; one thread row folds them
//     serially (16 steps, not 64) from the previous window's carry, writes
//     each run's carry_in back, and carries the window's end on.
//   * Pass 2: ghat = loc + P * carry_in, du_x~ and du_f, all independent.
//   * The f/r bias gradient: each thread sums its steps; the block sums its
//     16 rows in a fixed order and writes the (b, h) partial; the last block
//     of an h group to finish (a ticket counter, reset by that block) sums
//     the B partials in order of b and writes db = [0 | dbf | dbr | 0].
//     Deterministic: the ticket only picks which block sums.  The tickets
//     live in this library, so two launches of this kernel must not run
//     concurrently on different streams.
//
// Rounding: the recurrence is reassociated (chunk scans joined through
// their carries), so ghat differs from the plain version's step-by-step
// sum by f32 rounding; the bias gradient is summed over 4-step runs, then
// 16 rows, then windows, then b, where the plain version sums over T, then
// B.  bf16 outputs are rounded once, to nearest even.
// ---------------------------------------------------------------------------

constexpr int kChunks = 16, kSub = 4, kPairs = 8;
constexpr int kScanThreads = kChunks * kPairs;
constexpr int kWindow = kChunks * kSub;
constexpr int kMaxGroups = 4096;

__device__ unsigned int g_bwd_tickets[kMaxGroups];

template <int V>
__device__ __forceinline__ void load_lanes(const float* p, float (&o)[V]) {
  if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_lanes(const __nv_bfloat16* p,
                                           float (&o)[V]) {
  if constexpr (V == 2) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_lanes(float* p, const float (&v)[V]) {
  if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

template <int V>
__device__ __forceinline__ void store_lanes(__nv_bfloat16* p,
                                            const float (&v)[V]) {
  if constexpr (V == 2)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  else
    *p = __float2bfloat16(v[0]);
}

// The fold of a window, by thread row 0: the summaries (E, F) of the
// window's kChunks runs, in s_e and s_f, are joined serially from
// ``carry``; each run's carry_in replaces its E, and ``carry`` becomes the
// window's end.
template <int V, int L>
__device__ __forceinline__ void fold_runs(float (&s_e)[kChunks][L],
                                          const float (&s_f)[kChunks][L],
                                          float (&carry)[V], int q) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float e[kChunks], f[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      e[j] = s_e[j][q * V + i];
      f[j] = s_f[j][q * V + i];
    }
    float cr = carry[i];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      s_e[j][q * V + i] = cr;  // run j's carry_in
      cr = e[j] + f[j] * cr;
    }
    carry[i] = cr;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kScanThreads)
sru_bwd_scan_kernel(const T* __restrict__ u, const float* __restrict__ bias4,
                    const int* __restrict__ lengths,
                    const float* __restrict__ c, const T* __restrict__ gh,
                    T* __restrict__ du, float* __restrict__ dbp,
                    float* __restrict__ db, int nt, int B, int H, int reverse,
                    int use_relu) {
  constexpr int kLanes = kPairs * V;
  __shared__ float s_e[kChunks][kLanes], s_f[kChunks][kLanes];
  __shared__ float s_db[2][kChunks][kLanes];
  __shared__ int s_last;
  const int groups = (H + kLanes - 1) / kLanes;
  const int b = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int q = threadIdx.x % kPairs, p = threadIdx.x / kPairs;
  const int h = grp * kLanes + q * V;
  const bool live = h < H;
  const int hc = live ? h : 0;  // dead lanes load lane 0 and store nothing
  float bf[V], br[V];
  load_lanes<V>(bias4 + H + hc, bf);
  load_lanes<V>(bias4 + 2 * H + hc, br);
  const int len = lengths[b];
  const size_t us = (size_t)B * 4 * H, hs = (size_t)B * H;
  const T* ub = u + (size_t)b * 4 * H + hc;
  T* dub = du + (size_t)b * 4 * H + hc;
  const float* cb = c + (size_t)b * H + hc;
  const T* gb = gh + (size_t)b * H + hc;
  // time of traversal step s (clamped into range): the backward walks
  // opposite to the forward, whose previous step of t(s) is t(s + 1)
  auto time_of = [&](int s) {
    s = s < nt ? s : nt - 1;
    return reverse ? s : nt - 1 - s;
  };

  float carry[V], dbf[V], dbr[V];
#pragma unroll
  for (int i = 0; i < V; ++i) carry[i] = dbf[i] = dbr[i] = 0.f;

  for (int w0 = 0; w0 < nt; w0 += kWindow) {
    const int s0 = w0 + p * kSub;
    // Padded frames (t >= len) contribute nothing.  They lie at one end of
    // T, so a run is mostly all padding (its loads are skipped) or all
    // valid; one branch around all of a run's loads keeps them issued
    // together.
    bool valid[kSub], any = false;
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      valid[k] = s0 + k < nt && time_of(s0 + k) < len;
      any = any || valid[k];
    }
    float xt[kSub][V], uf[kSub][V], ur[kSub][V], xp[kSub][V], g_h[kSub][V];
    float ct[kSub + 1][V];
    if (any) {
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const size_t t = time_of(s0 + k);
        const T* ut = ub + t * us;
        load_lanes<V>(ut, xt[k]);
        load_lanes<V>(ut + H, uf[k]);
        load_lanes<V>(ut + 2 * H, ur[k]);
        load_lanes<V>(ut + 3 * H, xp[k]);
        load_lanes<V>(cb + t * hs, ct[k]);
        load_lanes<V>(gb + t * hs, g_h[k]);
      }
      load_lanes<V>(cb + (size_t)time_of(s0 + kSub) * hs, ct[kSub]);
    } else {
#pragma unroll
      for (int k = 0; k <= kSub; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          ct[k][i] = 0.f;
          if (k < kSub)
            xt[k][i] = uf[k][i] = ur[k][i] = xp[k][i] = g_h[k][i] = 0.f;
        }
    }

    // pass 1
    float loc[kSub][V], pr[kSub][V], al[kSub][V], be[kSub][V];
    float l[V], fmp[V], pp[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      l[i] = 0.f;
      fmp[i] = 0.f;
      pp[i] = 1.f;
    }
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      const int s = s0 + k;
      const int t = time_of(s);
      const float m = valid[k] ? 1.f : 0.f;
      const bool has_prev = s + 1 < nt;
      float du_r[V], du_xp[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = sigmoidf(uf[k][i] + bf[i]);
        const float r = sigmoidf(ur[k][i] + br[i]);
        const float cv = ct[k][i];
        float g, gp;
        if (use_relu) {
          g = fmaxf(cv, 0.f);
          gp = cv > 0.f ? 1.f : 0.f;
        } else {
          g = tanhf(cv);
          gp = 1.f - g * g;
        }
        const float a = g_h[k][i] * m * r * gp;
        l[i] = a + fmp[i] * l[i];
        loc[k][i] = l[i];
        pr[k][i] = pp[i];
        const float fm = f * m + (1.f - m);
        fmp[i] = fm;
        pp[i] *= fm;
        const float cp = has_prev ? ct[k + 1][i] : 0.f;
        al[k][i] = (1.f - f) * m;
        be[k][i] = m * (cp - xt[k][i]) * f * (1.f - f);
        du_r[i] = g_h[k][i] * m * (g - xp[k][i]) * r * (1.f - r);
        du_xp[i] = g_h[k][i] * (1.f - r) * m;
        dbr[i] += du_r[i];
      }
      if (live && s < nt) {
        T* dut = dub + (size_t)t * us;
        store_lanes<V>(dut + 2 * H, du_r);
        store_lanes<V>(dut + 3 * H, du_xp);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s_e[p][q * V + i] = fmp[i] * l[i];
      s_f[p][q * V + i] = pp[i];
    }
    __syncthreads();
    if (p == 0) fold_runs<V>(s_e, s_f, carry, q);
    __syncthreads();

    // pass 2
    float cin[V];
#pragma unroll
    for (int i = 0; i < V; ++i) cin[i] = s_e[p][q * V + i];
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      const int s = s0 + k;
      float du_x[V], du_f[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float ghat = loc[k][i] + pr[k][i] * cin[i];
        du_x[i] = ghat * al[k][i];
        du_f[i] = ghat * be[k][i];
        dbf[i] += du_f[i];
      }
      if (live && s < nt) {
        T* dut = dub + (size_t)time_of(s) * us;
        store_lanes<V>(dut, du_x);
        store_lanes<V>(dut + H, du_f);
      }
    }
  }

  // the bias gradient: this block's rows, then (last block) all of B
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s_db[0][p][q * V + i] = dbf[i];
    s_db[1][p][q * V + i] = dbr[i];
  }
  __syncthreads();
  if (p == 0 && live) {
    float sf[V], sr[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sf[i] = sr[i] = 0.f;
      for (int j = 0; j < kChunks; ++j) {
        sf[i] += s_db[0][j][q * V + i];
        sr[i] += s_db[1][j][q * V + i];
      }
    }
    store_lanes<V>(dbp + (size_t)b * 2 * H + h, sf);
    store_lanes<V>(dbp + (size_t)b * 2 * H + H + h, sr);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&g_bwd_tickets[grp], 1u) == (unsigned)(B - 1);
  __syncthreads();
  if (!s_last) return;
  if (threadIdx.x == 0) g_bwd_tickets[grp] = 0;
  if (p == 0 && live) {
    __threadfence();
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float sf = 0.f, sr = 0.f;
      for (int bb = 0; bb < B; ++bb) {
        sf += __ldcg(dbp + (size_t)bb * 2 * H + h + i);
        sr += __ldcg(dbp + (size_t)bb * 2 * H + H + h + i);
      }
      db[h + i] = 0.f;
      db[H + h + i] = sf;
      db[2 * H + h + i] = sr;
      db[3 * H + h + i] = 0.f;
    }
  }
}

template <typename T>
cudaError_t launch_bwd_scan(const void* u, const float* bias4,
                            const int* lengths, const float* c, const void* gh,
                            void* du, float* dbp, float* db, int nt, int B,
                            int H, int reverse, int use_relu, cudaStream_t s) {
  const int V = H % 2 == 0 ? 2 : 1;
  const int groups = (H + kPairs * V - 1) / (kPairs * V);
  if (groups > kMaxGroups) return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  const dim3 grid((unsigned)(B * groups));
  if (V == 2)
    sru_bwd_scan_kernel<T, 2><<<grid, kScanThreads, 0, s>>>(
        (const T*)u, bias4, lengths, c, (const T*)gh, (T*)du, dbp, db, nt, B,
        H, reverse, use_relu);
  else
    sru_bwd_scan_kernel<T, 1><<<grid, kScanThreads, 0, s>>>(
        (const T*)u, bias4, lengths, c, (const T*)gh, (T*)du, dbp, db, nt, B,
        H, reverse, use_relu);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Forward scan, time-chunked
//
// What bounds it: bytes (u in on valid frames; h and c out), with enough
// loads in flight, as the backward above.  One thread per (b, h) lane
// walking all of T with scalar 2-byte bf16 accesses keeps too few of them
// in flight (17x the bound on an H100).  This is the backward's design
// applied to c:
//
//   * c is affine in its carry.  For a run of steps starting at s0 (in the
//     forward's traversal order), c_s = loc_s + P_s * carry_in, where loc is
//     the run's scan c = fm c + bm from a zero carry and P_s the product of
//     fm over the run's steps up to s.  A run's summary (E, F) = (loc_last,
//     P_last) maps carry_in to the next run's: carry_out = E + F * carry_in.
//   * The block layout, windows and runs are the backward's: 128 threads own
//     kPairs * V consecutive h of one b (V = 2 lanes a thread, bf16x2 /
//     float2 accesses, when H is even), thread row p takes the kSub = 4
//     steps at window + 4p of each kWindow = 64-step window.
//   * Pass 1: each thread issues the loads of u's four blocks for its 4
//     steps together, forms f, fm, loc and P, and keeps loc, P, r and x' in
//     registers (32 at V = 2): u is read once.  Runs of padded frames only
//     (t >= len) read nothing: there fm = 1 and bm = 0, so loc = 0, P = 1.
//   * The 16 summaries go to shared memory; one thread row folds them
//     serially from the previous window's carry (fold_runs, as above).
//   * Pass 2: c = loc + P * carry_in and h = (r g(c) + (1 - r) x') m, all
//     independent.  Padded frames get h = 0 and c = the carried value: the
//     last valid c in the forward traversal (padding follows the valid
//     frames), 0 in the reversed one (padding comes first).  The backward
//     reads c at t and at the forward's previous step.
//
// Rounding: the recurrence is reassociated (run scans joined through their
// carries), so c differs from the plain version's step-by-step sum by f32
// rounding, which h inherits; h is rounded once to bf16, to nearest even.
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kScanThreads)
sru_fwd_scan_kernel(const T* __restrict__ u, const float* __restrict__ bias4,
                    const int* __restrict__ lengths, T* __restrict__ h,
                    float* __restrict__ c, int nt, int B, int H, int reverse,
                    int use_relu) {
  constexpr int kLanes = kPairs * V;
  __shared__ float s_e[kChunks][kLanes], s_f[kChunks][kLanes];
  const int groups = (H + kLanes - 1) / kLanes;
  const int b = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int q = threadIdx.x % kPairs, p = threadIdx.x / kPairs;
  const int j = grp * kLanes + q * V;
  const bool live = j < H;
  const int jc = live ? j : 0;  // dead lanes load lane 0 and store nothing
  float bf[V], br[V];
  load_lanes<V>(bias4 + H + jc, bf);
  load_lanes<V>(bias4 + 2 * H + jc, br);
  const int len = lengths[b];
  const size_t us = (size_t)B * 4 * H, hs = (size_t)B * H;
  const T* ub = u + (size_t)b * 4 * H + jc;
  T* hb = h + (size_t)b * H + jc;
  float* cb = c + (size_t)b * H + jc;
  // time of traversal step s, clamped into range
  auto time_of = [&](int s) {
    s = s < nt ? s : nt - 1;
    return reverse ? nt - 1 - s : s;
  };

  float carry[V];
#pragma unroll
  for (int i = 0; i < V; ++i) carry[i] = 0.f;

  for (int w0 = 0; w0 < nt; w0 += kWindow) {
    const int s0 = w0 + p * kSub;
    // one branch around all of a run's loads keeps them issued together
    bool valid[kSub], any = false;
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      valid[k] = s0 + k < nt && time_of(s0 + k) < len;
      any = any || valid[k];
    }
    float xt[kSub][V], uf[kSub][V], ur[kSub][V], xp[kSub][V];
    if (any) {
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const T* ut = ub + (size_t)time_of(s0 + k) * us;
        load_lanes<V>(ut, xt[k]);
        load_lanes<V>(ut + H, uf[k]);
        load_lanes<V>(ut + 2 * H, ur[k]);
        load_lanes<V>(ut + 3 * H, xp[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSub; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i)
          xt[k][i] = uf[k][i] = ur[k][i] = xp[k][i] = 0.f;
    }

    // pass 1: the run's scan from a zero carry
    float loc[kSub][V], pr[kSub][V], r[kSub][V];
    float l[V], pp[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      l[i] = 0.f;
      pp[i] = 1.f;
    }
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      const float m = valid[k] ? 1.f : 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = sigmoidf(uf[k][i] + bf[i]);
        const float fm = f * m + (1.f - m);
        l[i] = fm * l[i] + (1.f - f) * xt[k][i] * m;
        pp[i] *= fm;
        loc[k][i] = l[i];
        pr[k][i] = pp[i];
        r[k][i] = sigmoidf(ur[k][i] + br[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s_e[p][q * V + i] = l[i];
      s_f[p][q * V + i] = pp[i];
    }
    __syncthreads();
    if (p == 0) fold_runs<V>(s_e, s_f, carry, q);
    __syncthreads();

    // pass 2
    float cin[V];
#pragma unroll
    for (int i = 0; i < V; ++i) cin[i] = s_e[p][q * V + i];
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      const int s = s0 + k;
      const float m = valid[k] ? 1.f : 0.f;
      float cv[V], hv[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        cv[i] = loc[k][i] + pr[k][i] * cin[i];
        const float g = use_relu ? fmaxf(cv[i], 0.f) : tanhf(cv[i]);
        hv[i] = (r[k][i] * g + (1.f - r[k][i]) * xp[k][i]) * m;
      }
      if (live && s < nt) {
        const size_t t = time_of(s);
        store_lanes<V>(hb + t * hs, hv);
        store_lanes<V>(cb + t * hs, cv);
      }
    }
  }
}

template <typename T>
cudaError_t launch_fwd_scan(const void* u, const float* bias4,
                            const int* lengths, void* h, float* c, int nt,
                            int B, int H, int reverse, int use_relu,
                            cudaStream_t s) {
  if (B == 0 || H == 0 || nt == 0) return cudaSuccess;
  const int V = H % 2 == 0 ? 2 : 1;
  const dim3 grid((unsigned)(B * ((H + kPairs * V - 1) / (kPairs * V))));
  if (V == 2)
    sru_fwd_scan_kernel<T, 2><<<grid, kScanThreads, 0, s>>>(
        (const T*)u, bias4, lengths, (T*)h, c, nt, B, H, reverse, use_relu);
  else
    sru_fwd_scan_kernel<T, 1><<<grid, kScanThreads, 0, s>>>(
        (const T*)u, bias4, lengths, (T*)h, c, nt, B, H, reverse, use_relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x: (M, K) bf16 with rows ldx elements apart.
int sru_proj_gemm_bf16(const void* x, const void* w, void* u, int M, int N,
                       int K, int ldx, void* stream) {
  return (int)launch_proj_gemm_bf16(x, w, u, M, N, K, ldx,
                                    (cudaStream_t)stream);
}

// x: (M, K) f32 with rows ldx elements apart; the plan (tile_m, tile_n,
// splits, kps) and the workspace ws (splits * M * N floats when
// splits > 1) come from the caller.
int sru_proj_gemm_f32(const float* x, const float* w, float* u, float* ws,
                      int M, int N, int K, int ldx, int tile_m, int tile_n,
                      int splits, int kps, void* stream) {
  return (int)launch_proj_gemm_f32(x, w, u, ws, M, N, K, ldx, tile_m, tile_n,
                                   splits, kps, (cudaStream_t)stream);
}

int sru_fwd_scan(const void* u, const float* bias4, const int* lengths,
                 void* h, float* c, int T, int B, int H, int reverse,
                 int use_relu, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_fwd_scan<__nv_bfloat16>(u, bias4, lengths, h, c,
                                                     T, B, H, reverse,
                                                     use_relu, s)
                    : launch_fwd_scan<float>(u, bias4, lengths, h, c, T, B,
                                             H, reverse, use_relu, s));
}

// dbp: (B, 2H) float32 scratch for the per-b partials; db: (4H,) float32.
int sru_bwd_scan(const void* u, const float* bias4, const int* lengths,
                 const float* c, const void* gh, void* du, float* dbp,
                 float* db, int T, int B, int H, int reverse, int use_relu,
                 int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_bwd_scan<__nv_bfloat16>(
                          u, bias4, lengths, c, gh, du, dbp, db, T, B, H,
                          reverse, use_relu, s)
                    : launch_bwd_scan<float>(u, bias4, lengths, c, gh, du,
                                             dbp, db, T, B, H, reverse,
                                             use_relu, s));
}

}  // extern "C"
