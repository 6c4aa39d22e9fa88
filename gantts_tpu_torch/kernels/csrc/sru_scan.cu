// Hopper (sm_90a) kernels for one direction of one SRU layer.
//
// Three launches replace the TPU kernels of gantts_tpu/kernels/sru_scan.py:
//
//   sru_proj_gemm  u = x @ W, the `_proj_u` half of `_psru_fwd_kernel`.
//                  (T*B, D) x (D, 4H) with f32 accumulation, u stored in the
//                  I/O dtype.  Bound by compute: 43 GFLOP per call at
//                  T=512, B=20, D=1024, H=512.  bf16 I/O runs on the tensor
//                  cores through WMMA 16x16x16 fragments (128x128 block
//                  tile, eight warps of 64x32, K tiles double-buffered in
//                  shared memory, 16-byte loads).  f32 I/O
//                  stays off the tensor cores (TF32 would lose the
//                  exactness the f32 path promises) and uses a shared-
//                  memory-tiled FMA kernel (64x64 tile, 4x4 outputs per
//                  thread, not double-buffered).  wgmma and TMA, the way to
//                  the card's full rate, are not used yet.
//
//   sru_fwd_scan   the scan half of `_psru_fwd_kernel` and all of
//                  `_fused_fwd_kernel`: bias add, gates, length mask, the
//                  recurrence c_t = fm_t * c_{t-1} + bm_t and the highway
//                  output, from a precomputed u.
//
//   sru_bwd_scan   `_fused_bwd_kernel`: the adjoint recurrence
//                  ghat_t = a_t + fm_{t+1} * ghat_{t+1}, the four du blocks,
//                  and per-row partial sums of the f/r bias gradient.
//
// The scans are sequential in time and elementwise across (b, h).  One thread
// owns one (b, h) lane and walks T in traversal order with its recurrence
// state in a register; neighbouring threads own neighbouring h, so every load
// and store is coalesced along h.  At B=20, H=512 that is 10,240 lanes, a
// few warps per SM on 132 SMs, so the scans are bound by memory latency
// rather than bandwidth (u alone is 42 MB a call in bf16).  The design hides
// latency with instruction-level parallelism instead of occupancy: the loads
// of kUnroll time steps are issued together before the dependent arithmetic
// (they do not depend on the carry), and blocks are kept small (64 threads)
// so the lanes spread over as many SMs as possible.
//
// The TPU's sequential grid forced a per-chunk carry array (`cb`) so that the
// backward could rebuild c_{t-1} at chunk edges.  Here c_{t-1} is read
// straight from the full f32 c array, so `cb` is dropped.
//
// The bias gradient is reduced per lane over T in a register and written as
// (B, 2H) partials, which the caller sums over B: deterministic, no atomics.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---------------------------------------------------------------------------
// u = x @ W
// ---------------------------------------------------------------------------

constexpr int kTile = 64;

// f32: 256 threads as a 16x16 grid, each owning a 4x4 block of C.  Rows and
// columns of a thread's block are strided by 16 so that a warp reads
// consecutive shared-memory words.
constexpr int kSimtK = 16;

__global__ void __launch_bounds__(256)
proj_gemm_f32(const float* __restrict__ A, const float* __restrict__ Bm,
              float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[kSimtK][kTile + 4];
  __shared__ float Bs[kSimtK][kTile + 4];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSimtK) {
    for (int i = tid; i < kTile * kSimtK; i += 256) {
      const int m = i / kSimtK, k = i % kSimtK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < kTile * kSimtK; i += 256) {
      const int k = i / kTile, n = i % kTile;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? Bm[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSimtK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// bf16: a 128x128 tile of C per block of eight warps (2 x 4), each warp
// owning 64x32 as 4x2 WMMA accumulators in f32.  K advances 32 at a time
// through two shared-memory buffers: the global loads of the next K tile
// are issued into registers before the tensor cores work on the current
// one, and stored to the other buffer after, so one barrier per K tile
// suffices.  Every load is 16 bytes (8 bf16), so K and N must be multiples
// of 8 and both operands 16-byte aligned (the caller zero-pads a ragged K,
// such as the first layer's 425); the ragged M, N and K tile edges are
// zero-filled.  Row strides are padded by 8 elements, which keeps every
// fragment pointer 32-byte aligned as WMMA requires.
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kAStride = kBK + 8;
constexpr int kBStride = kBN + 8;
constexpr int kGemmThreads = 256;
constexpr int kPerThread = kBM * kBK / kGemmThreads;  // 16, as kBK * kBN

struct TileRegs {
  uint4 a[kPerThread / 8], b[kPerThread / 8];

  __device__ void load(const __nv_bfloat16* A, const __nv_bfloat16* Bm,
                       int M, int N, int K, int m0, int n0, int k0,
                       int tid) {
#pragma unroll
    for (int i = 0; i < kPerThread / 8; ++i) {
      const int v = tid + i * kGemmThreads;
      const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      a[i] = (gm < M && gk < K)
                 ? *reinterpret_cast<const uint4*>(A + (size_t)gm * K + gk)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kPerThread / 8; ++i) {
      const int v = tid + i * kGemmThreads;
      const int r = v / (kBN / 8), c = (v % (kBN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + c;
      b[i] = (gk < K && gn < N)
                 ? *reinterpret_cast<const uint4*>(Bm + (size_t)gk * N + gn)
                 : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void store(__nv_bfloat16* As, __nv_bfloat16* Bs, int tid) const {
#pragma unroll
    for (int i = 0; i < kPerThread / 8; ++i) {
      const int v = tid + i * kGemmThreads;
      const int r = v / (kBK / 8), c = (v % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * kAStride + c) = a[i];
    }
#pragma unroll
    for (int i = 0; i < kPerThread / 8; ++i) {
      const int v = tid + i * kGemmThreads;
      const int r = v / (kBN / 8), c = (v % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + r * kBStride + c) = b[i];
    }
  }
};

__global__ void __launch_bounds__(kGemmThreads)
proj_gemm_bf16(const __nv_bfloat16* __restrict__ A,
               const __nv_bfloat16* __restrict__ Bm,
               __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[2][kBM * kAStride];
  __shared__ __align__(32) __nv_bfloat16 Bs[2][kBK * kBStride];
  __shared__ __align__(32) float Cs[kGemmThreads / 32][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  TileRegs regs;
  regs.load(A, Bm, M, N, K, m0, n0, 0, tid);
  regs.store(As[0], Bs[0], tid);
  __syncthreads();
  const int nk = (K + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) regs.load(A, Bm, M, N, K, m0, n0, (kt + 1) * kBK, tid);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As[cur] + (wm + 16 * i) * kAStride + kk,
                               kAStride);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs[cur] + kk * kBStride + wn + 16 * j,
                               kBStride);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < nk) regs.store(As[cur ^ 1], Bs[cur ^ 1], tid);
    __syncthreads();
  }
  // epilogue: each warp stages one 16x16 accumulator at a time
  float* stage = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm + 16 * i + e / 16;
        const int gn = n0 + wn + 16 * j + e % 16;
        if (gm < M && gn < N)
          C[(size_t)gm * N + gn] = __float2bfloat16(stage[e]);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// Scans: one thread per (b, h) lane, u laid out (T, B, 4H) as
// [x~ | f | r | x'] blocks, h / c / gh laid out (T, B, H).
// ---------------------------------------------------------------------------

constexpr int kUnroll = 8;
constexpr int kScanThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
sru_fwd_scan_kernel(const T* __restrict__ u, const float* __restrict__ bias4,
                    const int* __restrict__ lengths, T* __restrict__ h,
                    float* __restrict__ c, int nt, int B, int H, int reverse,
                    int use_relu) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B * H) return;
  const int b = lane / H, j = lane - b * H;
  const float bf = bias4[H + j], br = bias4[2 * H + j];
  const int len = lengths[b];
  const size_t us = (size_t)B * 4 * H, hs = (size_t)B * H;
  const T* ub = u + (size_t)b * 4 * H + j;
  T* hb = h + (size_t)b * H + j;
  float* cb = c + (size_t)b * H + j;

  float carry = 0.f;
  for (int s0 = 0; s0 < nt; s0 += kUnroll) {
    float xt[kUnroll], uf[kUnroll], ur[kUnroll], xp[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int s = s0 + i;
      if (s < nt) {
        const int t = reverse ? nt - 1 - s : s;
        const T* ut = ub + (size_t)t * us;
        xt[i] = to_f32(ut[0]);
        uf[i] = to_f32(ut[H]);
        ur[i] = to_f32(ut[2 * H]);
        xp[i] = to_f32(ut[3 * H]);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int s = s0 + i;
      if (s < nt) {
        const int t = reverse ? nt - 1 - s : s;
        const float m = t < len ? 1.f : 0.f;
        const float f = sigmoidf(uf[i] + bf);
        const float fm = f * m + (1.f - m);
        const float bm = (1.f - f) * xt[i] * m;
        carry = fm * carry + bm;
        const float r = sigmoidf(ur[i] + br);
        const float g = use_relu ? fmaxf(carry, 0.f) : tanhf(carry);
        hb[(size_t)t * hs] = from_f32<T>((r * g + (1.f - r) * xp[i]) * m);
        cb[(size_t)t * hs] = carry;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
sru_bwd_scan_kernel(const T* __restrict__ u, const float* __restrict__ bias4,
                    const int* __restrict__ lengths,
                    const float* __restrict__ c, const T* __restrict__ gh,
                    T* __restrict__ du, float* __restrict__ dbp, int nt, int B,
                    int H, int reverse, int use_relu) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B * H) return;
  const int b = lane / H, j = lane - b * H;
  const float bf = bias4[H + j], br = bias4[2 * H + j];
  const int len = lengths[b];
  const size_t us = (size_t)B * 4 * H, hs = (size_t)B * H;
  const T* ub = u + (size_t)b * 4 * H + j;
  T* dub = du + (size_t)b * 4 * H + j;
  const float* cb = c + (size_t)b * H + j;
  const T* gb = gh + (size_t)b * H + j;

  float ghat = 0.f, fm_next = 0.f, dbf = 0.f, dbr = 0.f;
  // Traverse opposite to the forward pass; the forward's previous step of
  // time t is tp = t - 1 (forward layer) or t + 1 (reversed layer).
  for (int s0 = 0; s0 < nt; s0 += kUnroll) {
    float xt[kUnroll], uf[kUnroll], ur[kUnroll], xp[kUnroll];
    float ct[kUnroll], cp[kUnroll], g_h[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int s = s0 + i;
      if (s < nt) {
        const int t = reverse ? s : nt - 1 - s;
        const int tp = reverse ? t + 1 : t - 1;
        const T* ut = ub + (size_t)t * us;
        xt[i] = to_f32(ut[0]);
        uf[i] = to_f32(ut[H]);
        ur[i] = to_f32(ut[2 * H]);
        xp[i] = to_f32(ut[3 * H]);
        ct[i] = cb[(size_t)t * hs];
        cp[i] = (tp >= 0 && tp < nt) ? cb[(size_t)tp * hs] : 0.f;
        g_h[i] = to_f32(gb[(size_t)t * hs]);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int s = s0 + i;
      if (s < nt) {
        const int t = reverse ? s : nt - 1 - s;
        const float m = t < len ? 1.f : 0.f;
        const float f = sigmoidf(uf[i] + bf);
        const float r = sigmoidf(ur[i] + br);
        float g, gp;
        if (use_relu) {
          g = fmaxf(ct[i], 0.f);
          gp = ct[i] > 0.f ? 1.f : 0.f;
        } else {
          g = tanhf(ct[i]);
          gp = 1.f - g * g;
        }
        const float a = g_h[i] * m * r * gp;
        ghat = a + fm_next * ghat;
        fm_next = f * m + (1.f - m);
        const float du_f = m * ghat * (cp[i] - xt[i]) * f * (1.f - f);
        const float du_r = g_h[i] * m * (g - xp[i]) * r * (1.f - r);
        T* dut = dub + (size_t)t * us;
        dut[0] = from_f32<T>(ghat * (1.f - f) * m);
        dut[H] = from_f32<T>(du_f);
        dut[2 * H] = from_f32<T>(du_r);
        dut[3 * H] = from_f32<T>(g_h[i] * (1.f - r) * m);
        dbf += du_f;
        dbr += du_r;
      }
    }
  }
  dbp[(size_t)b * 2 * H + j] = dbf;
  dbp[(size_t)b * 2 * H + H + j] = dbr;
}

inline dim3 scan_grid(int B, int H) {
  return dim3((unsigned)((B * H + kScanThreads - 1) / kScanThreads));
}

}  // namespace

extern "C" {

const char* sru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int sru_proj_gemm(const void* x, const void* w, void* u, int M, int N, int K,
                  int bf16, void* stream) {
  const dim3 grid((unsigned)((N + kTile - 1) / kTile),
                  (unsigned)((M + kTile - 1) / kTile));
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const dim3 tiles((unsigned)((N + kBN - 1) / kBN),
                     (unsigned)((M + kBM - 1) / kBM));
    if (K % 8 != 0 || N % 8 != 0 || (uintptr_t)x % 16 != 0 ||
        (uintptr_t)w % 16 != 0)
      return (int)cudaErrorInvalidValue;
    proj_gemm_bf16<<<tiles, kGemmThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)u,
        M, N, K);
  } else {
    proj_gemm_f32<<<grid, 256, 0, s>>>((const float*)x, (const float*)w,
                                       (float*)u, M, N, K);
  }
  return (int)cudaGetLastError();
}

int sru_fwd_scan(const void* u, const float* bias4, const int* lengths,
                 void* h, float* c, int T, int B, int H, int reverse,
                 int use_relu, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    sru_fwd_scan_kernel<__nv_bfloat16><<<scan_grid(B, H), kScanThreads, 0, s>>>(
        (const __nv_bfloat16*)u, bias4, lengths, (__nv_bfloat16*)h, c, T, B, H,
        reverse, use_relu);
  } else {
    sru_fwd_scan_kernel<float><<<scan_grid(B, H), kScanThreads, 0, s>>>(
        (const float*)u, bias4, lengths, (float*)h, c, T, B, H, reverse,
        use_relu);
  }
  return (int)cudaGetLastError();
}

int sru_bwd_scan(const void* u, const float* bias4, const int* lengths,
                 const float* c, const void* gh, void* du, float* dbp, int T,
                 int B, int H, int reverse, int use_relu, int bf16,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    sru_bwd_scan_kernel<__nv_bfloat16><<<scan_grid(B, H), kScanThreads, 0, s>>>(
        (const __nv_bfloat16*)u, bias4, lengths, c, (const __nv_bfloat16*)gh,
        (__nv_bfloat16*)du, dbp, T, B, H, reverse, use_relu);
  } else {
    sru_bwd_scan_kernel<float><<<scan_grid(B, H), kScanThreads, 0, s>>>(
        (const float*)u, bias4, lengths, c, (const float*)gh, (float*)du, dbp,
        T, B, H, reverse, use_relu);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
