// Hopper (sm_90a) kernels for the plain linear recurrence of the k=3 SRU
// layer (D == H, every layer after the first of a unidirectional stack).
//
// Two launches replace the TPU kernels of gantts_tpu/kernels/sru_scan.py
// (`pallas_linear_recurrence`, a custom_vjp over `_scan_call`):
//
//   linear_recurrence_fwd  `_fwd_kernel`:  c_t = f_t * c_{t-1} + b_t, c_{-1} = 0.
//   linear_recurrence_bwd  `_bwd_kernel` and the JAX `_bwd` around it:
//                          ghat_t = g_t + f_{t+1} * ghat_{t+1} (ghat_T = 0),
//                          db_t = ghat_t, df_t = ghat_t * c_{t-1}.
//
// All arrays are float32, time-major (T, B, H) and contiguous, so at each t
// the B*H lanes are one contiguous row.  The recurrence is sequential in t
// and independent across lanes; neighbouring threads own neighbouring
// lanes, so every load and store is coalesced.
//
// What bounds them.  The forward moves 3 arrays (f, b in; c out), the
// backward 5 (g, f, c in; df, db out): 63 MB and 105 MB at T=512, B=20,
// H=512, about 19 us and 31 us at 3.35 TB/s.  But 10,240 lanes are one
// thread each on 132 SMs, far too few to cover memory latency by occupancy:
// the bytes in flight decide the rate.  A thread that walks all of T with
// its carry in a register (the first forward here) had about 78 lanes x 16
// steps x 8 bytes in flight per SM, and none while a window was computed
// and stored: 34% of the bound's rate on an H100.
//
// So both split T, so that many times more threads have their loads in
// flight at once.  A thread owns a chunk of steps of one lane and issues
// all of their loads first, kept in registers.  Pass 1 reduces the chunk to
// an affine map of the carry it receives; one thread per lane then carries
// the state through the lane's chunks in order through shared memory, and
// pass 2 runs the plain version's steps from each chunk's carry and stores
// the outputs.  Every element is read once and written once.
//
// The forward: a chunk is kFwdChunk = 16 steps, and its map is c_out = a +
// p c_in, a the chunk run from carry 0 and p the product of its f (f_t and
// b_t, 32 floats a thread, 64 registers).  A block of 512 threads holds 16
// chunks of each of 32 lanes, a window of 256 steps, and walks T window by
// window, the joining thread keeping the lane's c in a register from one
// window to the next, so T has no upper limit.  f and b are loaded, and c
// stored, with the streaming hints (__ldcs, __stcs: each element is touched
// once).  On an H100 at T=512, B=20, H=512 that shape took 0.0228 ms, 82%
// of the bound's rate, where 32-step chunks in blocks of 256 threads took
// 0.0267 (0.0300 without the hints), the same shape without the hints
// 0.0271, and other windows, block sizes or 8-step chunks 0.0232-0.0297
// (tools/torch_linear_fwd_shapes.py, which rebuilds this file with its text
// patched: it names the kFwd* constants and the __ldcs / __stcs lines, and
// an edit to those must update it).
//
// The backward: a chunk is kChunk = 32 steps, its map ghat_lo = a + p
// ghat_{hi+1} (g_t, f_t and c_{t-1}, 96 floats a thread; f_{t1+1} above the
// chunk once more), and ghat_T = 0.  A block holds every chunk of up to 16
// lanes (256 threads at T=512), so T is at most 8192.  Deeper pipelines that
// kept one thread a lane (16-step stages of g, f and c in shared memory, four
// in flight, filled by cp.async.bulk or by 16-byte cp.async; or the next
// window's loads in registers) ran slower than the plain unrolled loop on an
// H100, whatever their depth.
//
// The backward reads f_{t+1} and c_{t-1} in place: f_t loaded at step t is
// kept for step t-1, and c_{t-1} is read from c.  The JAX `_bwd` builds
// shifted copies of f and c by concatenation; nothing here does.  The TPU
// padding of B to 8, H to 128 and T to a chunk multiple
// (`linear_recurrence_pallas`) is TPU tiling and has no counterpart.
//
// Rounding.  Pass 2 rounds each product and sum of the plain recurrence on
// its own (__fmul_rn, __fadd_rn: no fused multiply-add), as PyTorch's
// separate elementwise ops round them.  So each kernel is exact in the
// chunk its traversal starts with (the forward's t < 16, the backward's
// t >= T - 32), whose carry is 0.  Elsewhere each chunk starts from a carry
// composed through the chunks' affine maps, rounded in another order, so c,
// df and db agree with the plain version to rounding (4.1e-7 of scale for
// the backward in chip_smoke.py's phase 3c on an H100), not bit for bit.
// Where f = 1 and b = 0 (the k=3 layer's padding) a chunk's map is exactly
// the identity, so c holds the last valid value exactly.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// The forward: each thread walks kFwdChunk steps of one lane; a block holds
// nq chunks (at most kFwdMaxChunks) of LB lanes, nq * LB <= kFwdThreads.
constexpr int kFwdChunk = 16;
constexpr int kFwdThreads = 512;
constexpr int kFwdMaxChunks = 16;

__global__ void __launch_bounds__(kFwdThreads)
linear_recurrence_fwd_kernel(const float* __restrict__ f,
                             const float* __restrict__ b,
                             float* __restrict__ c, int T, int N, int LB) {
  __shared__ float sa[kFwdThreads], sp[kFwdThreads];
  const int tid = threadIdx.x, nq = blockDim.x / LB;
  const int li = tid % LB, q = tid / LB, lane = blockIdx.x * LB + li;
  const bool live = lane < N;
  const size_t ts = (size_t)N;
  float carry = 0.f;  // the lane's c before the window (thread q == 0)
  for (int w0 = 0; w0 < T; w0 += nq * kFwdChunk) {
    // chunk q of the window: t from t0 to t0 + n - 1 (n <= 0 past T)
    const int t0 = w0 + q * kFwdChunk, n = min(kFwdChunk, T - t0);
    // Every load of the chunk first, none depends on a carry.
    float fv[kFwdChunk], bv[kFwdChunk];
    if (live) {
#pragma unroll
      for (int i = 0; i < kFwdChunk; ++i)
        if (i < n) {
          const size_t o = (size_t)(t0 + i) * ts + lane;
          fv[i] = __ldcs(f + o);
          bv[i] = __ldcs(b + o);
        }
    }
    // Pass 1: the chunk as an affine map of its carry, c_out = a + p c_in.
    float a = 0.f, p = 1.f;
    if (live) {
#pragma unroll
      for (int i = 0; i < kFwdChunk; ++i)
        if (i < n) {
          a = fv[i] * a + bv[i];
          p = fv[i] * p;
        }
    }
    sa[tid] = a;
    sp[tid] = p;
    __syncthreads();
    // The carries, chunk after chunk of each lane, in place of the maps.
    if (q == 0) {
      float x = carry;
      for (int k = 0; k < nq; ++k) {
        const int j = k * LB + li;
        const float next = sa[j] + sp[j] * x;
        sa[j] = x;
        x = next;
      }
      carry = x;
    }
    __syncthreads();
    // Pass 2: the plain version's steps from the chunk's carry.
    if (live) {
      float cv = sa[tid];
#pragma unroll
      for (int i = 0; i < kFwdChunk; ++i)
        if (i < n) {
          cv = __fadd_rn(__fmul_rn(fv[i], cv), bv[i]);
          __stcs(c + (size_t)(t0 + i) * ts + lane, cv);
        }
    }
  }
}

// The backward: each thread walks kChunk steps of one lane; a block holds
// all ceil(T / kChunk) chunks of LB lanes (at most kBwdThreads threads).
constexpr int kChunk = 32;
constexpr int kBwdThreads = 256;
constexpr int kMaxLanes = 16;

__global__ void __launch_bounds__(kBwdThreads)
linear_recurrence_bwd_kernel(const float* __restrict__ g,
                             const float* __restrict__ f,
                             const float* __restrict__ c,
                             float* __restrict__ df, float* __restrict__ db,
                             int T, int N, int LB) {
  __shared__ float sa[kBwdThreads], sp[kBwdThreads];
  const int tid = threadIdx.x, nch = blockDim.x / LB;
  const int li = tid % LB, q = tid / LB, lane = blockIdx.x * LB + li;
  const bool live = lane < N;
  // chunk q: t from t1 down to t1 - n + 1 (chunk 0 ends the traversal's
  // start, t = T - 1)
  const int t1 = T - 1 - q * kChunk, n = min(kChunk, t1 + 1);
  const size_t ts = (size_t)N;

  // Every load of the chunk first, none depends on a carry: f_{t1+1}, and
  // g_t, f_t and c_{t-1} of its steps.
  float gv[kChunk], fv[kChunk], cv[kChunk];
  float f_top = 0.f;  // f_{t1+1}; 0 past the last step
  if (live) {
    if (t1 + 1 < T) f_top = f[(size_t)(t1 + 1) * ts + lane];
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < n) {
        const int t = t1 - i;
        const size_t o = (size_t)t * ts + lane;
        gv[i] = g[o];
        fv[i] = f[o];
        cv[i] = t > 0 ? c[o - ts] : 0.f;
      }
  }
  // Pass 1: the chunk as an affine map of the carry it receives,
  // ghat_{t1-n+1} = a + p ghat_{t1+1}.
  float a = 0.f, p = 1.f;
  if (live) {
    float f_next = f_top;
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < n) {
        a = gv[i] + f_next * a;
        p = f_next * p;
        f_next = fv[i];
      }
  }
  sa[tid] = a;
  sp[tid] = p;
  __syncthreads();
  // The carries, chunk after chunk of each lane (ghat_T = 0), in place of
  // the maps.
  if (q == 0) {
    float x = 0.f;
    for (int k = 0; k < nch; ++k) {
      const int j = k * LB + li;
      const float next = sa[j] + sp[j] * x;
      sa[j] = x;
      x = next;
    }
  }
  __syncthreads();
  // Pass 2: the plain version's steps from the chunk's carry.
  if (live) {
    float ghat = sa[tid], f_next = f_top;
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i < n) {
        ghat = __fadd_rn(gv[i], __fmul_rn(f_next, ghat));
        f_next = fv[i];
        const size_t o = (size_t)(t1 - i) * ts + lane;
        db[o] = ghat;
        df[o] = __fmul_rn(ghat, cv[i]);
      }
  }
}

}  // namespace

extern "C" {

const char* linear_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Any T: windows of kFwdMaxChunks chunks, 256 steps.
int linear_recurrence_fwd(const float* f, const float* b, float* c, int T,
                          int N, void* stream) {
  const int nch = (T + kFwdChunk - 1) / kFwdChunk;
  const int nq = nch < kFwdMaxChunks ? nch : kFwdMaxChunks;
  const int LB = kFwdThreads / nq;
  linear_recurrence_fwd_kernel<<<(N + LB - 1) / LB, nq * LB, 0,
                                 (cudaStream_t)stream>>>(f, b, c, T, N, LB);
  return (int)cudaGetLastError();
}

// T up to kChunk * kBwdThreads (8192) steps; a longer T returns
// cudaErrorInvalidValue.
int linear_recurrence_bwd(const float* g, const float* f, const float* c,
                          float* df, float* db, int T, int N, void* stream) {
  const int nch = (T + kChunk - 1) / kChunk;
  const int LB = kBwdThreads / nch < kMaxLanes ? kBwdThreads / nch : kMaxLanes;
  if (LB < 1) return (int)cudaErrorInvalidValue;
  linear_recurrence_bwd_kernel<<<(N + LB - 1) / LB, nch * LB, 0,
                                 (cudaStream_t)stream>>>(g, f, c, df, db, T,
                                                         N, LB);
  return (int)cudaGetLastError();
}

}  // extern "C"
