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
// the bytes in flight decide the rate.
//
// The forward: one thread owns one lane and walks all of T with its carry
// in a register.  It issues the loads of kUnroll time steps together before
// the dependent arithmetic (they do not depend on the carry) and keeps
// blocks small (64 threads) so the lanes spread over every SM.  That leaves
// about 78 lanes x 16 steps x 8 bytes in flight per SM, and none while a
// window is computed and stored.
//
// The backward splits T too, so that T / kChunk times more threads have
// their loads in flight at once.  A thread owns kChunk = 32 steps of one
// lane and issues all of their loads first (g_t, f_t and c_{t-1}, 96
// floats, kept in registers; f_{t1+1} above the chunk once more).  Pass 1
// reduces the chunk to an affine map of the carry it receives, ghat_lo = a
// + p ghat_{hi+1}.  One thread per lane then carries ghat through the
// lane's chunks in order through shared memory (ghat_T = 0), and pass 2
// runs the plain version's steps from each chunk's carry and stores df and
// db.  Every element is read once and written once.  A block holds every
// chunk of up to 16 lanes (256 threads at T=512), so T is at most 8192.
// Deeper pipelines that kept one thread a lane (16-step stages of g, f and
// c in shared memory, four in flight, filled by cp.async.bulk or by 16-byte
// cp.async; or the next window's loads in registers) ran slower than the
// plain unrolled loop on an H100, whatever their depth.
//
// The backward reads f_{t+1} and c_{t-1} in place: f_t loaded at step t is
// kept for step t-1, and c_{t-1} is read from c.  The JAX `_bwd` builds
// shifted copies of f and c by concatenation; nothing here does.  The TPU
// padding of B to 8, H to 128 and T to a chunk multiple
// (`linear_recurrence_pallas`) is TPU tiling and has no counterpart.
//
// Rounding.  Each product and sum of the plain recurrence is rounded on
// its own (__fmul_rn, __fadd_rn: no fused multiply-add), as PyTorch's
// separate elementwise ops round them.  The forward is therefore bit-exact
// against the plain version in linear_scan.py.  The backward is exact in
// the chunk its traversal starts with (t >= T - 32, carry 0); elsewhere each chunk
// starts from a carry composed through the chunks' affine maps, rounded in
// another order, so df and db agree with the plain version to rounding
// (4.1e-7 of scale in chip_smoke.py's phase 3c on an H100), not bit for
// bit.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kUnroll = 16;
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
linear_recurrence_fwd_kernel(const float* __restrict__ f,
                             const float* __restrict__ b,
                             float* __restrict__ c, int T, int N) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const size_t ts = (size_t)N;
  float carry = 0.f;
  for (int t0 = 0; t0 < T; t0 += kUnroll) {
    float fv[kUnroll], bv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (t0 + i < T) {
        const size_t o = (size_t)(t0 + i) * ts + lane;
        fv[i] = f[o];
        bv[i] = b[o];
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (t0 + i < T) {
        carry = __fadd_rn(__fmul_rn(fv[i], carry), bv[i]);
        c[(size_t)(t0 + i) * ts + lane] = carry;
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

inline dim3 grid_for(int N) {
  return dim3((unsigned)((N + kThreads - 1) / kThreads));
}

}  // namespace

extern "C" {

const char* linear_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int linear_recurrence_fwd(const float* f, const float* b, float* c, int T,
                          int N, void* stream) {
  linear_recurrence_fwd_kernel<<<grid_for(N), kThreads, 0,
                                 (cudaStream_t)stream>>>(f, b, c, T, N);
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
