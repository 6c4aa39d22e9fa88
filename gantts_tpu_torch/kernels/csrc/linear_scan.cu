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
// and independent across lanes: one thread owns one lane and walks all of T
// with its carry in a register; neighbouring threads own neighbouring lanes,
// so every load and store is coalesced.
//
// What bounds them.  The forward moves 3 arrays (f, b in; c out), the
// backward 5 (g, f, c in; df, db out): 63 MB and 105 MB at T=512, B=20,
// H=512, about 19 us and 31 us at 3.35 TB/s.  But 10,240 lanes are one
// thread each on 132 SMs, far too few to cover memory latency by occupancy,
// so the kernels are latency-bound: the bytes in flight decide the rate.
// The design issues the loads of kUnroll time steps together before the
// dependent arithmetic (they do not depend on the carry), as the SRU scans
// do, with a deeper unroll because each step carries less arithmetic, and
// keeps blocks small (64 threads) so the lanes spread over every SM.
//
// The backward reads f_{t+1} and c_{t-1} in place: f_t loaded at step t is
// kept in a register for step t-1, and c_{t-1} is read from c.  The JAX
// `_bwd` builds shifted copies of f and c by concatenation; nothing here
// does.  The TPU padding of B to 8, H to 128 and T to a chunk multiple
// (`linear_recurrence_pallas`) is TPU tiling and has no counterpart.
//
// Rounding.  Each product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: no fused multiply-add), as PyTorch's separate elementwise ops
// round them, so the plain version in linear_scan.py is the kernel's exact
// oracle.
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

__global__ void __launch_bounds__(kThreads)
linear_recurrence_bwd_kernel(const float* __restrict__ g,
                             const float* __restrict__ f,
                             const float* __restrict__ c,
                             float* __restrict__ df, float* __restrict__ db,
                             int T, int N) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const size_t ts = (size_t)N;
  float ghat = 0.f, f_next = 0.f;  // f_{t+1}; 0 past the last step
  for (int s0 = 0; s0 < T; s0 += kUnroll) {
    float gv[kUnroll], fv[kUnroll], cp[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = T - 1 - (s0 + i);
      if (t >= 0) {
        const size_t o = (size_t)t * ts + lane;
        gv[i] = g[o];
        fv[i] = f[o];
        cp[i] = t > 0 ? c[o - ts] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = T - 1 - (s0 + i);
      if (t >= 0) {
        ghat = __fadd_rn(gv[i], __fmul_rn(f_next, ghat));
        f_next = fv[i];
        const size_t o = (size_t)t * ts + lane;
        db[o] = ghat;
        df[o] = __fmul_rn(ghat, cp[i]);
      }
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

int linear_recurrence_bwd(const float* g, const float* f, const float* c,
                          float* df, float* db, int T, int N, void* stream) {
  linear_recurrence_bwd_kernel<<<grid_for(N), kThreads, 0,
                                 (cudaStream_t)stream>>>(g, f, c, df, db, T,
                                                         N);
  return (int)cudaGetLastError();
}

}  // extern "C"
