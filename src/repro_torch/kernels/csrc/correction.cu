// Eq.-10 balance-correction messages for Hopper (sm_90a), batched over Q
// query slots.
//
// Replaces the Pallas TPU kernel repro/kernels/correction.py::
// correction_kernel (launched by correction_call), and its query-batched
// form (the JAX service vmaps it over its slots).  For every slot q and
// peer i with violating set V_i (v_set):
//
//   T_i      = S_i + sum_{k in V_i} A_ik                  (Eq. 8 target)
//   nv       = max(|V_i|, 1)
//   |A'_ik|  = |A_ik| + (|S_i| - beta_q) / (2 nv)         (Eq. 10)
//   scale    = |A'_ik| / T_c   (T_c replaced by 1 where |T_c| <= eps_q)
//   X'_ik    = scale * T_i - X_ki                          (every slot)
//
// Design: a 2-D grid, blockIdx.y = slot, one thread per peer; one pass over
// its slots for T and |V_i| (reading A only on V_i), one pass writing X'
// for every slot (the caller keeps the V_i slots).  Memory-bound: it reads
// in_m, in_c, a_c once and writes out_m', out_c' once; d is a template
// parameter (1..kMaxD) so T stays in registers.  beta and eps are (Q,)
// device arrays, so per-slot knobs cost no host read.  Built without fast
// math and with --fmad=false so scale * T - in rounds like the plain
// PyTorch version.  The unbatched core path launches it with Q = 1.
//
// Layouts (row-major, contiguous): s_m (Q,n,d), s_c (Q,n), a_m/in_m
// (Q,n,D,d), a_c/in_c (Q,n,D), v_set (Q,n,D) bytes 0/1, beta/eps (Q).
// Outputs: o_m (Q,n,D,d), o_c (Q,n,D).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_decide.cuh"

namespace {

constexpr int kThreads = 128;

template <int DD>
__global__ void __launch_bounds__(kThreads) correction_kernel(
    const float* __restrict__ s_m, const float* __restrict__ s_c,
    const float* __restrict__ a_m, const float* __restrict__ a_c,
    const float* __restrict__ in_m, const float* __restrict__ in_c,
    const uint8_t* __restrict__ v_set, const float* __restrict__ beta_q,
    const float* __restrict__ eps_q, int n, int D, float* __restrict__ o_m,
    float* __restrict__ o_c) {
  const int q = blockIdx.y;
  const int64_t local = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (local >= n) return;
  const int64_t i = (int64_t)q * n + local;  // peer row across slots
  const int64_t row = i * D;
  const float beta = beta_q[q];
  const float eps = eps_q[q];

  float tm[DD];
#pragma unroll
  for (int j = 0; j < DD; ++j) tm[j] = 0.0f;
  float tc = 0.0f;
  int nv = 0;
  for (int kk = 0; kk < D; ++kk) {
    if (!v_set[row + kk]) continue;
    const int64_t e = (row + kk) * DD;
#pragma unroll
    for (int j = 0; j < DD; ++j) tm[j] = tm[j] + a_m[e + j];
    tc = tc + a_c[row + kk];
    ++nv;
  }
  const float sc = s_c[i];
#pragma unroll
  for (int j = 0; j < DD; ++j) tm[j] = s_m[i * DD + j] + tm[j];
  tc = sc + tc;
  const float inc = (sc - beta) / (2.0f * (float)(nv > 1 ? nv : 1));
  const float tsafe = fabsf(tc) > eps ? tc : 1.0f;

  for (int kk = 0; kk < D; ++kk) {
    const int64_t e = (row + kk) * DD;
    const float scale = (a_c[row + kk] + inc) / tsafe;
#pragma unroll
    for (int j = 0; j < DD; ++j) o_m[e + j] = scale * tm[j] - in_m[e + j];
    o_c[row + kk] = scale * tc - in_c[row + kk];
  }
}

template <int DD>
int launch(const void* s_m, const void* s_c, const void* a_m,
           const void* a_c, const void* in_m, const void* in_c,
           const void* v_set, const void* beta, const void* eps, int Q, int n,
           int D, void* o_m, void* o_c, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, Q);
  correction_kernel<DD><<<grid, kThreads, 0, stream>>>(
      (const float*)s_m, (const float*)s_c, (const float*)a_m,
      (const float*)a_c, (const float*)in_m, (const float*)in_c,
      (const uint8_t*)v_set, (const float*)beta, (const float*)eps, n, D,
      (float*)o_m, (float*)o_c);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_correction(const void* s_m, const void* s_c,
                                const void* a_m, const void* a_c,
                                const void* in_m, const void* in_c,
                                const void* v_set, const void* beta,
                                const void* eps, int Q, int n, int D, int d,
                                void* o_m, void* o_c, void* stream) {
  if (Q <= 0 || n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch<DD>(s_m, s_c, a_m, a_c, in_m, in_c, v_set, beta, eps, Q,  \
                      n, D, o_m, o_c, st);
  REPRO_SWITCH_D(d, REPRO_CASE)
#undef REPRO_CASE
}
