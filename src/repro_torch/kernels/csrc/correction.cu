// Eq.-10 balance-correction messages for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/correction.py::
// correction_kernel (launched by correction_call).  For every peer i with
// violating set V_i (v_set):
//
//   T_i      = S_i + sum_{k in V_i} A_ik                  (Eq. 8 target)
//   nv       = max(|V_i|, 1)
//   |A'_ik|  = |A_ik| + (|S_i| - beta) / (2 nv)           (Eq. 10)
//   scale    = |A'_ik| / T_c   (T_c replaced by 1 where |T_c| <= eps)
//   X'_ik    = scale * T_i - X_ki                          (every slot)
//
// Design: one thread per peer, one pass over its slots for T and |V_i|
// (reading A only on V_i), one pass writing X' for every slot (the caller
// keeps the V_i slots).  Memory-bound: it reads in_m, in_c, a_c once and
// writes out_m', out_c' once; d is a template parameter (1..kMaxD) so T
// stays in registers.  beta and eps are runtime arguments.  Built without
// fast math and with --fmad=false so scale * T - in rounds like the plain
// PyTorch version.
//
// Layouts (row-major, contiguous): s_m (n,d), s_c (n), a_m/in_m (n,D,d),
// a_c/in_c (n,D), v_set (n,D) bytes 0/1.  Outputs: o_m (n,D,d), o_c (n,D).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 16;  // MAX_D of the Python launcher
constexpr int kThreads = 128;

template <int DD>
__global__ void __launch_bounds__(kThreads) correction_kernel(
    const float* __restrict__ s_m, const float* __restrict__ s_c,
    const float* __restrict__ a_m, const float* __restrict__ a_c,
    const float* __restrict__ in_m, const float* __restrict__ in_c,
    const uint8_t* __restrict__ v_set, int n, int D, float beta, float eps,
    float* __restrict__ o_m, float* __restrict__ o_c) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t row = i * D;

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
           const void* v_set, int n, int D, float beta, float eps, void* o_m,
           void* o_c, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  correction_kernel<DD><<<blocks, kThreads, 0, stream>>>(
      (const float*)s_m, (const float*)s_c, (const float*)a_m,
      (const float*)a_c, (const float*)in_m, (const float*)in_c,
      (const uint8_t*)v_set, n, D, beta, eps, (float*)o_m, (float*)o_c);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_correction(const void* s_m, const void* s_c,
                                const void* a_m, const void* a_c,
                                const void* in_m, const void* in_c,
                                const void* v_set, int n, int D, int d,
                                float beta, float eps, void* o_m, void* o_c,
                                void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch<DD>(s_m, s_c, a_m, a_c, in_m, in_c, v_set, n, D, beta,    \
                      eps, o_m, o_c, st);
  switch (d) {
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
    REPRO_CASE(9) REPRO_CASE(10) REPRO_CASE(11) REPRO_CASE(12)
    REPRO_CASE(13) REPRO_CASE(14) REPRO_CASE(15) REPRO_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_CASE
}
