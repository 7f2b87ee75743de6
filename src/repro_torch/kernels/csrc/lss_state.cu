// Fused LSS per-peer state update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/lss_state.py::lss_state_kernel
// (launched by lss_state_call).  For every peer i, with `mask` the live
// slots, it computes in moment form:
//
//   S_i      = X_ii + sum_{k live} (X_ki - X_ik)
//   A_ik     = X_ik + X_ki,   S_i - A_ik
//   f(vec(S_i)), f(vec(A_ik)), f(vec(S_i - A_ik))    (packed region decision)
//   viol_ik  = live_ik & (|A_ik| <= eps | f(A_ik) != f(S_i)
//                         | (|S_i - A_ik| > eps & f(S_i - A_ik) != f(S_i)))
//
// f is the packed family of repro_torch/core/regions.py::decide_packed:
// argmin_c (-2 v.c + ||c||^2) with +inf norms on masked centers (first
// minimum wins), or v.w >= b, selected by meta[0] (0 = Voronoi).
//
// Design: one thread per peer.  The work is a few flops per message slot,
// so the kernel is bound by the bytes it reads.  Slots that are not live
// contribute nothing and get viol = 0 without their messages being read;
// on Barabasi-Albert graphs, where D is the hub degree and most rows are
// padding, that skips most of the (n, D, d) arrays.  The packed table
// ([centers | w] and the norms) sits in shared memory.  d is a template
// parameter (1..kMaxD) so the per-peer vectors live in registers.  Build
// without fast math and with --fmad=false: vec() divides and the decisions
// are argmin / >= comparisons, so IEEE division and no FMA contraction keep
// them as close as possible to the plain PyTorch version.
//
// Layouts (row-major, contiguous): x_m (n,d), x_c (n), out_m/in_m (n,D,d),
// out_c/in_c (n,D), mask (n,D) bytes 0/1, cthw (d,k+1) = [centers^T | w],
// cn (k), meta (4) = [kind, b, eps, beta].  Outputs: s_m (n,d), s_c (n),
// viol (n,D) bytes 0/1, dec (n) int32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 16;  // MAX_D of the Python launcher
constexpr int kThreads = 128;

template <int DD>
__device__ __forceinline__ void vec_of(const float* m, float c, float eps,
                                       float* v) {
  const bool ok = fabsf(c) > eps;
#pragma unroll
  for (int j = 0; j < DD; ++j) v[j] = ok ? m[j] / c : 0.0f;
}

template <int DD>
__device__ __forceinline__ int decide(const float* v, bool voronoi, int k,
                                      const float* sc, const float* scn,
                                      const float* sw, float b) {
  if (voronoi) {
    float best = INFINITY;
    int idx = 0;
    for (int c = 0; c < k; ++c) {
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < DD; ++j) dot = dot + v[j] * sc[c * DD + j];
      const float score = -2.0f * dot + scn[c];
      if (score < best) {
        best = score;
        idx = c;
      }
    }
    return idx;
  }
  float dot = 0.0f;
#pragma unroll
  for (int j = 0; j < DD; ++j) dot = dot + v[j] * sw[j];
  return dot >= b ? 1 : 0;
}

template <int DD>
__global__ void __launch_bounds__(kThreads) lss_state_kernel(
    const float* __restrict__ x_m, const float* __restrict__ x_c,
    const float* __restrict__ out_m, const float* __restrict__ out_c,
    const float* __restrict__ in_m, const float* __restrict__ in_c,
    const uint8_t* __restrict__ mask, const float* __restrict__ cthw,
    const float* __restrict__ cn, const float* __restrict__ meta, int n,
    int D, int k, float eps, float* __restrict__ s_m,
    float* __restrict__ s_c, uint8_t* __restrict__ viol,
    int32_t* __restrict__ dec) {
  extern __shared__ float sh[];
  float* sc = sh;            // (k, DD) centers
  float* scn = sc + k * DD;  // (k) squared norms, +inf on masked centers
  float* sw = scn + k;       // (DD) halfspace normal
  for (int t = threadIdx.x; t < k * DD; t += blockDim.x)
    sc[t] = cthw[(t % DD) * (k + 1) + t / DD];
  for (int t = threadIdx.x; t < k; t += blockDim.x) scn[t] = cn[t];
  for (int t = threadIdx.x; t < DD; t += blockDim.x)
    sw[t] = cthw[t * (k + 1) + k];
  __syncthreads();
  const bool voronoi = meta[0] == 0.0f;
  const float b = meta[1];

  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t row = i * D;

  // Pass 1: status S_i over the live slots.
  float acc_m[DD];
#pragma unroll
  for (int j = 0; j < DD; ++j) acc_m[j] = 0.0f;
  float acc_c = 0.0f;
  for (int kk = 0; kk < D; ++kk) {
    if (!mask[row + kk]) continue;
    const int64_t e = (row + kk) * DD;
#pragma unroll
    for (int j = 0; j < DD; ++j) acc_m[j] = acc_m[j] + (in_m[e + j] - out_m[e + j]);
    acc_c = acc_c + (in_c[row + kk] - out_c[row + kk]);
  }
  float sm[DD];
#pragma unroll
  for (int j = 0; j < DD; ++j) sm[j] = x_m[i * DD + j] + acc_m[j];
  const float scv = x_c[i] + acc_c;
  float v[DD];
  vec_of<DD>(sm, scv, eps, v);
  const int ds = decide<DD>(v, voronoi, k, sc, scn, sw, b);

  // Pass 2: the Alg.-1 violation of every slot (rows come from L1/L2).
  for (int kk = 0; kk < D; ++kk) {
    uint8_t bad = 0;
    if (mask[row + kk]) {
      const int64_t e = (row + kk) * DD;
      const float a_c = out_c[row + kk] + in_c[row + kk];
      if (fabsf(a_c) <= eps) {
        bad = 1;
      } else {
        float a_m[DD];
#pragma unroll
        for (int j = 0; j < DD; ++j) a_m[j] = out_m[e + j] + in_m[e + j];
        vec_of<DD>(a_m, a_c, eps, v);
        if (decide<DD>(v, voronoi, k, sc, scn, sw, b) != ds) {
          bad = 1;
        } else {
          const float sa_c = scv - a_c;
          if (fabsf(sa_c) > eps) {
            float sa_m[DD];
#pragma unroll
            for (int j = 0; j < DD; ++j) sa_m[j] = sm[j] - a_m[j];
            vec_of<DD>(sa_m, sa_c, eps, v);
            if (decide<DD>(v, voronoi, k, sc, scn, sw, b) != ds) bad = 1;
          }
        }
      }
    }
    viol[row + kk] = bad;
  }

#pragma unroll
  for (int j = 0; j < DD; ++j) s_m[i * DD + j] = sm[j];
  s_c[i] = scv;
  dec[i] = ds;
}

template <int DD>
int launch(const void* x_m, const void* x_c, const void* out_m,
           const void* out_c, const void* in_m, const void* in_c,
           const void* mask, const void* cthw, const void* cn,
           const void* meta, int n, int D, int k, float eps, void* s_m,
           void* s_c, void* viol, void* dec, cudaStream_t stream) {
  const size_t shmem = sizeof(float) * ((size_t)k * DD + k + DD);
  auto kern = lss_state_kernel<DD>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  kern<<<blocks, kThreads, shmem, stream>>>(
      (const float*)x_m, (const float*)x_c, (const float*)out_m,
      (const float*)out_c, (const float*)in_m, (const float*)in_c,
      (const uint8_t*)mask, (const float*)cthw, (const float*)cn,
      (const float*)meta, n, D, k, eps, (float*)s_m, (float*)s_c,
      (uint8_t*)viol, (int32_t*)dec);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_lss_state(const void* x_m, const void* x_c,
                               const void* out_m, const void* out_c,
                               const void* in_m, const void* in_c,
                               const void* mask, const void* cthw,
                               const void* cn, const void* meta, int n,
                               int D, int d, int k, float eps, void* s_m,
                               void* s_c, void* viol, void* dec,
                               void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(DD)                                                     \
  case DD:                                                                 \
    return launch<DD>(x_m, x_c, out_m, out_c, in_m, in_c, mask, cthw, cn,  \
                      meta, n, D, k, eps, s_m, s_c, viol, dec, st);
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
