// Fused LSS per-peer state update for Hopper (sm_90a), batched over Q query
// slots.
//
// Replaces the Pallas TPU kernel repro/kernels/lss_state.py::lss_state_kernel
// (launched by lss_state_call), and its query-batched form: the JAX service
// vmaps that call over its Q slots, which gives the pallas_call a leading
// grid axis with one slot's region table and knobs per step.  For every
// slot q and peer i, with `mask` the live slots, it computes in moment form:
//
//   S_i      = X_ii + sum_{k live} (X_ki - X_ik)
//   A_ik     = X_ik + X_ki,   S_i - A_ik
//   f(vec(S_i)), f(vec(A_ik)), f(vec(S_i - A_ik))    (packed region decision)
//   viol_ik  = live_ik & (|A_ik| <= eps | f(A_ik) != f(S_i)
//                         | (|S_i - A_ik| > eps & f(S_i - A_ik) != f(S_i)))
//
// with f and eps those of slot q (packed_decide.cuh; eps = meta[q, 2], read
// on the device, so per-slot knobs cost no host read).
//
// Design: a 2-D grid, blockIdx.y = slot, one thread per peer.  Each block
// loads its slot's table into shared memory.  The work is a few flops per
// message slot, so the kernel is bound by the bytes it reads.  Slots that
// are not live contribute nothing and get viol = 0 without their messages
// being read; on Barabasi-Albert graphs, where D is the hub degree and most
// rows are padding, that skips most of the (n, D, d) arrays.  d is a
// template parameter (1..kMaxD) so the per-peer vectors live in registers.
// The unbatched core path launches the same kernel with Q = 1.
//
// Layouts (row-major, contiguous): x_m (Q,n,d), x_c (Q,n), out_m/in_m
// (Q,n,D,d), out_c/in_c (Q,n,D), mask (Q,n,D) bytes 0/1, cthw (Q,d,k+1),
// cn (Q,k), meta (Q,4).  Outputs: s_m (Q,n,d), s_c (Q,n), viol (Q,n,D)
// bytes 0/1, dec (Q,n) int32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_decide.cuh"

namespace {

constexpr int kThreads = 128;

template <int DD>
__global__ void __launch_bounds__(kThreads) lss_state_kernel(
    const float* __restrict__ x_m, const float* __restrict__ x_c,
    const float* __restrict__ out_m, const float* __restrict__ out_c,
    const float* __restrict__ in_m, const float* __restrict__ in_c,
    const uint8_t* __restrict__ mask, const float* __restrict__ cthw,
    const float* __restrict__ cn, const float* __restrict__ meta, int n,
    int D, int k, float* __restrict__ s_m, float* __restrict__ s_c,
    uint8_t* __restrict__ viol, int32_t* __restrict__ dec) {
  extern __shared__ float sh[];
  const int q = blockIdx.y;
  repro::load_table<DD>(cthw + (size_t)q * DD * (k + 1), cn + (size_t)q * k,
                        k, sh);
  __syncthreads();
  const float* mq = meta + (size_t)q * 4;
  const bool voronoi = mq[0] == 0.0f;
  const float b = mq[1];
  const float eps = mq[2];

  const int64_t local = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (local >= n) return;
  const int64_t i = (int64_t)q * n + local;  // peer row across slots
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
    for (int j = 0; j < DD; ++j)
      acc_m[j] = acc_m[j] + (in_m[e + j] - out_m[e + j]);
    acc_c = acc_c + (in_c[row + kk] - out_c[row + kk]);
  }
  float sm[DD];
#pragma unroll
  for (int j = 0; j < DD; ++j) sm[j] = x_m[i * DD + j] + acc_m[j];
  const float scv = x_c[i] + acc_c;
  float v[DD];
  repro::vec_of<DD>(sm, scv, eps, v);
  const int ds = repro::decide<DD>(v, voronoi, k, sh, b);

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
        repro::vec_of<DD>(a_m, a_c, eps, v);
        if (repro::decide<DD>(v, voronoi, k, sh, b) != ds) {
          bad = 1;
        } else {
          const float sa_c = scv - a_c;
          if (fabsf(sa_c) > eps) {
            float sa_m[DD];
#pragma unroll
            for (int j = 0; j < DD; ++j) sa_m[j] = sm[j] - a_m[j];
            repro::vec_of<DD>(sa_m, sa_c, eps, v);
            if (repro::decide<DD>(v, voronoi, k, sh, b) != ds) bad = 1;
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
           const void* meta, int Q, int n, int D, int k, void* s_m,
           void* s_c, void* viol, void* dec, cudaStream_t stream) {
  const size_t shmem = sizeof(float) * repro::table_floats(k, DD);
  auto kern = lss_state_kernel<DD>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kThreads - 1) / kThreads, Q);
  kern<<<grid, kThreads, shmem, stream>>>(
      (const float*)x_m, (const float*)x_c, (const float*)out_m,
      (const float*)out_c, (const float*)in_m, (const float*)in_c,
      (const uint8_t*)mask, (const float*)cthw, (const float*)cn,
      (const float*)meta, n, D, k, (float*)s_m, (float*)s_c, (uint8_t*)viol,
      (int32_t*)dec);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_lss_state(const void* x_m, const void* x_c,
                               const void* out_m, const void* out_c,
                               const void* in_m, const void* in_c,
                               const void* mask, const void* cthw,
                               const void* cn, const void* meta, int Q,
                               int n, int D, int d, int k, void* s_m,
                               void* s_c, void* viol, void* dec,
                               void* stream) {
  if (Q <= 0 || n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(DD)                                                     \
  case DD:                                                                 \
    return launch<DD>(x_m, x_c, out_m, out_c, in_m, in_c, mask, cthw, cn,  \
                      meta, Q, n, D, k, s_m, s_c, viol, dec, st);
  REPRO_SWITCH_D(d, REPRO_CASE)
#undef REPRO_CASE
}
