// Packed region decision over batches of vectors for Hopper (sm_90a),
// batched over Q query slots.
//
// Replaces the Pallas TPU kernel repro/kernels/region_decide.py::
// region_decide_kernel (launched by region_decide_call) and its
// query-batched form.  For every slot q and vector i it returns
// f_q(v[q, i]), the packed decision of repro/kernels/region_decide.py::
// packed_decide: argmin of -2 v.c + ||c||^2 with +inf norms on masked
// centers (first minimum wins) for a Voronoi slot, v.w >= b for a
// halfspace slot, meta[q, 0] picking the kind.
//
// Design: a 2-D grid, blockIdx.y = slot, one thread per vector, the slot's
// table in shared memory, and the decide device function that lss_state
// uses (packed_decide.cuh), so the two kernels decide identically.  The
// TPU kernel made the decision one matmul against [centers^T | w]; here a
// thread loops over the k centers from shared memory.  Per vector it reads
// d floats and writes one int32 while doing about 3 k d flops, so it is
// bound by bytes up to k of a few hundred (the Sec. VI-D sweep goes to
// k = 243), and then by float32 operations.  Same build flags as lss_state
// (no fast math, --fmad=false).
//
// Layouts (row-major, contiguous): v (Q,m,d), cthw (Q,d,k+1), cn (Q,k),
// meta (Q,4).  Output: out (Q,m) int32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_decide.cuh"

namespace {

constexpr int kThreads = 128;

template <int DD>
__global__ void __launch_bounds__(kThreads) region_decide_kernel(
    const float* __restrict__ v, const float* __restrict__ cthw,
    const float* __restrict__ cn, const float* __restrict__ meta, int m,
    int k, int32_t* __restrict__ out) {
  extern __shared__ float sh[];
  const int q = blockIdx.y;
  repro::load_table<DD>(cthw + (size_t)q * DD * (k + 1), cn + (size_t)q * k,
                        k, sh);
  __syncthreads();
  const float* mq = meta + (size_t)q * 4;
  const bool voronoi = mq[0] == 0.0f;
  const float b = mq[1];

  const int64_t local = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (local >= m) return;
  const int64_t i = (int64_t)q * m + local;
  float x[DD];
#pragma unroll
  for (int j = 0; j < DD; ++j) x[j] = v[i * DD + j];
  out[i] = repro::decide<DD>(x, voronoi, k, sh, b);
}

template <int DD>
int launch(const void* v, const void* cthw, const void* cn, const void* meta,
           int Q, int m, int k, void* out, cudaStream_t stream) {
  const size_t shmem = sizeof(float) * repro::table_floats(k, DD);
  auto kern = region_decide_kernel<DD>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((m + kThreads - 1) / kThreads, Q);
  kern<<<grid, kThreads, shmem, stream>>>(
      (const float*)v, (const float*)cthw, (const float*)cn,
      (const float*)meta, m, k, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_region_decide(const void* v, const void* cthw,
                                   const void* cn, const void* meta, int Q,
                                   int m, int d, int k, void* out,
                                   void* stream) {
  if (Q <= 0 || m <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(DD)                                                     \
  case DD:                                                                 \
    return launch<DD>(v, cthw, cn, meta, Q, m, k, out, st);
  REPRO_SWITCH_D(d, REPRO_CASE)
#undef REPRO_CASE
}
