// Packed region decision for Hopper (sm_90a), batched over Q query slots,
// with two entries.
//
// Replaces the Pallas TPU kernel repro/kernels/region_decide.py::
// region_decide_kernel (launched by region_decide_call) and its
// query-batched form.  For every slot q and vector i the first entry,
// repro_region_decide, returns f_q(v[q, i]), the packed decision of
// repro/kernels/region_decide.py::packed_decide: argmin of -2 v.c + ||c||^2
// with +inf norms on masked centers (first minimum wins) for a Voronoi
// slot, v.w >= b for a halfspace slot, meta[q, 0] picking the kind.
//
// First entry.  A 2-D grid, blockIdx.y = slot, one thread per vector, the
// slot's table in shared memory, and the decide device function that
// lss_state uses (packed_decide.cuh), so the two kernels decide
// identically.  The TPU kernel made the decision one matmul against
// [centers^T | w]; here a thread loops over the k centers from shared
// memory.  Per vector it reads d floats and writes one int32 while doing
// about 3 k d flops, so it is bound by bytes up to k of a few hundred (the
// Sec. VI-D sweep goes to k = 243), and then by float32 operations.
//
// Second entry, repro_global_decide: the observe pass's ground truth in one
// launch.  For every slot q it returns want[q] = f_q(vec(gx)), where gx is
// the sum of (x_m, x_c) over the slot's live peers, taken in float64 and
// rounded to float32 once (__double2float_rn), and vec(gx) = gx_m / gx_c
// with IEEE division, or 0 where |gx_c| <= eps[q]; it also writes the
// rounded gx.  That is repro_torch/kernels/ref.py::global_decision_ref,
// which the observe pass used to run as about 20 torch ops and a
// region_decide launch.  It reads 4 d + 5 bytes a peer and does d + 1
// float64 adds, so it is bound by bytes: 66.6 MB, 0.020 ms at Q = 64 and
// n = 80,000, d = 2; at Q = 1 it is launch-bound.  Design: a grid of
// (B, Q) blocks of 256 threads, each block reducing a contiguous run of
// kRun = 2,048 peers of one slot; thread t reads peers t, t + 256, ... of
// the run (coalesced: d-vectors as 8- or 16-byte accesses where d and the
// pointer's alignment allow, the alive mask as bytes) into float64
// partials, a warp adds them with shuffles, and thread 0 adds the warps in
// order and writes the block's d + 1 partials to a float64 workspace
// (Q, B, d + 1).  The last block of a slot to finish (a __threadfence and
// an atomic ticket per slot) adds the B partials in index order, rounds,
// decides on the table it loads into shared memory, and puts its ticket
// back to 0.  Every sum therefore runs in one fixed order, and a run gives
// the same bits every time; the float64 sum of float32 values rounds to
// the float32 the plain version's torch.sum gives unless it lies within
// about 2^-29 relative of a float32 rounding boundary.  One launch was
// chosen over a partials kernel and a finish kernel because the observe
// pass is launch-bound at run_static's Q = 1; the tickets are one int per
// slot that the launcher allocates zeroed once per device and that the
// kernel leaves at zero, so launches that share them must run in stream
// order (the port launches on the current stream).
//
// Both entries build like lss_state (no fast math, --fmad=false), so
// divisions and products round as in the plain PyTorch versions.
//
// Layouts (row-major, contiguous): v (Q,m,d), cthw (Q,d,k+1), cn (Q,k),
// meta (Q,4); x_m (Q,n,d), x_c (Q,n), alive (Q,n) bytes, eps (Q) or one
// number for every slot.  Outputs: out (Q,m) int32; want (Q) int32,
// gx_m (Q,d), gx_c (Q) float32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dvec.cuh"
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


// --- second entry: the global decision ---------------------------------

constexpr int kGThreads = 256;
constexpr int kGPer = 8;                   // peers a thread reads
constexpr int kRun = kGThreads * kGPer;    // peers a block reduces
constexpr int kGWarps = kGThreads / 32;

template <int DD, int VW>
__global__ void __launch_bounds__(kGThreads) global_decide_kernel(
    const float* __restrict__ x_m, const float* __restrict__ x_c,
    const uint8_t* __restrict__ alive, const float* __restrict__ cthw,
    const float* __restrict__ cn, const float* __restrict__ meta,
    const float* __restrict__ eps, float eps0, int n, int k,
    double* __restrict__ part, unsigned int* __restrict__ tickets,
    int32_t* __restrict__ want, float* __restrict__ gx_m,
    float* __restrict__ gx_c) {
  constexpr int C = DD + 1;  // the DD moment components, then the weight
  __shared__ double warp_sum[kGWarps][C];
  __shared__ double total[C];
  __shared__ bool last;
  extern __shared__ float sh[];  // the slot's table, in the last block
  const int q = blockIdx.y;
  const int nb = gridDim.x;
  const int64_t row0 = (int64_t)q * n;
  const int64_t begin = (int64_t)blockIdx.x * kRun;
  const int64_t end = begin + kRun < n ? begin + kRun : (int64_t)n;

  double acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0;
#pragma unroll
  for (int i = 0; i < kGPer; ++i) {
    const int64_t p = begin + threadIdx.x + i * kGThreads;
    if (p < end) {
      const int64_t e = row0 + p;
      float x[DD];
      repro::load_d<DD, VW>(x_m, e, x);
      const float c = x_c[e];
      if (alive[e]) {
#pragma unroll
        for (int j = 0; j < DD; ++j) acc[j] += (double)x[j];
        acc[DD] += (double)c;
      }
    }
  }

  // The block's partials: shuffles within a warp, then the warps in order.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    double s = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sum[warp][c] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double* mine = part + ((int64_t)q * nb + blockIdx.x) * C;
    for (int c = 0; c < C; ++c) {
      double s = warp_sum[0][c];
      for (int w = 1; w < kGWarps; ++w) s += warp_sum[w][c];
      mine[c] = s;
    }
    __threadfence();  // the partials are visible before the ticket
    last = atomicAdd(&tickets[q], 1u) == (unsigned int)(nb - 1);
  }
  __syncthreads();
  if (!last) return;

  // The last block of slot q: the B partials in index order, then the
  // decision on the slot's table.
  if (threadIdx.x < C) {
    const double* slot = part + (int64_t)q * nb * C;
    double s = __ldcg(slot + threadIdx.x);
    for (int b = 1; b < nb; ++b)
      s += __ldcg(slot + (int64_t)b * C + threadIdx.x);
    total[threadIdx.x] = s;
  }
  repro::load_table<DD>(cthw + (size_t)q * DD * (k + 1), cn + (size_t)q * k,
                        k, sh);
  __syncthreads();
  if (threadIdx.x == 0) {
    float m[DD], v[DD];
#pragma unroll
    for (int j = 0; j < DD; ++j) {
      m[j] = __double2float_rn(total[j]);
      gx_m[(int64_t)q * DD + j] = m[j];
    }
    const float c = __double2float_rn(total[DD]);
    gx_c[q] = c;
    repro::vec_of<DD>(m, c, eps != nullptr ? eps[q] : eps0, v);
    const float* mq = meta + (size_t)q * 4;
    want[q] = repro::decide<DD>(v, mq[0] == 0.0f, k, sh, mq[1]);
    tickets[q] = 0u;  // ready for the next launch on this stream
  }
}

template <int DD, int VW>
int launch_global(const void* x_m, const void* x_c, const void* alive,
                  const void* cthw, const void* cn, const void* meta,
                  const void* eps, float eps0, int Q, int n, int k,
                  void* part, void* tickets, void* want, void* gx_m,
                  void* gx_c, cudaStream_t stream) {
  const size_t shmem = sizeof(float) * repro::table_floats(k, DD);
  auto kern = global_decide_kernel<DD, VW>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n > 0 ? (n + kRun - 1) / kRun : 1, Q);
  kern<<<grid, kGThreads, shmem, stream>>>(
      (const float*)x_m, (const float*)x_c, (const uint8_t*)alive,
      (const float*)cthw, (const float*)cn, (const float*)meta,
      (const float*)eps, eps0, n, k, (double*)part, (unsigned int*)tickets,
      (int32_t*)want, (float*)gx_m, (float*)gx_c);
  return (int)cudaGetLastError();
}

// The widest d-vector access that divides d and that x_m's alignment
// allows.
template <int DD>
int launch_global_d(const void* x_m, const void* x_c, const void* alive,
                    const void* cthw, const void* cn, const void* meta,
                    const void* eps, float eps0, int Q, int n, int k,
                    void* part, void* tickets, void* want, void* gx_m,
                    void* gx_c, cudaStream_t stream) {
#define REPRO_ARGS                                                        \
  x_m, x_c, alive, cthw, cn, meta, eps, eps0, Q, n, k, part, tickets,     \
      want, gx_m, gx_c, stream
  const uintptr_t addr = (uintptr_t)x_m;
  if constexpr (DD % 4 == 0) {
    if (addr % 16 == 0) return launch_global<DD, 4>(REPRO_ARGS);
  }
  if constexpr (DD % 2 == 0) {
    if (addr % 8 == 0) return launch_global<DD, 2>(REPRO_ARGS);
  }
  return launch_global<DD, 1>(REPRO_ARGS);
#undef REPRO_ARGS
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

// Peers one block of repro_global_decide reduces: the launcher sizes the
// (Q, B, d + 1) float64 workspace with B = ceil(n / this), at least 1.
extern "C" int repro_global_decide_run() { return kRun; }

// Returns the cudaError_t of the launch (0 on success).  ``eps`` is a
// (Q,) float32 array, or null to use ``eps0`` for every slot; ``part`` the
// (Q, B, d + 1) float64 workspace; ``tickets`` Q unsigned ints that are 0
// before the launch and are 0 again after it.
extern "C" int repro_global_decide(const void* x_m, const void* x_c,
                                   const void* alive, const void* cthw,
                                   const void* cn, const void* meta,
                                   const void* eps, float eps0, int Q, int n,
                                   int d, int k, void* part, void* tickets,
                                   void* want, void* gx_m, void* gx_c,
                                   void* stream) {
  if (Q <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(DD)                                                     \
  case DD:                                                                 \
    return launch_global_d<DD>(x_m, x_c, alive, cthw, cn, meta, eps, eps0, \
                               Q, n, k, part, tickets, want, gx_m, gx_c, st);
  REPRO_SWITCH_D(d, REPRO_CASE)
#undef REPRO_CASE
}
