// The packed region decision f, shared by the lss_state and region_decide
// kernels (sm_90a).
//
// f is repro_torch/core/regions.py::decide_packed on one slot's table:
// argmin_c (-2 v.c + ||c||^2) with +inf norms on masked centers (the first
// minimum wins, so an all-masked padding slot decides 0, as argmin does), or
// v.w >= b, selected by meta[0] (0 = Voronoi).  Slot q's table is
// cthw (d, k+1) = [centers^T | w], cn (k) and meta (4) = [kind, b, eps,
// beta], each at offset q in a (Q, ...) array; load_table copies it into
// shared memory as centers (k, DD), norms (k) and the normal (DD).
//
// Callers build without fast math and with --fmad=false: vec() divides and
// the decisions are argmin / >= comparisons, so IEEE division and no FMA
// contraction keep them as close as possible to the plain PyTorch version.

#pragma once

#include <math.h>
#include <stdint.h>

namespace repro {

constexpr int kMaxD = 16;  // MAX_D of the Python launchers

// Floats of shared memory one slot's table takes.
__host__ __device__ inline size_t table_floats(int k, int dd) {
  return (size_t)k * dd + k + dd;
}

template <int DD>
__device__ __forceinline__ void load_table(const float* __restrict__ cthw,
                                           const float* __restrict__ cn,
                                           int k, float* sh) {
  float* sc = sh;            // (k, DD) centers
  float* scn = sc + k * DD;  // (k) squared norms, +inf on masked centers
  float* sw = scn + k;       // (DD) halfspace normal
  for (int t = threadIdx.x; t < k * DD; t += blockDim.x)
    sc[t] = cthw[(t % DD) * (k + 1) + t / DD];
  for (int t = threadIdx.x; t < k; t += blockDim.x) scn[t] = cn[t];
  for (int t = threadIdx.x; t < DD; t += blockDim.x)
    sw[t] = cthw[t * (k + 1) + k];
}

template <int DD>
__device__ __forceinline__ void vec_of(const float* m, float c, float eps,
                                       float* v) {
  const bool ok = fabsf(c) > eps;
#pragma unroll
  for (int j = 0; j < DD; ++j) v[j] = ok ? m[j] / c : 0.0f;
}

template <int DD>
__device__ __forceinline__ int decide(const float* v, bool voronoi, int k,
                                      const float* sh, float b) {
  const float* sc = sh;
  const float* scn = sc + k * DD;
  const float* sw = scn + k;
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

}  // namespace repro

// One switch over d = 1..kMaxD for the extern "C" entry points.
#define REPRO_SWITCH_D(d, CASE)                                          \
  switch (d) {                                                           \
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)     \
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15)        \
    CASE(16)                                                             \
    default:                                                             \
      return (int)cudaErrorInvalidValue;                                 \
  }
