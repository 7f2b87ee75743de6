// The d-vector load of the row-tile kernels (correction, lss_state; sm_90a):
// one peer-slot's d floats as 16- or 8-byte accesses where d and the
// pointer's alignment allow, scalars otherwise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// The DD floats at p[e * DD] as accesses of VW floats (VW divides DD and
// the host checked the pointer's alignment).
template <int DD, int VW>
__device__ __forceinline__ void load_d(const float* __restrict__ p,
                                       int64_t e, float* x) {
  const float* s = p + e * DD;
#pragma unroll
  for (int j = 0; j < DD; j += VW) {
    if constexpr (VW == 4) {
      const float4 u = *reinterpret_cast<const float4*>(s + j);
      x[j] = u.x, x[j + 1] = u.y, x[j + 2] = u.z, x[j + 3] = u.w;
    } else if constexpr (VW == 2) {
      const float2 u = *reinterpret_cast<const float2*>(s + j);
      x[j] = u.x, x[j + 1] = u.y;
    } else {
      x[j] = s[j];
    }
  }
}

}  // namespace repro
