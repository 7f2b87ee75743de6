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
// What bounds it on the H100: bytes.  Every slot reads v, a_c, in_c and
// in_m (a_m only on V) and writes out_m', out_c', with a handful of flops.
//
// Design.  The (Q, n, D[, d]) arrays are Q*n contiguous rows of D slots, so
// P consecutive rows are one contiguous range of P*D elements.  A block
// takes one such tile of whole rows (P chosen on the host, P*D <= kCap) and
// thread t owns the tile's elements t, t + kThreads, ..., so each warp-wide
// load or store is one contiguous span whatever D is; a d-vector moves as
// 16- or 8-byte accesses where d and the pointers allow.  Three steps:
//   1. load: each thread keeps a_c, in_c and in_m of its elements in
//      registers; on V it also reads a_m and puts a_m and a_c into shared
//      memory; warp ballots turn the tile's V into a bitmask there;
//   2. scan: one thread per (row, component) walks the row's bitmask words
//      over the set bits only (__ffs), adding one rounded term at a time in
//      slot order from +0, then S: the order of the plain version
//      (core/stopping.py::slot_sum), so T_i is bitwise the same (a tree or
//      shuffle reduction would round otherwise).  |V_i| is a popcount.
//      T_i, inc and the guarded T_c go to shared memory;
//   3. write: elementwise, scale = (a_c + inc) / T_c and X' = scale*T - in
//      from the registers of step 1.
// Each input byte is read from device memory once.  A row longer than a
// tile (D > kCap) gets a block of its own, which runs steps 1-2 over chunks
// of kCap slots and then step 3 over the chunks again (re-reading a_c).
// Loads and stores keep the default cache policy: the caller reads in and
// out' right after (the blend, the next lss_state), which at Q = 1 finds
// them in L2.  Built without fast math and with --fmad=false so
// scale * T - in rounds like the plain PyTorch version.  beta and eps are
// (Q,) device arrays.  The unbatched core path launches it with Q = 1.
//
// Layouts (row-major, contiguous): s_m (Q,n,d), s_c (Q,n), a_m/in_m
// (Q,n,D,d), a_c/in_c (Q,n,D), v_set (Q,n,D) bytes 0/1, beta/eps (Q).
// Outputs: o_m (Q,n,D,d), o_c (Q,n,D).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dvec.cuh"
#include "packed_decide.cuh"

namespace {

using repro::load_d;

constexpr int kThreads = 128;

// A tile's shape for d = DD: shared memory holds a_m and a_c of every V
// element, so a wide d gets a smaller tile (under 48 KB of shared memory).
template <int DD>
struct Tile {
  static constexpr int kCap = DD <= 4 ? 512 : 256;  // elements
  static constexpr int kPer = kCap / kThreads;       // elements per thread
  static constexpr int kWords = kCap / 32;           // V bitmask words
  static constexpr int kRows = kCap / 4;             // most rows (D < 4)
};

template <int DD, int VW>
__device__ __forceinline__ void store_d(float* __restrict__ p, int64_t e,
                                        const float* x) {
  float* s = p + e * DD;
#pragma unroll
  for (int j = 0; j < DD; j += VW) {
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(s + j) =
          make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
    } else if constexpr (VW == 2) {
      *reinterpret_cast<float2*>(s + j) = make_float2(x[j], x[j + 1]);
    } else {
      s[j] = x[j];
    }
  }
}

// acc + col[l * stride] over the set bits l of bits in [l0, l0 + len), in
// increasing l, one rounded add at a time; *count gets their number.
__device__ __forceinline__ float scan_bits(const uint32_t* bits, int l0,
                                           int len, const float* col,
                                           int stride, float acc,
                                           int* count) {
  const int l1 = l0 + len;
  int nv = 0;
  for (int w = l0 >> 5; w <= (l1 - 1) >> 5; ++w) {
    const int lo = w << 5;
    uint32_t word = bits[w];
    if (lo < l0) word &= ~0u << (l0 - lo);
    if (l1 - lo < 32) word &= (1u << (l1 - lo)) - 1u;
    nv += __popc(word);
    while (word) {
      const int b = __ffs(word) - 1;
      word &= word - 1u;
      acc = acc + col[(lo + b) * stride];
    }
  }
  *count = nv;
  return acc;
}

// Step 1 for kPer elements l = t + k * kThreads < E at e = base + l: v_set's
// bitmask, and a_m / a_c of the V elements, into shared memory.
template <int DD, int VW>
__device__ __forceinline__ void stage_v(const float* __restrict__ a_m,
                                        const float* ac,
                                        const uint8_t* __restrict__ v_set,
                                        int64_t base, int E, uint32_t* bits,
                                        float* sa_m, float* sa_c) {
  using T = Tile<DD>;
  const int t = threadIdx.x;
  uint8_t v[T::kPer];
#pragma unroll
  for (int k = 0; k < T::kPer; ++k) {
    const int l = t + k * kThreads;
    v[k] = l < E ? v_set[base + l] : 0;
  }
#pragma unroll
  for (int k = 0; k < T::kPer; ++k) {
    const int l = t + k * kThreads;
    if (v[k]) {  // a_m is read on V only
      load_d<DD, VW>(a_m, base + l, &sa_m[l * DD]);
      sa_c[l] = ac[k];
    }
    const uint32_t word = __ballot_sync(0xffffffffu, v[k] != 0);
    if ((t & 31) == 0) bits[l >> 5] = word;
  }
}

// One block per tile of P whole rows (rows r0 .. r0 + P - 1 of the Q*n).
template <int DD, int VW>
__global__ void __launch_bounds__(kThreads) correction_tiles(
    const float* __restrict__ s_m, const float* __restrict__ s_c,
    const float* __restrict__ a_m, const float* __restrict__ a_c,
    const float* __restrict__ in_m, const float* __restrict__ in_c,
    const uint8_t* __restrict__ v_set, const float* __restrict__ beta_q,
    const float* __restrict__ eps_q, int64_t rows_total, int n, int D, int P,
    float* __restrict__ o_m, float* __restrict__ o_c) {
  using T = Tile<DD>;
  __shared__ uint32_t bits[T::kWords];
  __shared__ float sa_m[T::kCap * DD];       // a_m on V, at l * DD + j
  __shared__ float sa_c[T::kCap];            // a_c on V
  __shared__ float st[T::kRows * (DD + 1)];  // T_i: t_m (DD), then t_c
  __shared__ float sinc[T::kRows];           // (|S_i| - beta) / (2 nv)
  __shared__ float sts[T::kRows];            // T_c, or 1 where |T_c| <= eps

  const int t = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * P;
  const int rows = rows_total - r0 < P ? (int)(rows_total - r0) : P;
  const int E = rows * D;
  const int64_t base = r0 * D;

  // Step 1: every load of the tile first, so they are all in flight.
  float ac[T::kPer], ic[T::kPer], im[T::kPer][DD];
#pragma unroll
  for (int k = 0; k < T::kPer; ++k) {
    const int l = t + k * kThreads;
    ac[k] = ic[k] = 0.0f;
    if (l < E) {
      ac[k] = a_c[base + l];
      ic[k] = in_c[base + l];
      load_d<DD, VW>(in_m, base + l, im[k]);
    }
  }
  stage_v<DD, VW>(a_m, ac, v_set, base, E, bits, sa_m, sa_c);
  __syncthreads();

  // Step 2: T_i component by component, in slot order.
  for (int u = t; u < rows * (DD + 1); u += kThreads) {
    const int p = u / (DD + 1);
    const int c = u - p * (DD + 1);
    const int64_t r = r0 + p;
    int nv;
    const float sum = c < DD
        ? scan_bits(bits, p * D, D, sa_m + c, DD, 0.0f, &nv)
        : scan_bits(bits, p * D, D, sa_c, 1, 0.0f, &nv);
    if (c < DD) {
      st[p * (DD + 1) + c] = s_m[r * DD + c] + sum;
    } else {
      const int q = (int)(r / n);
      const float sc = s_c[r];
      const float tc = sc + sum;
      st[p * (DD + 1) + DD] = tc;
      sinc[p] = (sc - beta_q[q]) / (2.0f * (float)(nv > 1 ? nv : 1));
      sts[p] = fabsf(tc) > eps_q[q] ? tc : 1.0f;
    }
  }
  __syncthreads();

  // Step 3: X' for every element, from the registers of step 1.
#pragma unroll
  for (int k = 0; k < T::kPer; ++k) {
    const int l = t + k * kThreads;
    if (l >= E) continue;
    const int p = l / D;
    const float* tp = &st[p * (DD + 1)];
    const float scale = (ac[k] + sinc[p]) / sts[p];
    float o[DD];
#pragma unroll
    for (int j = 0; j < DD; ++j) o[j] = scale * tp[j] - im[k][j];
    store_d<DD, VW>(o_m, base + l, o);
    o_c[base + l] = scale * tp[DD] - ic[k];
  }
}

// One block per row longer than a tile (D > kCap): steps 1-2 chunk by
// chunk, one running sum per component, then step 3 over the chunks.
template <int DD, int VW>
__global__ void __launch_bounds__(kThreads) correction_long(
    const float* __restrict__ s_m, const float* __restrict__ s_c,
    const float* __restrict__ a_m, const float* __restrict__ a_c,
    const float* __restrict__ in_m, const float* __restrict__ in_c,
    const uint8_t* __restrict__ v_set, const float* __restrict__ beta_q,
    const float* __restrict__ eps_q, int n, int D, float* __restrict__ o_m,
    float* __restrict__ o_c) {
  using T = Tile<DD>;
  __shared__ uint32_t bits[T::kWords];
  __shared__ float sa_m[T::kCap * DD];
  __shared__ float sa_c[T::kCap];
  __shared__ float st[DD + 1];
  __shared__ float sinc, sts;

  const int t = threadIdx.x;
  const int64_t r = blockIdx.x;
  const int64_t row = r * D;
  float sum = 0.0f;  // thread t <= DD: component t's sum so far
  int nv = 0;
  for (int s = 0; s < D; s += T::kCap) {
    const int E = D - s < T::kCap ? D - s : T::kCap;
    float ac[T::kPer];
#pragma unroll
    for (int k = 0; k < T::kPer; ++k) {
      const int l = t + k * kThreads;
      ac[k] = l < E ? a_c[row + s + l] : 0.0f;
    }
    stage_v<DD, VW>(a_m, ac, v_set, row + s, E, bits, sa_m, sa_c);
    __syncthreads();
    if (t <= DD) {
      int cnt;
      sum = t < DD ? scan_bits(bits, 0, E, sa_m + t, DD, sum, &cnt)
                   : scan_bits(bits, 0, E, sa_c, 1, sum, &cnt);
      nv += cnt;
    }
    __syncthreads();  // the next chunk overwrites the shared arrays
  }
  if (t < DD) {
    st[t] = s_m[r * DD + t] + sum;
  } else if (t == DD) {
    const int q = (int)(r / n);
    const float sc = s_c[r];
    const float tc = sc + sum;
    st[DD] = tc;
    sinc = (sc - beta_q[q]) / (2.0f * (float)(nv > 1 ? nv : 1));
    sts = fabsf(tc) > eps_q[q] ? tc : 1.0f;
  }
  __syncthreads();
  for (int l = t; l < D; l += kThreads) {
    const int64_t e = row + l;
    const float scale = (a_c[e] + sinc) / sts;
    float x[DD];
    load_d<DD, VW>(in_m, e, x);
#pragma unroll
    for (int j = 0; j < DD; ++j) x[j] = scale * st[j] - x[j];
    store_d<DD, VW>(o_m, e, x);
    o_c[e] = scale * st[DD] - in_c[e];
  }
}

template <int DD, int VW>
int launch(const void* s_m, const void* s_c, const void* a_m,
           const void* a_c, const void* in_m, const void* in_c,
           const void* v_set, const void* beta, const void* eps, int Q, int n,
           int D, void* o_m, void* o_c, cudaStream_t stream) {
  using T = Tile<DD>;
  const int64_t rows = (int64_t)Q * n;
  if (D > T::kCap) {
    if (rows > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    correction_long<DD, VW><<<(unsigned)rows, kThreads, 0, stream>>>(
        (const float*)s_m, (const float*)s_c, (const float*)a_m,
        (const float*)a_c, (const float*)in_m, (const float*)in_c,
        (const uint8_t*)v_set, (const float*)beta, (const float*)eps, n, D,
        (float*)o_m, (float*)o_c);
  } else {
    const int P = T::kCap / D < T::kRows ? T::kCap / D : T::kRows;
    const int64_t tiles = (rows + P - 1) / P;
    if (tiles > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    correction_tiles<DD, VW><<<(unsigned)tiles, kThreads, 0, stream>>>(
        (const float*)s_m, (const float*)s_c, (const float*)a_m,
        (const float*)a_c, (const float*)in_m, (const float*)in_c,
        (const uint8_t*)v_set, (const float*)beta, (const float*)eps, rows,
        n, D, P, (float*)o_m, (float*)o_c);
  }
  return (int)cudaGetLastError();
}

// The widest d-vector access that divides d and that the (., d) pointers'
// alignment allows.
template <int DD>
int launch_d(const void* s_m, const void* s_c, const void* a_m,
             const void* a_c, const void* in_m, const void* in_c,
             const void* v_set, const void* beta, const void* eps, int Q,
             int n, int D, void* o_m, void* o_c, cudaStream_t stream) {
  const uintptr_t addr = (uintptr_t)a_m | (uintptr_t)in_m | (uintptr_t)o_m;
  if constexpr (DD % 4 == 0) {
    if (addr % 16 == 0)
      return launch<DD, 4>(s_m, s_c, a_m, a_c, in_m, in_c, v_set, beta, eps,
                           Q, n, D, o_m, o_c, stream);
  }
  if constexpr (DD % 2 == 0) {
    if (addr % 8 == 0)
      return launch<DD, 2>(s_m, s_c, a_m, a_c, in_m, in_c, v_set, beta, eps,
                           Q, n, D, o_m, o_c, stream);
  }
  return launch<DD, 1>(s_m, s_c, a_m, a_c, in_m, in_c, v_set, beta, eps, Q,
                       n, D, o_m, o_c, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_correction(const void* s_m, const void* s_c,
                                const void* a_m, const void* a_c,
                                const void* in_m, const void* in_c,
                                const void* v_set, const void* beta,
                                const void* eps, int Q, int n, int D, int d,
                                void* o_m, void* o_c, void* stream) {
  if (Q <= 0 || n <= 0 || D <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch_d<DD>(s_m, s_c, a_m, a_c, in_m, in_c, v_set, beta, eps,   \
                        Q, n, D, o_m, o_c, st);
  REPRO_SWITCH_D(d, REPRO_CASE)
#undef REPRO_CASE
}
