// Fused LSS per-peer state update for Hopper (sm_90a), batched over Q query
// slots.
//
// Replaces the Pallas TPU kernel repro/kernels/lss_state.py::lss_state_kernel
// (launched by lss_state_call), and its query-batched form: the JAX service
// vmaps that call over its Q slots, which gives the pallas_call a leading
// grid axis with one slot's region table and knobs per step.  For every
// slot q and peer i, with `mask` the live slots, it computes in moment form:
//
//   S_i      = X_ii + sum_{k live} (X_ki - X_ik)      (slot order, from +0)
//   A_ik     = X_ik + X_ki,   S_i - A_ik
//   f(vec(S_i)), f(vec(A_ik)), f(vec(S_i - A_ik))    (packed region decision)
//   viol_ik  = live_ik & (|A_ik| <= eps | f(A_ik) != f(S_i)
//                         | (|S_i - A_ik| > eps & f(S_i - A_ik) != f(S_i)))
//
// with f and eps those of slot q (packed_decide.cuh; eps = meta[q, 2], read
// on the device, so per-slot knobs cost no host read).
//
// What bounds it on the H100: bytes at k = 3 (the paper's workload: every
// slot's mask byte and viol byte, the out/in moments and weights of the
// live slots), operations at k = 243 (the two decisions of a live slot
// scan every center).  At k = 3 the instruction rate comes close as well:
// a live slot costs up to four IEEE divisions and two decisions, about as
// many instructions as its bytes take time, so the design keeps the
// per-slot overhead small besides making every access coalesced.
//
// Design.  The (Q, n, D[, d]) arrays are Q*n contiguous rows of D slots, so
// P consecutive rows of one slot q are one contiguous range of P*D
// elements.  A block of 128 threads takes one such tile of whole rows (up
// to 512 slots, 256 for d > 4; P from D on the host) with slot q's table in
// shared memory, and thread t owns the tile's elements t, t + 128, ..., so
// every warp-wide load of mask, out and in and every store of viol is one
// contiguous span whatever D is; a d-vector moves as 16- or 8-byte
// accesses where d and the pointers allow.  Four steps:
//   1. load: each thread reads the mask bytes of its elements, then out and
//      in of the live ones only (predicated behind the mask byte); it puts
//      in - out of them into shared memory and keeps A = out + in in
//      registers; warp ballots turn the tile's live set into a bitmask and
//      flag its nonzero words;
//   2. scan: one thread per (row, component) walks the row's nonzero
//      words, and in each the groups of 8 slots that hold a live one,
//      loading a group's values together and then adding the live ones one
//      rounded term at a time in slot order from +0, then X_ii: the order
//      of the plain version (core/stopping.py::slot_sum), so S_i is bitwise
//      the same (a tree or shuffle reduction would round otherwise).  It
//      writes s_m, s_c and keeps S_i in shared memory.  Rows of up to 4
//      slots (grid) take a thread per row for all components instead;
//   3. decide: one thread per row forms vec(S_i) and dec_i = f(vec S_i)
//      (in step 2's thread for rows of up to 4 slots);
//   4. violations: elementwise over the live elements, A from the registers
//      of step 1, S_i and dec_i from shared memory (broadcast reads), then
//      the viol byte of every element (0 off the live set: the output is
//      not zeroed beforehand).
// Each input byte is read from device memory once.  A row longer than a
// tile (the Barabasi-Albert hub degree pads every row to 780 slots, nearly
// all dead) gets a warp, four rows a block: in segments of 1,024 slots,
// lane c holds the live word of slots 32c .. 32c + 31 and S is added over
// the nonzero words in slot order with shuffles; the violation pass then
// re-reads mask, and out and in on the live slots.  There is no matrix
// product at k = 3, so no tensor-core path.  Built without fast math and
// with --fmad=false so the decisions round like the plain
// PyTorch version.  The unbatched core path launches it with Q = 1.
//
// Layouts (row-major, contiguous): x_m (Q,n,d), x_c (Q,n), out_m/in_m
// (Q,n,D,d), out_c/in_c (Q,n,D), mask (Q,n,D) bytes 0/1, cthw (Q,d,k+1),
// cn (Q,k), meta (Q,4).  Outputs: s_m (Q,n,d), s_c (Q,n), viol (Q,n,D)
// bytes 0/1, dec (Q,n) int32.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dvec.cuh"
#include "packed_decide.cuh"

namespace {

using repro::load_d;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kShort = 4;  // rows of up to kShort slots: a thread per row
constexpr unsigned kFull = 0xffffffffu;

// Blocks a kernel asks to keep resident on an SM: 12 for d <= 2 (at most
// 40 registers a thread: more blocks hide more of each tile's two
// dependent loads, mask then out/in), the compiler's choice for wider d.
template <int DD>
constexpr int kMinBlocks = DD <= 2 ? 12 : 1;

// A tile of kPer slots a thread (4, or 2 for d > 4, whose stage is wider),
// staged in shared memory: the live bitmask, which of its words are not 0,
// in - out of the live slots, and S_i and dec_i of each row.
template <int DD>
struct Stage {
  static constexpr int kPer = DD <= 4 ? 4 : 2;
  static constexpr int kCap = kPer * kThreads;  // elements
  static constexpr int kRows = kCap / 4;  // most rows (D < 4)
  static_assert(kCap <= 32 * 32, "one word of nonzero-word flags");
  uint32_t bits[kCap / 32];
  uint32_t nz[kWarps];  // warp w's flags: bit b set where bits[b] != 0
  float d_m[kCap * DD];       // in_m - out_m on live slots, at l * DD + j
  float d_c[kCap];            // in_c - out_c on live slots
  float s[kRows * (DD + 1)];  // S_i: s_m (DD), then s_c
  int dec[kRows];
};

// Step 1 for the kPer elements l = t + i * kThreads < E at e = base + l:
// their live flags, the tile's live bitmask, in - out of the live ones into
// shared memory and A = out + in of them into a_m / a_c.
template <int DD, int VW, typename S>
__device__ __forceinline__ void stage_live(
    const float* __restrict__ out_m, const float* __restrict__ out_c,
    const float* __restrict__ in_m, const float* __restrict__ in_c,
    const uint8_t* __restrict__ mask, int64_t base, int E, S& sg,
    bool* live, float (*a_m)[DD], float* a_c) {
  constexpr int PER = S::kPer;
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int l = t + i * kThreads;
    live[i] = l < E && mask[base + l] != 0;
  }
  // Every load of the tile before the first use, so they are in flight
  // together; out and in are read on live slots only.
  float om[PER][DD], im[PER][DD], oc[PER], ic[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (live[i]) {
      const int64_t e = base + t + i * kThreads;
      load_d<DD, VW>(out_m, e, om[i]);
      load_d<DD, VW>(in_m, e, im[i]);
      oc[i] = out_c[e];
      ic[i] = in_c[e];
    }
  }
  uint32_t nz = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int l = t + i * kThreads;
    if (live[i]) {
#pragma unroll
      for (int j = 0; j < DD; ++j) {
        sg.d_m[l * DD + j] = im[i][j] - om[i][j];
        a_m[i][j] = om[i][j] + im[i][j];
      }
      sg.d_c[l] = ic[i] - oc[i];
      a_c[i] = oc[i] + ic[i];
    }
    const uint32_t word = __ballot_sync(kFull, live[i]);
    if ((t & 31) == 0) sg.bits[l >> 5] = word;
    nz |= (word != 0u ? 1u : 0u) << (l >> 5);
  }
  if ((t & 31) == 0) sg.nz[t >> 5] = nz;
}

// acc + col[l * stride] over the live slots l in [l0, l0 + len), in
// increasing l, one rounded add at a time (core/stopping.py::slot_sum's
// order from +0).  Words without a live slot are skipped through the
// nonzero-word flags; within a word the slots go in groups of 8, whose
// values are loaded together before their adds, so a dense row pays one
// shared-memory latency per 8 slots and not per slot.  Reads stay inside
// the tile's arrays; values of slots that are not live are not added.
template <typename S>
__device__ __forceinline__ float scan_live(const S& sg, int l0, int len,
                                           const float* col, int stride,
                                           float acc) {
  if (len <= 0) return acc;
  const int l1 = l0 + len;
  const int w0 = l0 >> 5;
  const int nw = ((l1 - 1) >> 5) - w0 + 1;
  uint32_t nz = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) nz |= sg.nz[w];
  uint32_t words = nz >> w0;
  if (nw < 32) words &= (1u << nw) - 1u;
  while (words) {
    const int w = w0 + __ffs(words) - 1;
    words &= words - 1u;
    const int lo = w << 5;
    uint32_t word = sg.bits[w];
    if (lo < l0) word &= ~0u << (l0 - lo);
    if (l1 - lo < 32) word &= (1u << (l1 - lo)) - 1u;
#pragma unroll
    for (int g = 0; g < 32; g += 8) {
      const uint32_t byte = (word >> g) & 0xffu;
      if (byte) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = col[(lo + g + u) * stride];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if ((byte >> u) & 1u) acc = acc + v[u];
      }
    }
  }
  return acc;
}

// Alg. 1's violation of one live slot with agreement A = (a_m, a_c), for a
// peer with status S = (s[0..DD-1], s[DD]) that decided ds.
template <int DD>
__device__ __forceinline__ uint8_t slot_viol(const float* a_m, float a_c,
                                             const float* s, int ds,
                                             bool voronoi, int k,
                                             const float* table, float b,
                                             float eps) {
  if (fabsf(a_c) <= eps) return 1;
  float v[DD];
  repro::vec_of<DD>(a_m, a_c, eps, v);
  if (repro::decide<DD>(v, voronoi, k, table, b) != ds) return 1;
  const float sa_c = s[DD] - a_c;
  if (fabsf(sa_c) <= eps) return 0;
  float sa_m[DD];
#pragma unroll
  for (int j = 0; j < DD; ++j) sa_m[j] = s[j] - a_m[j];
  repro::vec_of<DD>(sa_m, sa_c, eps, v);
  return repro::decide<DD>(v, voronoi, k, table, b) != ds ? 1 : 0;
}

// f(vec(S)) of a row whose S (DD + 1 floats) is at sp; kept in sg.dec[p]
// and written to dec[r].
template <int DD, typename S>
__device__ __forceinline__ void decide_row(S& sg, int p, int64_t r,
                                           const float* sp, bool voronoi,
                                           int k, const float* table,
                                           float b, float eps,
                                           int32_t* __restrict__ dec) {
  float v[DD];
  repro::vec_of<DD>(sp, sp[DD], eps, v);
  const int ds = repro::decide<DD>(v, voronoi, k, table, b);
  sg.dec[p] = ds;
  dec[r] = ds;
}

// One block per tile of P whole rows of one slot: tiles_per_q blocks per
// slot, block b taking slot b / tiles_per_q.  magic = ceil(2^32 / D), so
// that l / D = umulhi(l, magic) for the tile's l (l * D < 2^32).
template <int DD, int VW, bool SHORT>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DD>) lss_state_tiles(
    const float* __restrict__ x_m, const float* __restrict__ x_c,
    const float* __restrict__ out_m, const float* __restrict__ out_c,
    const float* __restrict__ in_m, const float* __restrict__ in_c,
    const uint8_t* __restrict__ mask, const float* __restrict__ cthw,
    const float* __restrict__ cn, const float* __restrict__ meta, int n,
    int D, int k, int P, int tiles_per_q, unsigned magic,
    float* __restrict__ s_m, float* __restrict__ s_c,
    uint8_t* __restrict__ viol, int32_t* __restrict__ dec) {
  using S = Stage<DD>;
  constexpr int PER = S::kPer;
  extern __shared__ __align__(16) unsigned char smem[];
  S& sg = *reinterpret_cast<S*>(smem);
  float* table = reinterpret_cast<float*>(smem + sizeof(S));

  const int t = threadIdx.x;
  const int q = blockIdx.x / tiles_per_q;
  const int p0 = (blockIdx.x - q * tiles_per_q) * P;  // first row in slot q
  const int rows = n - p0 < P ? n - p0 : P;
  const int E = rows * D;
  const int64_t r0 = (int64_t)q * n + p0;  // first row of the Q*n
  const int64_t base = r0 * D;
  repro::load_table<DD>(cthw + (size_t)q * DD * (k + 1), cn + (size_t)q * k,
                        k, table);
  const float* mq = meta + (size_t)q * 4;
  const bool voronoi = mq[0] == 0.0f;
  const float b = mq[1];
  const float eps = mq[2];

  // Step 1.
  bool live[PER];
  float a_m[PER][DD], a_c[PER];
  stage_live<DD, VW>(out_m, out_c, in_m, in_c, mask, base, E, sg, live, a_m,
                     a_c);
  __syncthreads();

  if constexpr (SHORT) {
    // Steps 2-3 for short rows: a thread per row adds each component over
    // the live slots in slot order from +0, then X_ii, and decides.
    for (int p = t; p < rows; p += kThreads) {
      const int64_t r = r0 + p;
      const int l0 = p * D;
      const int l1 = D > 0 ? l0 + D - 1 : l0;  // the row's last slot
      const uint64_t two =
          sg.bits[l0 >> 5] | (uint64_t)sg.bits[l1 >> 5] << 32;  // D <= 32
      const uint32_t row = (uint32_t)(two >> (l0 & 31));
      float acc[DD + 1];
#pragma unroll
      for (int j = 0; j <= DD; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int u = 0; u < kShort; ++u) {
        if (u < D && ((row >> u) & 1u)) {
#pragma unroll
          for (int j = 0; j < DD; ++j)
            acc[j] = acc[j] + sg.d_m[(l0 + u) * DD + j];
          acc[DD] = acc[DD] + sg.d_c[l0 + u];
        }
      }
      float* sp = &sg.s[p * (DD + 1)];
#pragma unroll
      for (int j = 0; j < DD; ++j) {
        sp[j] = x_m[r * DD + j] + acc[j];
        s_m[r * DD + j] = sp[j];
      }
      sp[DD] = x_c[r] + acc[DD];
      s_c[r] = sp[DD];
      decide_row<DD>(sg, p, r, sp, voronoi, k, table, b, eps, dec);
    }
  } else {
    // Step 2: S_i component by component, in slot order from +0, then X_ii.
    for (int u = t; u < rows * (DD + 1); u += kThreads) {
      const int p = u / (DD + 1);
      const int c = u - p * (DD + 1);
      const int64_t r = r0 + p;
      if (c < DD) {
        const float s =
            x_m[r * DD + c] + scan_live(sg, p * D, D, sg.d_m + c, DD, 0.0f);
        sg.s[p * (DD + 1) + c] = s;
        s_m[r * DD + c] = s;
      } else {
        const float s = x_c[r] + scan_live(sg, p * D, D, sg.d_c, 1, 0.0f);
        sg.s[p * (DD + 1) + DD] = s;
        s_c[r] = s;
      }
    }
    __syncthreads();
    // Step 3: dec_i = f(vec(S_i)).
    for (int p = t; p < rows; p += kThreads)
      decide_row<DD>(sg, p, r0 + p, &sg.s[p * (DD + 1)], voronoi, k, table,
                     b, eps, dec);
  }
  __syncthreads();

  // Step 4: the violation of every element.
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int l = t + i * kThreads;
    if (l >= E) continue;
    uint8_t bad = 0;
    if (live[i]) {
      const int p = D == 1 ? l : (int)__umulhi((unsigned)l, magic);  // l / D
      bad = slot_viol<DD>(a_m[i], a_c[i], &sg.s[p * (DD + 1)], sg.dec[p],
                          voronoi, k, table, b, eps);
    }
    viol[base + l] = bad;
  }
}

// One warp per row longer than a tile, four rows of one slot a block.  A
// Barabasi-Albert row of 780 slots, nearly all dead, would leave a
// block-sized tile mostly idle for a few live slots; a warp each puts four
// times as many rows in flight, with no barrier after the table's.  The
// row goes in segments of 1,024 slots: lane c gets the live word of the
// segment's slots 32c .. 32c + 31 (ballots of coalesced mask bytes), and S
// is summed over the nonzero words in slot order from +0 with shuffles
// (lane j <= DD adds component j of each live slot in turn), carried from
// segment to segment; then X_ii.  Every lane decides f(vec S); then the
// violation of every slot, re-reading mask, out and in (L1/L2 hits).
template <int DD, int VW>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DD>) lss_state_warps(
    const float* __restrict__ x_m, const float* __restrict__ x_c,
    const float* __restrict__ out_m, const float* __restrict__ out_c,
    const float* __restrict__ in_m, const float* __restrict__ in_c,
    const uint8_t* __restrict__ mask, const float* __restrict__ cthw,
    const float* __restrict__ cn, const float* __restrict__ meta, int n,
    int D, int k, int tiles_per_q, float* __restrict__ s_m,
    float* __restrict__ s_c, uint8_t* __restrict__ viol,
    int32_t* __restrict__ dec) {
  static_assert(DD + 1 <= 32, "a lane per component");
  extern __shared__ __align__(16) unsigned char smem[];
  float* table = reinterpret_cast<float*>(smem);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int q = blockIdx.x / tiles_per_q;
  const int p = (blockIdx.x - q * tiles_per_q) * kWarps + (t >> 5);
  repro::load_table<DD>(cthw + (size_t)q * DD * (k + 1), cn + (size_t)q * k,
                        k, table);
  const float* mq = meta + (size_t)q * 4;
  const bool voronoi = mq[0] == 0.0f;
  const float b = mq[1];
  const float eps = mq[2];
  __syncthreads();
  if (p >= n) return;  // the whole warp: p is the warp's row
  const int64_t r = (int64_t)q * n + p;
  const int64_t row = r * D;

  float acc = 0.0f;  // lane j <= DD: component j of S's sum so far
  for (int s0 = 0; s0 < D; s0 += 32 * 32) {
    // Step 1: lane c gets the live word of slots s0 + 32c .. s0 + 32c + 31;
    // the mask bytes of 16 words are loaded before their ballots.
    const int nw = (D - s0 + 31) >> 5 < 32 ? (D - s0 + 31) >> 5 : 32;
    uint32_t word = 0;
    for (int c0 = 0; c0 < nw; c0 += 16) {
      uint8_t m[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int l = s0 + (c0 + u) * 32 + lane;
        m[u] = l < D ? mask[row + l] : 0;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const uint32_t w = __ballot_sync(kFull, m[u] != 0);
        if (lane == c0 + u) word = w;
      }
    }
    // Step 2: the segment's live slots into S, in slot order.
    for (uint32_t words = __ballot_sync(kFull, word != 0u); words;
         words &= words - 1u) {
      const int c = __ffs(words) - 1;
      const uint32_t w = __shfl_sync(kFull, word, c);
      float dv[DD + 1];  // in - out of this lane's slot, where it is live
      if ((w >> lane) & 1u) {
        const int64_t e = row + s0 + c * 32 + lane;
        float om[DD], im[DD];
        load_d<DD, VW>(out_m, e, om);
        load_d<DD, VW>(in_m, e, im);
#pragma unroll
        for (int j = 0; j < DD; ++j) dv[j] = im[j] - om[j];
        dv[DD] = in_c[e] - out_c[e];
      }
      for (uint32_t bits = w; bits; bits &= bits - 1u) {
        const int src = __ffs(bits) - 1;
#pragma unroll
        for (int j = 0; j <= DD; ++j) {
          const float v = __shfl_sync(kFull, dv[j], src);
          if (lane == j) acc = acc + v;
        }
      }
    }
  }
  float sv = 0.0f;
  if (lane < DD) {
    sv = x_m[r * DD + lane] + acc;
    s_m[r * DD + lane] = sv;
  } else if (lane == DD) {
    sv = x_c[r] + acc;
    s_c[r] = sv;
  }
  float sp[DD + 1];
#pragma unroll
  for (int j = 0; j <= DD; ++j) sp[j] = __shfl_sync(kFull, sv, j);
  float v[DD];
  repro::vec_of<DD>(sp, sp[DD], eps, v);
  const int ds = repro::decide<DD>(v, voronoi, k, table, b);
  if (lane == 0) dec[r] = ds;

  // Step 3: the violation of every slot.
  for (int l = lane; l < D; l += 32) {
    const int64_t e = row + l;
    uint8_t bad = 0;
    if (mask[e]) {
      float om[DD], im[DD], a_m[DD];
      load_d<DD, VW>(out_m, e, om);
      load_d<DD, VW>(in_m, e, im);
#pragma unroll
      for (int j = 0; j < DD; ++j) a_m[j] = om[j] + im[j];
      bad = slot_viol<DD>(a_m, out_c[e] + in_c[e], sp, ds, voronoi, k,
                          table, b, eps);
    }
    viol[e] = bad;
  }
}

// Dynamic shared memory of a block: the stage (stage_bytes), then slot q's
// table.
template <typename Kernel>
int shared_bytes(Kernel kern, size_t stage_bytes, int k, int dd,
                 size_t* bytes) {
  *bytes = stage_bytes + sizeof(float) * repro::table_floats(k, dd);
  if (*bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

template <int DD, int VW, bool SHORT>
int launch_tiles(const void* x_m, const void* x_c, const void* out_m,
                 const void* out_c, const void* in_m, const void* in_c,
                 const void* mask, const void* cthw, const void* cn,
                 const void* meta, int Q, int n, int D, int k, void* s_m,
                 void* s_c, void* viol, void* dec, cudaStream_t stream) {
  using S = Stage<DD>;
  const int P = D > 0 && S::kCap / D < S::kRows ? S::kCap / D : S::kRows;
  const int tiles_per_q = (n + P - 1) / P;
  if ((int64_t)tiles_per_q * Q > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  const unsigned magic = D > 1 ? 0xffffffffu / (unsigned)D + 1u : 0u;
  auto kern = lss_state_tiles<DD, VW, SHORT>;
  size_t shmem;
  const int err = shared_bytes(kern, sizeof(S), k, DD, &shmem);
  if (err) return err;
  kern<<<tiles_per_q * Q, kThreads, shmem, stream>>>(
      (const float*)x_m, (const float*)x_c, (const float*)out_m,
      (const float*)out_c, (const float*)in_m, (const float*)in_c,
      (const uint8_t*)mask, (const float*)cthw, (const float*)cn,
      (const float*)meta, n, D, k, P, tiles_per_q, magic, (float*)s_m,
      (float*)s_c, (uint8_t*)viol, (int32_t*)dec);
  return (int)cudaGetLastError();
}

template <int DD, int VW>
int launch_warps(const void* x_m, const void* x_c, const void* out_m,
                 const void* out_c, const void* in_m, const void* in_c,
                 const void* mask, const void* cthw, const void* cn,
                 const void* meta, int Q, int n, int D, int k, void* s_m,
                 void* s_c, void* viol, void* dec, cudaStream_t stream) {
  const int tiles_per_q = (n + kWarps - 1) / kWarps;
  if ((int64_t)tiles_per_q * Q > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  auto kern = lss_state_warps<DD, VW>;
  size_t shmem;
  const int err = shared_bytes(kern, 0, k, DD, &shmem);
  if (err) return err;
  kern<<<tiles_per_q * Q, kThreads, shmem, stream>>>(
      (const float*)x_m, (const float*)x_c, (const float*)out_m,
      (const float*)out_c, (const float*)in_m, (const float*)in_c,
      (const uint8_t*)mask, (const float*)cthw, (const float*)cn,
      (const float*)meta, n, D, k, tiles_per_q, (float*)s_m, (float*)s_c,
      (uint8_t*)viol, (int32_t*)dec);
  return (int)cudaGetLastError();
}

// The path from D: tiles of whole rows with a thread per row for the
// shortest, tiles of whole rows up to a tile's length, a warp per row
// above.
template <int DD, int VW>
int launch(const void* x_m, const void* x_c, const void* out_m,
           const void* out_c, const void* in_m, const void* in_c,
           const void* mask, const void* cthw, const void* cn,
           const void* meta, int Q, int n, int D, int k, void* s_m,
           void* s_c, void* viol, void* dec, cudaStream_t stream) {
#define REPRO_ARGS                                                       \
  x_m, x_c, out_m, out_c, in_m, in_c, mask, cthw, cn, meta, Q, n, D, k,  \
      s_m, s_c, viol, dec, stream
  if (D <= kShort) return launch_tiles<DD, VW, true>(REPRO_ARGS);
  if (D <= Stage<DD>::kCap) return launch_tiles<DD, VW, false>(REPRO_ARGS);
  return launch_warps<DD, VW>(REPRO_ARGS);
#undef REPRO_ARGS
}

// The widest d-vector access that divides d and that the (., d) pointers'
// alignment allows.
template <int DD>
int launch_d(const void* x_m, const void* x_c, const void* out_m,
             const void* out_c, const void* in_m, const void* in_c,
             const void* mask, const void* cthw, const void* cn,
             const void* meta, int Q, int n, int D, int k, void* s_m,
             void* s_c, void* viol, void* dec, cudaStream_t stream) {
  const uintptr_t addr = (uintptr_t)out_m | (uintptr_t)in_m;
  if constexpr (DD % 4 == 0) {
    if (addr % 16 == 0)
      return launch<DD, 4>(x_m, x_c, out_m, out_c, in_m, in_c, mask, cthw,
                           cn, meta, Q, n, D, k, s_m, s_c, viol, dec, stream);
  }
  if constexpr (DD % 2 == 0) {
    if (addr % 8 == 0)
      return launch<DD, 2>(x_m, x_c, out_m, out_c, in_m, in_c, mask, cthw,
                           cn, meta, Q, n, D, k, s_m, s_c, viol, dec, stream);
  }
  return launch<DD, 1>(x_m, x_c, out_m, out_c, in_m, in_c, mask, cthw, cn,
                       meta, Q, n, D, k, s_m, s_c, viol, dec, stream);
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
    return launch_d<DD>(x_m, x_c, out_m, out_c, in_m, in_c, mask, cthw,    \
                        cn, meta, Q, n, D, k, s_m, s_c, viol, dec, st);
  REPRO_SWITCH_D(d, REPRO_CASE)
#undef REPRO_CASE
}
