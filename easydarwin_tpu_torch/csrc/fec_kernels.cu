// Hand-written Hopper kernel of the lossy-UDP reliability tier (sm_90a).
//
// Built by ops/kernel_lib.py into the same library as relay_kernels.cu
// (one nvcc -c per source, one link) and bound with ctypes: a plain C
// entry point taking pointers, sizes and the caller's stream, which
// launches on that stream, never synchronises, allocates nothing and
// returns a cudaError_t.
//
// What it replaces
//   ed_gf_parity replaces the XLA pass
//   easydarwin_tpu/models/relay_pipeline.py:280 fec_parity_window_step:
//   rows [K, B] uint8 x coeff [R, K] uint8 -> out [R, B] uint8 over
//   GF(256), polynomial 0x11D: out[r, b] = XOR over k of
//   coeff[r, k] * rows[k, b].  Callers: the wire FEC's window parity
//   (relay/fec.py; K = 16, B = 2,048 for 1080p packets, R <= 8) and the
//   stripe codec's parity and reconstruct (storage/codec.py; K = 4,
//   R = 2, B up to ~1 MiB).
//
// The product without log/antilog tables
//   A product by a fixed coefficient c is linear over XOR, so
//   c*x = c*(x & 0x0F) ^ c*(x & 0xF0): two 16-entry tables per
//   coefficient, lo[i] = c*i and hi[i] = c*(i << 4).  ``tables`` is
//   GF_NIB [256][2][16] (ops/fec_kernel.py): coefficient c's lo then hi,
//   32 bytes, read as two 16-byte loads (lanes that share a coefficient
//   read one address: a broadcast).  Zero needs no sentinel: GF_NIB[0]
//   and entry 0 of every table are zeros.
//   Linearity halves the tables again: entry i + 8 is entry i ^ c*8 (lo)
//   or entry i ^ c*0x80 (hi).  A thread keeps entries 0-7 of each table
//   (two words) and c*8, c*0x80 replicated over 4 bytes: 6 registers a
//   coefficient.  For 4 bytes of a word, bits 0-2 of each nibble, packed
//   into a prmt selector, pick from entries 0-7 (bit 3 of a selector
//   nibble would switch prmt to sign replication, so it stays clear),
//   and the replicated c*8 (c*0x80), masked to the bytes whose nibble
//   has bit 3 set, is XORed in.  That is 2 prmt and 3 LOP3 a
//   (word, coefficient), after 10 ops a word for its selectors and masks
//   (the masks are prmt's sign replication of bits 3 and 7).  The packed
//   selector ``lo | lo >> 12`` lists the bytes in the order (0, 2, 1, 3);
//   sums stay in that order (XOR is bytewise) and one prmt a word puts
//   them back before the store.  No shared memory, no gathers, no
//   barrier.
//
// What bounds it, and what the design does about it
//   Each input byte is read once and each output byte written once.
//   * The wire shape [16, 2048] x [2, 16] moves 37 KB (0.011 us at
//     3.35 TB/s): it is bound by the launch and by two dependent load
//     rounds (the coefficient bytes with the rows, then their tables:
//     the table address is data).  The lane kernel spreads it: one thread
//     per 4-byte word of one row, the rows of a word on adjacent lanes
//     (pow2(K) lanes, 32 at most), so the wire shape is 8,192 threads in
//     128 CTAs of 64 on as many SMs.  The XOR over K is a __shfl_xor_sync
//     butterfly inside the warp (4 steps at K = 16); for K = 33..64 a
//     thread takes rows k and k + 32, so no shape goes through shared
//     memory.  Lane r mod pow2(K) of a word stores parity row r.  R is a
//     template argument (8 instantiations a row count): a runtime R cost
//     a branch around every row's loads, products and shuffles.
//   * The stripe [4, 1 MiB] x [2, 4] moves 6.3 MB (1.9 us) and does
//     21.5 M integer ops: bound by bytes, with the ALU work close behind
//     (1.3 us at 64 int32 lanes an SM a clock, a quarter of the 67 T/s
//     fp32 rate).  For
//     K <= 8, R <= 2 and B >= 256 KiB the stripe kernel is a one-wave
//     grid (SMs x occupancy) of 128 threads; each thread keeps its R x K
//     coefficients' tables in registers (6 x 8 at K = 4, R = 2) and
//     loads one 16-byte chunk of every row a trip, streaming loads and
//     stores (one chunk a trip timed faster than two).  Other stripe
//     shapes (R > 2 with K <= 8) take the lane kernel.
//   * What is left: the wire shape's two load rounds and its launch; at
//     the stripe, a single wave loads everything and then computes, so
//     the products do not hide under the loads.  All arithmetic is
//     32-bit integer; no TMA or wgmma.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch_timing.h"

namespace {

constexpr int kGfMaxK = 64;        // rows a window (MASK_BITS 48, pow2)
constexpr int kGfMaxR = 8;         // parity rows (MAX_PARITY_ROWS)
constexpr int kGfBUnit = 256;      // B is a multiple of this
constexpr int kGfNibBytes = 32;    // one coefficient's lo and hi tables
constexpr int kGfLaneThreads = 64;     // lane kernel CTA
constexpr int kGfStripeThreads = 128;  // stripe kernel CTA
constexpr int kGfStripeMaxK = 8;       // the stripe kernel: K at most,
constexpr int kGfStripeMaxR = 2;       // R at most,
constexpr int kGfStripeMinB = 1 << 18; // and B at least (256 KiB)
constexpr int kMaxDevices = 64;

// PTX prmt in its default mode: result byte n is byte (s >> 4n) & 7 of
// {b, a} (a holds bytes 0-3), or, when bit 3 of that nibble is set, the
// sign of that byte replicated over 8 bits.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// One word's selectors and masks, shared by every coefficient it meets.
struct Nibbles {
  uint32_t sel_lo, sel_hi;   // 3-bit table indices, bytes (0, 2, 1, 3)
  uint32_t big_lo, big_hi;   // 0xFF where the nibble is 8..15, same order
};

__device__ __forceinline__ Nibbles nibbles(uint32_t w) {
  const uint32_t lo = w & 0x07070707u;         // byte j: bits 0-2
  const uint32_t hi = (w >> 4) & 0x07070707u;  // byte j: bits 4-6
  Nibbles n;
  n.sel_lo = lo | (lo >> 12);
  n.sel_hi = hi | (hi >> 12);
  // bits 3 and 7 of a byte are the signs of (w << 4) and of w
  n.big_lo = prmt(w << 4, 0u, 0xB9A8u);
  n.big_hi = prmt(w, 0u, 0xB9A8u);
  return n;
}

// One coefficient's tables as a thread keeps them: entries 0-7 of its lo
// and hi tables, and c*8 and c*0x80 in every byte.  Entry i + 8 is entry
// i XOR c*8 (c*(i ^ 8) = c*i ^ c*8), so entries 8-15 need no registers.
struct Coef {
  uint32_t lo0, lo1, hi0, hi1, c8, c80;
};

__device__ __forceinline__ Coef coef_tables(const uint8_t* __restrict__ nib,
                                            uint32_t c) {
  const uint4* t = reinterpret_cast<const uint4*>(nib + kGfNibBytes * c);
  const uint4 lo = __ldg(t);
  const uint4 hi = __ldg(t + 1);
  return {lo.x, lo.y, hi.x, hi.y, prmt(lo.z, 0u, 0u), prmt(hi.z, 0u, 0u)};
}

// The 4 bytes of ``n``'s word times one coefficient, in the byte order
// (0, 2, 1, 3): per nibble one prmt over entries 0-7, and c*8 (c*0x80)
// XORed where the nibble is 8..15.
__device__ __forceinline__ uint32_t product(const Nibbles& n,
                                            const Coef& t) {
  return prmt(t.lo0, t.lo1, n.sel_lo) ^ (t.c8 & n.big_lo) ^
         prmt(t.hi0, t.hi1, n.sel_hi) ^ (t.c80 & n.big_hi);
}

// (0, 2, 1, 3) back to (0, 1, 2, 3): the permutation is its own inverse.
__device__ __forceinline__ uint32_t in_order(uint32_t acc) {
  return prmt(acc, 0u, 0x3120u);
}

// The lane kernel: one thread per (4-byte word, row) pair, 2^lanes_log2
// lanes a word (pow2(K), at most 32); KPT rows a thread (2 for K > 32:
// rows k and k + 32); R parity rows, a template argument so that no
// branch guards a row.  The grid covers the words exactly (B / 4 is a
// multiple of 64, a CTA is 64 threads), so every lane takes every
// shuffle.
template <int KPT, int R>
__global__ void __launch_bounds__(kGfLaneThreads)
gf_parity_lanes_kernel(const uint8_t* __restrict__ rows, int K, int B,
                       const uint8_t* __restrict__ coeff,
                       const uint8_t* __restrict__ nib, int lanes_log2,
                       uint8_t* __restrict__ out) {
  const long gid = long(blockIdx.x) * kGfLaneThreads + threadIdx.x;
  const int lanes = 1 << lanes_log2;
  const int k0 = int(gid) & (lanes - 1);
  const long word = gid >> lanes_log2;
  // round 1: the row words and the coefficient bytes
  uint32_t w[KPT];
  uint32_t c[KPT][R];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int k = k0 + 32 * j;
    const bool live = k < K;
    w[j] = live ? __ldg(reinterpret_cast<const uint32_t*>(
                            rows + long(k) * B) + word)
                : 0u;
#pragma unroll
    for (int r = 0; r < R; ++r)
      c[j][r] = live ? uint32_t(__ldg(coeff + r * K + k)) : 0u;
  }
  // round 2: their tables (a row past K has coefficient 0: zero tables)
  Coef t[KPT][R];
#pragma unroll
  for (int j = 0; j < KPT; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) t[j][r] = coef_tables(nib, c[j][r]);
  uint32_t acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0u;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const Nibbles n = nibbles(w[j]);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] ^= product(n, t[j][r]);
  }
  // XOR over the lanes of one word (lanes_log2 is uniform over the grid)
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    if (s < lanes_log2) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] ^= __shfl_xor_sync(0xffffffffu, acc[r], 1 << s);
    }
  }
  uint32_t* out32 = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if ((r & (lanes - 1)) == k0)
      out32[long(r) * (B / 4) + word] = in_order(acc[r]);
}

// The stripe kernel: a one-wave grid walks the B / 16 chunks of the rows,
// one 16-byte chunk of every row a thread a trip; each thread holds its
// R x K coefficients' tables in registers for the whole walk (MAXK x R
// of them allocated, K <= MAXK used).
template <int MAXK, int R>
__global__ void __launch_bounds__(kGfStripeThreads, 1)
gf_parity_stripe_kernel(const uint4* __restrict__ rows, int K, int chunks,
                        const uint8_t* __restrict__ coeff,
                        const uint8_t* __restrict__ nib,
                        uint4* __restrict__ out) {
  Coef t[R][MAXK];
  {
    uint32_t c[R][MAXK];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < MAXK; ++k)
        c[r][k] = k < K ? uint32_t(__ldg(coeff + r * K + k)) : 0u;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < MAXK; ++k) t[r][k] = coef_tables(nib, c[r][k]);
  }
  const int stride = int(gridDim.x) * kGfStripeThreads;
  for (int i = int(blockIdx.x) * kGfStripeThreads + int(threadIdx.x);
       i < chunks; i += stride) {
    uint4 v[MAXK];
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      v[k] = k < K ? __ldcs(rows + long(k) * chunks + i)
                   : make_uint4(0u, 0u, 0u, 0u);
    uint32_t acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0u;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      if (k < K) {
        const uint32_t words[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const Nibbles n = nibbles(words[q]);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][q] ^= product(n, t[r][k]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      __stcs(out + long(r) * chunks + i,
             make_uint4(in_order(acc[r][0]), in_order(acc[r][1]),
                        in_order(acc[r][2]), in_order(acc[r][3])));
  }
}

// The stripe kernel's CTAs in one wave on the current device (SMs x its
// occupancy), worked out once per device and instantiation.
template <int MAXK, int R>
int stripe_wave(int* ctas) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < kMaxDevices && cached[dev] > 0) {
    *ctas = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gf_parity_stripe_kernel<MAXK, R>, kGfStripeThreads, 0);
  if (err != cudaSuccess) return int(err);
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = n;
  *ctas = n;
  return 0;
}

using Launch = int (*)(const uint8_t*, int, int, const uint8_t*,
                       const uint8_t*, uint8_t*, cudaStream_t);

template <int MAXK, int R>
int launch_stripe(const uint8_t* rows, int K, int B, const uint8_t* coeff,
                  const uint8_t* nib, uint8_t* out, cudaStream_t st) {
  int wave = 0;
  const int rc = stripe_wave<MAXK, R>(&wave);
  if (rc != 0) return rc;
  const int chunks = B / 16;
  int ctas = (chunks + kGfStripeThreads - 1) / kGfStripeThreads;
  if (ctas > wave) ctas = wave;
  if (const int rc2 = ed_timing::start(st)) return rc2;
  gf_parity_stripe_kernel<MAXK, R><<<ctas, kGfStripeThreads, 0, st>>>(
      reinterpret_cast<const uint4*>(rows), K, chunks, coeff, nib,
      reinterpret_cast<uint4*>(out));
  return ed_timing::stop(st, cudaGetLastError());
}

template <int KPT, int R>
int launch_lanes(const uint8_t* rows, int K, int B, const uint8_t* coeff,
                 const uint8_t* nib, uint8_t* out, cudaStream_t st) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < K && lanes_log2 < 5) ++lanes_log2;
  // B / 4 words, a multiple of 64, times 2^lanes_log2 lanes: whole CTAs
  const long blocks = (long(B / 4) << lanes_log2) / kGfLaneThreads;
  if (const int rc = ed_timing::start(st)) return rc;
  gf_parity_lanes_kernel<KPT, R>
      <<<unsigned(blocks), kGfLaneThreads, 0, st>>>(rows, K, B, coeff, nib,
                                                   lanes_log2, out);
  return ed_timing::stop(st, cudaGetLastError());
}

}  // namespace

extern "C" {

// rows [K, B] uint8 (16-byte aligned), coeff [R, K] uint8, tables GF_NIB
// [256][2][16] uint8 (16-byte aligned), out [R, B] uint8 (16-byte
// aligned).  K in 1..64, R in 1..8, B a positive multiple of 256; anything
// else is refused.
int ed_gf_parity(const void* rows, int K, int B, const void* coeff, int R,
                 const void* tables, void* out, void* stream) {
  if (K < 1 || K > kGfMaxK || R < 1 || R > kGfMaxR || B <= 0 ||
      B % kGfBUnit != 0 || (reinterpret_cast<uintptr_t>(rows) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(tables) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return int(cudaErrorInvalidValue);
  const auto* r8 = static_cast<const uint8_t*>(rows);
  const auto* c8 = static_cast<const uint8_t*>(coeff);
  const auto* t8 = static_cast<const uint8_t*>(tables);
  auto* o8 = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (K <= kGfStripeMaxK && R <= kGfStripeMaxR && B >= kGfStripeMinB) {
    static constexpr Launch kStripe[2][kGfStripeMaxR] = {
        {launch_stripe<4, 1>, launch_stripe<4, 2>},
        {launch_stripe<kGfStripeMaxK, 1>, launch_stripe<kGfStripeMaxK, 2>}};
    return kStripe[K > 4][R - 1](r8, K, B, c8, t8, o8, st);
  }
  static constexpr Launch kLanes[2][kGfMaxR] = {
      {launch_lanes<1, 1>, launch_lanes<1, 2>, launch_lanes<1, 3>,
       launch_lanes<1, 4>, launch_lanes<1, 5>, launch_lanes<1, 6>,
       launch_lanes<1, 7>, launch_lanes<1, 8>},
      {launch_lanes<2, 1>, launch_lanes<2, 2>, launch_lanes<2, 3>,
       launch_lanes<2, 4>, launch_lanes<2, 5>, launch_lanes<2, 6>,
       launch_lanes<2, 7>, launch_lanes<2, 8>}};
  return kLanes[K > 32][R - 1](r8, K, B, c8, t8, o8, st);
}

}  // extern "C"
