// Hand-written Hopper kernels of the H.264 requant ladder (sm_90a): B6.
//
// Built by ops/kernel_lib.py into the same library as relay_kernels.cu
// (one nvcc -c per source, one link) and bound with ctypes: plain C entry
// points taking pointers, sizes and the caller's stream, which launch on
// that stream, never synchronise, allocate nothing and return a
// cudaError_t.
//
// What they replace
//   B6 is an XLA-fused int32 pass of the reference, not a Pallas kernel:
//   ed_h264_requant replaces easydarwin_tpu/ops/transform.py:264
//   h264_requant and ed_h264_requant_chroma replaces :315
//   h264_requant_chroma.  Their plain versions are the torch chains of
//   ops/transform.py (h264_requant, h264_requant_chroma), which the CPU
//   runs and which these kernels match bit for bit on every int32 input:
//   * ed_h264_requant: levels [N, 16], qp_in [N], qp_out [N] int32 ->
//     [N, 16]: l' = sign(l) * ((|l| + (1 << k) / 3) >> k) after a clip to
//     +-kLevelClip, k = floor((qp_out - qp_in) / 6).
//   * ed_h264_requant_chroma: dc [N, 4], ac [N, 4, 15], qpc_in [N],
//     qpc_out [N] int32 -> (dc', ac') of the same shapes.  Each row (one
//     macroblock's chroma component: 4 blocks) takes one of three arms
//     by delta = qpc_out - qpc_in: identity (0), the exact shift (a
//     multiple of 6; a negative one shifts by 0), or the general round
//     trip: DC dequant through the 2x2 Hadamard, AC dequant, the inverse
//     integer core, the clip to +-kResClip, the forward core, the clip to
//     +-kWClip, and the requant at qpc_out (AC with the JM deadzone, DC
//     through the Hadamard again with a doubled offset and one more
//     bit).  The plain chain computes all three arms for every row and
//     selects one per value; the kernel computes only the arms a warp's
//     rows take (below), with the same results.
//   The callers are ops/h264_kernel.py's wrappers: on tensors, and as
//   the HLS ladder's leg (ed_h264_requant_leg, ed_h264_requant_chroma_leg:
//   one launch of each kernel an access unit, the rows of every slice of
//   the AU tiled over the ladder's deltas, staged, copied and launched in
//   one host call; codecs/h264_requant.py FusedRequantDispatch).
//
// Bit-exactness with the torch chains
//   * Shifts follow torch's int32 rules: x << s is 0 and x >> s is the
//     sign fill when s < 0 or s >= 32; a left shift is made on the
//     unsigned bits (shifting a negative value is undefined in C++17).
//   * floor((a) / 6) and a mod 6 are floor division and the non-negative
//     remainder (torch's rounding_mode="floor" and remainder), not C's
//     truncation.
//   * Products are taken modulo 2^32 on unsigned bits, as torch's int32
//     products wrap; |INT_MIN| stays INT_MIN as in torch's abs.  On every
//     level the decoder can produce the clips keep each product inside
//     int32 (codecs/h264_transform.py: |W| * MF + 2 * 2^23 < 2^31).
//   * The order of the clips is the plain chain's, step for step.
//
// What bounds them (the int32 rate: 64 INT32 lanes an SM a clock x 132
// SMs x 1,980 MHz = 16.7 T operations/s; bytes at 3.35 TB/s)
//   At the config-5 width (16 sources x one 1080p frame, 8,160
//   macroblocks each) the luma pass moves N = 2,088,960 rows of 64 B in
//   and out plus two QP words a row: 284.1 MB, 0.0848 ms, against ~6
//   integer operations a level (0.013 ms).  The chroma pass moves N =
//   261,120 rows of 256 B in and out plus two QP words: 135.8 MB, 0.0405
//   ms; its arms are 128 (identity), 448 (shift) and 1,756 (general)
//   operations a row, 0.014 ms at phase 5c's mix of arms and 0.028 ms
//   with every row general.  Both are bound by bytes.  On the card
//   (tools/b6_chroma_probe.py, NVIDIA H100 80GB HBM3, 700.00 W) the
//   chroma kernel's integer issue alone, without device-memory traffic,
//   takes 0.030 ms at the mix (it issues about twice the counted
//   operations: the per-row amounts on each of a row's four lanes, the
//   shared-memory reads and writes, the selects), and its bulk copies
//   alone 0.050 ms (81% of the byte bound): neither is small beside the
//   other, so the design's job is to overlap them.  One thread a row with
//   every arm computed (the design before) held 120 registers, 16 warps
//   an SM, and took 0.099-0.100 ms.
//
// What the design does about that
//   ed_h264_requant: one thread per row, the whole row in registers, four
//   16-byte loads and four 16-byte stores; neighbouring threads read
//   neighbouring rows.
//   ed_h264_requant_chroma:
//   * Each warp walks its own chunks of 8 rows through its own ring of 3
//     stages in shared memory; lane 0 brings a chunk in by cp.async.bulk
//     on the stage's mbarrier (AC, DC and the two QP runs: every run a
//     multiple of 16 bytes, but a ragged last chunk's QP tail, loaded
//     plainly), and sends the results out by bulk stores from the same
//     stage once the lanes have written them over the inputs.  No barrier
//     spans more than a warp, so a warp whose rows take the general arm
//     never holds up one whose rows do not (a 64-row tile a CTA behind
//     CTA barriers was 7-8% slower; ordering a tile's rows by arm did not
//     help it).  A persistent grid of one wave, 8 warps a CTA, 4 CTAs an
//     SM (50,688 bytes of dynamic shared memory a CTA, opted into above
//     the 48 KB default).
//   * Four lanes a row, one a 4x4 block: 63 registers, no spills.  Lane
//     l reads AC words 15 l + j, conflict-free; the chroma DC's 2x2
//     Hadamard runs on the way in and out as two __shfl_xor_sync
//     butterflies among a row's lanes.  The zigzag is folded at compile
//     time, so every register index is a constant.
//   * Per row, once: the arm, the exact shift's k and offset, the
//     dequant's V << qpc_in / 6 (one multiply a level in place of a
//     multiply and a guarded shift), MF, qbits and its offset; every
//     right shift of a level is by an amount clamped to 0..31 (torch's
//     sign fill for an amount outside is x >> 31), so a level pays one
//     shift.  V and MF come from a table in shared memory.
//   * A warp runs the general transform (dequant, cores, clips) only if
//     __any_sync says one of its rows takes that arm, and then one last
//     step serves every row of the warp: a general row's coefficient
//     times MF shifted by qbits, a shift or identity row's clipped level
//     times 1 shifted by k (k = 0 for the identity; the clip after it
//     changes no such level).  A warp with no general row shifts or
//     clips.  (Separate passes for the other arms cost 0.040 ms of issue
//     at the mix against 0.030.)
//   Measured (same card and tool): 0.0550-0.0557 ms at phase 5c's mix,
//   73% of the byte bound; 0.0035 ms at the ladder's 396-row AU.

#include <cuda_runtime.h>

#include <atomic>
#include <chrono>
#include <climits>
#include <cstdint>
#include <cstring>

#include "launch_timing.h"

namespace {

constexpr int kLevelClip = 2047;   // codecs/h264_transform.py LEVEL_CLIP
constexpr int kResClip = 4095;     // RES_CLIP
constexpr int kWClip = 131071;     // W_CLIP
// ed_h264_requant: rows a CTA (chip_smoke.py B6_LUMA_CTA_ROWS)
constexpr int kThreads = 128;
// ed_h264_requant_chroma: rows a warp's chunk (chip_smoke.py
// B6_CHROMA_CHUNK_ROWS; four lanes a row), warps a CTA, stages a warp's
// ring, CTAs an SM, and the bytes of a chunk (AC, DC, two QPs) and of a
// CTA's rings
constexpr int kChromaChunkRows = 8;
constexpr int kChromaWarps = 8;
constexpr int kChromaThreads = 32 * kChromaWarps;
constexpr int kChromaStages = 3;
constexpr int kChromaCtasPerSm = 4;
constexpr int kChromaChunkBytes = kChromaChunkRows * (240 + 16 + 2 * 4);
constexpr int kChromaSmem = kChromaWarps * kChromaStages * kChromaChunkBytes;
static_assert(4 * kChromaChunkRows == 32, "four lanes a row fill a warp");
constexpr int kMaxDevices = 64;

// V[qp % 6][class] and MF[qp % 6][class], class order A, B, C
// (codecs/h264_transform.py V and MF)
__constant__ int kV[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                             {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
__constant__ int kMF[6][3] = {{13107, 5243, 8066}, {11916, 4660, 7490},
                              {10082, 4194, 6554}, {9362, 3647, 5825},
                              {8192, 3355, 5243},  {7282, 2893, 4559}};

// the class (A = 0, B = 1, C = 2) of raster position p (_CLS)
__device__ constexpr int cls(int p) {
  return ((p >> 2) & 1) == 0 ? ((p & 1) == 0 ? 0 : 2)
                             : ((p & 1) == 0 ? 2 : 1);
}

// the raster position of zigzag scan position j (ZIGZAG4)
__device__ constexpr int zigzag(int j) {
  return j == 0 ? 0 : j == 1 ? 1 : j == 2 ? 4 : j == 3 ? 8 : j == 4 ? 5
       : j == 5 ? 2 : j == 6 ? 3 : j == 7 ? 6 : j == 8 ? 9 : j == 9 ? 12
       : j == 10 ? 13 : j == 11 ? 10 : j == 12 ? 7 : j == 13 ? 11
       : j == 14 ? 14 : 15;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int shl(int a, int s) {
  return (s < 0 || s >= 32) ? 0 : int(unsigned(a) << s);
}

__device__ __forceinline__ int shr(int a, int s) {
  return (s < 0 || s >= 32) ? (a >> 31) : (a >> s);
}

__device__ __forceinline__ int mul(int a, int b) {
  return int(unsigned(a) * unsigned(b));
}

__device__ __forceinline__ int add(int a, int b) {
  return int(unsigned(a) + unsigned(b));
}

__device__ __forceinline__ int sub(int a, int b) {
  return int(unsigned(a) - unsigned(b));
}

__device__ __forceinline__ int iabs(int a) {
  return a < 0 ? int(0u - unsigned(a)) : a;
}

__device__ __forceinline__ int sgn(int a) { return (a > 0) - (a < 0); }

__device__ __forceinline__ int clip(int a, int lim) {
  return a < -lim ? -lim : (a > lim ? lim : a);
}

// floor(a / d) for d > 0
__device__ __forceinline__ int floordiv(int a, int d) {
  const int q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int mod6(int a) {
  const int r = a % 6;
  return r < 0 ? r + 6 : r;
}

// sign(x) * ((|x| + f) >> k): the rounded shift of a level
__device__ __forceinline__ int shift_round(int x, int k, int f) {
  return mul(sgn(x), shr(add(iabs(x), f), k));
}

// the 4-point inverse core butterfly (8.5.12.2) on a, b, c, d in place
__device__ __forceinline__ void inv_core(int& a, int& b, int& c, int& d) {
  const int e0 = add(a, c), e1 = sub(a, c);
  const int e2 = sub(b >> 1, d), e3 = add(b, d >> 1);
  a = add(e0, e3);
  b = add(e1, e2);
  c = sub(e1, e2);
  d = sub(e0, e3);
}

// the 4-point forward core butterfly on x0..x3 in place
__device__ __forceinline__ void fwd_core(int& x0, int& x1, int& x2, int& x3) {
  const int t0 = add(x0, x3), t1 = add(x1, x2);
  const int t2 = sub(x1, x2), t3 = sub(x0, x3);
  x0 = add(t0, t1);
  x1 = add(mul(2, t3), t2);
  x2 = sub(t0, t1);
  x3 = sub(t3, mul(2, t2));
}

__global__ void __launch_bounds__(kThreads)
h264_requant_kernel(const int4* __restrict__ levels,
                    const int* __restrict__ qp_in,
                    const int* __restrict__ qp_out, int n,
                    int4* __restrict__ out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const int k = floordiv(sub(qp_out[row], qp_in[row]), 6);
  const int f = floordiv(shl(1, k), 3);
  const int4* src = levels + size_t(row) * 4;
  int4* dst = out + size_t(row) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 v = src[i];
    dst[i] = make_int4(shift_round(clip(v.x, kLevelClip), k, f),
                       shift_round(clip(v.y, kLevelClip), k, f),
                       shift_round(clip(v.z, kLevelClip), k, f),
                       shift_round(clip(v.w, kLevelClip), k, f));
  }
}

// ------------------------------------------ ed_h264_requant_chroma's chunks
//
// Each warp walks its own chunks of kChromaChunkRows rows through its own
// ring of kChromaStages stages in shared memory.  A chunk lies in a stage
// as its rows lie in device memory: AC [8, 60], then DC [8, 4], then
// qpc_in [8] and qpc_out [8], each run a multiple of 16 bytes, so each
// comes in by one cp.async.bulk.  Four lanes take a row, one a 4x4 block:
// lane l holds row l / 4 and block b = l % 4, whose AC levels are the 15
// words at 60 (l / 4) + 15 b = 15 l (15 is coprime with 32, so a warp's 32
// reads of one j fall on 32 banks) and whose DC level is word l.

// The per-row half of the requant: the row's arm and every amount its
// levels share, computed once a row (each of the row's four lanes computes
// it alike).  Every right shift of a level is by a clamped amount: torch's
// x >> s for s < 0 or s >= 32 is the sign fill, which is x >> 31, so qb,
// qb1 and kc lie in 0..31 and a level pays one shift.  The left shifts of
// the dequant are folded into the V multipliers ((x V) << s == x (V << s)
// modulo 2^32; 0 when s lies outside 0..31).
struct RowArm {
  int arm;           // 0 identity, 1 exact shift, 2 general round trip
  int kc, f6;        // the shift arm's amount and rounding offset
  int vs[3];         // V[qpc_in % 6][class] << qpc_in / 6
  int mf[3];         // MF[qpc_out % 6][class]
  int qb, off;       // AC requant: >> qbits, + 2^qbits / 3
  int qb1, off2;     // DC requant: >> qbits + 1, + 2 off
};

__device__ __forceinline__ int rshift_amount(int s) {
  return (s < 0 || s > 31) ? 31 : s;
}

// the arm of a row by delta = qpc_out - qpc_in (a row past the input's end
// takes the identity, the cheapest)
__device__ __forceinline__ int arm_of(int qi, int qo, bool live) {
  const int delta = sub(qo, qi);
  return !live || delta == 0 ? 0 : (mod6(delta) == 0 ? 1 : 2);
}

// tab: V [6][3] then MF [6][3], in shared memory
__device__ __forceinline__ RowArm row_arm(int qi, int qo, bool live,
                                          const int* tab) {
  RowArm r;
  r.arm = arm_of(qi, qo, live);
  const int k = max(floordiv(sub(qo, qi), 6), 0);
  r.kc = min(k, 31);
  r.f6 = floordiv(shl(1, k), 3);
  const int si = floordiv(qi, 6);
  const int* v = tab + 3 * mod6(qi);
  const int* mf = tab + 18 + 3 * mod6(qo);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.vs[c] = shl(v[c], si);
    r.mf[c] = mf[c];
  }
  const int qbits = 15 + floordiv(qo, 6);
  r.off = floordiv(shl(1, qbits), 3);
  r.qb = rshift_amount(qbits);
  r.qb1 = rshift_amount(qbits + 1);
  r.off2 = mul(2, r.off);
  return r;
}

// sign(x) * ((|x| + f) >> s) for s in 0..31
__device__ __forceinline__ int round_shift(int x, int s, int f) {
  const int z = add(iabs(x), f) >> s;
  return x > 0 ? z : (x < 0 ? sub(0, z) : 0);
}

// The 2x2 Hadamard H2 . c . H2 of a row's four raster values, one a lane
// (b = the lane's block): two butterflies over the row's lanes.
__device__ __forceinline__ int hadamard4(int x, int b) {
  int y = __shfl_xor_sync(0xffffffffu, x, 1);
  x = (b & 1) ? sub(y, x) : add(x, y);
  y = __shfl_xor_sync(0xffffffffu, x, 2);
  return (b & 2) ? sub(y, x) : add(x, y);
}

// One chunk in shared memory, and the V/MF table
struct ChromaChunk {
  int* ac;           // [kChromaChunkRows, 60]
  int* dc;           // [kChromaChunkRows, 4]
  const int* qi;     // [kChromaChunkRows]
  const int* qo;     // [kChromaChunkRows]
  int rows;          // rows of it that are real (the last chunk's fewer)
  const int* tab;    // V [6][3], MF [6][3]
};

// One lane's block of its row requantized in place (row = lane / 4, b =
// lane % 4).  A warp runs the general arm's transform only if one of its
// rows takes that arm; then its last step, the requant at qpc_out, serves
// every row of the warp: a general row's forward coefficient times MF,
// shifted by qbits, or an exact-shift or identity row's clipped level
// times 1, shifted by k (0 for the identity; the clip after it changes
// no such level).  A warp with no general row shifts or clips.
__device__ __forceinline__ void requant_block(const ChromaChunk& c, int row,
                                              int b) {
  const RowArm r = row_arm(c.qi[row], c.qo[row], row < c.rows, c.tab);
  int* ac = c.ac + row * 60 + 15 * b;
  int* dc = c.dc + row * 4 + b;
  if (__any_sync(0xffffffffu, r.arm == 2)) {
    // DC dequant (8.5.11) through the Hadamard, AC dequant (8.5.12)
    int w[16];
    w[0] = mul(hadamard4(clip(*dc, kLevelClip), b), r.vs[0]) >> 1;
#pragma unroll
    for (int j = 1; j < 16; ++j) {
      const int p = zigzag(j);
      w[p] = mul(clip(ac[j - 1], kLevelClip), r.vs[cls(p)]);
    }
    // inverse core: rows, then columns; the round and the clip
#pragma unroll
    for (int i = 0; i < 4; ++i)
      inv_core(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) inv_core(w[k], w[4 + k], w[8 + k], w[12 + k]);
#pragma unroll
    for (int p = 0; p < 16; ++p) w[p] = clip(add(w[p], 32) >> 6, kResClip);
    // forward core: rows, then columns, then the clip
#pragma unroll
    for (int i = 0; i < 4; ++i)
      fwd_core(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) fwd_core(w[k], w[4 + k], w[8 + k], w[12 + k]);
#pragma unroll
    for (int p = 0; p < 16; ++p) w[p] = clip(w[p], kWClip);
    // the DC requant's input: the Hadamard of the blocks' forward DC
    const int g = clip(hadamard4(w[0], b), kWClip);
    // the requant at qpc_out, for the row's own arm
    const bool gen = r.arm == 2;
    const int s = gen ? r.qb : r.kc, o = gen ? r.off : r.f6;
    *dc = clip(round_shift(gen ? mul(g, r.mf[0]) : clip(*dc, kLevelClip),
                           gen ? r.qb1 : r.kc, gen ? r.off2 : r.f6),
               kLevelClip);
#pragma unroll
    for (int j = 1; j < 16; ++j) {
      const int p = zigzag(j);
      const int v =
          gen ? mul(w[p], r.mf[cls(p)]) : clip(ac[j - 1], kLevelClip);
      ac[j - 1] = clip(round_shift(v, s, o), kLevelClip);
    }
  } else if (r.arm == 1) {
    *dc = round_shift(clip(*dc, kLevelClip), r.kc, r.f6);
#pragma unroll
    for (int j = 0; j < 15; ++j)
      ac[j] = round_shift(clip(ac[j], kLevelClip), r.kc, r.f6);
  } else {
    *dc = clip(*dc, kLevelClip);
#pragma unroll
    for (int j = 0; j < 15; ++j) ac[j] = clip(ac[j], kLevelClip);
  }
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

// Rows [row0, row0 + rows) into a stage (one lane): AC, DC and the QPs'
// whole 16-byte words, one bulk copy each on the stage's mbarrier.  A
// ragged last chunk's QP words past its last whole 16 bytes are loaded
// plainly (chroma_ring).
__device__ __forceinline__ void load_rows(uint8_t* stage, uint32_t bar,
                                          const int* dc, const int* ac,
                                          const int* qpc_in,
                                          const int* qpc_out, int row0,
                                          int rows, int capacity) {
  const uint32_t qp_bytes = uint32_t(rows & ~3) * 4;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(uint32_t(rows) * 256 + 2 * qp_bytes)
               : "memory");
  bulk_load(stage, ac + size_t(row0) * 60, uint32_t(rows) * 240, bar);
  uint8_t* at = stage + capacity * 240;
  bulk_load(at, dc + size_t(row0) * 4, uint32_t(rows) * 16, bar);
  if (qp_bytes != 0) {
    at += capacity * 16;
    bulk_load(at, qpc_in + row0, qp_bytes, bar);
    bulk_load(at + capacity * 4, qpc_out + row0, qp_bytes, bar);
  }
}

// The persistent loop of ed_h264_requant_chroma: warp w of the grid's W
// takes chunks w, w + W, ...  Its lane 0 loads its first chunks into all
// kStages stages; after it has issued chunk i's bulk stores it waits for
// chunk i - 1's stores to have read their stage
// (cp.async.bulk.wait_group.read 1) and loads chunk i - 1 + kStages there.
// `body(chunk, lane)` requantizes a chunk in place; the results leave by
// bulk stores straight from the stage.  No barrier spans more than a warp.
template <int kStages, class Body>
__device__ __forceinline__ void chroma_ring(
    const int* __restrict__ dc, const int* __restrict__ ac,
    const int* __restrict__ qpc_in, const int* __restrict__ qpc_out, int n,
    int* __restrict__ dc_out, int* __restrict__ ac_out, Body body) {
  constexpr int R = kChromaChunkRows;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kChromaWarps][kStages];
  __shared__ int tab[36];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t < 18) {
    tab[t] = kV[t / 3][t % 3];
    tab[18 + t] = kMF[t / 3][t % 3];
  }
  uint8_t* ring = smem + warp * kStages * kChromaChunkBytes;
  const int chunks = (n + R - 1) / R;
  const int first = blockIdx.x * kChromaWarps + warp;
  const int stride = gridDim.x * kChromaWarps;
  auto load = [&](int s, int chunk) {
    load_rows(ring + s * kChromaChunkBytes, smem_addr(&full[warp][s]), dc,
              ac, qpc_in, qpc_out, chunk * R, min(R, n - chunk * R), R);
  };
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&full[warp][s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kStages; ++s)
      if (first + s * stride < chunks) load(s, first + s * stride);
  }
  __syncthreads();                   // the table and the mbarriers
  int i = 0;
  for (int chunk = first; chunk < chunks; chunk += stride, ++i) {
    const int s = i % kStages;
    uint8_t* stage = ring + s * kChromaChunkBytes;
    const int row0 = chunk * R, rows = min(R, n - row0);
    int* s_ac = reinterpret_cast<int*>(stage);
    int* s_dc = reinterpret_cast<int*>(stage + R * 240);
    int* s_qi = reinterpret_cast<int*>(stage + R * 256);
    int* s_qo = s_qi + R;
    mbar_wait(smem_addr(&full[warp][s]), (i / kStages) & 1);
    if (rows & 3) {                  // the ragged last chunk's QP tail
      const int q = (rows & ~3) + lane;
      if (q < rows) {
        s_qi[q] = qpc_in[row0 + q];
        s_qo[q] = qpc_out[row0 + q];
      }
      __syncwarp();
    }
    body(ChromaChunk{s_ac, s_dc, s_qi, s_qo, rows, tab}, lane);
    // the generic-proxy writes above, then the async-proxy stores
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      bulk_store(ac_out + size_t(row0) * 60, s_ac, uint32_t(rows) * 240);
      bulk_store(dc_out + size_t(row0) * 4, s_dc, uint32_t(rows) * 16);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      const int next = chunk + (kStages - 1) * stride;
      if (i > 0 && next < chunks) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load((i - 1) % kStages, next);
      }
    }
    __syncwarp();
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(kChromaThreads, kChromaCtasPerSm)
h264_requant_chroma_kernel(const int* __restrict__ dc,
                           const int* __restrict__ ac,
                           const int* __restrict__ qpc_in,
                           const int* __restrict__ qpc_out, int n,
                           int* __restrict__ dc_out,
                           int* __restrict__ ac_out) {
  chroma_ring<kChromaStages>(
      dc, ac, qpc_in, qpc_out, n, dc_out, ac_out,
      [](const ChromaChunk& c, int lane) {
        requant_block(c, lane >> 2, lane & 3);
      });
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

// words rounded up to a multiple of 4: where a segment of a leg's buffers
// starts, so that it stays 16-byte aligned
size_t align4(size_t words) { return (words + 3) & ~size_t(3); }

// CTAs of one ed_h264_requant_chroma launch at most: a wave, kChromaCtasPerSm
// an SM as the kernel's occupancy allows.  The kernel's opt-in to
// kChromaSmem bytes of dynamic shared memory (above the 48 KB default) and
// the count are set up once a device.
int chroma_wave(int* ctas) {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < kMaxDevices && (*ctas = cached[dev].load()) > 0) return 0;
  e = cudaFuncSetAttribute(h264_requant_chroma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kChromaSmem);
  if (e != cudaSuccess) return int(e);
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, h264_requant_chroma_kernel, kChromaThreads, kChromaSmem);
  if (e != cudaSuccess) return int(e);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  *ctas = sms * per_sm;
  if (dev < kMaxDevices) cached[dev].store(*ctas);
  return 0;
}

// ONE ed_h264_requant_chroma launch over n > 0 rows (every array 16-byte
// aligned): a grid of at most one wave, and no more warps than chunks.
int launch_chroma(const int* dc, const int* ac, const int* qpc_in,
                  const int* qpc_out, int n, int* dc_out, int* ac_out,
                  cudaStream_t s) {
  int ctas = 0;
  const int rc = chroma_wave(&ctas);
  if (rc != 0) return rc;
  const int rows = kChromaWarps * kChromaChunkRows;
  const int need = int((int64_t(n) + rows - 1) / rows);
  if (const int rc2 = ed_timing::start(s)) return rc2;
  h264_requant_chroma_kernel<<<need < ctas ? need : ctas, kChromaThreads,
                               kChromaSmem, s>>>(dc, ac, qpc_in, qpc_out, n,
                                                 dc_out, ac_out);
  return ed_timing::stop(s, cudaGetLastError());
}

// The leg's tail: upload the staged inputs, run the launch (which returns
// a cudaError_t), read the outputs back into pinned memory and record the
// event behind them, all on one stream.
template <class Launch>
int leg_run(const int* stage, size_t in_words, int* dev, size_t out_at,
            size_t out_words, int* back, void* event, cudaStream_t s,
            Launch launch) {
  cudaError_t e = cudaMemcpyAsync(dev, stage, in_words * 4,
                                  cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return int(e);
  const int rc = launch();
  if (rc != 0) return rc;
  e = cudaMemcpyAsync(back, dev + out_at, out_words * 4,
                      cudaMemcpyDeviceToHost, s);
  if (e != cudaSuccess) return int(e);
  return int(cudaEventRecord(static_cast<cudaEvent_t>(event), s));
}

}  // namespace

extern "C" {

// levels [n, 16] int32 (16-byte aligned), qp_in [n], qp_out [n] int32,
// out [n, 16] int32 (16-byte aligned).  ONE launch; n = 0 launches nothing.
int ed_h264_requant(const void* levels, const void* qp_in,
                    const void* qp_out, int n, void* out, void* stream) {
  if (n < 0 || misaligned(levels) || misaligned(out))
    return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int rc = ed_timing::start(st)) return rc;
  h264_requant_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const int4*>(levels), static_cast<const int*>(qp_in),
      static_cast<const int*>(qp_out), n, static_cast<int4*>(out));
  return ed_timing::stop(st, cudaGetLastError());
}

// dc [n, 4] and ac [n, 4, 15] int32, qpc_in [n] and qpc_out [n] int32,
// dc_out [n, 4] and ac_out [n, 4, 15] int32; all six arrays 16-byte
// aligned (each chunk's runs are bulk copies).  ONE launch; n = 0 launches
// nothing.
int ed_h264_requant_chroma(const void* dc, const void* ac,
                           const void* qpc_in, const void* qpc_out, int n,
                           void* dc_out, void* ac_out, void* stream) {
  if (n < 0 || misaligned(dc) || misaligned(ac) || misaligned(qpc_in) ||
      misaligned(qpc_out) || misaligned(dc_out) || misaligned(ac_out))
    return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return launch_chroma(
      static_cast<const int*>(dc), static_cast<const int*>(ac),
      static_cast<const int*>(qpc_in), static_cast<const int*>(qpc_out), n,
      static_cast<int*>(dc_out), static_cast<int*>(ac_out),
      static_cast<cudaStream_t>(stream));
}

// ------------------------------------------------------------- the legs
// The HLS ladder's B6 leg as ONE host call (ops/h264_kernel.py RequantLeg
// binds these through ctypes.PyDLL, so its caller keeps the GIL): the
// int64 rows of an access unit are narrowed to int32 and tiled over the
// ladder's target QPs straight into pinned staging, uploaded once,
// requantized by ONE launch, read back once into pinned memory, and an
// event is recorded behind the readback.  A chain of torch calls doing
// the same gives up the GIL at every step and, beside the requant pool's
// Python threads, waits milliseconds to take it back each time; this
// costs microseconds and gives it up never.  Narrowing wraps modulo 2^32
// as numpy's assignment into int32 does.

// rows [r, 16], qp_in [r] and deltas [t] int64 (C order): the output is
// [t * r, 16] int32 in `back`, tile i holding the rows requantized from
// qp_in to qp_in + deltas[i].  stage: 18 n pinned words (n = t * r); dev:
// align4(18 n) + 16 n words on the card, 16-byte aligned; back: 16 n
// pinned words.  ONE ed_h264_requant launch on `stream`.
int ed_h264_requant_leg(const int64_t* rows, const int64_t* qp_in,
                        const int64_t* deltas, int r, int t, int* stage,
                        int* dev, int* back, void* event, void* stream) {
  const size_t n = size_t(r > 0 ? r : 0) * size_t(t > 0 ? t : 0);
  if (n == 0 || n > size_t(INT_MAX) || misaligned(dev))
    return int(cudaErrorInvalidValue);
  int* lev = stage;
  int* qi = stage + 16 * n;
  int* qo = qi + n;
  for (int i = 0; i < r; ++i) {
    for (int j = 0; j < 16; ++j)
      lev[size_t(i) * 16 + j] = int(rows[size_t(i) * 16 + j]);
    qi[i] = int(qp_in[i]);
  }
  for (int k = 1; k < t; ++k) {
    std::memcpy(lev + size_t(k) * r * 16, lev, size_t(r) * 16 * 4);
    std::memcpy(qi + size_t(k) * r, qi, size_t(r) * 4);
  }
  for (int k = 0; k < t; ++k)
    for (int i = 0; i < r; ++i)
      qo[size_t(k) * r + i] = int(qp_in[i] + deltas[k]);
  const size_t out_at = align4(18 * n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return leg_run(stage, 18 * n, dev, out_at, 16 * n, back, event, s, [&] {
    if (const int rc = ed_timing::start(s)) return rc;
    h264_requant_kernel<<<(int(n) + kThreads - 1) / kThreads, kThreads, 0,
                          s>>>(reinterpret_cast<const int4*>(dev), dev + 16 * n,
                               dev + 17 * n, int(n),
                               reinterpret_cast<int4*>(dev + out_at));
    return ed_timing::stop(s, cudaGetLastError());
  });
}

// dc [m g, 4] and ac [m g, 4, 15] int64 rows, g rows a QP (the ladder's
// g = 2: a macroblock's Cb and Cr), qp_in [m] and qp_out [t, m] int64:
// the output is dc' [n, 4] then ac' [n, 4, 15] int32 in `back` (n =
// t m g rows), tile i requantized from qp_in to qp_out[i].  The card
// buffer holds dc [n, 4] at word 0, ac [n, 4, 15] at 4 n, qpc_in [n] at
// 64 n, qpc_out [n] at 64 n + align4(n), the outputs at align4 of where
// qpc_out ends (ops/h264_kernel.py chroma_leg_layout): every segment on
// a 16-byte boundary, as the kernel's bulk copies need.  stage: the
// inputs' words, pinned; dev: the inputs' and outputs' words on the
// card, 16-byte aligned; back: 64 n pinned words.  ONE
// ed_h264_requant_chroma launch on `stream`.
int ed_h264_requant_chroma_leg(const int64_t* dc, const int64_t* ac,
                               const int64_t* qp_in, const int64_t* qp_out,
                               int m, int g, int t, int* stage, int* dev,
                               int* back, void* event, void* stream) {
  const size_t rows = size_t(m > 0 ? m : 0) * size_t(g > 0 ? g : 0);
  const size_t n = rows * size_t(t > 0 ? t : 0);
  if (n == 0 || n > size_t(INT_MAX) || misaligned(dev))
    return int(cudaErrorInvalidValue);
  const size_t qo_at = 64 * n + align4(n), in_words = qo_at + n;
  int* sdc = stage;
  int* sac = stage + 4 * n;
  int* qi = stage + 64 * n;
  int* qo = stage + qo_at;
  for (size_t i = 0; i < rows * 4; ++i) sdc[i] = int(dc[i]);
  for (size_t i = 0; i < rows * 60; ++i) sac[i] = int(ac[i]);
  for (int k = 1; k < t; ++k) {
    std::memcpy(sdc + k * rows * 4, sdc, rows * 4 * 4);
    std::memcpy(sac + k * rows * 60, sac, rows * 60 * 4);
  }
  for (int k = 0; k < t; ++k)
    for (int q = 0; q < m; ++q)
      for (int h = 0; h < g; ++h) {
        const size_t row = (size_t(k) * m + q) * g + h;
        qi[row] = int(qp_in[q]);
        qo[row] = int(qp_out[size_t(k) * m + q]);
      }
  const size_t out_at = align4(in_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return leg_run(stage, in_words, dev, out_at, 64 * n, back, event, s, [&] {
    return launch_chroma(dev, dev + 4 * n, dev + 64 * n, dev + qo_at, int(n),
                         dev + out_at, dev + out_at + 4 * n, s);
  });
}

// Wait for a leg's event, spinning up to spin_us microseconds (a wait
// this short is cheaper with the GIL kept than given up), then widen
// `words` int32 of `back` into int64 `out`.  cudaErrorNotReady, with
// nothing widened, when the event is still pending after the spin: the
// caller then waits in ed_event_synchronize (bound without the GIL) and
// calls again.
int ed_h264_leg_finish(void* event, const int* back, long long words,
                       int64_t* out, int spin_us) {
  const cudaEvent_t ev = static_cast<cudaEvent_t>(event);
  const auto until = std::chrono::steady_clock::now() +
                     std::chrono::microseconds(spin_us);
  cudaError_t e;
  while ((e = cudaEventQuery(ev)) == cudaErrorNotReady &&
         std::chrono::steady_clock::now() < until) {
  }
  if (e != cudaSuccess) return int(e);
  for (long long i = 0; i < words; ++i) out[i] = back[i];
  return 0;
}

// A CUDA event without timing, on the calling thread's current device.
int ed_event_create(void** event) {
  return int(cudaEventCreateWithFlags(reinterpret_cast<cudaEvent_t*>(event),
                                      cudaEventDisableTiming));
}

int ed_event_synchronize(void* event) {
  return int(cudaEventSynchronize(static_cast<cudaEvent_t>(event)));
}

}  // extern "C"
