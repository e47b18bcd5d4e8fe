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
//   GF(256), polynomial 0x11D.  out[r, b] = XOR over k of
//   exp[log coeff[r, k] + log rows[k, b]], a product with a zero operand
//   being 0.  Callers: the wire FEC's window parity (relay/fec.py; K = 16,
//   B = 2,048 for 1080p packets, R <= 8) and the stripe codec's parity and
//   reconstruct (storage/codec.py; K = 4, R = 2, B up to ~1 MiB).
//
// What bounds it
//   Each input byte is read once and each output byte written once: the
//   wire shape [16, 2048] x [2, 16] moves 37 KB (0.011 us at 3.35 TB/s),
//   the stripe [4, 1 MiB] x [2, 4] 6.3 MB (1.9 us).  The products are a
//   few 32-bit operations each (R*K*B of them), under the byte bound at
//   both shapes.  So the wire shape is bound by the launch, and the stripe
//   by bytes.
//
// What the design does about that
//   * Everything a thread needs is requested in ONE round of independent
//     loads before anything waits: its word of the 768-byte table block
//     (the 512-entry antilog table, then the 256-entry log table), its
//     coefficient bytes and its rows.  A launch then pays about one memory
//     latency, not one per table chunk and per row.
//   * The tables and the R*K coefficient logs sit in shared memory; log[0]
//     is a sentinel (a zero operand is masked, never looked up) and a zero
//     coefficient's log is -1, which skips its (r, k) term.
//   * A thread owns WPT 32-bit words (4*WPT consecutive output columns) of
//     each of its rows and keeps R*WPT 32-bit accumulators; a warp's words
//     are contiguous, so its loads and stores are whole 128-byte lines.
//     Two shapes of work:
//     - K <= 8 and B >= 256 KiB (the stripe codec, K = 4): WPT = 4, one
//       16-byte vector load a row, every row in one thread: a 1 MiB
//       stripe is 512 CTAs (one word a thread would need 2,048 CTAs,
//       each filling its tables);
//     - otherwise (the wire, K = 16): WPT = 1, and K split over G thread
//       rows of the CTA (G = 4 for K >= 16, 2 for K >= 8, else 1), each
//       walking K/G rows, the G partial sums meeting by XOR in shared
//       memory: the wire shape runs 16 CTAs of 32 words x 4 groups, 4 rows
//       a thread, so the chain of table lookups a thread walks is short.
//   * What is left: the table gathers hit shared-memory banks at random
//     (a warp's 32 lookups replay on conflicts), which bounds both shapes
//     well above their byte bound.
//   * All arithmetic is 32-bit integer; no TMA or wgmma: a simple kernel
//     that is right.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGfMaxK = 64;        // rows a window (MASK_BITS 48, pow2)
constexpr int kGfMaxR = 8;         // parity rows (MAX_PARITY_ROWS)
constexpr int kGfThreads = 128;
constexpr int kGfMaxGroups = 4;    // thread rows splitting K (WPT = 1)
constexpr int kGfWideMaxK = 8;     // the 16-byte-a-row shape: K at most,
constexpr int kGfWideMinB = 1 << 18;  // and B at least (256 KiB)
constexpr int kGfBUnit = 256;      // B is a multiple of this
constexpr int kGfCoeffPerThread = (kGfMaxR * kGfMaxK) / kGfThreads;

template <int WPT, int MAXK>
__global__ void __launch_bounds__(kGfThreads)
gf_parity_kernel(const uint8_t* __restrict__ rows, int K, int B,
                 const uint8_t* __restrict__ coeff, int R,
                 const uint8_t* __restrict__ tables,
                 uint8_t* __restrict__ out) {
  __shared__ uint32_t s_exp[512];
  __shared__ int s_log[256];
  __shared__ int s_lc[kGfMaxR * kGfMaxK];
  __shared__ uint32_t s_part[WPT == 1 ? kGfMaxGroups - 1 : 1]
                            [WPT == 1 ? kGfMaxR : 1][kGfThreads];

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;   // 0..127
  const int per = (K + blockDim.y - 1) / blockDim.y;        // rows a group
  const int k0 = threadIdx.y * per;
  const long word = (long(blockIdx.x) * blockDim.x + threadIdx.x) * WPT;
  const bool live = word < B / 4;

  // one round of independent loads
  const uint32_t* t32 = reinterpret_cast<const uint32_t*>(tables);
  const uint32_t t_exp = t32[tid];                        // exp[4 tid ..]
  const uint32_t t_log = tid < 64 ? t32[128 + tid] : 0u;  // log[4 tid ..]
  int cb[kGfCoeffPerThread];
#pragma unroll
  for (int m = 0; m < kGfCoeffPerThread; ++m) {
    const int i = tid + m * kGfThreads;
    cb[m] = i < R * K ? int(coeff[i]) : 0;
  }
  uint32_t w[MAXK][WPT];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    const bool load = k < per && k0 + k < K && live;
    const uint8_t* src = rows + long(k0 + k) * B + 4 * word;
    if constexpr (WPT == 4) {
      const uint4 v = load ? __ldg(reinterpret_cast<const uint4*>(src))
                           : make_uint4(0u, 0u, 0u, 0u);
      w[k][0] = v.x;
      w[k][1] = v.y;
      w[k][2] = v.z;
      w[k][3] = v.w;
    } else {
      w[k][0] = load ? __ldg(reinterpret_cast<const uint32_t*>(src)) : 0u;
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) s_exp[4 * tid + j] = (t_exp >> (8 * j)) & 0xFFu;
  if (tid < 64) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s_log[4 * tid + j] = int((t_log >> (8 * j)) & 0xFFu);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kGfCoeffPerThread; ++m) {
    const int i = tid + m * kGfThreads;
    if (i < R * K) s_lc[i] = cb[m] ? s_log[cb[m]] : -1;
  }
  __syncthreads();

  uint32_t acc[kGfMaxR][WPT];
#pragma unroll
  for (int r = 0; r < kGfMaxR; ++r)
#pragma unroll
    for (int q = 0; q < WPT; ++q) acc[r][q] = 0u;
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    if (k >= per || k0 + k >= K) break;
#pragma unroll
    for (int q = 0; q < WPT; ++q) {
      int lr[4];                    // log of each byte, -1 for a zero byte
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte = (w[k][q] >> (8 * j)) & 0xFFu;
        lr[j] = byte ? s_log[byte] : -1;
      }
#pragma unroll
      for (int r = 0; r < kGfMaxR; ++r) {
        if (r >= R) break;
        const int lc = s_lc[r * K + k0 + k];
        if (lc < 0) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t p = lr[j] < 0 ? 0u : s_exp[lc + lr[j]];
          acc[r][q] ^= p << (8 * j);
        }
      }
    }
  }

  if constexpr (WPT == 1) {
    if (blockDim.y > 1) {           // the groups' partial sums meet
      if (threadIdx.y > 0) {
#pragma unroll
        for (int r = 0; r < kGfMaxR; ++r)
          if (r < R) s_part[threadIdx.y - 1][r][threadIdx.x] = acc[r][0];
      }
      __syncthreads();
      if (threadIdx.y == 0) {
        for (int g = 1; g < int(blockDim.y); ++g) {
#pragma unroll
          for (int r = 0; r < kGfMaxR; ++r)
            if (r < R) acc[r][0] ^= s_part[g - 1][r][threadIdx.x];
        }
      }
    }
  }
  if (threadIdx.y != 0 || !live) return;
#pragma unroll
  for (int r = 0; r < kGfMaxR; ++r) {
    if (r >= R) break;
    uint8_t* dst = out + long(r) * B + 4 * word;
    if constexpr (WPT == 4) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = acc[r][0];
    }
  }
}

}  // namespace

extern "C" {

// rows [K, B] uint8 (16-byte aligned), coeff [R, K] uint8, tables: 512
// antilog bytes then 256 log bytes (16-byte aligned), out [R, B] uint8.
// K in 1..64, R in 1..8, B a positive multiple of 256; anything else is
// refused.
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
  const int words = B / 4;
  if (K <= kGfWideMaxK && B >= kGfWideMinB) {
    const int blocks = (words + 4 * kGfThreads - 1) / (4 * kGfThreads);
    gf_parity_kernel<4, kGfWideMaxK><<<blocks, kGfThreads, 0, st>>>(
        r8, K, B, c8, R, t8, o8);
  } else {
    const int groups = K >= 16 ? 4 : K >= 8 ? 2 : 1;
    const dim3 block(kGfThreads / groups, groups);
    const int blocks = (words + int(block.x) - 1) / int(block.x);
    gf_parity_kernel<1, kGfMaxK><<<blocks, block, 0, st>>>(
        r8, K, B, c8, R, t8, o8);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
