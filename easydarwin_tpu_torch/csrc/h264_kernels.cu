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
//     bit).  All three arms are computed and one is selected per value,
//     with no branch, as the plain chain does.
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
// What bounds them
//   At the config-5 width (16 sources x one 1080p frame, 8,160
//   macroblocks each) the luma pass moves N = 2,088,960 rows of 64 B in
//   and out plus two QP words a row: 284.1 MB, 0.0848 ms at 3.35 TB/s,
//   against ~6 integer operations a level (0.003 ms at 67 T/s).  The
//   chroma pass moves N = 261,120 rows of 256 B in and out plus two QP
//   words: 135.8 MB, 0.0405 ms; its three arms are ~1,840 operations a
//   row (0.48 G ops, 0.007 ms).  Both are bound by bytes.
//
// What the design does about that
//   One thread per row, the whole row in registers: the luma row is four
//   16-byte loads and four 16-byte stores; the chroma row is one 16-byte
//   load of DC and fifteen of AC (a row's 240 AC bytes are 16-byte
//   aligned, a block's 60 are not, so the row is loaded whole) and as
//   many stores, each block's results written over its inputs in
//   registers.  Neighbouring threads read neighbouring rows: a warp's
//   loads touch one contiguous span, which the L1 serves to the
//   instructions that follow.  The zigzag scan is folded into the code at
//   compile time (constexpr) so that every register index is a constant
//   and nothing spills to local memory; the six dequant (V) and six
//   requant (MF) multipliers of a row's qp % 6 come from constant memory.

#include <cuda_runtime.h>

#include <chrono>
#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kLevelClip = 2047;   // codecs/h264_transform.py LEVEL_CLIP
constexpr int kResClip = 4095;     // RES_CLIP
constexpr int kWClip = 131071;     // W_CLIP
constexpr int kThreads = 128;     // chip_smoke.py B6_CTA_ROWS

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

// the 2x2 Hadamard H2 . c . H2 of a raster quad, in place
__device__ __forceinline__ void h2x2(int* v) {
  const int a = v[0], b = v[1], c = v[2], d = v[3];
  v[0] = add(add(a, b), add(c, d));
  v[1] = add(sub(a, b), sub(c, d));
  v[2] = sub(add(a, b), add(c, d));
  v[3] = sub(sub(a, b), sub(c, d));
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

__global__ void __launch_bounds__(kThreads)
h264_requant_chroma_kernel(const int4* __restrict__ dc_in,
                           const int4* __restrict__ ac_in,
                           const int* __restrict__ qpc_in,
                           const int* __restrict__ qpc_out, int n,
                           int4* __restrict__ dc_out,
                           int4* __restrict__ ac_out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const int qi = qpc_in[row], qo = qpc_out[row];
  const int delta = sub(qo, qi);
  const bool same = delta == 0;
  const bool shift = mod6(delta) == 0;

  // the exact-shift arm's step
  const int k = max(floordiv(delta, 6), 0);
  const int f6 = floordiv(shl(1, k), 3);

  // the general arm's scales
  const int si = floordiv(qi, 6), so = floordiv(qo, 6);
  const int mi = mod6(qi), mo = mod6(qo);
  const int v[3] = {kV[mi][0], kV[mi][1], kV[mi][2]};
  const int mf[3] = {kMF[mo][0], kMF[mo][1], kMF[mo][2]};
  const int qbits = 15 + so;
  const int off = floordiv(shl(1, qbits), 3);

  int dc[4];
  {
    const int4 d = dc_in[row];
    dc[0] = clip(d.x, kLevelClip);
    dc[1] = clip(d.y, kLevelClip);
    dc[2] = clip(d.z, kLevelClip);
    dc[3] = clip(d.w, kLevelClip);
  }
  int ac[60];
  {
    const int4* src = ac_in + size_t(row) * 15;
#pragma unroll
    for (int i = 0; i < 15; ++i) {
      const int4 a = src[i];
      ac[4 * i + 0] = clip(a.x, kLevelClip);
      ac[4 * i + 1] = clip(a.y, kLevelClip);
      ac[4 * i + 2] = clip(a.z, kLevelClip);
      ac[4 * i + 3] = clip(a.w, kLevelClip);
    }
  }

  // DC dequant (8.5.11): ((H2 . c . H2) * V[qp%6][A]) << qp/6 >> 1
  int dcc[4] = {dc[0], dc[1], dc[2], dc[3]};
  h2x2(dcc);
#pragma unroll
  for (int b = 0; b < 4; ++b) dcc[b] = shl(mul(dcc[b], v[0]), si) >> 1;

  int big0[4];     // each block's forward DC coefficient (general arm)
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    // dequant the block in raster order, DC from the chroma DC chain
    int w[16];
    w[0] = dcc[b];
#pragma unroll
    for (int j = 1; j < 16; ++j) {
      const int p = zigzag(j);
      w[p] = shl(mul(ac[15 * b + j - 1], v[cls(p)]), si);
    }
    // inverse core: rows, then columns
#pragma unroll
    for (int r = 0; r < 4; ++r)
      inv_core(w[4 * r], w[4 * r + 1], w[4 * r + 2], w[4 * r + 3]);
#pragma unroll
    for (int c = 0; c < 4; ++c) inv_core(w[c], w[4 + c], w[8 + c], w[12 + c]);
#pragma unroll
    for (int p = 0; p < 16; ++p) w[p] = clip(add(w[p], 32) >> 6, kResClip);
    // forward core: rows, then columns, then the clip
#pragma unroll
    for (int r = 0; r < 4; ++r)
      fwd_core(w[4 * r], w[4 * r + 1], w[4 * r + 2], w[4 * r + 3]);
#pragma unroll
    for (int c = 0; c < 4; ++c) fwd_core(w[c], w[4 + c], w[8 + c], w[12 + c]);
#pragma unroll
    for (int p = 0; p < 16; ++p) w[p] = clip(w[p], kWClip);
    big0[b] = w[0];
    // select the arm of each AC level, written over its input
#pragma unroll
    for (int j = 1; j < 16; ++j) {
      const int p = zigzag(j);
      const int x = ac[15 * b + j - 1];
      const int gen =
          clip(shift_round(mul(w[p], mf[cls(p)]), qbits, off), kLevelClip);
      ac[15 * b + j - 1] = same ? x : (shift ? shift_round(x, k, f6) : gen);
    }
  }
  // the DC requant: the Hadamard of the blocks' forward DC, clipped
  h2x2(big0);
  int dco[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int gen = clip(shift_round(mul(clip(big0[b], kWClip), mf[0]),
                                     qbits + 1, mul(2, off)),
                         kLevelClip);
    dco[b] = same ? dc[b] : (shift ? shift_round(dc[b], k, f6) : gen);
  }
  dc_out[row] = make_int4(dco[0], dco[1], dco[2], dco[3]);
  int4* dst = ac_out + size_t(row) * 15;
#pragma unroll
  for (int i = 0; i < 15; ++i)
    dst[i] = make_int4(ac[4 * i], ac[4 * i + 1], ac[4 * i + 2], ac[4 * i + 3]);
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

// words rounded up to a multiple of 4: where a leg's outputs start in its
// card buffer, so that they stay 16-byte aligned
size_t align4(size_t words) { return (words + 3) & ~size_t(3); }

// The leg's tail: upload the staged inputs, run the launch, read the
// outputs back into pinned memory and record the event behind them, all
// on one stream.
template <class Launch>
int leg_run(const int* stage, size_t in_words, int* dev, size_t out_at,
            size_t out_words, int* back, void* event, cudaStream_t s,
            Launch launch) {
  cudaError_t e = cudaMemcpyAsync(dev, stage, in_words * 4,
                                  cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return int(e);
  launch();
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
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
  h264_requant_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(levels), static_cast<const int*>(qp_in),
      static_cast<const int*>(qp_out), n, static_cast<int4*>(out));
  return int(cudaGetLastError());
}

// dc [n, 4] and ac [n, 4, 15] int32, qpc_in [n] and qpc_out [n] int32,
// dc_out [n, 4] and ac_out [n, 4, 15] int32; the four row arrays 16-byte
// aligned.  ONE launch; n = 0 launches nothing.
int ed_h264_requant_chroma(const void* dc, const void* ac,
                           const void* qpc_in, const void* qpc_out, int n,
                           void* dc_out, void* ac_out, void* stream) {
  if (n < 0 || misaligned(dc) || misaligned(ac) || misaligned(dc_out) ||
      misaligned(ac_out))
    return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  h264_requant_chroma_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(dc), static_cast<const int4*>(ac),
      static_cast<const int*>(qpc_in), static_cast<const int*>(qpc_out), n,
      static_cast<int4*>(dc_out), static_cast<int4*>(ac_out));
  return int(cudaGetLastError());
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
    h264_requant_kernel<<<(int(n) + kThreads - 1) / kThreads, kThreads, 0,
                          s>>>(reinterpret_cast<const int4*>(dev), dev + 16 * n,
                               dev + 17 * n, int(n),
                               reinterpret_cast<int4*>(dev + out_at));
  });
}

// dc [m g, 4] and ac [m g, 4, 15] int64 rows, g rows a QP (the ladder's
// g = 2: a macroblock's Cb and Cr), qp_in [m] and qp_out [t, m] int64:
// the output is dc' [n, 4] then ac' [n, 4, 15] int32 in `back` (n =
// t m g rows), tile i requantized from qp_in to qp_out[i].  stage: 66 n
// pinned words; dev: align4(66 n) + 64 n words on the card, 16-byte
// aligned; back: 64 n pinned words.  ONE ed_h264_requant_chroma launch
// on `stream`.
int ed_h264_requant_chroma_leg(const int64_t* dc, const int64_t* ac,
                               const int64_t* qp_in, const int64_t* qp_out,
                               int m, int g, int t, int* stage, int* dev,
                               int* back, void* event, void* stream) {
  const size_t rows = size_t(m > 0 ? m : 0) * size_t(g > 0 ? g : 0);
  const size_t n = rows * size_t(t > 0 ? t : 0);
  if (n == 0 || n > size_t(INT_MAX) || misaligned(dev))
    return int(cudaErrorInvalidValue);
  int* sdc = stage;
  int* sac = stage + 4 * n;
  int* qi = stage + 64 * n;
  int* qo = qi + n;
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
  const size_t out_at = align4(66 * n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return leg_run(stage, 66 * n, dev, out_at, 64 * n, back, event, s, [&] {
    h264_requant_chroma_kernel<<<(int(n) + kThreads - 1) / kThreads,
                                 kThreads, 0, s>>>(
        reinterpret_cast<const int4*>(dev),
        reinterpret_cast<const int4*>(dev + 4 * n), dev + 64 * n,
        dev + 65 * n, int(n), reinterpret_cast<int4*>(dev + out_at),
        reinterpret_cast<int4*>(dev + out_at + 4 * n));
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
