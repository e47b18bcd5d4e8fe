// Hand-written Hopper kernels of the transcode path (sm_90a): K2 and B7.
//
// Built by ops/kernel_lib.py beside relay_kernels.cu into the same shared
// library, with plain C entry points bound with ctypes: pointers, sizes
// and the caller's stream.  Each launches on that stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() (or
// kTensorMapError + the CUresult of cuTensorMapEncodeTiled when a tensor
// map cannot be encoded).
//
// ed_requant_rungs (B7) replaces the XLA pass
// easydarwin_tpu/models/transcode_pipeline.py:61 _ladder_step without
// pixels, whose rung is easydarwin_tpu/ops/transform.py:144 requantize:
// levels [N, 64] int32, qt_in [64] and qt_rungs [R, 64] f32 -> rungs
// [R, N, 64] int32 = rint(float(level) * qt_in / qt_rung) and nonzeros
// [R].  At config 5 (N = 783,360, R = 3) it reads 200.5 MB and writes
// 601.6 MB: 0.239 ms at 3.35 TB/s, against 4 R + 1 = 13 operations a
// coefficient (0.01 ms at 67 T/s), so it is bound by bytes.  The torch
// chain it replaces wrote and read back about 4.9 GB of intermediates;
// this kernel reads each level once and writes each rung level once, with
// streaming (evict-first) loads and stores.  Exactness: each step is
// rounded as the plain version rounds it, the product by __fmul_rn, the
// IEEE quotient by __fdiv_rn (never a reciprocal: coef * (1 / q) differs
// from coef / q on some levels), round half to even by __float2int_rn.
//
// What this replaces
//   ed_decode_blocks (K2) replaces the Pallas kernel
//   easydarwin_tpu/ops/transform.py:172 decode_blocks_pallas
//   (_decode_kernel): for each 8x8 block of dequantized coefficients
//   Y = levels * qt it writes the pixels
//     X = clamp(rint(C^T . Y . C + 128), 0, 255)
//   with C the orthonormal 8-point DCT-II matrix (ops.transform.operator
//   "idct8").  The reference computes C^T.Y.C as one [N,64] @ [64,64]
//   product with the Kronecker operator inv = C^T (x) C^T, a form chosen
//   for the TPU's 128x128 systolic array; the result is the same linear
//   map.  fp32 throughout, rounding half to even as jnp.round does, +128
//   after the sum, clamp in float before the u8 conversion.  No fast-math:
//   rintf, fmaf, fminf/fmaxf.
//
// What bounds it
//   At the config-5 batch (16 sources x one 1080p 4:2:0 frame = 783,360
//   blocks) it reads 783,360 x 256 B = 200.5 MB of levels and writes
//   783,360 x 64 B = 50.1 MB: 250.7 MB / 3.35 TB/s = 0.0748 ms.  The
//   separable form does a row pass and a column pass of 8 x 64 fmaf each,
//   1,024 per block: 1.6 GFLOP, 0.024 ms at the 67 TFLOP/s fp32 rate (the
//   dense Kronecker product would be 4x that, 0.096 ms).  So it is bound by
//   bytes: the design's job is to keep HBM streaming.
//
// What the design does about that
//   * One thread per 8x8 block, held in 64 registers: dequantize, row
//     pass, column pass, epilogue, with eight temporaries per pass and no
//     exchange between threads.  C and qt sit in shared memory; every lane
//     reads the same entry, so each read is a broadcast.
//   * A persistent grid (one CTA per SM at this shared-memory size) walks
//     tiles of kTile = 256 blocks.  Each CTA has kConsumers = 256 consumer
//     threads and one producer warp whose elected lane keeps a ring of
//     kStages = 3 shared-memory stages full with TMA loads: a stage is one
//     tile, 64 KB, loaded as two 2-D boxes of [256 rows, 32 int32] (128 B
//     wide) through a tensor map over [N, 64] int32.  One mbarrier per stage
//     says "full" (transaction bytes), one says "empty" (one arrival per
//     consumer warp once its lanes hold their rows in registers).
//   * CU_TENSOR_MAP_SWIZZLE_128B.  In a linear stage each thread's 256-byte
//     block would put a quarter-warp's eight 16-byte reads on the same four
//     banks; with the swizzle, thread t reads its logical chunk j at
//     physical chunk j ^ (t & 7), and the eight land on 32 distinct banks.
//     Stages are aligned to 1,024 bytes, as the swizzle requires.
//   * Whole-sector stores: each warp packs its 32 blocks' pixels as 16-byte
//     words into a [32, 64] u8 output buffer (SWIZZLE_64B, physical chunk
//     c ^ ((lane >> 1) & 3), conflict-free) and its lane 0 writes it back
//     with one TMA store.  Two output buffers per warp alternate; lane 0
//     waits for the older store's reads (cp.async.bulk.wait_group.read 1)
//     before its buffer is written again.
//   * The ragged last tile is the tensor map's out-of-bounds zero fill on
//     the way in and its clipping on the way out: rows past N are neither
//     computed nor stored, and nothing is padded.
//
// The tensor maps encode the levels' and pixels' addresses, so they are
// built on the host at every call (cuTensorMapEncodeTiled, reached through
// the libcuda the CUDA runtime has loaded) and passed by value as
// __grid_constant__ parameters.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include "launch_timing.h"

namespace {

constexpr int kTile = 256;                     // blocks per tile
constexpr int kConsumers = kTile;              // one thread per block
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;      // + the producer warp
constexpr int kStages = 3;
constexpr int kBoxBytes = kTile * 128;         // one [256, 32] int32 box
constexpr int kStageBytes = 2 * kBoxBytes;     // one tile of levels
constexpr int kWarpOutBytes = 32 * 64;         // one warp's [32, 64] u8 box
constexpr int kOutBytes = kConsumerWarps * kWarpOutBytes;
constexpr int kOutBuffers = 2;
constexpr int kAlign = 1024;                   // SWIZZLE_128B's period
constexpr int kSmemBytes = kAlign + kStages * kStageBytes
                           + kOutBuffers * kOutBytes + 2 * 64 * 4
                           + 2 * kStages * 8;
constexpr int kMaxDevices = 64;
constexpr int kRqThreads = 256;                // ed_requant_rungs
constexpr int kRqUnroll = 2;                   // chunk loads in flight a thread
constexpr int kRqMaxRungs = 8;
constexpr int kRqMaxCtas = 2048;
constexpr int kRqMaxBlocks = 1 << 24;          // N * 64 counts fit an int32

static_assert((kRqThreads % 16) == 0, "a fixed 4-column group a thread");
constexpr int kTensorMapError = 1 << 16;       // + CUresult

static_assert(kSmemBytes <= 232448, "one CTA's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 state;\n"
               " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(row)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
decode_blocks_kernel(__grid_constant__ const CUtensorMap levels_map,
                     __grid_constant__ const CUtensorMap out_map,
                     int n_blocks, const float* __restrict__ qtable,
                     const float* __restrict__ idct8) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1)))
                              & (kAlign - 1));
  uint8_t* s_in = base;                                  // [kStages][64 KB]
  uint8_t* s_out = s_in + kStages * kStageBytes;         // [2][8 warps][2 KB]
  float* s_c = reinterpret_cast<float*>(s_out + kOutBuffers * kOutBytes);
  float* s_qt = s_c + 64;
  const float4* s_c4 = reinterpret_cast<const float4*>(s_c);   // C's rows
  uint64_t* s_full = reinterpret_cast<uint64_t*>(s_qt + 64);
  uint64_t* s_empty = s_full + kStages;

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  if (t < 64) {
    s_c[t] = idct8[t];
    s_qt[t] = qtable[t];
  }
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&s_full[s]), 1);
      mbar_init(smem_addr(&s_empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (n_blocks + kTile - 1) / kTile;
  if (warp == kConsumerWarps) {                          // producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        mbar_wait(smem_addr(&s_empty[stage]), phase ^ 1);
        const uint32_t full = smem_addr(&s_full[stage]);
        const uint32_t dst = smem_addr(s_in + stage * kStageBytes);
        mbar_expect_tx(full, kStageBytes);
        tma_load(dst, &levels_map, full, 0, tile * kTile);
        tma_load(dst + kBoxBytes, &levels_map, full, 32, tile * kTile);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  int stage = 0, buf = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile * kTile + t;
    const bool live = row < n_blocks;

    // levels -> dequantized Y, row-major y[u * 8 + v]
    float y[64];
    mbar_wait(smem_addr(&s_full[stage]), phase);
    const uint8_t* mine = s_in + stage * kStageBytes + t * 128;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int4 v = *reinterpret_cast<const int4*>(
            mine + h * kBoxBytes + ((j ^ (t & 7)) << 4));
        const int k = h * 32 + j * 4;
        y[k + 0] = float(v.x) * s_qt[k + 0];
        y[k + 1] = float(v.y) * s_qt[k + 1];
        y[k + 2] = float(v.z) * s_qt[k + 2];
        y[k + 3] = float(v.w) * s_qt[k + 3];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&s_empty[stage]));
    if (++stage == kStages) { stage = 0; phase ^= 1; }

    uint8_t* wout = s_out + buf * kOutBytes + warp * kWarpOutBytes;
    if (lane == 0)   // the store that last read this buffer is done reading
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    __syncwarp();
    if (live) {
      // row pass: Z[u][j] = sum_v Y[u][v] C[v][j], v ascending
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float z[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) z[j] = 0.f;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const float a = y[u * 8 + v];
          const float4 lo = s_c4[2 * v], hi = s_c4[2 * v + 1];
          const float c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) z[j] = fmaf(a, c[j], z[j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) y[u * 8 + j] = z[j];
      }
      // column pass: X[i][j] = sum_u C[u][i] Z[u][j], u ascending
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float b = y[u * 8 + j];
          const float4 lo = s_c4[2 * u], hi = s_c4[2 * u + 1];
          const float c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] = fmaf(c[i], b, x[i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i * 8 + j] = x[i];
      }
      // +128 after the sum, round half to even, clamp, pack 4 pixels a word
      uint32_t w[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fminf(fmaxf(rintf(y[4 * q + e] + 128.f), 0.f), 255.f);
          word |= uint32_t(p) << (8 * e);
        }
        w[q] = word;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint4*>(
            wout + lane * 64 + ((c ^ ((lane >> 1) & 3)) << 4)) =
            make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
    }
    // the generic-proxy writes above, then the async-proxy store
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    const int row0 = tile * kTile + warp * 32;
    if (lane == 0 && row0 < n_blocks)
      tma_store(&out_map, smem_addr(wout), 0, row0);
    buf ^= 1;
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ------------------------------------------------ B7: ed_requant_rungs

// A persistent grid of one wave (at most kRqMaxCtas CTAs) walks the
// [N, 64] levels as 16-byte chunks (four columns); the grid's stride is a
// multiple of 16 chunks, so each thread keeps one 4-column group, and its
// four qt_in and R x 4 rung-table entries stay in registers.  A thread
// issues kRqUnroll chunk loads before any arithmetic, then writes R
// 16-byte rung stores a chunk.  Nonzeros: per warp by
// __ballot_sync/__popc (all lanes take every trip: the loop's bound is
// warp-uniform and a lane past the end counts a zero chunk), per CTA into
// partials[cta * kRqMaxRungs + r], then the last CTA of one acq_rel
// ticket sums them and resets the ticket.
// ``scratch`` = ticket ++ partials[kRqMaxCtas * kRqMaxRungs].
template <int R>
__global__ void __launch_bounds__(kRqThreads)
requant_rungs_kernel(const int4* __restrict__ levels, int n_chunks,
                     const float* __restrict__ qt_in,
                     const float* __restrict__ qt_rungs,
                     int4* __restrict__ rungs, int* __restrict__ scratch,
                     int32_t* __restrict__ nonzeros) {
  __shared__ int s_count[kRqThreads / 32][R];
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int stride = int(gridDim.x) * kRqThreads;
  const int first = int(blockIdx.x) * kRqThreads + t;
  const int col = (first & 15) * 4;
  float qi[4], qr[R][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    qi[e] = qt_in[col + e];
#pragma unroll
    for (int r = 0; r < R; ++r) qr[r][e] = qt_rungs[r * 64 + col + e];
  }
  int count[R];
#pragma unroll
  for (int r = 0; r < R; ++r) count[r] = 0;
  const size_t plane = size_t(n_chunks);             // chunks of one rung
  for (int base = first - lane; base < n_chunks; base += kRqUnroll * stride) {
    int4 v[kRqUnroll];
#pragma unroll
    for (int u = 0; u < kRqUnroll; ++u) {
      const int i = base + lane + u * stride;
      v[u] = i < n_chunks ? __ldcs(levels + i) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kRqUnroll; ++u) {
      const int i = base + lane + u * stride;
      // coef = float(level) * qt_in, then the IEEE quotient and round half
      // to even: the plain version's ops, each rounded once (no reciprocal)
      const float c[4] = {__fmul_rn(__int2float_rn(v[u].x), qi[0]),
                          __fmul_rn(__int2float_rn(v[u].y), qi[1]),
                          __fmul_rn(__int2float_rn(v[u].z), qi[2]),
                          __fmul_rn(__int2float_rn(v[u].w), qi[3])};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int4 q = make_int4(__float2int_rn(__fdiv_rn(c[0], qr[r][0])),
                                 __float2int_rn(__fdiv_rn(c[1], qr[r][1])),
                                 __float2int_rn(__fdiv_rn(c[2], qr[r][2])),
                                 __float2int_rn(__fdiv_rn(c[3], qr[r][3])));
        if (i < n_chunks) __stcs(rungs + r * plane + i, q);
        count[r] += __popc(__ballot_sync(0xffffffffu, q.x != 0)) +
                    __popc(__ballot_sync(0xffffffffu, q.y != 0)) +
                    __popc(__ballot_sync(0xffffffffu, q.z != 0)) +
                    __popc(__ballot_sync(0xffffffffu, q.w != 0));
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) s_count[warp][r] = count[r];
  }
  __syncthreads();
  int* partials = scratch + 1;
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int sum = 0;
      for (int w = 0; w < kRqThreads / 32; ++w) sum += s_count[w][r];
      partials[blockIdx.x * kRqMaxRungs + r] = sum;
    }
    // one acq_rel atomic: it releases the partials before the arrival and,
    // for the last CTA, acquires every other CTA's
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(before) : "l"(scratch) : "memory");
    s_last = before == int(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last || warp != 0) return;
  // the last arrival: warp 0 sums each rung's partials (read from L2)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int sum = 0;
    for (int b = lane; b < int(gridDim.x); b += 32)
      sum += __ldcg(partials + b * kRqMaxRungs + r);
    sum = __reduce_add_sync(0xffffffffu, sum);
    if (lane == 0) nonzeros[r] = sum;
  }
  if (lane == 0) *scratch = 0;                 // ready for the next launch
}

// The CTAs of one wave on the current device (SMs x the kernel's
// occupancy, at most kRqMaxCtas), worked out once per device: a second,
// partial wave would leave SMs idle at the end.
template <int R>
int requant_wave(int* ctas) {
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
      &per_sm, requant_rungs_kernel<R>, kRqThreads, 0);
  if (err != cudaSuccess) return int(err);
  int n = sms * (per_sm > 0 ? per_sm : 1);
  if (n > kRqMaxCtas) n = kRqMaxCtas;
  if (dev < kMaxDevices) cached[dev] = n;
  *ctas = n;
  return 0;
}

template <int R>
int launch_requant(const void* levels, int n_chunks, const void* qt_in,
                   const void* qt_rungs, void* rungs, void* scratch,
                   void* nonzeros, cudaStream_t stream) {
  int wave = 0;
  const int rc = requant_wave<R>(&wave);
  if (rc != 0) return rc;
  const int per_cta = kRqThreads * kRqUnroll;
  int ctas = (n_chunks + per_cta - 1) / per_cta;
  if (ctas > wave) ctas = wave;
  if (const int rc2 = ed_timing::start(stream)) return rc2;
  requant_rungs_kernel<R><<<ctas, kRqThreads, 0, stream>>>(
      static_cast<const int4*>(levels), n_chunks,
      static_cast<const float*>(qt_in), static_cast<const float*>(qt_rungs),
      static_cast<int4*>(rungs), static_cast<int*>(scratch),
      static_cast<int32_t*>(nonzeros));
  return ed_timing::stop(stream, cudaGetLastError());
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, from the libcuda the CUDA runtime has loaded (no
// link-time dependency on libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A 2-D map over a row-major [rows, cols] tensor, boxes of [box_rows,
// box_cols]; out-of-bounds reads fill zeros, out-of-bounds writes drop.
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
              void* ptr, int rows, int cols, int box_rows, int box_cols,
              CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * elem_bytes};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = fn(map, type, 2, ptr, dims, strides, box, elem_strides,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kTensorMapError + int(rc);
}

// CTAs to launch: one per SM at the kernel's occupancy (its shared memory
// allows one), never more than there are tiles.  The shared-memory
// attribute and the count are set up once per device.
int max_ctas(int* ctas) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < kMaxDevices && cached[dev] > 0) {
    *ctas = cached[dev];
    return 0;
  }
  err = cudaFuncSetAttribute(decode_blocks_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return int(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decode_blocks_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return int(err);
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = n;
  *ctas = n;
  return 0;
}

}  // namespace

extern "C" {

int ed_decode_blocks(const void* levels, int n_blocks, const void* qtable,
                     const void* idct8, void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  int ctas = 0;
  int rc = max_ctas(&ctas);
  if (rc != 0) return rc;
  CUtensorMap levels_map, out_map;
  rc = encode_2d(&levels_map, CU_TENSOR_MAP_DATA_TYPE_INT32, 4,
                 const_cast<void*>(levels), n_blocks, 64, kTile, 32,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  rc = encode_2d(&out_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, out, n_blocks,
                 64, 32, 64, CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc != 0) return rc;
  const int n_tiles = (n_blocks + kTile - 1) / kTile;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((rc = ed_timing::start(st)) != 0) return rc;
  decode_blocks_kernel<<<n_tiles < ctas ? n_tiles : ctas, kThreads,
                         kSmemBytes, st>>>(
      levels_map, out_map, n_blocks, static_cast<const float*>(qtable),
      static_cast<const float*>(idct8));
  return ed_timing::stop(st, cudaGetLastError());
}

// B7's ladder requant: levels [n_blocks, 64] int32 (16-byte aligned),
// qt_in [64] and qt_rungs [n_rungs, 64] f32 -> rungs [n_rungs, n_blocks,
// 64] int32 (16-byte aligned) and nonzeros [n_rungs] int32.  ``scratch``
// holds 1 + kRqMaxCtas * kRqMaxRungs int32 whose first word is 0 (every
// launch leaves it at 0).  ONE launch.
int ed_requant_rungs(const void* levels, int n_blocks, const void* qt_in,
                     const void* qt_rungs, int n_rungs, void* rungs,
                     void* scratch, void* nonzeros, void* stream) {
  if (n_blocks < 1 || n_blocks > kRqMaxBlocks || n_rungs < 1 ||
      n_rungs > kRqMaxRungs ||
      ((reinterpret_cast<uintptr_t>(levels) |
        reinterpret_cast<uintptr_t>(rungs)) & 15) != 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launch = int (*)(const void*, int, const void*, const void*, void*,
                         void*, void*, cudaStream_t);
  static constexpr Launch kByRungs[kRqMaxRungs] = {
      launch_requant<1>, launch_requant<2>, launch_requant<3>,
      launch_requant<4>, launch_requant<5>, launch_requant<6>,
      launch_requant<7>, launch_requant<8>};
  return kByRungs[n_rungs - 1](levels, n_blocks * 16, qt_in, qt_rungs, rungs,
                               scratch, nonzeros, st);
}

// ed_requant_rungs's limits (ops/transform_kernel.py REQUANT_*): checked by
// chip_smoke.py against the Python side.
int ed_requant_geometry(int* max_rungs, int* max_blocks, int* max_ctas) {
  *max_rungs = kRqMaxRungs;
  *max_blocks = kRqMaxBlocks;
  *max_ctas = kRqMaxCtas;
  return 0;
}

// The ring's geometry on the current device: blocks per tile, stages, and
// the most CTAs a launch uses.  Returns a CUDA error code.
int ed_decode_blocks_geometry(int* tile_blocks, int* stages, int* ctas) {
  *tile_blocks = kTile;
  *stages = kStages;
  return max_ctas(ctas);
}

}  // extern "C"
