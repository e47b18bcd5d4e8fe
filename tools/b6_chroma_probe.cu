// Experiments on B6's chroma kernel, ed_h264_requant_chroma, built beside
// it by tools/b6_chroma_probe.py (never by the package).  This file takes
// the kernel's own source whole, so each variant below runs the product's
// code for every part it does not replace:
//   * copy: the product's per-warp rings (bulk loads, bulk stores) with no
//     arithmetic: each chunk leaves as it came;
//   * arith: the product's per-chunk requant with no device-memory
//     traffic: each warp loads its first chunk once, then requantizes it
//     in place as often as the product's warp takes chunks (the arms
//     depend on the QPs alone, so each pass does one chunk's work);
//   * separate: the product's rings with the arms as separate passes (a
//     warp with a general row runs the round trip, then its other rows
//     run the shift or the clip on their own), in place of the product's
//     shared last step;
//   * warp4: the product's kernel with four stages a ring (three CTAs an
//     SM) in place of three;
//   * tile: 64-row tiles a CTA (256 threads, four a row) through one ring
//     of three stages a CTA, thread 0 issuing every bulk copy, with a
//     barrier of the whole CTA around each tile;
//   * sorted: tile, with each tile's rows taken in arm order (identity,
//     shift, general; warp 0 orders them by ballots), so that a warp's
//     rows share an arm;
//   * early: tile, with thread 0 refilling the stage of tile i - 1 before
//     tile i's arithmetic (after its stores have read it).
// Entry: probe_chroma(variant, ...) with the product's arguments; variant
// 0 copy, 1 arith, 2 separate, 3 warp4, 4 tile, 5 sorted, 6 early.

#include "h264_kernels.cu"

namespace {

// ------------------------------------------------- the per-warp variants
__global__ void __launch_bounds__(kChromaThreads, kChromaCtasPerSm)
chroma_copy_kernel(const int* __restrict__ dc, const int* __restrict__ ac,
                   const int* __restrict__ qpc_in,
                   const int* __restrict__ qpc_out, int n,
                   int* __restrict__ dc_out, int* __restrict__ ac_out) {
  chroma_ring<kChromaStages>(dc, ac, qpc_in, qpc_out, n, dc_out, ac_out,
                             [](const ChromaChunk&, int) {});
}

__global__ void __launch_bounds__(kChromaThreads, 3)
chroma_warp4_kernel(const int* __restrict__ dc, const int* __restrict__ ac,
                    const int* __restrict__ qpc_in,
                    const int* __restrict__ qpc_out, int n,
                    int* __restrict__ dc_out, int* __restrict__ ac_out) {
  chroma_ring<4>(dc, ac, qpc_in, qpc_out, n, dc_out, ac_out,
                 [](const ChromaChunk& c, int lane) {
                   requant_block(c, lane >> 2, lane & 3);
                 });
}

__global__ void __launch_bounds__(kChromaThreads, kChromaCtasPerSm)
chroma_arith_kernel(const int* __restrict__ dc, const int* __restrict__ ac,
                    const int* __restrict__ qpc_in,
                    const int* __restrict__ qpc_out, int n,
                    int* __restrict__ dc_out, int* __restrict__ ac_out) {
  constexpr int R = kChromaChunkRows;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int tab[36];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t < 18) {
    tab[t] = kV[t / 3][t % 3];
    tab[18 + t] = kMF[t / 3][t % 3];
  }
  uint8_t* stage = smem + warp * kChromaStages * kChromaChunkBytes;
  int* s_ac = reinterpret_cast<int*>(stage);
  int* s_dc = reinterpret_cast<int*>(stage + R * 240);
  int* s_qi = reinterpret_cast<int*>(stage + R * 256);
  int* s_qo = s_qi + R;
  const int chunks = (n + R - 1) / R;
  const int first = blockIdx.x * kChromaWarps + warp;
  const int stride = gridDim.x * kChromaWarps;
  const int row0 = first * R;
  const int rows = first < chunks ? min(R, n - row0) : 0;
  for (int w = lane; w < rows * 60; w += 32)
    s_ac[w] = ac[size_t(row0) * 60 + w];
  for (int w = lane; w < rows * 4; w += 32)
    s_dc[w] = dc[size_t(row0) * 4 + w];
  if (lane < rows) {
    s_qi[lane] = qpc_in[row0 + lane];
    s_qo[lane] = qpc_out[row0 + lane];
  }
  __syncthreads();
  for (int c = first; c < chunks; c += stride) {
    requant_block(ChromaChunk{s_ac, s_dc, s_qi, s_qo, rows, tab}, lane >> 2,
                  lane & 3);
    __syncwarp();
  }
  for (int w = lane; w < rows * 60; w += 32)
    ac_out[size_t(row0) * 60 + w] = s_ac[w];
  for (int w = lane; w < rows * 4; w += 32)
    dc_out[size_t(row0) * 4 + w] = s_dc[w];
}

// The arms as separate passes: a warp with a general row runs the round
// trip and writes the general rows; then every other row shifts or clips.
__device__ __forceinline__ void general_pass(const RowArm& r, int b, int* ac,
                                             int* dc) {
  int w[16];
  w[0] = mul(hadamard4(clip(*dc, kLevelClip), b), r.vs[0]) >> 1;
#pragma unroll
  for (int j = 1; j < 16; ++j) {
    const int p = zigzag(j);
    w[p] = mul(clip(ac[j - 1], kLevelClip), r.vs[cls(p)]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    inv_core(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) inv_core(w[k], w[4 + k], w[8 + k], w[12 + k]);
#pragma unroll
  for (int p = 0; p < 16; ++p) w[p] = clip(add(w[p], 32) >> 6, kResClip);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    fwd_core(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) fwd_core(w[k], w[4 + k], w[8 + k], w[12 + k]);
#pragma unroll
  for (int p = 0; p < 16; ++p) w[p] = clip(w[p], kWClip);
  const int g = clip(hadamard4(w[0], b), kWClip);
  if (r.arm != 2) return;
  *dc = clip(round_shift(mul(g, r.mf[0]), r.qb1, r.off2), kLevelClip);
#pragma unroll
  for (int j = 1; j < 16; ++j) {
    const int p = zigzag(j);
    ac[j - 1] =
        clip(round_shift(mul(w[p], r.mf[cls(p)]), r.qb, r.off), kLevelClip);
  }
}

__device__ __forceinline__ void requant_separate(const ChromaChunk& c,
                                                 int row, int b) {
  const RowArm r = row_arm(c.qi[row], c.qo[row], row < c.rows, c.tab);
  int* ac = c.ac + row * 60 + 15 * b;
  int* dc = c.dc + row * 4 + b;
  if (__any_sync(0xffffffffu, r.arm == 2)) general_pass(r, b, ac, dc);
  if (r.arm == 1) {
    *dc = round_shift(clip(*dc, kLevelClip), r.kc, r.f6);
#pragma unroll
    for (int j = 0; j < 15; ++j)
      ac[j] = round_shift(clip(ac[j], kLevelClip), r.kc, r.f6);
  } else if (r.arm == 0) {
    *dc = clip(*dc, kLevelClip);
#pragma unroll
    for (int j = 0; j < 15; ++j) ac[j] = clip(ac[j], kLevelClip);
  }
}

__global__ void __launch_bounds__(kChromaThreads, kChromaCtasPerSm)
chroma_separate_kernel(const int* __restrict__ dc,
                       const int* __restrict__ ac,
                       const int* __restrict__ qpc_in,
                       const int* __restrict__ qpc_out, int n,
                       int* __restrict__ dc_out, int* __restrict__ ac_out) {
  chroma_ring<kChromaStages>(dc, ac, qpc_in, qpc_out, n, dc_out, ac_out,
                             [](const ChromaChunk& c, int lane) {
                               requant_separate(c, lane >> 2, lane & 3);
                             });
}

// ------------------------------------------------- the 64-row tile ring
constexpr int kTileRows = 64;
constexpr int kTileBytes = kTileRows * (240 + 16 + 2 * 4);
constexpr int kTileStages = 3;
constexpr int kTileSmem = kTileStages * kTileBytes;
static_assert(4 * kTileRows == kChromaThreads, "four threads a row");

// The product's body over a 64-row tile: thread t holds row t / 4.
__device__ __forceinline__ void requant_tile(const ChromaChunk& tile) {
  const int t = threadIdx.x;
  requant_block(tile, t >> 2, t & 3);
}

// The tile in arm order: warp 0 ranks the 64 rows (two a lane) by ballots.
__device__ __forceinline__ void requant_tile_sorted(const ChromaChunk& tile,
                                                    int* order) {
  const int t = threadIdx.x;
  if (t < 32) {
    const int r0 = t, r1 = t + 32;
    const int a0 = arm_of(tile.qi[r0], tile.qo[r0], r0 < tile.rows);
    const int a1 = arm_of(tile.qi[r1], tile.qo[r1], r1 < tile.rows);
    const unsigned lt = (1u << t) - 1;
    int base = 0, p0 = 0, p1 = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const unsigned m0 = __ballot_sync(0xffffffffu, a0 == a);
      const unsigned m1 = __ballot_sync(0xffffffffu, a1 == a);
      if (a0 == a) p0 = base + __popc(m0 & lt);
      if (a1 == a) p1 = base + __popc(m0) + __popc(m1 & lt);
      base += __popc(m0) + __popc(m1);
    }
    order[p0] = r0;
    order[p1] = r1;
  }
  __syncthreads();
  requant_block(tile, order[t >> 2], t & 3);
}

// CTA c takes tiles c, c + gridDim.x, ...  Thread 0 loads the first tiles
// into every stage; it refills the stage of tile i - 1 with tile i - 1 +
// kTileStages after it has issued tile i's stores (kEarly: before tile
// i's arithmetic), once tile i - 1's stores have read it.
template <bool kEarly, class Body>
__device__ __forceinline__ void tile_ring(
    const int* __restrict__ dc, const int* __restrict__ ac,
    const int* __restrict__ qpc_in, const int* __restrict__ qpc_out, int n,
    int* __restrict__ dc_out, int* __restrict__ ac_out, Body body) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kTileStages];
  __shared__ int tab[36];
  const int t = threadIdx.x;
  if (t < 18) {
    tab[t] = kV[t / 3][t % 3];
    tab[18 + t] = kMF[t / 3][t % 3];
  }
  const int tiles = (n + kTileRows - 1) / kTileRows;
  auto load = [&](int s, int tile) {
    load_rows(smem + s * kTileBytes, smem_addr(&full[s]), dc, ac, qpc_in,
              qpc_out, tile * kTileRows, min(kTileRows, n - tile * kTileRows),
              kTileRows);
  };
  if (t == 0) {
    for (int s = 0; s < kTileStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kTileStages; ++s)
      if (blockIdx.x + s * gridDim.x < tiles)
        load(s, blockIdx.x + s * gridDim.x);
  }
  __syncthreads();
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    const int s = i % kTileStages;
    uint8_t* stage = smem + s * kTileBytes;
    const int row0 = tile * kTileRows;
    const int rows = min(kTileRows, n - row0);
    int* s_ac = reinterpret_cast<int*>(stage);
    int* s_dc = reinterpret_cast<int*>(stage + kTileRows * 240);
    int* s_qi = reinterpret_cast<int*>(stage + kTileRows * 256);
    int* s_qo = s_qi + kTileRows;
    const int next = tile + (kTileStages - 1) * gridDim.x;
    if (kEarly && t == 0 && i > 0 && next < tiles) {
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      load((i - 1) % kTileStages, next);
    }
    mbar_wait(smem_addr(&full[s]), (i / kTileStages) & 1);
    if (rows & 3) {
      const int q = (rows & ~3) + t;
      if (q < rows) {
        s_qi[q] = qpc_in[row0 + q];
        s_qo[q] = qpc_out[row0 + q];
      }
      __syncthreads();
    }
    body(ChromaChunk{s_ac, s_dc, s_qi, s_qo, rows, tab});
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (t == 0) {
      bulk_store(ac_out + size_t(row0) * 60, s_ac, uint32_t(rows) * 240);
      bulk_store(dc_out + size_t(row0) * 4, s_dc, uint32_t(rows) * 16);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (!kEarly && i > 0 && next < tiles) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load((i - 1) % kTileStages, next);
      }
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(kChromaThreads, kChromaCtasPerSm)
chroma_tile_kernel(const int* __restrict__ dc, const int* __restrict__ ac,
                   const int* __restrict__ qpc_in,
                   const int* __restrict__ qpc_out, int n,
                   int* __restrict__ dc_out, int* __restrict__ ac_out) {
  tile_ring<false>(dc, ac, qpc_in, qpc_out, n, dc_out, ac_out,
                   [](const ChromaChunk& tile) { requant_tile(tile); });
}

__global__ void __launch_bounds__(kChromaThreads, kChromaCtasPerSm)
chroma_sorted_kernel(const int* __restrict__ dc, const int* __restrict__ ac,
                     const int* __restrict__ qpc_in,
                     const int* __restrict__ qpc_out, int n,
                     int* __restrict__ dc_out, int* __restrict__ ac_out) {
  __shared__ int order[kTileRows];
  int* ranks = order;
  tile_ring<false>(dc, ac, qpc_in, qpc_out, n, dc_out, ac_out,
                   [ranks](const ChromaChunk& tile) {
                     requant_tile_sorted(tile, ranks);
                   });
}

__global__ void __launch_bounds__(kChromaThreads, kChromaCtasPerSm)
chroma_early_kernel(const int* __restrict__ dc, const int* __restrict__ ac,
                    const int* __restrict__ qpc_in,
                    const int* __restrict__ qpc_out, int n,
                    int* __restrict__ dc_out, int* __restrict__ ac_out) {
  tile_ring<true>(dc, ac, qpc_in, qpc_out, n, dc_out, ac_out,
                  [](const ChromaChunk& tile) { requant_tile(tile); });
}

using ChromaKernel = void (*)(const int*, const int*, const int*, const int*,
                              int, int*, int*);
constexpr int kNumVariants = 7;
const ChromaKernel kVariants[kNumVariants] = {
    chroma_copy_kernel,  chroma_arith_kernel, chroma_separate_kernel,
    chroma_warp4_kernel, chroma_tile_kernel,  chroma_sorted_kernel,
    chroma_early_kernel};
// each variant's dynamic shared memory
constexpr int kVariantSmem[kNumVariants] = {
    kChromaSmem, kChromaSmem, kChromaSmem,
    kChromaWarps * 4 * kChromaChunkBytes, kTileSmem, kTileSmem, kTileSmem};
// rows a CTA takes at once (every variant: 64)
constexpr int kCtaRows = kChromaWarps * kChromaChunkRows;
static_assert(kCtaRows == kTileRows, "one grid rule for every variant");

}  // namespace

extern "C" {

// CTAs an SM of variant v (-1: the product's kernel) at its shared
// memory, after opting it in.
int probe_occupancy(int v, int* per_sm) {
  const ChromaKernel k = v < 0 ? h264_requant_chroma_kernel : kVariants[v];
  const int smem = v < 0 ? kChromaSmem : kVariantSmem[v];
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, k, kChromaThreads, smem));
}

// One launch of variant v over the product's arguments: a wave of the
// variant's CTAs (its occupancy), at most one CTA a 64 rows.
int probe_chroma(int v, const void* dc, const void* ac, const void* qpc_in,
                 const void* qpc_out, int n, void* dc_out, void* ac_out,
                 void* stream) {
  static int per_sm[kNumVariants] = {0};          // one card a process
  static int sms = 0;
  if (v < 0 || v >= kNumVariants || n <= 0) return int(cudaErrorInvalidValue);
  if (per_sm[v] == 0) {
    const int rc = probe_occupancy(v, &per_sm[v]);
    if (rc != 0) return rc;
    if (per_sm[v] == 0) return int(cudaErrorInvalidConfiguration);
    const cudaError_t e = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, 0);
    if (e != cudaSuccess) return int(e);
  }
  const int ctas = sms * per_sm[v];
  const int need = (n + kCtaRows - 1) / kCtaRows;
  kVariants[v]<<<need < ctas ? need : ctas, kChromaThreads, kVariantSmem[v],
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dc), static_cast<const int*>(ac),
      static_cast<const int*>(qpc_in), static_cast<const int*>(qpc_out), n,
      static_cast<int*>(dc_out), static_cast<int*>(ac_out));
  return int(cudaGetLastError());
}

// The product's geometry: rows a warp's chunk, threads a CTA, stages a
// ring, bytes of dynamic shared memory a CTA.
int probe_geometry(int* rows, int* threads, int* stages, int* smem) {
  *rows = kChromaChunkRows;
  *threads = kChromaThreads;
  *stages = kChromaStages;
  *smem = kChromaSmem;
  return 0;
}

}  // extern "C"
