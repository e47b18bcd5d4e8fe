// Hand-written Hopper kernels of the live relay path (sm_90a).
//
// Built by ops/kernel_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into build/easydarwin_tpu_torch/ and bound with ctypes: plain C entry
// points taking pointers, sizes, strides and the caller's stream.  Each
// entry point launches on that stream, never synchronises, allocates
// nothing, and returns a cudaError_t so the Python wrapper can raise on a
// refused launch.
//
// What these replace
//   * ed_parse_packets (K1) replaces the Pallas kernel
//     easydarwin_tpu/ops/parse_pallas.py:_kernel / parse_packets_pallas:
//     [P, W>=96] uint8 prefixes + [P] int32 lengths -> words [P,4] uint32
//     (seq, timestamp, ssrc, payload_start) and flags [P,5] int32
//     (nal_type, keyframe_first, frame_first, frame_last, marker).
//   * ed_relay_window replaces the XLA pass
//     easydarwin_tpu/ops/fanout.py:relay_affine_step_window (the megabatch
//     window step) with K1's parse fused in: [B, P, W>=100] uint8 rows
//     (96-byte prefix + le32 length) and [B, S, 6] uint32 subscriber state
//     -> [B, 4*S+1] uint32 (seq_off | ts_off | ssrc | chan | newest_kf),
//     for every shape bucket of a scheduler wake in ONE launch.
//   * ed_ring_query replaces the XLA pass
//     easydarwin_tpu/ops/device_ring.py:66 query, whose parse is K1's
//     function: K1's parse of every row of a stream's resident ring
//     [C, 100] uint8, keyframe_first & valid under the ring's absolute-id
//     mapping, the max absolute id over those rows, and the affine emit of
//     S subscribers -> [4*S+1] uint32.  At C = 4096 it reads 409.6 KB
//     (0.12 us at 3.35 TB/s), so it is bound by latency like the others:
//     ONE kernel node per query (the window kernel cannot take it: a
//     4,096-row stream row needs 51,200 B of shared memory per CTA of a
//     cluster of 8, and its newest keyframe is a row index, where a
//     wrapped ring needs the newest absolute id).
//   * ed_relay_batch replaces the XLA pass
//     easydarwin_tpu/ops/fanout.py:212 relay_batch_step (B9, the batch-
//     header rung's step, K1's parse inside): [P, W>=96] uint8 prefixes,
//     [P] int32 lengths and ages, [S, 6] uint32 state and [S] int32 delay
//     buckets -> headers [S, P, 12] uint8 (bytes 0-1 the source's, seq and
//     ts rewritten big-endian mod 2^16 and 2^32, the output's SSRC), the
//     [S, P] mask (bucket-eligible and length >= 12), keyframe_first and
//     frame_last [P] and the newest keyframe (-1 = none).  At phase 7c's
//     pass (P = 47, S = 16) it moves 15 KB: bound by latency, like the
//     others; at P = S = 256 its 852 KB of headers and mask are most of
//     its bytes.  It is ONE launch of ed_relay_shard's kernel as its
//     one-source, one-shard case: a CTA parses a 64-row tile once for
//     kBatchSubsPerCta outputs, writes their spans as 16-byte stores, and
//     the newest keyframe meets in one self-resetting 64-bit word.
//   * ed_relay_shard replaces the XLA pass
//     easydarwin_tpu/parallel/mesh.py:80 _local_step (B8's per-shard step
//     of sharded_relay_step, :110): B9's function over a shard's block of
//     sources, with the reference's mask (eligible and length > 0),
//     keyframe indices offset by the shard's packet base along ``win``, and
//     strided views in and out, so a shard reads its block where it lies
//     and writes straight into its block of the whole result.  It writes
//     [N, S, P, 12] headers and an [N, S, P] mask, 13 bytes an (output,
//     packet): 96% of its bytes at config 4, so it is bound by its
//     stores.  ONE launch a device takes every shard of that device
//     (descriptors in a __grid_constant__ struct); a CTA parses a 64-row
//     tile once for 64 outputs and writes their spans as 16-byte stores;
//     the newest keyframe of each source (maxed over its ``win`` shards)
//     and the sum of the eligible sends are written, not folded into, by
//     the last CTA of each source and of the launch, through
//     self-resetting atomic words.
//
// Why the TPU's trick is dropped
//   The TPU kernel avoids per-row dynamic gathers by building each byte at
//   12 + 4*CC + delta from 16 masked static column slices
//   (parse_pallas.py:30-38), because Mosaic lowers that to vector selects.
//   On Hopper one thread owns one packet and indexes its own row, which
//   sits in shared memory.
//
// What bounds them
//   At the megabatch's config-4 size (16 streams x 256 packets x 256
//   subscribers) the window pass reads 16*256*100 B = 410 KB of rows plus
//   16*256*24 B = 98 KB of state and writes 16*1025*4 B = 66 KB: 0.17 us
//   at 3.35 TB/s.  A scheduler wake's buckets are smaller still, and K1 on
//   the main path parses 256 rows.  The arithmetic is a few dozen integer
//   ops per packet.  So both kernels are bound by latency: the launch, and
//   inside it the chain of dependent memory round trips per packet
//   (row[0] -> row[hs] -> the inner NAL byte), not by bytes or operations.
//
// What the design does about that
//   * One launch per wake: ed_relay_window takes up to kMaxBuckets bucket
//     descriptors by value (a __grid_constant__ struct), so every bucket of
//     a wake shares one launch; a cluster finds its bucket by a short scan.
//   * One thread-block cluster per stream row, C = min(8, max(1, P_max/64))
//     CTAs (the launch plan of ops/fanout.py:window_launch_plan, which this
//     file computes by the same formulas).  CTA rank r takes rows
//     [r*P/C, (r+1)*P/C) and subscribers [r*S/C, (r+1)*S/C), so a stream's
//     rows are pulled by C SMs at once.
//   * Rows come into shared memory by ONE bulk asynchronous copy
//     (cp.async.bulk ... mbarrier::complete_tx) of the 16-byte-aligned
//     interior of the CTA's byte span, issued by one elected thread; the
//     at most 15 head and 15 tail bytes outside it are plain loads by the
//     other threads.  One code path serves ragged P and W and unaligned
//     views.  The buffer keeps the global address's offset mod 16, so byte
//     i of the span is buf[i] whatever the alignment.
//   * The subscriber emit does not depend on the rows: it runs while the
//     copy is in flight, and only then do the threads wait on the mbarrier.
//   * The parse reads shared memory, and issues every peek that may be
//     needed (row[hs + 0/1/3/5/8/9]) at once after row[0], so a packet
//     costs two dependent shared-memory latencies.
//   * The newest keyframe: __reduce_max_sync in a warp, a shared-memory max
//     across warps, and across the cluster each rank stores its partial
//     max into rank 0's shared memory through distributed shared memory;
//     after ONE cluster barrier rank 0 reduces them.  (Rank 0 pulling the
//     partials between two barriers measured slower on the H100: every
//     cluster barrier and every serial remote load is latency.)
//   * K1 runs the same parse on 64-row tiles brought in by the same bulk
//     copy; it writes words as one 16-byte store a row, and stages flags in
//     shared memory so the CTA writes them with coalesced 4-byte stores.
//   * ed_ring_query is one launch of tile CTAs and nothing else: no memset
//     node before it, no emit CTAs beside it.  Each tile CTA issues its
//     rows' bulk copy, writes its share of the S subscribers' affine
//     columns while the copy is in flight, then parses its rows.  The
//     newest keyframe is a last-CTA fold that resets itself: each CTA
//     stores its partial max into partials[tile] of a per-ring scratch
//     (n_tiles + 1 int32, zeroed once when the ring is made) and makes ONE
//     acq_rel atomic add on the arrival counter scratch[n_tiles] (it
//     releases the partial, and for the last CTA acquires the others', in
//     place of two full fences around a relaxed atomic); warp 0 of the CTA
//     that draws n_tiles - 1 reduces the partials, writes out[4*S] exactly
//     once and stores 0 back into the counter, so the next query, or the
//     next replay of a CUDA graph, needs no host step.  This needs the queries
//     of one ring to be ordered on one stream, as the engine's are.  Tiles
//     of kRingTileRows = 128 rows (K1's parse_row and bulk_fetch as they
//     are): 128 timed faster than 64 or 256, and than one non-portable
//     cluster of 16 CTAs reducing over distributed shared memory (PERF.md).

#include <atomic>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch_timing.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kParsePrefix = 96;       // PARSE_PREFIX: where the le32 length sits
constexpr int kWindowExtra = 4;        // the le32 length
constexpr int kMinClassifyLen = 20;    // the reflector's classify floor
constexpr int kStateCols = 6;          // ssrc, base_seq, base_ts, seq0, ts0, chan
constexpr int kFlagCols = 5;
constexpr int kBulkAlign = 16;         // cp.async.bulk: address and size
// dynamic shared memory a launch may ask for without an opt-in (48 KB less
// room for the kernels' static shared memory)
constexpr int kDynSmemLimit = 48 * 1024 - 2048;
// ed_relay_window opts into Hopper's large shared memory: 227 KB a block
// (232,448 B), less 1 KB for its static shared memory.  A VOD prime stacks
// whole cached windows, up to 16,384 rows of 100 B at a cluster of 8
// (204,816 B a CTA).  ops/kernel_lib.py WINDOW_SMEM_LIMIT is this value.
constexpr int kWindowSmemLimit = 227 * 1024 - 1024;

constexpr int kWindowThreads = 128;
constexpr int kWindowWarps = kWindowThreads / 32;
constexpr int kEmitPerThread = 2;      // subscribers a window thread emits
constexpr int kMaxBuckets = 32;
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kTileRows = 64;          // K1: rows (and threads) per CTA
constexpr int kRingTileRows = 128;     // ed_ring_query: rows (and threads) per CTA
constexpr int kShardTileRows = 64;     // ed_relay_shard: rows a CTA parses
constexpr int kShardSubsPerCta = 64;   // outputs a CTA renders from them
constexpr int kShardThreads = 256;
constexpr int kShardMaxShards = 16;    // shard descriptors a launch
constexpr int kShardMaxSlots = 4096;   // sources a launch folds
constexpr int kBatchTileRows = 64;     // ed_relay_batch: rows a CTA parses
constexpr int kBatchSubsPerCta = 4;    // outputs a CTA renders from them
constexpr int kBatchMaxPkts = 1 << 16;
constexpr int kBatchMaxSubs = 1 << 16;
constexpr int kBatchScratchWords = 2;  // the 64-bit keyframe word

// head + tail bytes are at most 2 * 15 (an empty interior means a span of
// at most 30 bytes); threads 1.. load them, one byte each
static_assert(kWindowThreads - 1 >= 2 * (kBulkAlign - 1), "head/tail loaders");
static_assert(kTileRows - 1 >= 2 * (kBulkAlign - 1), "head/tail loaders");
static_assert(kRingTileRows - 1 >= 2 * (kBulkAlign - 1), "head/tail loaders");
static_assert(kShardThreads - 1 >= 2 * (kBulkAlign - 1), "head/tail loaders");

struct Parsed {
  uint32_t seq, ts, ssrc, hs;
  int32_t nal, kf, ff, fl, marker;
};

// K1's fields for one packet.  ``row`` holds at least kParsePrefix bytes;
// the deepest peek is 12 + 4*15 + 9 = 81 < 96, so no read leaves the row
// whatever the packet's length (the length only gates what a peek means).
// Every peek is issued before any is used: row[0] gives hs, then the six
// payload bytes come in parallel.
__device__ __forceinline__ Parsed parse_row(const uint8_t* row,
                                            int32_t length) {
  Parsed o;
  const int b0 = row[0];
  const int b1 = row[1];
  const int hs = 12 + 4 * (b0 & 0x0F);
  const uint8_t* pl = row + hs;
  const int p0 = pl[0], p1 = pl[1], p3 = pl[3], p5 = pl[5], p8 = pl[8],
            p9 = pl[9];
  o.seq = (uint32_t(row[2]) << 8) | uint32_t(row[3]);
  o.ts = (uint32_t(row[4]) << 24) | (uint32_t(row[5]) << 16) |
         (uint32_t(row[6]) << 8) | uint32_t(row[7]);
  o.ssrc = (uint32_t(row[8]) << 24) | (uint32_t(row[9]) << 16) |
           (uint32_t(row[10]) << 8) | uint32_t(row[11]);
  o.hs = uint32_t(hs);
  const bool marker = (b1 & 0x80) != 0;
  const bool classifiable = length >= kMinClassifyLen && length > hs;
  const int nal0 = p0 & 0x1F;
  int eff = nal0;
  // STAP-A/B, MTAP16/24: the first aggregated NAL's header byte
  const int off = nal0 == 24 ? 3 : nal0 == 25 ? 5 : nal0 == 26 ? 8
                : nal0 == 27 ? 9 : 0;
  const int inner = nal0 == 24 ? p3 : nal0 == 25 ? p5 : nal0 == 26 ? p8 : p9;
  if (off != 0 && length > hs + off) eff = inner & 0x1F;
  // FU-A/B: the fragmented NAL's type, only on the start fragment
  const bool fu_start = (nal0 == 28 || nal0 == 29) && length > hs + 1 &&
                        (p1 & 0x80) != 0;
  if (fu_start) eff = p1 & 0x1F;
  if (!classifiable) eff = -1;
  o.nal = eff;
  o.kf = classifiable && (eff == 5 || eff == 7 || eff == 8);
  o.ff = classifiable && ((nal0 >= 1 && nal0 <= 27) || fu_start);
  o.fl = length >= kMinClassifyLen && marker;
  o.marker = marker;
  return o;
}

__device__ __forceinline__ int32_t le32(const uint8_t* p) {
  return int32_t(uint32_t(p[0]) | (uint32_t(p[1]) << 8) |
                 (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24));
}

// A byte span [addr, addr + nbytes) cut into a head, a 16-byte-aligned
// interior (a multiple of 16, what one bulk copy moves) and a tail
// (kernel_lib.bulk_split is the same rule).
struct BulkSpan {
  uint32_t head, interior, tail;
};

__host__ __device__ __forceinline__ BulkSpan bulk_split(uintptr_t addr,
                                                        uint32_t nbytes) {
  const uintptr_t lo = (addr + kBulkAlign - 1) & ~uintptr_t(kBulkAlign - 1);
  const uintptr_t hi = (addr + nbytes) & ~uintptr_t(kBulkAlign - 1);
  if (hi <= lo) return {nbytes, 0u, 0u};
  return {uint32_t(lo - addr), uint32_t(hi - lo), uint32_t(addr + nbytes - hi)};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Bring the span [src, src + nbytes) into buf (buf keeps src's offset mod
// 16, so buf[i] == src[i]).  Thread 0 initialises the mbarrier and issues
// one bulk copy of the aligned interior; threads 1.. load the head and
// tail bytes.  Returns whether the caller must wait on ``bar`` (phase 0)
// after a __syncthreads.
__device__ __forceinline__ bool bulk_fetch(uint8_t* buf, const uint8_t* src,
                                           uint32_t nbytes, uint64_t* bar) {
  const BulkSpan sp = bulk_split(reinterpret_cast<uintptr_t>(src), nbytes);
  const int t = threadIdx.x;
  if (t == 0 && sp.interior != 0) {
    const uint32_t b = smem_addr(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(sp.interior) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_addr(buf + sp.head)), "l"(src + sp.head),
           "r"(sp.interior), "r"(b) : "memory");
  }
  const int i = t - 1;
  if (i >= 0 && i < int(sp.head + sp.tail)) {
    const uint32_t at = i < int(sp.head) ? uint32_t(i)
                                         : nbytes - sp.tail + (i - sp.head);
    buf[at] = src[at];
  }
  return sp.interior != 0;
}

// The affine columns of subscribers [lo, hi) of ``st`` [n_subs, 6] into
// ``o`` [4 * n_subs + 1] by kThreads threads, kEmitPerThread subscribers a
// thread with every state word loaded before any store: one memory round
// trip for up to kEmitPerThread * kThreads subscribers.  State columns:
// ssrc, base_seq, base_ts, seq0, ts0, chan.
template <int kThreads>
__device__ __forceinline__ void emit_affine(const uint32_t* __restrict__ st,
                                            int n_subs, int lo, int hi,
                                            uint32_t* __restrict__ o) {
  for (int s0 = lo + int(threadIdx.x); s0 < hi;
       s0 += kEmitPerThread * kThreads) {
    uint32_t sv[kEmitPerThread][kStateCols];
#pragma unroll
    for (int j = 0; j < kEmitPerThread; ++j) {
      const int s = s0 + j * kThreads;
#pragma unroll
      for (int c = 0; c < kStateCols; ++c)
        sv[j][c] = s < hi ? st[size_t(s) * kStateCols + c] : 0u;
    }
#pragma unroll
    for (int j = 0; j < kEmitPerThread; ++j) {
      const int s = s0 + j * kThreads;
      if (s < hi) {
        o[s] = (sv[j][3] - sv[j][1]) & 0xFFFFu;  // seq_off (mod 2^16)
        o[n_subs + s] = sv[j][4] - sv[j][2];     // ts_off (mod 2^32)
        o[2 * n_subs + s] = sv[j][0];            // ssrc
        o[3 * n_subs + s] = sv[j][5];            // interleave channel
      }
    }
  }
}

// The max of ``v`` over a CTA of kThreads threads, in every thread
// (``s_warp`` holds kThreads / 32 ints; the caller's next write to it must
// follow a __syncthreads).
template <int kThreads>
__device__ __forceinline__ int block_max(int v, int* s_warp) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = -1;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = max(m, s_warp[w]);
  return m;
}

// Ring slot -> absolute id: head - ((head - slot - 1) mod C) - 1; a slot
// the ring never wrote maps below 0.
__device__ __forceinline__ int ring_abs_id(int head, int slot, int capacity) {
  int m = (head - slot - 1) % capacity;
  if (m < 0) m += capacity;
  return head - m - 1;
}

// The abs id of ring row ``row`` (slot ``slot``) if it is a valid
// keyframe-first packet, else -1.
__device__ __forceinline__ int ring_row_best(const uint8_t* row, int slot,
                                             int head, int capacity) {
  const int32_t len = le32(row + kParsePrefix);
  const int abs_id = ring_abs_id(head, slot, capacity);
  return len > 0 && abs_id >= 0 && parse_row(row, len).kf ? abs_id : -1;
}

// ------------------------------------------------------------------ K1

__global__ void __launch_bounds__(kTileRows)
parse_packets_kernel(const uint8_t* __restrict__ prefix, int n_rows,
                     int row_stride, const int32_t* __restrict__ length,
                     uint4* __restrict__ words, int32_t* __restrict__ flags) {
  extern __shared__ __align__(16) uint8_t s_tile[];
  __shared__ uint64_t s_bar;
  __shared__ int32_t s_flags[kTileRows * kFlagCols];
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, n_rows - row0);
  const uint8_t* src = prefix + size_t(row0) * row_stride;
  uint8_t* buf = s_tile + (reinterpret_cast<uintptr_t>(src) & (kBulkAlign - 1));
  const bool wait = bulk_fetch(buf, src, uint32_t(rows) * row_stride, &s_bar);
  const int32_t len = t < rows ? length[row0 + t] : 0;    // coalesced
  __syncthreads();
  if (wait) mbar_wait(smem_addr(&s_bar), 0);
  if (t < rows) {
    const Parsed p = parse_row(buf + size_t(t) * row_stride, len);
    words[row0 + t] = make_uint4(p.seq, p.ts, p.ssrc, p.hs);
    int32_t* f = s_flags + t * kFlagCols;
    f[0] = p.nal;
    f[1] = p.kf;
    f[2] = p.ff;
    f[3] = p.fl;
    f[4] = p.marker;
  }
  __syncthreads();
  int32_t* out = flags + size_t(row0) * kFlagCols;
  for (int j = t; j < rows * kFlagCols; j += kTileRows) out[j] = s_flags[j];
}

// ------------------------------------------------------------- window

// One shape bucket of a grouped window launch (ops/fanout.py
// WindowBucketDesc has the same layout).
struct WindowBucket {
  const uint8_t* window;     // [n_streams, n_pkts, row_stride] uint8
  const uint32_t* state;     // [n_streams, n_subs, kStateCols] uint32
  uint32_t* out;             // [n_streams, 4 * n_subs + 1] uint32
  int n_streams, n_pkts, row_stride, n_subs;
  int first_cluster;         // clusters of earlier buckets in the launch
  int pad;
};

struct WindowLaunch {
  WindowBucket bucket[kMaxBuckets];
  int n_buckets;
};

static_assert(sizeof(WindowBucket) == 48, "WindowBucketDesc layout");
static_assert(sizeof(WindowLaunch) < 4096, "kernel parameter space");

// One cluster per stream row of one bucket.  Phase 1 (no dependence on the
// rows): bulk copy in flight, the subscribers' affine columns written.
// Phase 2: parse the CTA's rows from shared memory and keep the newest
// keyframe-first row; phase 3: reduce it over the warp, the CTA and the
// cluster; rank 0 writes newest_kf.  When the launch's cluster size is
// above 1 this costs a cluster barrier; the split is what keeps a CTA's
// rows within 48 KB of shared memory at MAX_STAGE_ROWS, and within
// kWindowSmemLimit for a VOD window of 16,384 rows.
__global__ void __launch_bounds__(kWindowThreads)
relay_window_kernel(const __grid_constant__ WindowLaunch launch) {
  extern __shared__ __align__(16) uint8_t s_rows[];
  __shared__ uint64_t s_bar;
  __shared__ int s_warp_best[kWindowWarps];
  __shared__ int s_rank_best[kMaxCluster];     // rank 0's: every rank's max

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int cluster_id = blockIdx.x / n_ranks;
  int k = 0;
  while (k + 1 < launch.n_buckets &&
         cluster_id >= launch.bucket[k + 1].first_cluster)
    ++k;
  const WindowBucket& bk = launch.bucket[k];
  const int b = cluster_id - bk.first_cluster;
  const int n_pkts = bk.n_pkts, stride = bk.row_stride, n_subs = bk.n_subs;
  const int row_lo = rank * n_pkts / n_ranks;
  const int row_hi = (rank + 1) * n_pkts / n_ranks;
  const int sub_lo = rank * n_subs / n_ranks;
  const int sub_hi = (rank + 1) * n_subs / n_ranks;
  const int t = threadIdx.x;

  const uint8_t* src = bk.window + (size_t(b) * n_pkts + row_lo) * stride;
  uint8_t* buf = s_rows + (reinterpret_cast<uintptr_t>(src) & (kBulkAlign - 1));
  const bool wait =
      bulk_fetch(buf, src, uint32_t(row_hi - row_lo) * stride, &s_bar);

  const uint32_t* __restrict__ st = bk.state + size_t(b) * n_subs * kStateCols;
  uint32_t* __restrict__ o = bk.out + size_t(b) * (4 * size_t(n_subs) + 1);
  emit_affine<kWindowThreads>(st, n_subs, sub_lo, sub_hi, o);
  __syncthreads();                             // mbarrier init, head/tail bytes
  if (wait) mbar_wait(smem_addr(&s_bar), 0);

  int best = -1;
  for (int p = t; p < row_hi - row_lo; p += kWindowThreads) {
    const uint8_t* row = buf + size_t(p) * stride;
    const int32_t len = le32(row + kParsePrefix);
    const Parsed q = parse_row(row, len);
    // padding rows carry length 0: never valid, never a keyframe
    if (q.kf && len > 0) best = row_lo + p;   // p grows: last hit is max
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if ((t & 31) == 0) s_warp_best[t >> 5] = best;
  __syncthreads();
  if (t == 0) {
    int m = -1;
    for (int w = 0; w < kWindowWarps; ++w) m = max(m, s_warp_best[w]);
    if (n_ranks == 1)
      o[4 * size_t(n_subs)] = uint32_t(m);     // -1 rides as 0xFFFFFFFF
    else                                       // into rank 0's shared memory
      *cluster.map_shared_rank(&s_rank_best[rank], 0) = m;
  }
  if (n_ranks == 1) return;
  // every rank's max is in rank 0's shared memory; after this barrier no
  // CTA touches another's shared memory, so the others may exit
  cluster.sync();
  if (rank == 0 && t == 0) {
    int m = -1;
    for (int r = 0; r < n_ranks; ++r) m = max(m, s_rank_best[r]);
    o[4 * size_t(n_subs)] = uint32_t(m);
  }
}

// -------------------------------------------------------- ring query

// One launch per per-stream query over the whole resident ring: one CTA
// per kRingTileRows-row tile, one thread per row, gridDim.x = n_tiles.
// Phase 1 (no dependence on the rows): the tile's bulk copy in flight, the
// CTA's share of the subscribers' affine columns written.  Phase 2: parse the
// tile from shared memory, the CTA's max over the absolute ids of its
// valid keyframe-first rows into partials[tile], then the arrival.  The
// last arrival folds every partial into out[4 * n_subs] and resets the
// counter.  ``scratch`` = partials[n_tiles] ++ arrival counter, which is 0
// between queries.
__global__ void __launch_bounds__(kRingTileRows)
ring_query_kernel(const uint8_t* __restrict__ rows, int capacity,
                  int row_stride, int head, const uint32_t* __restrict__ state,
                  int n_subs, int* __restrict__ scratch,
                  uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t s_tile[];
  __shared__ uint64_t s_bar;
  __shared__ int s_warp_best[kRingTileRows / 32];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int row0 = tile * kRingTileRows;
  const int rows_here = min(kRingTileRows, capacity - row0);
  const uint8_t* src = rows + size_t(row0) * row_stride;
  uint8_t* buf = s_tile + (reinterpret_cast<uintptr_t>(src) & (kBulkAlign - 1));
  const bool wait =
      bulk_fetch(buf, src, uint32_t(rows_here) * row_stride, &s_bar);
  emit_affine<kRingTileRows>(state, n_subs,
                             int(int64_t(tile) * n_subs / n_tiles),
                             int(int64_t(tile + 1) * n_subs / n_tiles), out);
  __syncthreads();                             // mbarrier init, head/tail bytes
  if (wait) mbar_wait(smem_addr(&s_bar), 0);

  int* partials = scratch;
  int* arrivals = scratch + n_tiles;
  const int mine = t < rows_here ? ring_row_best(buf + size_t(t) * row_stride,
                                                 row0 + t, head, capacity)
                                  : -1;
  const int best = block_max<kRingTileRows>(mine, s_warp_best);
  if (t == 0) {
    partials[tile] = best;
    // one acq_rel atomic: it releases the partial before the arrival and,
    // for the last CTA, acquires every other CTA's partial
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(before) : "l"(arrivals) : "memory");
    s_last = before == n_tiles - 1;
  }
  __syncthreads();                             // s_last
  if (!s_last || t >= 32) return;
  // the last arrival: warp 0 folds the partials (read from L2)
  int m = -1;
  for (int i = t; i < n_tiles; i += 32) m = max(m, __ldcg(partials + i));
  m = __reduce_max_sync(0xffffffffu, m);
  if (t == 0) {
    out[4 * size_t(n_subs)] = uint32_t(m);     // -1 rides as 0xFFFFFFFF
    *arrivals = 0;                             // ready for the next query
  }
}

// ---------------------------------------- shard step (B8) and batch step (B9)

// One mesh shard of a grouped B8 launch (ops/fanout.py ShardDescStruct has
// the same layout): n_src sources of rows, lengths, ages, state and
// buckets, each input and output a view with a stride between sources
// (and, for the outputs, between outputs), so a shard reads its block
// where it lies and writes straight into its block of the whole
// [N, S, P, ...] result.  The shards of one source block (its ``sub`` and
// ``win`` shards) share ``newest``, ``slot0`` and ``n_src``, and ``parts``
// counts them.  A B9 pass is one such shard of one source.
struct ShardDesc {
  const uint8_t* prefix;
  const int32_t* length;
  const int32_t* age_ms;
  const uint32_t* state;
  const int32_t* bucket;
  uint8_t* headers;
  uint8_t* mask;
  int32_t* newest;                       // the source block's [n_src]
  long long prefix_src;                  // bytes between sources
  long long length_src, age_src;         // elements between sources
  long long state_src, bucket_src;       // elements between sources
  long long headers_src, headers_sub;    // bytes
  long long mask_src, mask_sub;          // bytes
  int n_src, kf_base;
  int slot0;                             // the block's first fold slot
  int parts;                             // shards of the block in the launch
  int first_item;                        // CTAs of earlier shards
  int pad;
};

// One launch of relay_shard_kernel: kSlots shard descriptors and the
// packet, output and row geometry they share (a mesh cuts equal blocks);
// ``eligible`` and ``accumulate`` are B8's.
template <int kSlots>
struct TileLaunch {
  ShardDesc shard[kSlots];
  unsigned long long* eligible;
  long long delay_ms;
  int n_shards, n_pkts, row_stride, n_subs;
  int n_tiles, n_groups;                 // CTAs a source: tiles x groups
  int n_items, n_sources;                // CTAs; fold slots in use
  int accumulate;                        // add to *eligible, not write it
  int pad;
};
// B8: every shard of one device's call (or of its share, past
// kShardMaxShards shards or kShardMaxSlots sources) in ONE launch
using ShardLaunch = TileLaunch<kShardMaxShards>;
// B9: one pass, 216 bytes of parameters where ShardLaunch has 2,616
// (the two forms timed in turns: PERF.md)
using BatchLaunch = TileLaunch<1>;

static_assert(sizeof(ShardDesc) == 160, "ShardDescStruct layout");
static_assert(sizeof(ShardLaunch) < 4096, "kernel parameter space");

// the fold's tickets: a source's counts arrivals in its low 28 bits and
// eligible sends above them; the launch's counts finished sources in its
// low 16 bits and their sends above (a source's keyframe word counts its
// tiles in its low 32 bits and holds the keyframe + 1 above)
constexpr int kSrcArrivalBits = 28;
constexpr int kLaunchArrivalBits = 16;
static_assert(kShardMaxSlots < (1 << kLaunchArrivalBits), "launch arrivals");

// The four header words of output span word i0 .. i0 + 3 (word i is packet
// i / 3, part i % 3; i0 may be -3 .. -1 for the chunk that begins before
// the span): the chunk lies in packets j = floor(i0 / 3) and j + 1, so both
// are rendered and the chunk's phase p = i0 - 3j picks four of their six
// words.  Packets outside [0, rows) are read clamped; their words are the
// caller's to skip.
__device__ __forceinline__ uint4 header_chunk(
    int i0, int rows, const uint32_t* s_word0, const uint32_t* s_ts,
    uint32_t seq_add, uint32_t ts_add, uint32_t ssrc_be) {
  const int j = (i0 + 3) / 3 - 1;
  const int p = i0 - 3 * j;
  uint32_t w[2][3];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int k = min(max(j + q, 0), rows - 1);
    const uint32_t w0 = s_word0[k];
    const uint32_t seq = ((w0 >> 16) + seq_add) & 0xFFFFu;
    w[q][0] = (w0 & 0xFFFFu) | ((seq >> 8) << 16) | ((seq & 0xFFu) << 24);
    w[q][1] = __byte_perm(s_ts[k] + ts_add, 0, 0x0123);
    w[q][2] = ssrc_be;
  }
  return make_uint4(p == 0 ? w[0][0] : p == 1 ? w[0][1] : w[0][2],
                    p == 0 ? w[0][1] : p == 1 ? w[0][2] : w[1][0],
                    p == 0 ? w[0][2] : p == 1 ? w[1][0] : w[1][1],
                    p == 0 ? w[1][0] : p == 1 ? w[1][1] : w[1][2]);
}

// A source's keyframe word (keyframe + 1 above, arrivals below), met by
// the ``reporters`` CTAs that report its tiles, each with its tile's
// newest keyframe ``m`` (-1 = none), through relaxed atomics whose values
// carry everything, so no fence orders any store: a CAS that maxes the one
// and counts the other (an add when the tile has none); the last arrival
// writes *newest and resets the word.
__device__ __forceinline__ void fold_keyframe(unsigned long long* kf, int m,
                                              unsigned long long reporters,
                                              int32_t* newest) {
  unsigned long long now;
  if (m < 0) {
    now = atomicAdd(kf, 1ull) + 1;
  } else {
    unsigned long long seen = 0;
    do {
      now = (max(seen >> 32, (unsigned long long)(m + 1)) << 32) |
            ((seen & 0xFFFFFFFFull) + 1);
      const unsigned long long was = atomicCAS(kf, seen, now);
      if (was == seen) break;
      seen = was;
    } while (true);
  }
  if ((now & 0xFFFFFFFFull) == reporters) {
    *newest = int(now >> 32) - 1;              // 0 (none) rides as -1
    *kf = 0;
  }
}

// B9's fold of a pass of 2 to field_tiles(kRows) tiles of kRows rows, by
// each tile's reporting CTA: ONE relaxed add of its arrival (the low
// kFieldBase bits) and its newest keyframe's row in the tile + 1 (``r``
// + 1, 0 = none) in field_bits(kRows) bits of its own, so the values
// carry everything with no retry and no fence.  The last arrival reads
// the highest tile's nonzero field, writes *newest and resets the word.
constexpr int kFieldBase = 8;
__host__ __device__ constexpr int field_bits(int rows) {
  int b = 0;
  while ((1 << b) <= rows) ++b;
  return b;
}
__host__ __device__ constexpr int field_tiles(int rows) {
  return (64 - kFieldBase) / field_bits(rows);
}
static_assert(field_tiles(kShardTileRows) == 8, "eight 64-row tiles a word");

template <int kRows>
__device__ __forceinline__ void fold_fields(unsigned long long* kf, int r,
                                            int tile, int n_tiles,
                                            int32_t* newest) {
  constexpr int kBits = field_bits(kRows);
  const unsigned long long mine =
      1ull + ((unsigned long long)(r + 1) << (kFieldBase + kBits * tile));
  const unsigned long long all = atomicAdd(kf, mine) + mine;
  if (int(all & ((1ull << kFieldBase) - 1)) != n_tiles) return;
  int best = -1;
  for (int i = n_tiles - 1; i >= 0 && best < 0; --i) {
    const int f = int(all >> (kFieldBase + kBits * i)) & ((1 << kBits) - 1);
    if (f != 0) best = i * kRows + f - 1;
  }
  *newest = best;
  *kf = 0;
}

// B8's fold of one CTA of a shard launch, by one thread: ``counts`` and
// ``bests`` hold each warp's eligible sends and newest keyframe (the
// source's index + kf_base, -1 = none); ``report_kf`` whether this CTA
// reports its tile's keyframe (group 0 does, one CTA a tile).
//   * the keyframe: fold_keyframe on its source slot's keyframe word;
//   * the sends: every CTA adds its count (above) and one arrival (below)
//     to its source's ticket; the source's last CTA resets it and adds the
//     source's sends and one arrival to the launch's ticket, whose last
//     arrival writes *eligible and resets it.
__device__ __forceinline__ void shard_fold(
    const ShardLaunch& L, const ShardDesc& sd, int* scratch, int z,
    bool report_kf, const int* counts, const int* bests) {
  unsigned long long total = 0;
  int m = -1;
#pragma unroll
  for (int w = 0; w < kShardThreads / 32; ++w) {
    total += unsigned(counts[w]);
    m = max(m, bests[w]);
  }
  unsigned long long* slot = reinterpret_cast<unsigned long long*>(
      scratch + 2 + 4 * (sd.slot0 + z));
  if (report_kf)
    fold_keyframe(slot + 1, m, (unsigned long long)sd.parts * L.n_tiles,
                  sd.newest + z);
  const unsigned long long before =
      atomicAdd(slot, (total << kSrcArrivalBits) | 1ull);
  const int per_src = L.n_tiles * L.n_groups;
  if ((before & ((1ull << kSrcArrivalBits) - 1)) + 1 !=
      (unsigned long long)sd.parts * per_src)
    return;
  // the source's last CTA
  *slot = 0;
  const unsigned long long src_total = (before >> kSrcArrivalBits) + total;
  unsigned long long* launch_ticket =
      reinterpret_cast<unsigned long long*>(scratch);
  const unsigned long long done = atomicAdd(
      launch_ticket, (src_total << kLaunchArrivalBits) | 1ull);
  if ((done & ((1ull << kLaunchArrivalBits) - 1)) + 1 !=
      (unsigned long long)L.n_sources)
    return;
  // the launch's last source
  const unsigned long long all = (done >> kLaunchArrivalBits) + src_total;
  *L.eligible = L.accumulate ? *L.eligible + all : all;
  *launch_ticket = 0;                          // ready for the next launch
}

// One CTA a work item (shard, source z, tile of kRows rows, group of kSubs
// outputs), the group fastest, so CTAs that share a tile run side by side.
// B8 (kBatch false) and B9 (kBatch true) share it: B9 is B8's one-source,
// one-shard case but for its mask's length floor (12, where B8's is > 0),
// its keyframe_first and frame_last rows (written by group 0) and B8's sum
// of the eligible sends, which it does not keep.  Outputs go out as
// 16-byte chunks: an output's mask span (rows bytes) and header span
// (rows * 12 bytes) are cut into the aligned 16-byte chunks
// they touch, the chunks wholly inside a span go out as one 16-byte store
// each (the chunks of a span run along consecutive threads), and the at
// most one chunk at each end of a span that it only partly covers goes
// out byte by byte (mask) or word by word (headers).  In order:
//   1. the tile's bulk copy is issued; the rows' lengths and ages and the
//      outputs' state are loaded under it;
//   2. while the copy flies, the mask, which needs no row byte, is
//      computed into shared memory (a thread a row, for every
//      kShardThreads / kRows-th output) and each thread of B8 counts its
//      eligible sends;
//   3. each row is parsed once (one thread a row) for all kSubs outputs;
//   4. warp 0 folds (relaxed atomics, no fence) while warps 1.. write the
//      mask and the headers: B8's CTAs by shard_fold; B9's group-0 CTAs on
//      its one keyframe word, by fold_fields up to field_tiles(kRows)
//      tiles and by fold_keyframe past them (a one-tile pass writes
//      *newest at once).
// ``scratch``: B8's = the launch's ticket ++ kShardMaxSlots slots of (the
// source's ticket, its keyframe word), B9's = its keyframe word, each 64
// bits; every launch leaves it at 0, and launches sharing it stay on one
// stream.
template <int kRows, int kSubs, bool kBatch, int kSlots>
__global__ void __launch_bounds__(kShardThreads)
relay_shard_kernel(const __grid_constant__ TileLaunch<kSlots> L,
                   int* __restrict__ scratch,
                   uint8_t* __restrict__ keyframe_first,
                   uint8_t* __restrict__ frame_last) {
  static_assert(kRows <= kShardThreads && kSubs <= kShardThreads &&
                kRows % 16 == 0 && kShardThreads % kRows == 0 &&
                kShardThreads > 32,
                "one thread a row and an output; a warp to fold");
  extern __shared__ __align__(16) uint8_t s_tile[];
  __shared__ uint64_t s_bar;
  __shared__ uint32_t s_word0[kRows];          // b0 | b1 << 8 | seq << 16
  __shared__ uint32_t s_ts[kRows];
  __shared__ int32_t s_age[kRows];
  __shared__ uint8_t s_sendable[kRows];        // length > 0 (B9: >= 12)
  __shared__ __align__(16) uint8_t s_mask[kSubs * kRows];
  __shared__ uint32_t s_seq_add[kSubs];
  __shared__ uint32_t s_ts_add[kSubs];
  __shared__ uint32_t s_ssrc_be[kSubs];
  __shared__ int64_t s_min_age[kSubs];
  __shared__ int s_warp_best[kShardThreads / 32];
  __shared__ int s_warp_count[kShardThreads / 32];
  const int t = threadIdx.x;
  const int item = blockIdx.x;
  // B9: shard 0, source 0, so its descriptor's fields are constant-bank
  // operands and no stride is multiplied (0.4 us at 7c's pass, PERF.md)
  int d = 0, z = 0, local = item;
  if constexpr (!kBatch) {
    for (int k = 1; k < L.n_shards; ++k)
      if (item >= L.shard[k].first_item) d = k;
    const int per_src = L.n_tiles * L.n_groups;
    local = item - L.shard[d].first_item;
    z = local / per_src;
    local -= z * per_src;
  }
  const ShardDesc& sd = L.shard[d];
  const int tile = local / L.n_groups;
  const int group = local - tile * L.n_groups;
  const int row0 = tile * kRows;
  const int rows = min(kRows, L.n_pkts - row0);
  const int sub0 = group * kSubs;
  const int subs = min(kSubs, L.n_subs - sub0);
  const uint8_t* src =
      sd.prefix + z * sd.prefix_src + size_t(row0) * L.row_stride;
  uint8_t* buf = s_tile + (reinterpret_cast<uintptr_t>(src) & (kBulkAlign - 1));
  const bool wait =
      bulk_fetch(buf, src, uint32_t(rows) * L.row_stride, &s_bar);

  // 1. under the copy: the rows' lengths and ages, the outputs' terms
  const int32_t len = t < rows ? sd.length[z * sd.length_src + row0 + t] : 0;
  if (t < rows) {
    s_age[t] = sd.age_ms[z * sd.age_src + row0 + t];
    // B8: the reference's length > 0; B9: not a runt
    s_sendable[t] = kBatch ? len >= 12 : len > 0;
  }
  if (t < subs) {
    const uint32_t* st =
        sd.state + z * sd.state_src + size_t(sub0 + t) * kStateCols;
    uint32_t sv[kStateCols];
#pragma unroll
    for (int c = 0; c < kStateCols; ++c) sv[c] = st[c];
    const int32_t b = sd.bucket[z * sd.bucket_src + sub0 + t];
    s_seq_add[t] = (sv[3] - sv[1]) & 0xFFFFu;      // seq' = seq + this (mod 2^16)
    s_ts_add[t] = sv[4] - sv[2];                   // ts' = ts + this (mod 2^32)
    s_ssrc_be[t] = __byte_perm(sv[0], 0, 0x0123);  // big-endian on the wire
    // bucket * delay in int64, wrapping as the plain version's product does
    s_min_age[t] = int64_t(uint64_t(int64_t(b)) * uint64_t(L.delay_ms));
  }
  __syncthreads();                             // mbarrier init, head/tail bytes

  // 2. the mask, bucket-eligible (age >= bucket * delay) and sendable,
  // into shared memory while the copy flies
  int sent = 0;
  if (t % kRows < rows) {
    const int k = t % kRows;
    const bool sendable = s_sendable[k];
    const int64_t age = s_age[k];
    for (int s = t / kRows; s < subs; s += kShardThreads / kRows) {
      const bool m = sendable && age >= s_min_age[s];
      s_mask[s * kRows + k] = uint8_t(m);
      if (!kBatch) sent += m;
    }
  }

  // 3. the parse
  if (wait) mbar_wait(smem_addr(&s_bar), 0);
  int best = -1;
  if (t < rows) {
    const uint8_t* row = buf + size_t(t) * L.row_stride;
    const Parsed p = parse_row(row, len);
    s_word0[t] = uint32_t(row[0]) | (uint32_t(row[1]) << 8) | (p.seq << 16);
    s_ts[t] = p.ts;
    if (kBatch && group == 0) {
      keyframe_first[row0 + t] = uint8_t(p.kf);
      frame_last[row0 + t] = uint8_t(p.fl);
    }
    // padding rows carry length 0: never valid, never a keyframe
    if (p.kf && len > 0) best = row0 + t + (kBatch ? 0 : sd.kf_base);
  }
  if (!kBatch) sent = __reduce_add_sync(0xffffffffu, sent);
  best = __reduce_max_sync(0xffffffffu, best);
  if ((t & 31) == 0) {
    if (!kBatch) s_warp_count[t >> 5] = sent;
    s_warp_best[t >> 5] = best;
  }
  __syncthreads();                             // the parsed rows, the mask

  // 4. warp 0 folds; the others write the mask and the headers
  if (t < 32) {
    if (t != 0) return;
    if constexpr (kBatch) {
      if (group == 0) {
        int m = -1;
#pragma unroll
        for (int w = 0; w < kShardThreads / 32; ++w) m = max(m, s_warp_best[w]);
        unsigned long long* kf = reinterpret_cast<unsigned long long*>(scratch);
        if (L.n_tiles == 1)
          *sd.newest = m;
        else if (L.n_tiles <= field_tiles(kRows))
          fold_fields<kRows>(kf, m < 0 ? -1 : m - row0, tile, L.n_tiles,
                             sd.newest);
        else
          fold_keyframe(kf, m, (unsigned long long)L.n_tiles, sd.newest);
      }
    } else {
      shard_fold(L, sd, scratch, z, group == 0, s_warp_count, s_warp_best);
    }
    return;
  }
  constexpr int kStoreThreads = kShardThreads - 32;
  constexpr int kMaskSlots = kRows / 16 + 1;   // chunks a mask span touches
  uint8_t* const mask0 = sd.mask + z * sd.mask_src + row0;
  for (int idx = t - 32; idx < subs * kMaskSlots; idx += kStoreThreads) {
    const int s = idx / kMaskSlots;
    const int c = idx - s * kMaskSlots;
    const uintptr_t span =
        reinterpret_cast<uintptr_t>(mask0 + (sub0 + s) * sd.mask_sub);
    const int k0 = 16 * c - int(span & (kBulkAlign - 1));
    if (k0 >= rows) continue;
    const uint8_t* bits = s_mask + s * kRows;
    uint8_t* chunk = reinterpret_cast<uint8_t*>(
        (span & ~uintptr_t(kBulkAlign - 1)) + size_t(kBulkAlign) * c);
    if (k0 >= 0 && k0 + 16 <= rows) {
      uint4 v;
      if ((k0 & (kBulkAlign - 1)) == 0) {      // an aligned span
        v = *reinterpret_cast<const uint4*>(bits + k0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 16; ++b)
          w[b >> 2] |= uint32_t(bits[k0 + b]) << (8 * (b & 3));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(chunk) = v;
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (unsigned(k0 + b) < unsigned(rows)) chunk[b] = bits[k0 + b];
    }
  }
  constexpr int kHdrSlots = kRows * 12 / 16 + 1;  // chunks a header span hits
  const int n_words = 3 * rows;
  uint8_t* const hdr0 = sd.headers + z * sd.headers_src + size_t(row0) * 12;
  for (int idx = t - 32; idx < subs * kHdrSlots; idx += kStoreThreads) {
    const int s = idx / kHdrSlots;
    const int c = idx - s * kHdrSlots;
    const uintptr_t span = reinterpret_cast<uintptr_t>(hdr0 + (sub0 + s) *
                                                       sd.headers_sub);
    const int i0 = 4 * c - int(span & (kBulkAlign - 1)) / 4;
    if (i0 >= n_words) continue;
    const uint4 v = header_chunk(i0, rows, s_word0, s_ts, s_seq_add[s],
                                 s_ts_add[s], s_ssrc_be[s]);
    uint32_t* chunk = reinterpret_cast<uint32_t*>(
        (span & ~uintptr_t(kBulkAlign - 1)) + size_t(kBulkAlign) * c);
    if (i0 >= 0 && i0 + 4 <= n_words) {
      *reinterpret_cast<uint4*>(chunk) = v;
    } else {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k >= 0 && i0 + k < n_words) chunk[k] = w[k];
    }
  }
}

// relay_shard_kernel<kRows, kSubs, kBatch, kSlots> over L's items on
// ``st``.  Its tile of rows is dynamic shared memory beside up to 6.3 KB
// of static arrays (64 x 64), and a block gets 48 KB of both without an
// opt-in, so a tile past 32 KB opts the kernel into kDynSmemLimit bytes
// first.
template <int kRows, int kSubs, bool kBatch, int kSlots>
cudaError_t launch_tiles(const TileLaunch<kSlots>& L, int* scratch,
                         uint8_t* keyframe_first, uint8_t* frame_last,
                         cudaStream_t st) {
  const auto kernel = relay_shard_kernel<kRows, kSubs, kBatch, kSlots>;
  const size_t smem = size_t(kRows) * L.row_stride + kBulkAlign;
  if (smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynSmemLimit);
    if (err != cudaSuccess) return err;
  }
  kernel<<<unsigned(L.n_items), kShardThreads, smem, st>>>(
      L, scratch, keyframe_first, frame_last);
  return cudaGetLastError();
}

// A B9 pass (ed_relay_batch's arguments) as relay_shard_kernel's
// one-source, one-shard case on kRows-row tiles at kSubs outputs a CTA:
// ``L`` filled, or an error for arguments the kernel does not take.  The
// product launches <kBatchTileRows, kBatchSubsPerCta> in a BatchLaunch;
// tools/b9_batch_probe.cu the others.
template <int kRows, int kSubs, int kSlots>
int batch_plan(const void* prefix, int n_pkts, int row_stride,
               const void* length, const void* age_ms, const void* state,
               const void* bucket, int n_subs, long long delay_ms,
               void* headers, void* mask, void* scratch, void* newest,
               TileLaunch<kSlots>& L) {
  const size_t smem = size_t(kRows) * row_stride + kBulkAlign;
  if (n_pkts < 1 || n_pkts > kBatchMaxPkts || n_subs < 1 ||
      n_subs > kBatchMaxSubs || row_stride < kParsePrefix ||
      smem > size_t(kDynSmemLimit) || scratch == nullptr ||
      (reinterpret_cast<uintptr_t>(headers) & 3) != 0)
    return int(cudaErrorInvalidValue);
  L = {};
  ShardDesc& d = L.shard[0];
  d.prefix = static_cast<const uint8_t*>(prefix);
  d.length = static_cast<const int32_t*>(length);
  d.age_ms = static_cast<const int32_t*>(age_ms);
  d.state = static_cast<const uint32_t*>(state);
  d.bucket = static_cast<const int32_t*>(bucket);
  d.headers = static_cast<uint8_t*>(headers);
  d.mask = static_cast<uint8_t*>(mask);
  d.newest = static_cast<int32_t*>(newest);
  d.headers_sub = 12ll * n_pkts;               // dense [S, P, 12] and [S, P]
  d.mask_sub = n_pkts;
  d.n_src = d.parts = 1;
  L.delay_ms = delay_ms;
  L.n_shards = L.n_sources = 1;
  L.n_pkts = n_pkts;
  L.row_stride = row_stride;
  L.n_subs = n_subs;
  L.n_tiles = (n_pkts + kRows - 1) / kRows;
  L.n_groups = (n_subs + kSubs - 1) / kSubs;
  L.n_items = L.n_tiles * L.n_groups;
  return 0;
}

// The card's floor for one launch: a kernel that does nothing.
__global__ void launch_floor_kernel() {}

// Opt relay_window_kernel into kWindowSmemLimit bytes of dynamic shared
// memory on the current device, once a device (up to 64 of them).
int window_optin() {
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (opted.load() & bit)) return 0;
  err = cudaFuncSetAttribute(relay_window_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWindowSmemLimit);
  if (err != cudaSuccess) return int(err);
  opted.fetch_or(bit);
  return 0;
}

}  // namespace

extern "C" {

int ed_parse_packets(const void* prefix, int n_rows, int row_stride,
                     const void* length, void* words, void* flags,
                     void* stream) {
  if (n_rows <= 0) return 0;
  const size_t smem = size_t(kTileRows) * row_stride + kBulkAlign;
  if (row_stride < kParsePrefix || smem > size_t(kDynSmemLimit) ||
      (reinterpret_cast<uintptr_t>(words) & 15) != 0)
    return int(cudaErrorInvalidValue);
  const int blocks = (n_rows + kTileRows - 1) / kTileRows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int rc = ed_timing::start(st)) return rc;
  parse_packets_kernel<<<blocks, kTileRows, smem, st>>>(
      static_cast<const uint8_t*>(prefix), n_rows, row_stride,
      static_cast<const int32_t*>(length), static_cast<uint4*>(words),
      static_cast<int32_t*>(flags));
  return ed_timing::stop(st, cudaGetLastError());
}

// One grouped window launch: ``buckets`` points at n_buckets WindowBucket
// descriptors (first_cluster = the running sum of n_streams), ``cluster``
// is the launch's cluster size.  The plan is checked, not trusted: a
// descriptor that does not follow it is refused.
int ed_relay_window(const void* buckets, int n_buckets, int cluster,
                    void* stream) {
  if (n_buckets <= 0) return 0;
  if (n_buckets > kMaxBuckets || cluster < 1 || cluster > kMaxCluster)
    return int(cudaErrorInvalidValue);
  WindowLaunch launch = {};
  launch.n_buckets = n_buckets;
  const WindowBucket* in = static_cast<const WindowBucket*>(buckets);
  int clusters = 0;
  size_t smem = kBulkAlign;
  for (int k = 0; k < n_buckets; ++k) {
    const WindowBucket& d = in[k];
    if (d.first_cluster != clusters || d.n_streams <= 0 || d.n_pkts < 0 ||
        d.n_subs < 0 || d.row_stride < kParsePrefix + kWindowExtra)
      return int(cudaErrorInvalidValue);
    launch.bucket[k] = d;
    clusters += d.n_streams;
    const size_t rows = (size_t(d.n_pkts) + cluster - 1) / cluster;
    const size_t need = rows * d.row_stride + kBulkAlign;
    if (need > smem) smem = need;
  }
  smem = (smem + kBulkAlign - 1) & ~size_t(kBulkAlign - 1);
  if (smem > size_t(kWindowSmemLimit)) return int(cudaErrorInvalidValue);
  if (smem > size_t(kDynSmemLimit)) {
    const int rc = window_optin();
    if (rc != 0) return rc;
  }

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(clusters) * unsigned(cluster), 1, 1);
  cfg.blockDim = dim3(kWindowThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (const int rc = ed_timing::start(cfg.stream)) return rc;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, relay_window_kernel, launch);
  return ed_timing::stop(cfg.stream,
                         err != cudaSuccess ? err : cudaGetLastError());
}

// One per-stream ring query: rows [capacity, row_stride] uint8 (prefix +
// le32 length), head = packets ever appended, state [n_subs, 6] uint32 ->
// out [4 * n_subs + 1] uint32, the last word the newest keyframe's
// absolute id (-1 = none).  ``scratch`` holds ceil(capacity / kRingTileRows)
// + 1 int32 whose last word is 0 (the ring's, zeroed when it was made and
// reset by every query).  ONE launch.
int ed_ring_query(const void* rows, int capacity, int row_stride, int head,
                  const void* state, int n_subs, void* scratch, void* out,
                  void* stream) {
  const size_t smem = size_t(kRingTileRows) * row_stride + kBulkAlign;
  if (capacity <= 0 || head < 0 || n_subs < 0 ||
      row_stride < kParsePrefix + kWindowExtra || smem > size_t(kDynSmemLimit))
    return int(cudaErrorInvalidValue);
  const int n_tiles = (capacity + kRingTileRows - 1) / kRingTileRows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int rc = ed_timing::start(st)) return rc;
  ring_query_kernel<<<n_tiles, kRingTileRows, smem, st>>>(
      static_cast<const uint8_t*>(rows), capacity, row_stride, head,
      static_cast<const uint32_t*>(state), n_subs, static_cast<int*>(scratch),
      static_cast<uint32_t*>(out));
  return ed_timing::stop(st, cudaGetLastError());
}

// One batch-header pass (B9): prefix [n_pkts, row_stride] uint8, length
// and age_ms [n_pkts] int32, state [n_subs, 6] uint32, bucket [n_subs]
// int32 -> headers [n_subs, n_pkts, 12] uint8 (4-byte aligned), mask
// [n_subs, n_pkts], keyframe_first and frame_last [n_pkts] (0/1 bytes) and
// *newest (-1 = none).  ``scratch`` holds kBatchScratchWords int32 at 0
// (every pass leaves them at 0).  ONE launch.
int ed_relay_batch(const void* prefix, int n_pkts, int row_stride,
                   const void* length, const void* age_ms, const void* state,
                   const void* bucket, int n_subs, long long delay_ms,
                   void* headers, void* mask, void* keyframe_first,
                   void* frame_last, void* scratch, void* newest,
                   void* stream) {
  BatchLaunch L;
  if (const int rc = batch_plan<kBatchTileRows, kBatchSubsPerCta>(
          prefix, n_pkts, row_stride, length, age_ms, state, bucket, n_subs,
          delay_ms, headers, mask, scratch, newest, L))
    return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int rc = ed_timing::start(st)) return rc;
  return ed_timing::stop(st, launch_tiles<kBatchTileRows, kBatchSubsPerCta,
                                          true, 1>(
                                 L, static_cast<int*>(scratch),
                                 static_cast<uint8_t*>(keyframe_first),
                                 static_cast<uint8_t*>(frame_last), st));
}

// One grouped B8 launch (ed_relay_shard): ``launch`` points at a
// ShardLaunch (ops/fanout.py ShardLaunchStruct, built by
// shard_launch_plan); ``scratch`` holds 2 + 4 * kShardMaxSlots int32
// that every launch leaves at 0.  Each shard's rows [n_src, n_pkts,
// row_stride] uint8, lengths and ages [n_src, n_pkts] int32, state
// [n_src, n_subs, 6] uint32 and buckets [n_src, n_subs] int32 -> headers
// [n_src, n_subs, n_pkts, 12] uint8 (4-byte aligned) and mask [n_src,
// n_subs, n_pkts] (eligible and length > 0), each where its strides put
// it; newest[z] of each source block = its newest keyframe + kf_base,
// maxed over the block's shards (-1 = none), and *eligible = the sends of
// the launch (plus *eligible with ``accumulate``): written, not folded
// into, so nothing is filled first.  ONE launch.  The plan is checked,
// not trusted: a descriptor that does not follow it is refused.
int ed_relay_shard(const void* launch, void* scratch, void* stream) {
  const ShardLaunch& L = *static_cast<const ShardLaunch*>(launch);
  const size_t smem = size_t(kShardTileRows) * L.row_stride + kBulkAlign;
  if (L.n_shards < 1 || L.n_shards > kShardMaxShards || L.n_pkts < 1 ||
      L.n_pkts > kBatchMaxPkts || L.n_subs < 1 || L.n_subs > kBatchMaxSubs ||
      L.row_stride < kParsePrefix || smem > size_t(kDynSmemLimit) ||
      L.n_tiles != (L.n_pkts + kShardTileRows - 1) / kShardTileRows ||
      L.n_groups != (L.n_subs + kShardSubsPerCta - 1) / kShardSubsPerCta ||
      L.n_sources < 1 || L.n_sources > kShardMaxSlots ||
      L.eligible == nullptr || scratch == nullptr)
    return int(cudaErrorInvalidValue);
  const long long per_src = (long long)L.n_tiles * L.n_groups;
  long long items = 0, sources = 0;
  for (int k = 0; k < L.n_shards; ++k) {
    const ShardDesc& d = L.shard[k];
    if (d.first_item != items || d.n_src < 1 || d.slot0 < 0 ||
        d.slot0 + d.n_src > L.n_sources || d.kf_base < 0 ||
        d.kf_base > (1 << 30) ||
        ((reinterpret_cast<uintptr_t>(d.headers) | uintptr_t(d.headers_src) |
          uintptr_t(d.headers_sub)) & 3) != 0)
      return int(cudaErrorInvalidValue);
    // the shards of one block share its slots, sources and newest; the
    // blocks' slots do not overlap
    int parts = 0;
    bool first = true;
    for (int q = 0; q < L.n_shards; ++q) {
      const ShardDesc& e = L.shard[q];
      if (e.slot0 != d.slot0) {
        if (e.slot0 < d.slot0 + d.n_src && d.slot0 < e.slot0 + e.n_src)
          return int(cudaErrorInvalidValue);
        continue;
      }
      if (e.n_src != d.n_src || e.newest != d.newest)
        return int(cudaErrorInvalidValue);
      first = first && q >= k;
      ++parts;
    }
    if (parts != d.parts) return int(cudaErrorInvalidValue);
    if (first) sources += d.n_src;
    items += d.n_src * per_src;
    if (items > 0x7FFFFFFF) return int(cudaErrorInvalidValue);
  }
  if (items != L.n_items || sources != L.n_sources)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int rc = ed_timing::start(st)) return rc;
  return ed_timing::stop(st, launch_tiles<kShardTileRows, kShardSubsPerCta,
                                          false, kShardMaxShards>(
                                 L, static_cast<int*>(scratch), nullptr,
                                 nullptr, st));
}

// ed_relay_shard's geometry and limits (ops/fanout.py SHARD_*): checked
// by chip_smoke.py against the Python side.
int ed_relay_shard_geometry(int* tile_rows, int* subs_per_cta,
                            int* max_shards, int* max_slots,
                            int* launch_bytes) {
  *tile_rows = kShardTileRows;
  *subs_per_cta = kShardSubsPerCta;
  *max_shards = kShardMaxShards;
  *max_slots = kShardMaxSlots;
  *launch_bytes = int(sizeof(ShardLaunch));
  return 0;
}

// ed_relay_batch's tile, limits and scratch (ops/fanout.py BATCH_*):
// checked by chip_smoke.py against the Python side.
int ed_relay_batch_geometry(int* tile_rows, int* subs_per_cta, int* max_pkts,
                            int* max_subs, int* scratch_words) {
  *tile_rows = kBatchTileRows;
  *subs_per_cta = kBatchSubsPerCta;
  *max_pkts = kBatchMaxPkts;
  *max_subs = kBatchMaxSubs;
  *scratch_words = kBatchScratchWords;
  return 0;
}

// The constants the Python launch plans mirror (ops/kernel_lib.py and
// ops/fanout.py): checked by chip_smoke.py against the Python side.
int ed_relay_geometry(int* max_buckets, int* max_cluster, int* window_threads,
                      int* tile_rows, int* smem_limit, int* ring_tile_rows) {
  *max_buckets = kMaxBuckets;
  *max_cluster = kMaxCluster;
  *window_threads = kWindowThreads;
  *tile_rows = kTileRows;
  *smem_limit = kDynSmemLimit;
  *ring_tile_rows = kRingTileRows;
  return 0;
}

// Opt ed_relay_window into its large shared memory on the current device
// and report the limit (ops/kernel_lib.py checks it at load).
int ed_relay_window_optin(int* smem_limit) {
  *smem_limit = kWindowSmemLimit;
  return window_optin();
}

int ed_launch_floor(void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int rc = ed_timing::start(st)) return rc;
  launch_floor_kernel<<<1, 32, 0, st>>>();
  return ed_timing::stop(st, cudaGetLastError());
}

// ------------------------------------------------------- the device timer
// (launch_timing.h) A TimingPair's two timing events, made on `device`
// (the calling thread's current device is left as it was).
int ed_timing_open(int device, void* pair) {
  TimingPair* t = static_cast<TimingPair*>(pair);
  int old = 0;
  cudaError_t e = cudaGetDevice(&old);
  if (e != cudaSuccess) return int(e);
  if (device != old && (e = cudaSetDevice(device)) != cudaSuccess)
    return int(e);
  t->start = t->stop = nullptr;
  t->started = t->stops = 0;
  e = cudaEventCreate(&t->start);
  if (e == cudaSuccess) e = cudaEventCreate(&t->stop);
  const cudaError_t back = device != old ? cudaSetDevice(old) : cudaSuccess;
  return int(e != cudaSuccess ? e : back);
}

// Arm the calling thread's next launch with `pair` (null: disarm).
int ed_timing_arm(void* pair) {
  ed_timing::armed() = static_cast<TimingPair*>(pair);
  return 0;
}

// Milliseconds from the pair's start to its last stop; both must be done.
int ed_timing_elapsed(const void* pair, float* ms) {
  const TimingPair* t = static_cast<const TimingPair*>(pair);
  return int(cudaEventElapsedTime(ms, t->start, t->stop));
}

// Release the pair's events (those still pending are released once done).
int ed_timing_close(void* pair) {
  TimingPair* t = static_cast<TimingPair*>(pair);
  cudaError_t e = cudaSuccess;
  if (t->start != nullptr) e = cudaEventDestroy(t->start);
  if (t->stop != nullptr) {
    const cudaError_t e2 = cudaEventDestroy(t->stop);
    if (e == cudaSuccess) e = e2;
  }
  t->start = t->stop = nullptr;
  return int(e);
}

const char* ed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
