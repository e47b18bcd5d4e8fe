// Experiments on B9's kernel, ed_relay_batch, built beside it by
// tools/b9_batch_probe.py (and by chip_smoke.py's phase 10; never by the
// package).  This file takes the kernel's own source whole, so the
// variants below run the product's code:
//   * the column design, the one the product replaced: a grid (P / 64,
//     S / 4) of 128-thread CTAs that each copy and parse a 64-row tile for 4
//     outputs, store 4-byte words (a divide and a three-way branch each),
//     and fold the newest keyframe through partials and ONE acq_rel
//     atomic on a ticket;
//   * variant (rows, subs, form): the product's kernel in B9 mode on
//     64- or 128-row tiles at another number of outputs a CTA (2 to 64;
//     the product's is kBatchTileRows x kBatchSubsPerCta), its parameters
//     in a BatchLaunch (216 bytes, the product's) or in B8's ShardLaunch
//     (2,616 bytes);
//   * fold (fold, subs): the product's kernel in B9 mode with another fold
//     of a multi-tile pass: the column design's (partials, one acq_rel
//     atomic, the last CTA reduces) or fold_keyframe's CAS (the product's
//     past field_tiles(64) tiles) in place of fold_fields' one relaxed add.
// Entries: probe_batch_column, probe_batch_variant and probe_batch_fold
// take ed_relay_batch's arguments (the variants and folds first their
// own).  The column design and its fold need a scratch of
// kColScratchWords int32 at 0, the others ed_relay_batch's.  Built with
// -DB9_PROBE_COLUMN_ONLY (chip_smoke.py's phase 10) it holds the column
// design alone.

#include "relay_kernels.cu"

namespace {

// The column design's CTA: 64 rows, 4 outputs, 128 threads.
constexpr int kColRows = 64;
constexpr int kColThreads = 128;
constexpr int kColSubs = 4;
constexpr int kColMaxTiles = kBatchMaxPkts / kColRows;
constexpr int kColScratchWords = 1 + kColMaxTiles;   // ticket ++ partials

// What one batch launch reads and writes: one source's rows, lengths and
// ages, its outputs' state and delay buckets; the headers, the mask
// (bucket-eligible and length >= 12), keyframe_first and frame_last, and
// the newest keyframe, folded through ``scratch``.
struct ColumnArgs {
  const uint8_t* prefix;
  int n_pkts, row_stride;
  const int32_t* length;
  const int32_t* age_ms;
  const uint32_t* state;
  const int32_t* bucket;
  int n_subs, pad;
  long long delay_ms;
  uint32_t* headers;
  long long headers_sub;                 // 4-byte words
  uint8_t* mask;
  long long mask_sub;                    // bytes
  uint8_t* keyframe_first;
  uint8_t* frame_last;
  int* scratch;
  int32_t* newest;
};

// Grid (n_tiles, ceil(n_subs / kColSubs)).  CTA (x, y) takes rows
// [64x, 64x + 64) into shared memory by the bulk copy, loads its outputs'
// state and the rows' lengths and ages while the copy is in flight,
// parses each row once (one thread a row) into shared memory, then writes
// its (output, packet) tile: headers as 4-byte words, three a packet,
// along each output's contiguous 12 * P bytes, and the mask bytes.  The
// y = 0 CTAs also write keyframe_first and frame_last and, after their
// stores are issued, fold the newest keyframe: one tile writes it at
// once; more store each tile's max into partials[x] and make ONE acq_rel
// add on the ticket, and the last arrival's warp 0 reduces the partials,
// writes *newest and puts the ticket back to 0 (``scratch`` = ticket ++
// partials[kColMaxTiles]; launches sharing it stay on one stream).
__global__ void __launch_bounds__(kColThreads)
column_batch_kernel(const ColumnArgs a) {
  extern __shared__ __align__(16) uint8_t s_tile[];
  __shared__ uint64_t s_bar;
  __shared__ uint32_t s_word0[kColRows];   // b0 | b1 << 8 | seq << 16
  __shared__ uint32_t s_ts[kColRows];
  __shared__ int32_t s_age[kColRows];
  __shared__ uint8_t s_sendable[kColRows];  // length >= 12
  __shared__ uint32_t s_seq_add[kColSubs];
  __shared__ uint32_t s_ts_add[kColSubs];
  __shared__ uint32_t s_ssrc_be[kColSubs];
  __shared__ int64_t s_min_age[kColSubs];
  __shared__ int s_warp_best[kColThreads / 32];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int n_pkts = a.n_pkts;
  const int row0 = tile * kColRows;
  const int rows = min(kColRows, n_pkts - row0);
  const int sub0 = blockIdx.y * kColSubs;
  const int subs = min(kColSubs, a.n_subs - sub0);
  const bool first_col = blockIdx.y == 0;      // writes the per-packet outputs
  const uint8_t* src = a.prefix + size_t(row0) * a.row_stride;
  uint8_t* buf = s_tile + (reinterpret_cast<uintptr_t>(src) & (kBulkAlign - 1));
  const bool wait =
      bulk_fetch(buf, src, uint32_t(rows) * a.row_stride, &s_bar);

  // under the copy: the rows' lengths and ages, the outputs' affine terms
  const int32_t len = t < rows ? a.length[row0 + t] : 0;
  const int32_t age = t < rows ? a.age_ms[row0 + t] : 0;
  if (t < subs) {
    const uint32_t* st = a.state + size_t(sub0 + t) * kStateCols;
    uint32_t sv[kStateCols];
#pragma unroll
    for (int c = 0; c < kStateCols; ++c) sv[c] = st[c];
    const int32_t b = a.bucket[sub0 + t];
    s_seq_add[t] = (sv[3] - sv[1]) & 0xFFFFu;      // seq' = seq + this (mod 2^16)
    s_ts_add[t] = sv[4] - sv[2];                   // ts' = ts + this (mod 2^32)
    s_ssrc_be[t] = __byte_perm(sv[0], 0, 0x0123);  // big-endian on the wire
    // bucket * delay in int64, wrapping as the plain version's product does
    s_min_age[t] = int64_t(uint64_t(int64_t(b)) * uint64_t(a.delay_ms));
  }
  __syncthreads();                             // mbarrier init, head/tail bytes
  if (wait) mbar_wait(smem_addr(&s_bar), 0);

  int best = -1;
  if (t < rows) {
    const uint8_t* row = buf + size_t(t) * a.row_stride;
    const Parsed p = parse_row(row, len);
    s_word0[t] = uint32_t(row[0]) | (uint32_t(row[1]) << 8) | (p.seq << 16);
    s_ts[t] = p.ts;
    s_age[t] = age;
    s_sendable[t] = len >= 12;                 // not a runt
    if (first_col) {
      a.keyframe_first[row0 + t] = uint8_t(p.kf);
      a.frame_last[row0 + t] = uint8_t(p.fl);
    }
    // padding rows carry length 0: never valid, never a keyframe
    if (p.kf && len > 0) best = row0 + t;
  }
  __syncthreads();                             // the parsed rows

  // headers: word w of an output's span is packet w / 3, part w % 3
  // (0: b0 b1 seq_hi seq_lo, 1: ts big-endian, 2: ssrc big-endian)
  const int words = 3 * rows;
  for (int s = 0; s < subs; ++s) {
    uint32_t* out = a.headers + (sub0 + s) * a.headers_sub + size_t(row0) * 3;
    const uint32_t seq_add = s_seq_add[s], ts_add = s_ts_add[s];
    for (int w = t; w < words; w += kColThreads) {
      const int j = w / 3;
      const int part = w - 3 * j;
      uint32_t v;
      if (part == 0) {
        const uint32_t w0 = s_word0[j];
        const uint32_t seq = ((w0 >> 16) + seq_add) & 0xFFFFu;
        v = (w0 & 0xFFFFu) | ((seq >> 8) << 16) | ((seq & 0xFFu) << 24);
      } else if (part == 1) {
        v = __byte_perm(s_ts[j] + ts_add, 0, 0x0123);
      } else {
        v = s_ssrc_be[s];
      }
      out[w] = v;
    }
    // mask: bucket-eligible (age >= bucket * delay) and long enough
    if (t < rows) {
      const bool m = s_sendable[t] && int64_t(s_age[t]) >= s_min_age[s];
      a.mask[(sub0 + s) * a.mask_sub + row0 + t] = uint8_t(m);
    }
  }

  if (!first_col) return;                      // uniform over the CTA
  const int m = block_max<kColThreads>(best, s_warp_best);
  if (gridDim.x == 1) {                        // one tile: no fold
    if (t == 0) *a.newest = m;
    return;
  }
  int* scratch = a.scratch;
  if (t == 0) {
    scratch[1 + tile] = m;
    // one acq_rel atomic: it releases the partial before the arrival and,
    // for the last CTA, acquires every other CTA's partial
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(before) : "l"(scratch) : "memory");
    s_last = before == int(gridDim.x) - 1;
  }
  __syncthreads();                             // s_last
  if (!s_last || t >= 32) return;
  // the last arrival: warp 0 folds the partials (read from L2)
  int fold = -1;
  for (int i = t; i < int(gridDim.x); i += 32)
    fold = max(fold, __ldcg(scratch + 1 + i));
  fold = __reduce_max_sync(0xffffffffu, fold);
  if (t == 0) {
    *a.newest = fold;
    *scratch = 0;                              // ready for the next pass
  }
}

#ifndef B9_PROBE_COLUMN_ONLY
// The product's kernel in B9 mode (relay_shard_kernel<64, kSubs, true, 1>)
// with another fold of a multi-tile pass.  kFold 0, the column design's:
// each group-0 CTA stores its tile's newest keyframe into partials[tile]
// (scratch + 1) and makes ONE acq_rel add on the ticket (scratch[0]); the
// last arrival reduces the partials, writes *newest and resets the
// ticket.  kFold 1:
// fold_keyframe's CAS on the 64-bit word whatever the tile count (the
// product takes it past field_tiles(64) tiles).  Everything else is the
// product's code.
template <int kSubs, int kFold>
__global__ void __launch_bounds__(kShardThreads)
batch_fold_kernel(const __grid_constant__ BatchLaunch L,
                    int* __restrict__ scratch,
                    uint8_t* __restrict__ keyframe_first,
                    uint8_t* __restrict__ frame_last) {
  constexpr int kRows = kShardTileRows;
  extern __shared__ __align__(16) uint8_t s_tile[];
  __shared__ uint64_t s_bar;
  __shared__ uint32_t s_word0[kRows];
  __shared__ uint32_t s_ts[kRows];
  __shared__ int32_t s_age[kRows];
  __shared__ uint8_t s_sendable[kRows];
  __shared__ __align__(16) uint8_t s_mask[kSubs * kRows];
  __shared__ uint32_t s_seq_add[kSubs];
  __shared__ uint32_t s_ts_add[kSubs];
  __shared__ uint32_t s_ssrc_be[kSubs];
  __shared__ int64_t s_min_age[kSubs];
  __shared__ int s_warp_best[kShardThreads / 32];
  const int t = threadIdx.x;
  const ShardDesc& sd = L.shard[0];
  const int tile = blockIdx.x / L.n_groups;
  const int group = blockIdx.x - tile * L.n_groups;
  const int row0 = tile * kRows;
  const int rows = min(kRows, L.n_pkts - row0);
  const int sub0 = group * kSubs;
  const int subs = min(kSubs, L.n_subs - sub0);
  const uint8_t* src = sd.prefix + size_t(row0) * L.row_stride;
  uint8_t* buf = s_tile + (reinterpret_cast<uintptr_t>(src) & (kBulkAlign - 1));
  const bool wait =
      bulk_fetch(buf, src, uint32_t(rows) * L.row_stride, &s_bar);
  const int32_t len = t < rows ? sd.length[row0 + t] : 0;
  if (t < rows) {
    s_age[t] = sd.age_ms[row0 + t];
    s_sendable[t] = len >= 12;
  }
  if (t < subs) {
    const uint32_t* st = sd.state + size_t(sub0 + t) * kStateCols;
    uint32_t sv[kStateCols];
#pragma unroll
    for (int c = 0; c < kStateCols; ++c) sv[c] = st[c];
    const int32_t b = sd.bucket[sub0 + t];
    s_seq_add[t] = (sv[3] - sv[1]) & 0xFFFFu;
    s_ts_add[t] = sv[4] - sv[2];
    s_ssrc_be[t] = __byte_perm(sv[0], 0, 0x0123);
    s_min_age[t] = int64_t(uint64_t(int64_t(b)) * uint64_t(L.delay_ms));
  }
  __syncthreads();
  if (t % kRows < rows) {
    const int k = t % kRows;
    const bool sendable = s_sendable[k];
    const int64_t age = s_age[k];
    for (int s = t / kRows; s < subs; s += kShardThreads / kRows)
      s_mask[s * kRows + k] = uint8_t(sendable && age >= s_min_age[s]);
  }
  if (wait) mbar_wait(smem_addr(&s_bar), 0);
  int best = -1;
  if (t < rows) {
    const uint8_t* row = buf + size_t(t) * L.row_stride;
    const Parsed p = parse_row(row, len);
    s_word0[t] = uint32_t(row[0]) | (uint32_t(row[1]) << 8) | (p.seq << 16);
    s_ts[t] = p.ts;
    if (group == 0) {
      keyframe_first[row0 + t] = uint8_t(p.kf);
      frame_last[row0 + t] = uint8_t(p.fl);
    }
    if (p.kf && len > 0) best = row0 + t;
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if ((t & 31) == 0) s_warp_best[t >> 5] = best;
  __syncthreads();
  if (t < 32) {
    if (t != 0 || group != 0) return;
    int m = -1;
#pragma unroll
    for (int w = 0; w < kShardThreads / 32; ++w) m = max(m, s_warp_best[w]);
    if (L.n_tiles == 1) {
      *sd.newest = m;
      return;
    }
    if (kFold == 1) {
      fold_keyframe(reinterpret_cast<unsigned long long*>(scratch), m,
                    (unsigned long long)L.n_tiles, sd.newest);
      return;
    }
    scratch[1 + tile] = m;
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(before) : "l"(scratch) : "memory");
    if (before != L.n_tiles - 1) return;
    int fold = -1;
    for (int i = 0; i < L.n_tiles; ++i)
      fold = max(fold, __ldcg(scratch + 1 + i));
    *sd.newest = fold;
    *scratch = 0;
    return;
  }
  constexpr int kStoreThreads = kShardThreads - 32;
  constexpr int kMaskSlots = kRows / 16 + 1;
  uint8_t* const mask0 = sd.mask + row0;
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
      if ((k0 & (kBulkAlign - 1)) == 0) {
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
  constexpr int kHdrSlots = kRows * 12 / 16 + 1;
  const int n_words = 3 * rows;
  uint8_t* const hdr0 = sd.headers + size_t(row0) * 12;
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

// The product's kernel on kRows-row tiles at kSubs outputs a CTA, its
// parameters a TileLaunch<kSlots>, or (fold 0 or 1, 64 rows, a
// BatchLaunch) batch_fold_kernel with that fold.
template <int kRows, int kSubs, int kSlots>
int variant(const void* prefix, int n_pkts, int row_stride,
            const void* length, const void* age_ms, const void* state,
            const void* bucket, int n_subs, long long delay_ms, void* headers,
            void* mask, void* keyframe_first, void* frame_last, void* scratch,
            void* newest, cudaStream_t st, int fold) {
  TileLaunch<kSlots> L;
  if (const int rc = batch_plan<kRows, kSubs>(
          prefix, n_pkts, row_stride, length, age_ms, state, bucket, n_subs,
          delay_ms, headers, mask, scratch, newest, L))
    return rc;
  uint8_t* kf = static_cast<uint8_t*>(keyframe_first);
  uint8_t* fl = static_cast<uint8_t*>(frame_last);
  if constexpr (kSlots == 1 && kRows == kShardTileRows) {
    if (fold >= 0) {
      const size_t smem = size_t(kShardTileRows) * row_stride + kBulkAlign;
      int* sc = static_cast<int*>(scratch);
      if (fold == 0)
        batch_fold_kernel<kSubs, 0>
            <<<unsigned(L.n_items), kShardThreads, smem, st>>>(L, sc, kf, fl);
      else
        batch_fold_kernel<kSubs, 1>
            <<<unsigned(L.n_items), kShardThreads, smem, st>>>(L, sc, kf, fl);
      return int(cudaGetLastError());
    }
  }
  return int(launch_tiles<kRows, kSubs, true, kSlots>(
      L, static_cast<int*>(scratch), kf, fl, st));
}
#endif  // B9_PROBE_COLUMN_ONLY

}  // namespace

extern "C" {

// The column design's ed_relay_batch: ``scratch`` holds
// kColScratchWords int32 whose first word is 0.
int probe_batch_column(const void* prefix, int n_pkts, int row_stride,
                       const void* length, const void* age_ms,
                       const void* state, const void* bucket, int n_subs,
                       long long delay_ms, void* headers, void* mask,
                       void* keyframe_first, void* frame_last, void* scratch,
                       void* newest, void* stream) {
  const size_t smem = size_t(kColRows) * row_stride + kBulkAlign;
  if (n_pkts < 1 || n_pkts > kBatchMaxPkts || n_subs < 1 ||
      n_subs > kBatchMaxSubs || row_stride < kParsePrefix ||
      smem > size_t(kDynSmemLimit) ||
      (reinterpret_cast<uintptr_t>(headers) & 3) != 0)
    return int(cudaErrorInvalidValue);
  ColumnArgs a = {};
  a.prefix = static_cast<const uint8_t*>(prefix);
  a.n_pkts = n_pkts;
  a.row_stride = row_stride;
  a.length = static_cast<const int32_t*>(length);
  a.age_ms = static_cast<const int32_t*>(age_ms);
  a.state = static_cast<const uint32_t*>(state);
  a.bucket = static_cast<const int32_t*>(bucket);
  a.n_subs = n_subs;
  a.delay_ms = delay_ms;
  a.headers = static_cast<uint32_t*>(headers);
  a.headers_sub = 3ll * n_pkts;
  a.mask = static_cast<uint8_t*>(mask);
  a.mask_sub = n_pkts;
  a.keyframe_first = static_cast<uint8_t*>(keyframe_first);
  a.frame_last = static_cast<uint8_t*>(frame_last);
  a.scratch = static_cast<int*>(scratch);
  a.newest = static_cast<int32_t*>(newest);
  const dim3 grid((n_pkts + kColRows - 1) / kColRows,
                  (n_subs + kColSubs - 1) / kColSubs);
  column_batch_kernel<<<grid, kColThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

int probe_batch_scratch_words() { return kColScratchWords; }

#ifndef B9_PROBE_COLUMN_ONLY
// The product's kernel on ``rows``-row tiles (64 or 128) at ``subs``
// outputs a CTA (2, 4, 8, 16, 32 or 64; 128 rows: 4, 8, 16), its
// parameters a BatchLaunch (``shared_struct`` 0) or a ShardLaunch (1, at
// 64 rows); ed_relay_batch's scratch.
int probe_batch_variant(int rows, int subs, int shared_struct,
                        const void* prefix,
                        int n_pkts, int row_stride, const void* length,
                        const void* age_ms, const void* state,
                        const void* bucket, int n_subs, long long delay_ms,
                        void* headers, void* mask, void* keyframe_first,
                        void* frame_last, void* scratch, void* newest,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ED_VARIANT(R, G, SLOTS)                                              \
  if (rows == R && subs == G && (SLOTS == 1) != (shared_struct != 0))        \
    return variant<R, G, SLOTS>(prefix, n_pkts, row_stride, length, age_ms,  \
                                state, bucket, n_subs, delay_ms, headers,    \
                                mask, keyframe_first, frame_last, scratch,   \
                                newest, st, -1);
  ED_VARIANT(64, 2, 1) ED_VARIANT(64, 4, 1) ED_VARIANT(64, 8, 1)
  ED_VARIANT(64, 16, 1) ED_VARIANT(64, 32, 1) ED_VARIANT(64, 64, 1)
  ED_VARIANT(64, 4, kShardMaxShards) ED_VARIANT(64, 16, kShardMaxShards)
  ED_VARIANT(128, 4, 1) ED_VARIANT(128, 8, 1) ED_VARIANT(128, 16, 1)
#undef ED_VARIANT
  return int(cudaErrorInvalidValue);
}

// The product's kernel at ``subs`` outputs a CTA (4, 16, 32 or 64) with
// the fold ``fold``: 0 the column design's acq_rel fold (a scratch of
// kColScratchWords int32 at 0), 1 fold_keyframe's CAS (ed_relay_batch's
// scratch).
int probe_batch_fold(int fold, int subs, const void* prefix, int n_pkts,
                       int row_stride, const void* length, const void* age_ms,
                       const void* state, const void* bucket, int n_subs,
                       long long delay_ms, void* headers, void* mask,
                       void* keyframe_first, void* frame_last, void* scratch,
                       void* newest, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fold != 0 && fold != 1) return int(cudaErrorInvalidValue);
#define ED_FOLD(G)                                                           \
  if (subs == G)                                                             \
    return variant<kShardTileRows, G, 1>(                                    \
        prefix, n_pkts, row_stride, length, age_ms, state, bucket, n_subs,   \
        delay_ms, headers, mask, keyframe_first, frame_last, scratch,        \
        newest, st, fold);
  ED_FOLD(4) ED_FOLD(16) ED_FOLD(32) ED_FOLD(64)
#undef ED_FOLD
  return int(cudaErrorInvalidValue);
}
#endif  // B9_PROBE_COLUMN_ONLY

}  // extern "C"
