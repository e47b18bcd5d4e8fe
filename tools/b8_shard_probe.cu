// Experiments on B8's kernel, ed_relay_shard, built beside it by
// tools/b8_shard_probe.py (and by chip_smoke.py's phase 10; never by the
// package).  This file takes the kernel's own source whole, so the
// variants below run the product's code:
//   * variant (rows, subs): the product's relay_shard_kernel at another
//     tile height and outputs a CTA (the product's is 64 x 64), the
//     launch's CTA counts recomputed for it;
//   * stores (rows, subs): the product's CTA grid and store loops with no
//     bulk copy, no parse and no fold (every row reads as zeros): what the
//     stores alone cost;
//   * ablation (flags): the product's kernel with a part taken out (the
//     copy, the mask's stores, the fold);
//   * per-shard: the design it replaces (the kShard case of B9's
//     template): one launch a shard, a grid (P / 64, S / 4, sources) of
//     128-thread CTAs that each copy and parse a 64-row tile for 4
//     outputs, store 4-byte words, and fold by one atomicMax and one
//     atomicAdd a CTA into newest and *eligible, which the caller fills
//     with -1 and 0 first.
// Entries: probe_shard_variant, probe_shard_stores and
// probe_shard_ablation take the product's ShardLaunch and scratch;
// probe_per_shard takes the per-shard design's arguments.  Built with
// -DB8_PROBE_PER_SHARD_ONLY (chip_smoke.py's phase 10) it holds the
// per-shard design alone, which compiles in seconds.

#include "relay_kernels.cu"

namespace {

// the per-shard design's CTA: 64 rows, 4 outputs, 128 threads
constexpr int kPerShardRows = 64;
constexpr int kPerShardSubs = 4;
constexpr int kPerShardThreads = 128;

struct PerShardArgs {
  const uint8_t* prefix;
  long long prefix_src;                  // bytes between sources
  int n_pkts, row_stride;
  const int32_t* length;
  const int32_t* age_ms;
  long long length_src, age_src;         // elements between sources
  const uint32_t* state;
  const int32_t* bucket;
  long long state_src, bucket_src;       // elements between sources
  int n_subs, min_len, kf_base, pad;
  long long delay_ms;
  uint32_t* headers;
  long long headers_src, headers_sub;    // 4-byte words
  uint8_t* mask;
  long long mask_src, mask_sub;          // bytes
  uint8_t* keyframe_first;               // B9 only
  uint8_t* frame_last;                   // B9 only
  int* scratch;                          // B9 only
  int32_t* newest;
  unsigned long long* eligible;          // B8 only
};

// Grid (n_tiles, ceil(n_subs / kPerShardSubs), sources).  CTA (x, y, z)
// takes rows [64x, 64x + 64) of source z into shared memory by the bulk
// copy, loads its outputs' state and the rows' lengths and ages while the
// copy is in flight, parses each row once (one thread a row) into shared
// memory, then writes its (output, packet) tile: headers as 4-byte words,
// three a packet, along each output's contiguous 12 * P bytes, and the
// mask bytes.  The y = 0 CTAs also write keyframe_first and frame_last
// (B9) and, after their stores are issued, fold the newest keyframe.  B9:
// one tile writes it at once; more store each tile's max into partials[x]
// and make ONE acq_rel add on the ticket, and the last arrival's warp 0
// reduces the partials, writes *newest and puts the ticket back to 0
// (``scratch`` = ticket ++ one partial a tile; launches sharing it
// stay on one stream).  B8: each y = 0 CTA makes one atomicMax on
// newest[z], and every CTA one atomicAdd of its mask count.
__global__ void __launch_bounds__(kPerShardThreads)
per_shard_kernel(const PerShardArgs a) {
  extern __shared__ __align__(16) uint8_t s_tile[];
  __shared__ uint64_t s_bar;
  __shared__ uint32_t s_word0[kPerShardRows];   // b0 | b1 << 8 | seq << 16
  __shared__ uint32_t s_ts[kPerShardRows];
  __shared__ int32_t s_age[kPerShardRows];
  __shared__ uint8_t s_sendable[kPerShardRows];  // length >= min_len
  __shared__ uint32_t s_seq_add[kPerShardSubs];
  __shared__ uint32_t s_ts_add[kPerShardSubs];
  __shared__ uint32_t s_ssrc_be[kPerShardSubs];
  __shared__ int64_t s_min_age[kPerShardSubs];
  __shared__ int s_warp_best[kPerShardThreads / 32];
  __shared__ int s_warp_count[kPerShardThreads / 32];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int n_pkts = a.n_pkts;
  const int row0 = tile * kPerShardRows;
  const int rows = min(kPerShardRows, n_pkts - row0);
  const int sub0 = blockIdx.y * kPerShardSubs;
  const int subs = min(kPerShardSubs, a.n_subs - sub0);
  const bool first_col = blockIdx.y == 0;      // writes the per-packet outputs
  const long long z = true ? blockIdx.z : 0;
  const uint8_t* src =
      a.prefix + z * a.prefix_src + size_t(row0) * a.row_stride;
  const int32_t* length = a.length + z * a.length_src;
  const int32_t* age_ms = a.age_ms + z * a.age_src;
  uint8_t* buf = s_tile + (reinterpret_cast<uintptr_t>(src) & (kBulkAlign - 1));
  const bool wait =
      bulk_fetch(buf, src, uint32_t(rows) * a.row_stride, &s_bar);

  // under the copy: the rows' lengths and ages, the outputs' affine terms
  const int32_t len = t < rows ? length[row0 + t] : 0;
  const int32_t age = t < rows ? age_ms[row0 + t] : 0;
  if (t < subs) {
    const uint32_t* st =
        a.state + z * a.state_src + size_t(sub0 + t) * kStateCols;
    uint32_t sv[kStateCols];
#pragma unroll
    for (int c = 0; c < kStateCols; ++c) sv[c] = st[c];
    const int32_t b = a.bucket[z * a.bucket_src + sub0 + t];
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
    s_sendable[t] = len >= a.min_len;
    if (!true && first_col) {
      a.keyframe_first[row0 + t] = uint8_t(p.kf);
      a.frame_last[row0 + t] = uint8_t(p.fl);
    }
    // padding rows carry length 0: never valid, never a keyframe
    if (p.kf && len > 0) best = row0 + t + a.kf_base;
  }
  __syncthreads();                             // the parsed rows

  // headers: word w of an output's span is packet w / 3, part w % 3
  // (0: b0 b1 seq_hi seq_lo, 1: ts big-endian, 2: ssrc big-endian)
  const int words = 3 * rows;
  int sent = 0;
  for (int s = 0; s < subs; ++s) {
    uint32_t* out = a.headers + z * a.headers_src +
                    (sub0 + s) * a.headers_sub + size_t(row0) * 3;
    const uint32_t seq_add = s_seq_add[s], ts_add = s_ts_add[s];
    for (int w = t; w < words; w += kPerShardThreads) {
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
      a.mask[z * a.mask_src + (sub0 + s) * a.mask_sub + row0 + t] = uint8_t(m);
      sent += m;
    }
  }

  if (true) {
    // the CTA's eligible sends: a warp sum, then one add a CTA
    sent = __reduce_add_sync(0xffffffffu, sent);
    if ((t & 31) == 0) s_warp_count[t >> 5] = sent;
    const int m = block_max<kPerShardThreads>(best, s_warp_best);  // syncs
    if (t == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < kPerShardThreads / 32; ++w) total += s_warp_count[w];
      if (total) atomicAdd(a.eligible, (unsigned long long)total);
      if (first_col && m >= 0) atomicMax(a.newest + z, m);
    }
    return;
  }
  if (!first_col) return;                      // uniform over the CTA
  const int m = block_max<kPerShardThreads>(best, s_warp_best);
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


#ifndef B8_PROBE_PER_SHARD_ONLY
// The product's store loops at (kRows, kSubs) over rows that read as
// zeros: no bulk copy, no parse, no fold.
template <int kRows, int kSubs>
__global__ void __launch_bounds__(kShardThreads)
shard_stores_kernel(const __grid_constant__ ShardLaunch L) {
  __shared__ uint32_t s_word0[kRows];
  __shared__ uint32_t s_ts[kRows];
  __shared__ uint8_t s_sendable[kRows];
  const int t = threadIdx.x;
  const int item = blockIdx.x;
  int d = 0;
  for (int k = 1; k < L.n_shards; ++k)
    if (item >= L.shard[k].first_item) d = k;
  const ShardDesc& sd = L.shard[d];
  const int per_src = L.n_tiles * L.n_groups;
  const int local = item - sd.first_item;
  const int z = local / per_src;
  const int tile = (local - z * per_src) / L.n_groups;
  const int group = local - z * per_src - tile * L.n_groups;
  const int row0 = tile * kRows;
  const int rows = min(kRows, L.n_pkts - row0);
  const int sub0 = group * kSubs;
  const int subs = min(kSubs, L.n_subs - sub0);
  if (t < kRows) {
    s_word0[t] = 0;
    s_ts[t] = 0;
    s_sendable[t] = 0;
  }
  __syncthreads();
  constexpr int kSlots = kRows * 12 / 16 + 1;
  const int n_words = 3 * rows;
  uint8_t* const hdr0 = sd.headers + z * sd.headers_src + size_t(row0) * 12;
  for (int idx = t; idx < subs * kSlots; idx += kShardThreads) {
    const int s = idx / kSlots;
    const int c = idx - s * kSlots;
    const uintptr_t span = reinterpret_cast<uintptr_t>(hdr0 + (sub0 + s) *
                                                       sd.headers_sub);
    const int i0 = 4 * c - int(span & (kBulkAlign - 1)) / 4;
    if (i0 >= n_words) continue;
    const uint4 v = header_chunk(i0, rows, s_word0, s_ts, 0u, 0u, 0u);
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
  constexpr int kMaskSlots = kRows / 16 + 1;
  uint8_t* const mask0 = sd.mask + z * sd.mask_src + row0;
  for (int idx = t; idx < subs * kMaskSlots; idx += kShardThreads) {
    const int s = idx / kMaskSlots;
    const int c = idx - s * kMaskSlots;
    const uintptr_t span =
        reinterpret_cast<uintptr_t>(mask0 + (sub0 + s) * sd.mask_sub);
    const int k0 = 16 * c - int(span & (kBulkAlign - 1));
    if (k0 >= rows) continue;
    uint8_t* chunk = reinterpret_cast<uint8_t*>(
        (span & ~uintptr_t(kBulkAlign - 1)) + size_t(kBulkAlign) * c);
    if (k0 >= 0 && k0 + 16 <= rows) {
      *reinterpret_cast<uint4*>(chunk) =
          make_uint4(s_sendable[k0], 0u, 0u, 0u);
    } else {
      for (int b = 0; b < 16; ++b)
        if (unsigned(k0 + b) < unsigned(rows)) chunk[b] = s_sendable[0];
    }
  }
}

// The product's kernel (or its stores alone) at (kRows, kSubs) over L,
// with the launch's CTA counts recomputed for that geometry.
template <int kRows, int kSubs>
int launch_variant(ShardLaunch L, int* scratch, cudaStream_t stream,
                   bool stores_only) {
  L.n_tiles = (L.n_pkts + kRows - 1) / kRows;
  L.n_groups = (L.n_subs + kSubs - 1) / kSubs;
  long long items = 0;
  for (int k = 0; k < L.n_shards; ++k) {
    L.shard[k].first_item = int(items);
    items += (long long)L.shard[k].n_src * L.n_tiles * L.n_groups;
  }
  if (items > 0x7FFFFFFF) return int(cudaErrorInvalidValue);
  L.n_items = int(items);
  if (stores_only) {
    shard_stores_kernel<kRows, kSubs>
        <<<unsigned(items), kShardThreads, 0, stream>>>(L);
  } else {
    const size_t smem = size_t(kRows) * L.row_stride + kBulkAlign;
    if (smem > size_t(kDynSmemLimit)) return int(cudaErrorInvalidValue);
    relay_shard_kernel<kRows, kSubs, false, kShardMaxShards>
        <<<unsigned(items), kShardThreads, smem, stream>>>(L, scratch, nullptr,
                                                           nullptr);
  }
  return int(cudaGetLastError());
}


// Ablations of the product's kernel (a copy of relay_shard_kernel with
// flags): kNoCopy skips the tile's bulk copy (the parse reads whatever
// shared memory holds), kNoMask computes the mask but stores none of it,
// kNoFold skips the fold.  Each times what its part costs inside the
// whole.
constexpr int kNoCopy = 1, kNoMask = 2, kNoFold = 4;

template <int kRows, int kSubs, int kFlags>
__global__ void __launch_bounds__(kShardThreads)
shard_ablation_kernel(const __grid_constant__ ShardLaunch L,
                   int* __restrict__ scratch) {
  static_assert(kRows <= kShardThreads && kSubs <= kShardThreads &&
                kRows % 16 == 0 && kShardThreads % kRows == 0 &&
                kShardThreads > 32,
                "one thread a row and an output; a warp to fold");
  extern __shared__ __align__(16) uint8_t s_tile[];
  __shared__ uint64_t s_bar;
  __shared__ uint32_t s_word0[kRows];          // b0 | b1 << 8 | seq << 16
  __shared__ uint32_t s_ts[kRows];
  __shared__ int32_t s_age[kRows];
  __shared__ uint8_t s_sendable[kRows];        // length > 0
  __shared__ __align__(16) uint8_t s_mask[kSubs * kRows];
  __shared__ uint32_t s_seq_add[kSubs];
  __shared__ uint32_t s_ts_add[kSubs];
  __shared__ uint32_t s_ssrc_be[kSubs];
  __shared__ int64_t s_min_age[kSubs];
  __shared__ int s_warp_best[kShardThreads / 32];
  __shared__ int s_warp_count[kShardThreads / 32];
  const int t = threadIdx.x;
  const int item = blockIdx.x;
  int d = 0;
  for (int k = 1; k < L.n_shards; ++k)
    if (item >= L.shard[k].first_item) d = k;
  const ShardDesc& sd = L.shard[d];
  const int per_src = L.n_tiles * L.n_groups;
  const int local = item - sd.first_item;
  const int z = local / per_src;
  const int tile = (local - z * per_src) / L.n_groups;
  const int group = local - z * per_src - tile * L.n_groups;
  const int row0 = tile * kRows;
  const int rows = min(kRows, L.n_pkts - row0);
  const int sub0 = group * kSubs;
  const int subs = min(kSubs, L.n_subs - sub0);
  const uint8_t* src =
      sd.prefix + z * sd.prefix_src + size_t(row0) * L.row_stride;
  uint8_t* buf = s_tile + (reinterpret_cast<uintptr_t>(src) & (kBulkAlign - 1));
  const bool wait = (kFlags & kNoCopy) == 0 &&
      bulk_fetch(buf, src, uint32_t(rows) * L.row_stride, &s_bar);

  // 1. under the copy: the rows' lengths and ages, the outputs' terms
  const int32_t len = t < rows ? sd.length[z * sd.length_src + row0 + t] : 0;
  if (t < rows) {
    s_age[t] = sd.age_ms[z * sd.age_src + row0 + t];
    s_sendable[t] = len > 0;                   // the reference's length > 0
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

  // 2. the mask, bucket-eligible (age >= bucket * delay) and length > 0,
  // into shared memory while the copy flies
  int sent = 0;
  if (t % kRows < rows) {
    const int k = t % kRows;
    const bool sendable = s_sendable[k];
    const int64_t age = s_age[k];
    for (int s = t / kRows; s < subs; s += kShardThreads / kRows) {
      const bool m = sendable && age >= s_min_age[s];
      s_mask[s * kRows + k] = uint8_t(m);
      sent += m;
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
    // padding rows carry length 0: never valid, never a keyframe
    if (p.kf && len > 0) best = row0 + t + sd.kf_base;
  }
  sent = __reduce_add_sync(0xffffffffu, sent);
  best = __reduce_max_sync(0xffffffffu, best);
  if ((t & 31) == 0) {
    s_warp_count[t >> 5] = sent;
    s_warp_best[t >> 5] = best;
  }
  __syncthreads();                             // the parsed rows, the mask

  // 4. warp 0 folds; the others write the mask and the headers
  if (t < 32) {
    if (t == 0 && !(kFlags & kNoFold))
      shard_fold(L, sd, scratch, z, group == 0, s_warp_count, s_warp_best);
    return;
  }
  constexpr int kStoreThreads = kShardThreads - 32;
  constexpr int kMaskSlots = kRows / 16 + 1;   // chunks a mask span touches
  uint8_t* const mask0 = sd.mask + z * sd.mask_src + row0;
  for (int idx = t - 32; idx < subs * kMaskSlots && !(kFlags & kNoMask);
       idx += kStoreThreads) {
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
  constexpr int kSlots = kRows * 12 / 16 + 1;  // chunks a header span touches
  const int n_words = 3 * rows;
  uint8_t* const hdr0 = sd.headers + z * sd.headers_src + size_t(row0) * 12;
  for (int idx = t - 32; idx < subs * kSlots; idx += kStoreThreads) {
    const int s = idx / kSlots;
    const int c = idx - s * kSlots;
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

int ablation(const void* launch, void* scratch, int flags, void* stream) {
  const ShardLaunch& L = *static_cast<const ShardLaunch*>(launch);
  const size_t smem = size_t(kShardTileRows) * L.row_stride + kBulkAlign;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* s = static_cast<int*>(scratch);
#define ED_ABLATION(F)                                                      \
  if (flags == (F)) {                                                      \
    shard_ablation_kernel<kShardTileRows, kShardSubsPerCta, (F)>           \
        <<<unsigned(L.n_items), kShardThreads, smem, st>>>(L, s);           \
    return int(cudaGetLastError());                                        \
  }
  ED_ABLATION(kNoCopy)
  ED_ABLATION(kNoMask)
  ED_ABLATION(kNoFold)
  ED_ABLATION(kNoCopy | kNoFold)
  ED_ABLATION(kNoCopy | kNoMask | kNoFold)
#undef ED_ABLATION
  return int(cudaErrorInvalidValue);
}

int dispatch(const void* launch, void* scratch, int rows, int subs,
             void* stream, bool stores_only) {
  const ShardLaunch& L = *static_cast<const ShardLaunch*>(launch);
  int* s = static_cast<int*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ED_VARIANT(R, S)                                     \
  if (rows == R && subs == S)                                \
    return launch_variant<R, S>(L, s, st, stores_only);
  ED_VARIANT(64, 32)
  ED_VARIANT(64, 16)
  ED_VARIANT(64, 64)
  ED_VARIANT(128, 16)
  ED_VARIANT(128, 32)
  ED_VARIANT(256, 8)
  ED_VARIANT(256, 16)
#undef ED_VARIANT
  return int(cudaErrorInvalidValue);
}

#endif  // B8_PROBE_PER_SHARD_ONLY

}  // namespace

extern "C" {

#ifndef B8_PROBE_PER_SHARD_ONLY
// The product's kernel, or its stores alone, at tile height ``rows`` and
// ``subs`` outputs a CTA: (64, 64) is the product's; also (64, 16),
// (64, 32), (128, 16), (128, 32), (256, 8), (256, 16).
int probe_shard_variant(const void* launch, void* scratch, int rows,
                        int subs, void* stream) {
  return dispatch(launch, scratch, rows, subs, stream, false);
}

int probe_shard_stores(const void* launch, void* scratch, int rows, int subs,
                       void* stream) {
  return dispatch(launch, scratch, rows, subs, stream, true);
}

// The product's kernel with parts taken out (``flags``: kNoCopy 1,
// kNoMask 2, kNoFold 4, and the combinations 1|4 and 1|2|4).
int probe_shard_ablation(const void* launch, void* scratch, int flags,
                         void* stream) {
  return ablation(launch, scratch, flags, stream);
}

#endif  // B8_PROBE_PER_SHARD_ONLY

// The per-shard ed_relay_shard this kernel replaced: one shard a launch.
int probe_per_shard(const void* prefix, int n_src, int n_pkts, int row_stride,
                   long long prefix_src, const void* length,
                   long long length_src, const void* age_ms,
                   long long age_src, const void* state, long long state_src,
                   const void* bucket, long long bucket_src, int n_subs,
                   long long delay_ms, int kf_base, void* headers,
                   long long headers_src, long long headers_sub, void* mask,
                   long long mask_src, long long mask_sub, void* newest,
                   void* eligible, void* stream) {
  const size_t smem = size_t(kPerShardRows) * row_stride + kBulkAlign;
  if (n_src < 1 || n_src > 65535 || n_pkts < 1 ||
      n_pkts > kBatchMaxPkts || n_subs < 1 || n_subs > kBatchMaxSubs ||
      row_stride < kParsePrefix || smem > size_t(kDynSmemLimit) ||
      kf_base < 0 || kf_base > (1 << 30) ||
      ((reinterpret_cast<uintptr_t>(headers) | uintptr_t(headers_src) |
        uintptr_t(headers_sub)) & 3) != 0)
    return int(cudaErrorInvalidValue);
  PerShardArgs a = {};
  a.prefix = static_cast<const uint8_t*>(prefix);
  a.prefix_src = prefix_src;
  a.n_pkts = n_pkts;
  a.row_stride = row_stride;
  a.length = static_cast<const int32_t*>(length);
  a.age_ms = static_cast<const int32_t*>(age_ms);
  a.length_src = length_src;
  a.age_src = age_src;
  a.state = static_cast<const uint32_t*>(state);
  a.bucket = static_cast<const int32_t*>(bucket);
  a.state_src = state_src;
  a.bucket_src = bucket_src;
  a.n_subs = n_subs;
  a.min_len = 1;                               // the reference's length > 0
  a.kf_base = kf_base;
  a.delay_ms = delay_ms;
  a.headers = static_cast<uint32_t*>(headers);
  a.headers_src = headers_src / 4;
  a.headers_sub = headers_sub / 4;
  a.mask = static_cast<uint8_t*>(mask);
  a.mask_src = mask_src;
  a.mask_sub = mask_sub;
  a.newest = static_cast<int32_t*>(newest);
  a.eligible = static_cast<unsigned long long*>(eligible);
  const dim3 grid((n_pkts + kPerShardRows - 1) / kPerShardRows,
                  (n_subs + kPerShardSubs - 1) / kPerShardSubs, n_src);
  per_shard_kernel<<<grid, kPerShardThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
