// h264_walk — the native H.264 slice walk of the HLS requant ladder.
//
// The first half is the FUSED walk, ed_h264_requant_slice[_cabac]: it
// mirrors easydarwin_tpu_torch/codecs/{h264_bits,h264_cavlc,h264_intra,
// h264_cabac,h264_requant}.py BIT-EXACTLY (differential-tested
// byte-for-byte): parse a CAVLC or CABAC I/P slice, shift every residual
// level by k (a +6k QP step is exactly a rounded k-bit shift with the
// intra 1/3 deadzone, by quant-table periodicity), re-encode with
// recomputed CBP/nC contexts and rewritten QP chain.  The VLC tables
// come from h264_tables.h, GENERATED from the Python source of truth
// (tools/gen_h264_tables_torch.py).
//
// The second half is the SPLIT walk (ed_h264_parse_slice[_cabac],
// ed_h264_walk_gather, ed_h264_write_slice[_cabac]): the fused walk's
// decode and its encode as two calls around B6 on the card, so one parse
// serves every rung of a ladder.  The fused walk is its oracle.
//
// Pure-Python CAVLC costs ~0.5 ms per macroblock; this path runs the
// same walk at native speed so HD pictures fit a real-time budget.
// Returns output NAL length, or a negative ED_H264_ERR_* code — every
// unsupported feature fails cleanly so the caller passes the slice
// through unchanged (never corrupt what cannot be parsed).

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#include "h264_walk.h"
#include "h264_tables.h"

namespace {

constexpr int kErrUnsupported = -1;
constexpr int kErrBitstream = -2;
constexpr int kErrOverflow = -3;
constexpr int kLevelClip = 2047;   // codecs.h264_transform.LEVEL_CLIP

struct BitReader {
  const uint8_t *d;
  int64_t nbits;
  int64_t pos = 0;
  bool ok = true;
  int64_t stop_bit = -1;  // rbsp_stop_one_bit position (last set bit)

  BitReader(const uint8_t *data, int64_t nbytes)
      : d(data), nbits(nbytes * 8) {
    for (int64_t i = nbytes - 1; i >= 0; --i) {
      uint8_t b = data[i];
      if (b) {
        int low = __builtin_ctz(b);
        stop_bit = i * 8 + 7 - low;
        break;
      }
    }
  }

  // 7.3.4 moreDataFlag for CAVLC: payload remains before the stop bit
  bool more_rbsp_data() const { return pos < stop_bit; }

  int bit() {
    if (pos >= nbits) {
      ok = false;
      return 0;
    }
    int b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return b;
  }

  // up to 25 bits starting at pos, zero-padded past the end: one
  // unaligned 64-bit load + bswap on the common path (the VLC walk is
  // bit-I/O bound — this is the q-rung's hottest primitive)
  uint32_t peek(int n) const {
    int64_t byte = pos >> 3;
    int off = static_cast<int>(pos & 7);
    int64_t nbytes = (nbits + 7) >> 3;
    uint64_t w;
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    if (byte + 8 <= nbytes) {
      std::memcpy(&w, d + byte, 8);
      w = __builtin_bswap64(w);
      return static_cast<uint32_t>((w >> (64 - off - n)) &
                                   ((1u << n) - 1));
    }
#endif
    w = 0;
    for (int i = 0; i < 5; ++i)
      w = (w << 8) | (byte + i < nbytes ? d[byte + i] : 0);
    return static_cast<uint32_t>((w >> (40 - off - n)) &
                                 ((1u << n) - 1));
  }

  uint32_t bits(int n) {
    if (n == 0) return 0;
    if (n <= 25) {
      uint32_t v = peek(n);
      if (pos + n > nbits) {
        ok = false;
        return 0;
      }
      pos += n;
      return v;
    }
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }

  bool advance(int n) {
    if (pos + n > nbits) {
      ok = false;
      return false;
    }
    pos += n;
    return true;
  }

  // zero-run before the next stop 1 within a 25-bit window, WITHOUT
  // consuming; -1 = run extends past the window (callers take the
  // per-bit slow path).  Shared by ue() and the level_prefix reader.
  int zrun25() const {
    uint32_t w = peek(25);
    return w ? __builtin_clz(w) - 7 : -1;
  }

  uint32_t ue() {
    int lz = zrun25();
    if (lz >= 0 && 2 * lz + 1 <= 25) {
      uint32_t w = peek(2 * lz + 1);
      if (!advance(2 * lz + 1)) return 0;
      return w - 1;
    }
    int zeros = 0;
    while (bit() == 0) {
      if (++zeros > 31 || !ok) {
        ok = false;
        return 0;
      }
    }
    return (1u << zeros) - 1 + (zeros ? bits(zeros) : 0);
  }

  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? static_cast<int32_t>((k + 1) / 2)
                   : -static_cast<int32_t>(k / 2);
  }
};

struct BitWriter {
  std::vector<uint8_t> out;
  uint32_t cur = 0;
  int nbits = 0;

  void bit(int b) {
    cur = (cur << 1) | (b & 1);
    if (++nbits == 8) {
      out.push_back(static_cast<uint8_t>(cur));
      cur = 0;
      nbits = 0;
    }
  }

  // append n bits in one accumulator pass (≤ 7 pending + 32 new = 39
  // bits max); the per-bit loop was the encode side's hot spot
  void bits(uint32_t v, int n) {
    if (n <= 0) return;
    uint64_t acc = (static_cast<uint64_t>(cur) << n) |
                   (n < 32 ? (v & ((1u << n) - 1)) : v);
    int total = nbits + n;
    while (total >= 8) {
      out.push_back(static_cast<uint8_t>(acc >> (total - 8)));
      total -= 8;
    }
    cur = static_cast<uint32_t>(acc & ((1u << total) - 1));
    nbits = total;
  }

  void ue(uint32_t v) {
    uint32_t k = v + 1;
    int n = 32 - __builtin_clz(k);
    bits(0, n - 1);
    bits(k, n);
  }

  void se(int32_t v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }

  void trailing() {
    bit(1);
    while (nbits) bit(0);
  }
};

// ---------------------------------------------------------------- CAVLC
int ct_class(int nC) {
  if (nC < 2) return 0;
  if (nC < 4) return 1;
  if (nC < 8) return 2;
  return 3;
}

// O(1) VLC decode: prefix-expanded lookup tables built once from the
// generated codeword tables (decode entry: len<<16 | tc<<8 | t1; 0 =
// invalid).  16-bit peek covers the longest coeff_token codeword.
struct DecodeLuts {
  std::vector<uint32_t> ct[3];       // [1<<16]
  std::vector<uint16_t> tz[15];      // [1<<9]  len<<8 | total_zeros
  std::vector<uint16_t> rb[7];       // [1<<3]  len<<8 | run
  std::vector<uint32_t> ctc;         // [1<<8]  chroma DC coeff_token
  std::vector<uint16_t> tzc[3];      // [1<<3]  chroma DC total_zeros

  DecodeLuts() {
    ctc.assign(1 << 8, 0);
    for (int tc = 0; tc <= 4; ++tc)
      for (int t1 = 0; t1 < 4; ++t1) {
        uint32_t e = tc <= 4 ? kCoeffTokenCdc[tc][t1] : 0;
        if (!e) continue;
        int n = static_cast<int>(e >> 24);
        uint32_t code = (e & 0xFFFFFF) << (8 - n);
        uint32_t entry = (static_cast<uint32_t>(n) << 16) |
                         (static_cast<uint32_t>(tc) << 8) |
                         static_cast<uint32_t>(t1);
        for (uint32_t i = 0; i < (1u << (8 - n)); ++i)
          ctc[code + i] = entry;
      }
    for (int t = 0; t < 3; ++t) {
      tzc[t].assign(1 << 3, 0);
      for (int z = 0; z < 4; ++z) {
        uint32_t e = kTotalZerosCdc[t][z];
        if (!e) continue;
        int n = static_cast<int>(e >> 24);
        uint32_t code = (e & 0xFFFFFF) << (3 - n);
        for (uint32_t i = 0; i < (1u << (3 - n)); ++i)
          tzc[t][code + i] = static_cast<uint16_t>((n << 8) | z);
      }
    }
    for (int cls = 0; cls < 3; ++cls) {
      ct[cls].assign(1 << 16, 0);
      for (int tc = 0; tc <= 16; ++tc)
        for (int t1 = 0; t1 < 4; ++t1) {
          uint32_t e = kCoeffToken[cls][tc][t1];
          if (!e) continue;
          int n = static_cast<int>(e >> 24);
          uint32_t code = (e & 0xFFFFFF) << (16 - n);
          uint32_t fill = 1u << (16 - n);
          uint32_t entry = (static_cast<uint32_t>(n) << 16) |
                           (static_cast<uint32_t>(tc) << 8) |
                           static_cast<uint32_t>(t1);
          for (uint32_t i = 0; i < fill; ++i) ct[cls][code + i] = entry;
        }
    }
    for (int t = 0; t < 15; ++t) {
      tz[t].assign(1 << 9, 0);
      for (int z = 0; z < 16; ++z) {
        uint32_t e = kTotalZeros[t][z];
        if (!e) continue;
        int n = static_cast<int>(e >> 24);
        uint32_t code = (e & 0xFFFFFF) << (9 - n);
        for (uint32_t i = 0; i < (1u << (9 - n)); ++i)
          tz[t][code + i] = static_cast<uint16_t>((n << 8) | z);
      }
    }
    for (int idx = 0; idx < 7; ++idx) {
      rb[idx].assign(1 << 3, 0);
      for (int r = 0; r < 7; ++r) {
        uint32_t e = kRunBefore[idx][r];
        if (!e) continue;
        int n = static_cast<int>(e >> 24);
        uint32_t code = (e & 0xFFFFFF) << (3 - n);
        for (uint32_t i = 0; i < (1u << (3 - n)); ++i)
          rb[idx][code + i] = static_cast<uint16_t>((n << 8) | r);
      }
    }
  }
};

const DecodeLuts &luts() {
  static DecodeLuts L;               // thread-safe magic static
  return L;
}
// resolved once at library load: the hot VLC readers hit this ~200x per
// macroblock, and the magic-static guard check is measurable (gprof: 28M
// calls/3s) — a namespace-scope reference has no guard
const DecodeLuts &G = luts();

bool read_coeff_token(BitReader &br, int nC, int *total, int *t1s) {
  if (nC < 0) {                        // chroma DC (4:2:0)
    uint32_t entry = G.ctc[br.peek(8)];
    if (!entry) return false;
    if (!br.advance(static_cast<int>(entry >> 16))) return false;
    *total = static_cast<int>((entry >> 8) & 0xFF);
    *t1s = static_cast<int>(entry & 0xFF);
    return true;
  }
  int cls = ct_class(nC);
  if (cls == 3) {
    uint32_t v = br.bits(6);
    if (!br.ok) return false;
    if (v == 0b000011) {
      *total = 0;
      *t1s = 0;
      return true;
    }
    *total = static_cast<int>(v >> 2) + 1;
    *t1s = static_cast<int>(v & 3);
    return *total <= 16 && *t1s <= *total;
  }
  uint32_t entry = G.ct[cls][br.peek(16)];
  if (!entry) return false;
  if (!br.advance(static_cast<int>(entry >> 16))) return false;
  *total = static_cast<int>((entry >> 8) & 0xFF);
  *t1s = static_cast<int>(entry & 0xFF);
  return true;
}

bool write_coeff_token(BitWriter &bw, int nC, int total, int t1s) {
  if (nC < 0) {
    uint32_t e = total <= 4 ? kCoeffTokenCdc[total][t1s] : 0;
    if (!e) return false;
    bw.bits(e & 0xFFFFFF, e >> 24);
    return true;
  }
  int cls = ct_class(nC);
  if (cls == 3) {
    uint32_t v = total == 0 ? 0b000011
                            : ((static_cast<uint32_t>(total - 1) << 2) |
                               static_cast<uint32_t>(t1s));
    bw.bits(v, 6);
    return true;
  }
  uint32_t e = kCoeffToken[cls][total][t1s];
  if (!e) return false;
  bw.bits(e & 0xFFFFFF, e >> 24);
  return true;
}

bool read_total_zeros(BitReader &br, int total, int *tz) {
  uint16_t entry = G.tz[total - 1][br.peek(9)];
  if (!entry) return false;
  if (!br.advance(entry >> 8)) return false;
  *tz = entry & 0xFF;
  return true;
}

bool read_total_zeros_cdc(BitReader &br, int total, int *tz) {
  uint16_t entry = G.tzc[total - 1][br.peek(3)];
  if (!entry) return false;
  if (!br.advance(entry >> 8)) return false;
  *tz = entry & 0xFF;
  return true;
}

bool read_run_before(BitReader &br, int zeros_left, int *run) {
  int idx = (zeros_left < 7 ? zeros_left : 7) - 1;
  uint16_t entry = G.rb[idx][br.peek(3)];
  if (entry) {
    if (!br.advance(entry >> 8)) return false;
    *run = entry & 0xFF;
    return true;
  }
  if (zeros_left > 6 && br.peek(3) == 0) {
    if (!br.advance(3)) return false;    // the three zeros
    int r = 6;
    while (br.bit() == 0) {
      if (++r > 14 || !br.ok) return false;
    }
    *run = r + 1;
    return br.ok;
  }
  return false;
}

void write_run_before(BitWriter &bw, int zeros_left, int run) {
  if (zeros_left > 6 && run > 6) {
    bw.bits(1, run - 3);      // unary extension
    return;
  }
  int idx = (zeros_left < 7 ? zeros_left : 7) - 1;
  uint32_t e = kRunBefore[idx][run];
  bw.bits(e & 0xFFFFFF, e >> 24);
}

// decode one residual block → levels[maxc] in zigzag order (maxc = 16
// for luma4x4 / I_16x16 DC, 15 for I_16x16 AC)
bool decode_residual_n(BitReader &br, int nC, int16_t *levels, int maxc,
                       int *total_out = nullptr) {
  std::memset(levels, 0, 16 * sizeof(int16_t));
  int total, t1s;
  if (!read_coeff_token(br, nC, &total, &t1s)) return false;
  if (total_out) *total_out = total;
  if (total == 0) return true;
  int32_t vals[16];
  int nvals = 0;
  for (int i = 0; i < t1s; ++i) vals[nvals++] = br.bit() ? -1 : 1;
  int suffix_len = (total > 10 && t1s < 3) ? 1 : 0;
  for (int i = 0; i < total - t1s; ++i) {
    int prefix = br.zrun25();
    if (prefix >= 0) {
      if (!br.advance(prefix + 1)) return false;
    } else {
      prefix = 0;
      while (br.bit() == 0) {
        if (++prefix > 32 || !br.ok) return false;
      }
    }
    int64_t level_code;
    if (prefix <= 14) {
      int sz = suffix_len;
      if (prefix == 14 && suffix_len == 0) sz = 4;
      level_code = (static_cast<int64_t>(prefix < 15 ? prefix : 15)
                    << suffix_len) + (sz ? br.bits(sz) : 0);
    } else {
      int sz = prefix - 3;
      if (sz > 28) return false;
      level_code = (15LL << suffix_len) + br.bits(sz);
      if (suffix_len == 0) level_code += 15;
      if (prefix >= 16) level_code += (1LL << (prefix - 3)) - 4096;
    }
    if (!br.ok) return false;
    if (i == 0 && t1s < 3) level_code += 2;
    int32_t lv = (level_code % 2 == 0)
                     ? static_cast<int32_t>((level_code + 2) >> 1)
                     : -static_cast<int32_t>((level_code + 1) >> 1);
    vals[nvals++] = lv;
    if (suffix_len == 0) suffix_len = 1;
    int32_t a = lv < 0 ? -lv : lv;
    if (a > (3 << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
  }
  if (total > maxc) return false;
  int total_zeros = 0;
  if (total < maxc) {
    bool ok = maxc == 4 ? read_total_zeros_cdc(br, total, &total_zeros)
                        : read_total_zeros(br, total, &total_zeros);
    if (!ok) return false;
  }
  int zeros_left = total_zeros;
  int pos = total + total_zeros - 1;
  for (int i = 0; i < nvals; ++i) {
    if (pos < 0 || pos >= maxc) return false;
    int32_t v = vals[i];
    if (v > kLevelClip) v = kLevelClip;
    if (v < -kLevelClip) v = -kLevelClip;
    levels[pos] = static_cast<int16_t>(v);
    if (i == nvals - 1) break;
    int run = 0;
    if (zeros_left > 0 && !read_run_before(br, zeros_left, &run))
      return false;
    zeros_left -= run;
    pos -= 1 + run;
  }
  return true;
}

bool encode_residual_n(BitWriter &bw, const int16_t *levels, int nC,
                       int maxc, int *total_out = nullptr) {
  int idxs[16];
  int32_t nzv[16];
  int total = 0;
  for (int i = 0; i < maxc; ++i)
    if (levels[i]) {
      idxs[total] = i;
      nzv[total] = levels[i];
      ++total;
    }
  if (total_out) *total_out = total;
  if (total == 0) return write_coeff_token(bw, nC, 0, 0);
  int t1s = 0;
  for (int i = total - 1; i >= 0 && t1s < 3; --i) {
    if (nzv[i] == 1 || nzv[i] == -1)
      ++t1s;
    else
      break;
  }
  if (!write_coeff_token(bw, nC, total, t1s)) return false;
  for (int i = 0; i < t1s; ++i)
    bw.bit(nzv[total - 1 - i] < 0 ? 1 : 0);
  int suffix_len = (total > 10 && t1s < 3) ? 1 : 0;
  for (int i = t1s; i < total; ++i) {
    int32_t v = nzv[total - 1 - i];
    int32_t a = v < 0 ? -v : v;
    int64_t level_code = static_cast<int64_t>(a - 1) * 2 + (v < 0 ? 1 : 0);
    if (i == t1s && t1s < 3) level_code -= 2;
    if (suffix_len == 0) {
      if (level_code < 14) {
        bw.bits(1, static_cast<int>(level_code) + 1);
      } else if (level_code < 30) {
        bw.bits(1, 15);
        bw.bits(static_cast<uint32_t>(level_code - 14), 4);
      } else {
        int64_t lc = level_code - 30;
        int size = 12, prefix = 15;
        while (lc >= (1LL << size)) {
          lc -= (1LL << size);
          ++prefix;
          ++size;
        }
        bw.bits(0, prefix);
        bw.bit(1);
        bw.bits(static_cast<uint32_t>(lc), size);
      }
    } else {
      if (level_code < (15LL << suffix_len)) {
        int prefix = static_cast<int>(level_code >> suffix_len);
        bw.bits(1, prefix + 1);
        bw.bits(static_cast<uint32_t>(level_code) &
                    ((1u << suffix_len) - 1),
                suffix_len);
      } else {
        int64_t lc = level_code - (15LL << suffix_len);
        int size = 12, prefix = 15;
        while (lc >= (1LL << size)) {
          lc -= (1LL << size);
          ++prefix;
          ++size;
        }
        bw.bits(0, prefix);
        bw.bit(1);
        bw.bits(static_cast<uint32_t>(lc), size);
      }
    }
    if (suffix_len == 0) suffix_len = 1;
    if (a > (3 << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
  }
  int highest = idxs[total - 1];
  int total_zeros = highest + 1 - total;
  if (total < maxc) {
    uint32_t e = maxc == 4 ? kTotalZerosCdc[total - 1][total_zeros]
                           : kTotalZeros[total - 1][total_zeros];
    if (!e) return false;
    bw.bits(e & 0xFFFFFF, e >> 24);
  }
  int zeros_left = total_zeros;
  for (int i = total - 1; i > 0; --i) {
    int run = idxs[i] - idxs[i - 1] - 1;
    if (zeros_left > 0) {
      write_run_before(bw, zeros_left, run);
      zeros_left -= run;
    }
  }
  return true;
}

inline bool decode_residual(BitReader &br, int nC, int16_t *levels,
                            int *tot = nullptr) {
  return decode_residual_n(br, nC, levels, 16, tot);
}
inline bool decode_residual15(BitReader &br, int nC, int16_t *levels,
                              int *tot = nullptr) {
  return decode_residual_n(br, nC, levels, 15, tot);
}
inline bool encode_residual(BitWriter &bw, const int16_t *levels, int nC,
                            int *tot = nullptr) {
  return encode_residual_n(bw, levels, nC, 16, tot);
}
inline bool encode_residual15(BitWriter &bw, const int16_t *levels,
                              int nC, int *tot = nullptr) {
  return encode_residual_n(bw, levels, nC, 15, tot);
}

// --------------------------------------------------------------- NAL/EPB
void strip_epb(const uint8_t *in, int64_t n, std::vector<uint8_t> &out) {
  // memchr-accelerated: only zero bytes can begin an escape, so spans
  // up to the next 0x00 bulk-copy; the stateful walk runs only around
  // zeros (coded slice data is mostly nonzero — this was ~2% of the
  // requant wall alone as a byte loop)
  out.clear();
  out.reserve(n);
  int zeros = 0;
  int64_t i = 0;
  while (i < n) {
    if (zeros == 0) {
      const void *p = std::memchr(in + i, 0, static_cast<size_t>(n - i));
      int64_t nz = p ? static_cast<const uint8_t *>(p) - in : n;
      out.insert(out.end(), in + i, in + nz);
      if (!p) return;
      i = nz;
    }
    uint8_t b = in[i];
    if (zeros >= 2 && b == 0x03 && i + 1 < n && in[i + 1] <= 0x03) {
      zeros = 0;
      ++i;
      continue;
    }
    out.push_back(b);
    zeros = (b == 0) ? zeros + 1 : 0;
    ++i;
  }
}

void insert_epb(const std::vector<uint8_t> &in, std::vector<uint8_t> &out) {
  out.clear();
  out.reserve(in.size() + in.size() / 64 + 8);
  int zeros = 0;
  const uint8_t *d = in.data();
  size_t n = in.size(), i = 0;
  while (i < n) {
    if (zeros == 0) {                  // escape needs two zeros first:
      const void *p = std::memchr(d + i, 0, n - i);
      size_t nz = p ? static_cast<size_t>(
                          static_cast<const uint8_t *>(p) - d)
                    : n;
      out.insert(out.end(), d + i, d + nz);
      if (!p) return;
      i = nz;
    }
    uint8_t b = d[i];
    if (zeros >= 2 && b <= 0x03) {
      out.push_back(0x03);
      zeros = 0;
    }
    out.push_back(b);
    zeros = (b == 0) ? zeros + 1 : 0;
    ++i;
  }
}

// luma4x4BlkIdx → (x4, y4), spec 6.4.3
inline void blk_xy(int i, int *x, int *y) {
  *x = 2 * ((i >> 2) & 1) + (i & 1);
  *y = 2 * ((i >> 3) & 1) + ((i >> 1) & 1);
}

// ------------------------------------------------------- chroma requant
// Mirrors codecs/h264_transform.requant_chroma_scalar BIT-EXACTLY (same
// clips: the scalar module documents the overflow contract).  Per-MB
// three-way dispatch: identity (Table 8-15 saturation), exact +6k level
// shift, or the open-loop integer round trip (8.5.11 DC + 8.5.12 AC
// dequant → inverse core transform → JM forward requant at qpc_out).

constexpr int64_t kResClip = 4095;   // h264_transform.RES_CLIP
constexpr int64_t kWClip = 131071;   // h264_transform.W_CLIP

inline int64_t clip64(int64_t v, int64_t c) {
  return v > c ? c : (v < -c ? -c : v);
}

inline int64_t dz_shift(int64_t v, int k, int64_t dz) {
  int64_t a = (v < 0 ? -v : v) + dz;
  a >>= k;
  return v < 0 ? -a : a;
}

inline void hadamard2x2(const int64_t *c, int64_t *f) {
  f[0] = c[0] + c[1] + c[2] + c[3];
  f[1] = c[0] - c[1] + c[2] - c[3];
  f[2] = c[0] + c[1] - c[2] - c[3];
  f[3] = c[0] - c[1] - c[2] + c[3];
}

inline void inv_core4(int64_t *w) {     // rows then cols, in place
  for (int r = 0; r < 4; ++r) {
    int64_t a = w[4 * r], b = w[4 * r + 1], c = w[4 * r + 2],
            d = w[4 * r + 3];
    int64_t e0 = a + c, e1 = a - c, e2 = (b >> 1) - d, e3 = b + (d >> 1);
    w[4 * r] = e0 + e3;
    w[4 * r + 1] = e1 + e2;
    w[4 * r + 2] = e1 - e2;
    w[4 * r + 3] = e0 - e3;
  }
  for (int col = 0; col < 4; ++col) {
    int64_t a = w[col], b = w[4 + col], c = w[8 + col], d = w[12 + col];
    int64_t e0 = a + c, e1 = a - c, e2 = (b >> 1) - d, e3 = b + (d >> 1);
    w[col] = e0 + e3;
    w[4 + col] = e1 + e2;
    w[8 + col] = e1 - e2;
    w[12 + col] = e0 - e3;
  }
}

inline void fwd_core4(int64_t *x) {     // exact integer Cf·X·Cfᵀ
  for (int r = 0; r < 4; ++r) {
    int64_t x0 = x[4 * r], x1 = x[4 * r + 1], x2 = x[4 * r + 2],
            x3 = x[4 * r + 3];
    int64_t t0 = x0 + x3, t1 = x1 + x2, t2 = x1 - x2, t3 = x0 - x3;
    x[4 * r] = t0 + t1;
    x[4 * r + 1] = 2 * t3 + t2;
    x[4 * r + 2] = t0 - t1;
    x[4 * r + 3] = t3 - 2 * t2;
  }
  for (int col = 0; col < 4; ++col) {
    int64_t x0 = x[col], x1 = x[4 + col], x2 = x[8 + col],
            x3 = x[12 + col];
    int64_t t0 = x0 + x3, t1 = x1 + x2, t2 = x1 - x2, t3 = x0 - x3;
    x[col] = t0 + t1;
    x[4 + col] = 2 * t3 + t2;
    x[8 + col] = t0 - t1;
    x[12 + col] = t3 - 2 * t2;
  }
}

// dc: 16-wide row (4 used, 2×2 raster); ac: 4 rows of 16 (15 used,
// zigzag tails).  Rewrites both at qpc_out.
//
// Clip contract: decode_residual_n clamps every parsed level to
// ±kLevelClip at store time, so the identity and shift arms below see
// pre-clipped inputs — byte-identical to the Python oracle, which parses
// unclipped and clamps inside requant_chroma_scalar instead.
void chroma_requant_comp(int16_t *dc, int16_t *ac, int qpc_in,
                         int qpc_out) {
  int delta = qpc_out - qpc_in;
  if (delta == 0) return;
  if (delta % 6 == 0 && delta > 0) {
    // exact-shift arm, vectorizable: the AC rows are 16-wide with the
    // 16th entry always zero (and a zero shifts to zero since the
    // deadzone is < 2^k), so one contiguous 64-element pass replaces
    // the strided 4x15 loop — this arm runs for every chroma-bearing
    // MB of a +6k ladder and was ~22% of the walk
    int k = delta / 6;
    int32_t dz = (1 << k) / 3;
    for (int i = 0; i < 4; ++i) {
      int32_t v = dc[i];
      int32_t a = ((v < 0 ? -v : v) + dz) >> k;
      dc[i] = static_cast<int16_t>(v < 0 ? -a : a);
    }
    for (int i = 0; i < 64; ++i) {
      int32_t v = ac[i];
      int32_t a = ((v < 0 ? -v : v) + dz) >> k;
      ac[i] = static_cast<int16_t>(v < 0 ? -a : a);
    }
    return;
  }
  // integer round-trip arm, all-int32: every intermediate fits — w ≤
  // 2047·18·2^8 ≈ 9.4M, transform sums ≤ ~300K (clipped ±4095/±131071),
  // and a·MF ≤ 131071·13107 ≈ 1.72e9 < 2^31 — which lets the 4x16-wide
  // loops vectorize (this arm was ~23% of the CAVLC walk at QPc deltas
  // off the +6k lattice, e.g. any rung crossing the Table 8-15 knee)
  int mi = qpc_in % 6, si = qpc_in / 6;
  int mo = qpc_out % 6, so = qpc_out / 6;
  auto clip32 = [](int32_t v, int32_t c) {
    return v < -c ? -c : (v > c ? c : v);
  };
  int32_t c[4], f2[4], dcc[4], w00[4];
  for (int i = 0; i < 4; ++i) c[i] = clip32(dc[i], kLevelClip);
  f2[0] = c[0] + c[1] + c[2] + c[3];
  f2[1] = c[0] - c[1] + c[2] - c[3];
  f2[2] = c[0] + c[1] - c[2] - c[3];
  f2[3] = c[0] - c[1] - c[2] + c[3];
  for (int i = 0; i < 4; ++i)
    dcc[i] = (f2[i] * kVPos[mi][0] * (1 << si)) >> 1;
  int qbits = 15 + so;
  int32_t off = (1 << qbits) / 3;
  for (int b = 0; b < 4; ++b) {
    int32_t w[16] = {0};
    for (int i = 0; i < 15; ++i) {
      int pos = kZigzag4[1 + i];
      w[pos] =
          clip32(ac[16 * b + i], kLevelClip) * kVPos[mi][pos] * (1 << si);
    }
    w[0] = dcc[b];
    // inverse core (8.5.12 butterflies), rows then columns
    for (int r = 0; r < 4; ++r) {
      int32_t *p = w + 4 * r;
      int32_t e0 = p[0] + p[2], e1 = p[0] - p[2];
      int32_t e2 = (p[1] >> 1) - p[3], e3 = p[1] + (p[3] >> 1);
      p[0] = e0 + e3;
      p[1] = e1 + e2;
      p[2] = e1 - e2;
      p[3] = e0 - e3;
    }
    for (int col = 0; col < 4; ++col) {
      int32_t *p = w + col;
      int32_t e0 = p[0] + p[8], e1 = p[0] - p[8];
      int32_t e2 = (p[4] >> 1) - p[12], e3 = p[4] + (p[12] >> 1);
      p[0] = e0 + e3;
      p[4] = e1 + e2;
      p[8] = e1 - e2;
      p[12] = e0 - e3;
    }
    for (int i = 0; i < 16; ++i)
      w[i] = clip32((w[i] + 32) >> 6, static_cast<int32_t>(kResClip));
    // forward core (Cf·X·Cfᵀ), rows then columns
    for (int r = 0; r < 4; ++r) {
      int32_t *p = w + 4 * r;
      int32_t s0 = p[0] + p[3], s1 = p[1] + p[2];
      int32_t d0 = p[0] - p[3], d1 = p[1] - p[2];
      p[0] = s0 + s1;
      p[1] = 2 * d0 + d1;
      p[2] = s0 - s1;
      p[3] = d0 - 2 * d1;
    }
    for (int col = 0; col < 4; ++col) {
      int32_t *p = w + col;
      int32_t s0 = p[0] + p[12], s1 = p[4] + p[8];
      int32_t d0 = p[0] - p[12], d1 = p[4] - p[8];
      p[0] = s0 + s1;
      p[4] = 2 * d0 + d1;
      p[8] = s0 - s1;
      p[12] = d0 - 2 * d1;
    }
    for (int i = 0; i < 16; ++i)
      w[i] = clip32(w[i], static_cast<int32_t>(kWClip));
    w00[b] = w[0];
    for (int i = 0; i < 15; ++i) {
      int pos = kZigzag4[1 + i];
      int32_t a = w[pos] < 0 ? -w[pos] : w[pos];
      int32_t q = static_cast<int32_t>(
          (static_cast<int64_t>(a) * kMFPos[mo][pos] + off) >> qbits);
      ac[16 * b + i] =
          static_cast<int16_t>(clip32(w[pos] < 0 ? -q : q, kLevelClip));
    }
  }
  f2[0] = w00[0] + w00[1] + w00[2] + w00[3];
  f2[1] = w00[0] - w00[1] + w00[2] - w00[3];
  f2[2] = w00[0] + w00[1] - w00[2] - w00[3];
  f2[3] = w00[0] - w00[1] - w00[2] + w00[3];
  for (int i = 0; i < 4; ++i) {
    int32_t v = clip32(f2[i], static_cast<int32_t>(kWClip));
    int32_t a = v < 0 ? -v : v;
    int32_t q = static_cast<int32_t>(
        (static_cast<int64_t>(a) * kMFPos[mo][0] + 2 * off) >>
        (qbits + 1));
    dc[i] = static_cast<int16_t>(clip32(v < 0 ? -q : q, kLevelClip));
  }
}

struct SliceHeader {
  int nal_type, nal_ref_idc, slice_type;
  uint32_t frame_num, idr_pic_id, poc_lsb;
  int no_output_prior, long_term_ref;
  int32_t qp;
  uint32_t deblock_idc;
  int32_t deblock_alpha, deblock_beta;
  // P-slice fields (7.3.3 + 7.3.3.1/7.3.3.3), round-tripped raw
  bool is_p = false;
  int num_ref_override = 0;
  uint32_t num_ref_l0_minus1 = 0;
  bool have_list_mod = false;
  std::vector<uint32_t> list_mod;                // (idc, val) pairs
  bool have_mmco = false;
  std::vector<uint32_t> mmco;                    // op then its args
  uint32_t cabac_init_idc = 0;
  int n_ref = 1;                                 // active l0 count
};

// shared I/P slice header parse (mirrors SliceCodec.parse_slice_header);
// 0 on success, kErr* otherwise
int parse_islice_header(BitReader &br, int nal_type, int nal_ref_idc,
                        int32_t log2_max_frame_num, int32_t poc_type,
                        int32_t log2_max_poc_lsb, int32_t pic_init_qp,
                        int32_t deblocking_control,
                        int32_t bottom_field_poc, SliceHeader *h,
                        uint32_t *first_mb, int32_t num_ref_l0_default = 0,
                        int32_t weighted_pred = 0, int32_t cabac = 0) {
  h->nal_type = nal_type;
  h->nal_ref_idc = nal_ref_idc;
  *first_mb = br.ue();                             // first_mb_in_slice
  h->slice_type = static_cast<int>(br.ue());
  {
    int st = h->slice_type % 5;
    if (st != 2 && st != 0) return kErrUnsupported;
    h->is_p = st == 0;
  }
  br.ue();                                         // pps id
  h->frame_num = br.bits(log2_max_frame_num);
  if (nal_type == 5) h->idr_pic_id = br.ue();
  if (poc_type == 0) {
    if (bottom_field_poc) return kErrUnsupported;
    h->poc_lsb = br.bits(log2_max_poc_lsb);
  } else if (poc_type == 1) {
    return kErrUnsupported;
  }
  if (h->is_p) {
    if (weighted_pred) return kErrUnsupported;     // explicit tables
    h->num_ref_override = br.bit();
    if (h->num_ref_override) h->num_ref_l0_minus1 = br.ue();
    h->n_ref = 1 + static_cast<int>(
                       h->num_ref_override
                           ? h->num_ref_l0_minus1
                           : static_cast<uint32_t>(num_ref_l0_default));
    if (br.bit()) {                                // 7.3.3.1 list mod l0
      h->have_list_mod = true;
      for (;;) {
        uint32_t idc = br.ue();
        if (idc == 3) break;
        if (idc > 3 || !br.ok) return kErrBitstream;
        h->list_mod.push_back(idc);
        h->list_mod.push_back(br.ue());
        if (h->list_mod.size() > 128) return kErrBitstream;
      }
    }
  }
  if (nal_ref_idc != 0) {
    if (nal_type == 5) {
      h->no_output_prior = br.bit();
      h->long_term_ref = br.bit();
    } else if (br.bit()) {                         // MMCO loop (7.4.3.3)
      h->have_mmco = true;
      for (;;) {
        uint32_t op = br.ue();
        h->mmco.push_back(op);
        if (op == 0) break;
        if (op == 1 || op == 2 || op == 4 || op == 6) {
          h->mmco.push_back(br.ue());
        } else if (op == 3) {
          h->mmco.push_back(br.ue());
          h->mmco.push_back(br.ue());
        } else if (op != 5) {
          return kErrBitstream;
        }
        if (h->mmco.size() > 128 || !br.ok) return kErrBitstream;
      }
    }
  }
  if (cabac && h->is_p) {
    h->cabac_init_idc = br.ue();
    if (h->cabac_init_idc > 2) return kErrBitstream;
  }
  h->qp = pic_init_qp + br.se();
  if (deblocking_control) {
    h->deblock_idc = br.ue();
    if (h->deblock_idc != 1) {
      h->deblock_alpha = br.se();
      h->deblock_beta = br.se();
    }
  }
  if (!br.ok || h->qp < 0 || h->qp > 51) return kErrBitstream;
  return 0;
}

void write_islice_header(BitWriter &bw, const SliceHeader &h,
                         uint32_t first_mb, int32_t pps_id,
                         int32_t qp_out_base, int32_t log2_max_frame_num,
                         int32_t poc_type, int32_t log2_max_poc_lsb,
                         int32_t pic_init_qp, int32_t deblocking_control,
                         int32_t cabac = 0) {
  bw.ue(first_mb);
  bw.ue(static_cast<uint32_t>(h.slice_type));
  bw.ue(static_cast<uint32_t>(pps_id));            // the latched PPS's id
  bw.bits(h.frame_num, log2_max_frame_num);
  if (h.nal_type == 5) bw.ue(h.idr_pic_id);
  if (poc_type == 0) bw.bits(h.poc_lsb, log2_max_poc_lsb);
  if (h.is_p) {
    bw.bit(h.num_ref_override);
    if (h.num_ref_override) bw.ue(h.num_ref_l0_minus1);
    bw.bit(h.have_list_mod ? 1 : 0);
    if (h.have_list_mod) {
      for (uint32_t v : h.list_mod) bw.ue(v);
      bw.ue(3);
    }
  }
  if (h.nal_ref_idc != 0) {
    if (h.nal_type == 5) {
      bw.bit(h.no_output_prior);
      bw.bit(h.long_term_ref);
    } else {
      bw.bit(h.have_mmco ? 1 : 0);
      if (h.have_mmco)
        for (uint32_t v : h.mmco) bw.ue(v);
    }
  }
  if (cabac && h.is_p) bw.ue(h.cabac_init_idc);
  bw.se(qp_out_base - pic_init_qp);
  if (deblocking_control) {
    bw.ue(h.deblock_idc);
    if (h.deblock_idc != 1) {
      bw.se(h.deblock_alpha);
      bw.se(h.deblock_beta);
    }
  }
}

}  // namespace

extern "C" int32_t ed_h264_requant_slice(
    const uint8_t *nal, int32_t nal_len, uint8_t *out, int32_t out_cap,
    int32_t width_mbs, int32_t height_mbs, int32_t log2_max_frame_num,
    int32_t poc_type, int32_t log2_max_poc_lsb, int32_t pic_init_qp,
    int32_t pps_id, int32_t deblocking_control, int32_t bottom_field_poc,
    int32_t delta_qp, int32_t chroma_qp_offset,
    int32_t num_ref_l0_default, int32_t weighted_pred, int32_t *mbs_out,
    int32_t *blocks_out) {
  // FUSED single-pass walk (round-5): each MB is decoded, requantized
  // and re-encoded before the next is touched — no slice-wide level
  // store, no second walk.  Two small context grids (parse-side and
  // write-side nC totals) replace the re-fill of one grid; everything
  // the MB needs lives in ~1.5 KB of scratch that stays in L1.
  // Covers I AND P slices (mirrors codecs/h264_requant.py byte for
  // byte): P adds mb_skip_run copy-through, inter MB types 0-4 with
  // motion syntax carried verbatim, and the Table 9-4 inter CBP map.
  if (nal_len < 2 || delta_qp < 6 || delta_qp % 6) return kErrUnsupported;
  uint8_t nal_byte = nal[0];
  int nal_type = nal_byte & 0x1F;
  int nal_ref_idc = (nal_byte >> 5) & 3;
  if (nal_type != 1 && nal_type != 5) return kErrUnsupported;

  std::vector<uint8_t> rbsp;
  strip_epb(nal + 1, nal_len - 1, rbsp);
  BitReader br(rbsp.data(), static_cast<int64_t>(rbsp.size()));

  SliceHeader h{};
  uint32_t first_mb = 0;
  int hrc = parse_islice_header(br, nal_type, nal_ref_idc,
                                log2_max_frame_num, poc_type,
                                log2_max_poc_lsb, pic_init_qp,
                                deblocking_control, bottom_field_poc, &h,
                                &first_mb, num_ref_l0_default,
                                weighted_pred, 0);
  if (hrc) return hrc;

  int n_mbs = width_mbs * height_mbs;
  int w4 = width_mbs * 4, h4 = height_mbs * 4;
  int w2 = width_mbs * 2, h2 = height_mbs * 2;
  if (first_mb >= static_cast<uint32_t>(n_mbs)) return kErrBitstream;
  // parse-side and write-side nC context grids (write contexts depend
  // on POST-requant totals, so they are tracked separately)
  std::vector<int16_t> tin(static_cast<size_t>(h4) * w4, -1);
  std::vector<int16_t> tout(static_cast<size_t>(h4) * w4, -1);
  std::vector<int16_t> cin(static_cast<size_t>(2) * h2 * w2, -1);
  std::vector<int16_t> cout_(static_cast<size_t>(2) * h2 * w2, -1);

  auto nc_at = [&](const std::vector<int16_t> &g, int gx, int gy) -> int {
    int nA = gx > 0 ? g[static_cast<size_t>(gy) * w4 + gx - 1] : -1;
    int nB = gy > 0 ? g[static_cast<size_t>(gy - 1) * w4 + gx] : -1;
    if (nA >= 0 && nB >= 0) return (nA + nB + 1) >> 1;
    if (nA >= 0) return nA;
    if (nB >= 0) return nB;
    return 0;
  };
  auto nc_at_c = [&](const std::vector<int16_t> &g0, int comp, int gx,
                     int gy) -> int {
    const int16_t *g = &g0[static_cast<size_t>(comp) * h2 * w2];
    int nA = gx > 0 ? g[static_cast<size_t>(gy) * w2 + gx - 1] : -1;
    int nB = gy > 0 ? g[static_cast<size_t>(gy - 1) * w2 + gx] : -1;
    if (nA >= 0 && nB >= 0) return (nA + nB + 1) >> 1;
    if (nA >= 0) return nA;
    if (nB >= 0) return nB;
    return 0;
  };
  auto qpc_of = [&](int32_t qpy) -> int {
    int q = qpy + chroma_qp_offset;
    if (q < 0) q = 0;
    if (q > 51) q = 51;
    return kChromaQp[q];
  };

  int k = delta_qp / 6;
  int deadzone = (1 << k) / 3;
  auto shift_row = [&](int16_t *lv, int n) {
    bool any = false;
    for (int i = 0; i < n; ++i) {
      int32_t v = lv[i];
      int32_t a = v < 0 ? -v : v;
      if (a > kLevelClip) a = kLevelClip;
      a = (a + deadzone) >> k;
      lv[i] = static_cast<int16_t>(v < 0 ? -a : a);
      any |= lv[i] != 0;
    }
    return any;
  };

  BitWriter bw;
  int32_t qp_out_base = h.qp + delta_qp;
  if (qp_out_base > 51) return kErrUnsupported;
  write_islice_header(bw, h, first_mb, pps_id, qp_out_base,
                      log2_max_frame_num, poc_type, log2_max_poc_lsb,
                      pic_init_qp, deblocking_control, 0);

  // ---- per-MB scratch (fits L1) ----
  int16_t dc[16], lv[16][16];
  int16_t cdcr[2][16], cacr[2][4][16];
  uint8_t modes[16][2];
  uint32_t sub_t[4];
  int refs[4];
  int32_t mvd[16][2];

  // one MB's chroma: parse with parse-side contexts, requant, report
  // the new chroma CBP; then emit with write-side contexts
  auto parse_chroma = [&](int mb, int ccbp, int32_t qpy,
                          int *new_ccbp) -> bool {
    int mbx2 = (mb % width_mbs) * 2, mby2 = (mb / width_mbs) * 2;
    if (ccbp) {
      for (int comp = 0; comp < 2; ++comp)
        if (!decode_residual_n(br, -1, cdcr[comp], 4)) return false;
    } else {
      std::memset(cdcr, 0, sizeof(cdcr));
    }
    for (int comp = 0; comp < 2; ++comp) {
      int16_t *g = &cin[static_cast<size_t>(comp) * h2 * w2];
      for (int b = 0; b < 4; ++b) {
        int gx = mbx2 + (b & 1), gy = mby2 + (b >> 1);
        if (ccbp != 2) {
          g[static_cast<size_t>(gy) * w2 + gx] = 0;
          std::memset(cacr[comp][b], 0, sizeof(cacr[comp][b]));
          continue;
        }
        int nC = nc_at_c(cin, comp, gx, gy);
        int tot;
        if (!decode_residual_n(br, nC, cacr[comp][b], 15, &tot))
          return false;
        g[static_cast<size_t>(gy) * w2 + gx] = static_cast<int16_t>(tot);
      }
    }
    if (!ccbp) {
      *new_ccbp = 0;
      return true;
    }
    for (int comp = 0; comp < 2; ++comp)
      chroma_requant_comp(cdcr[comp], &cacr[comp][0][0], qpc_of(qpy),
                          qpc_of(qpy + delta_qp));
    bool any_ac = false, any_dc = false;
    const int16_t *dflat = &cdcr[0][0];
    const int16_t *aflat = &cacr[0][0][0];
    for (int i = 0; i < 2 * 16; ++i) any_dc |= dflat[i] != 0;
    for (int i = 0; i < 2 * 4 * 16; ++i) any_ac |= aflat[i] != 0;
    *new_ccbp = any_ac ? 2 : (any_dc ? 1 : 0);
    return true;
  };
  auto write_chroma = [&](int mb, int ccbp) -> bool {
    int mbx2 = (mb % width_mbs) * 2, mby2 = (mb / width_mbs) * 2;
    if (ccbp) {
      for (int comp = 0; comp < 2; ++comp)
        if (!encode_residual_n(bw, cdcr[comp], -1, 4)) return false;
    }
    for (int comp = 0; comp < 2; ++comp) {
      int16_t *g = &cout_[static_cast<size_t>(comp) * h2 * w2];
      for (int b = 0; b < 4; ++b) {
        int gx = mbx2 + (b & 1), gy = mby2 + (b >> 1);
        if (ccbp != 2) {
          g[static_cast<size_t>(gy) * w2 + gx] = 0;
          continue;
        }
        int nC = nc_at_c(cout_, comp, gx, gy);
        int tot;
        if (!encode_residual_n(bw, cacr[comp][b], nC, 15, &tot))
          return false;
        g[static_cast<size_t>(gy) * w2 + gx] = static_cast<int16_t>(tot);
      }
    }
    return true;
  };
  auto zero_mb_cells = [&](int mb) {
    int mb_x = (mb % width_mbs) * 4, mb_y = (mb / width_mbs) * 4;
    for (int r = 0; r < 4; ++r) {
      std::memset(&tin[static_cast<size_t>(mb_y + r) * w4 + mb_x], 0,
                  4 * sizeof(int16_t));
      std::memset(&tout[static_cast<size_t>(mb_y + r) * w4 + mb_x], 0,
                  4 * sizeof(int16_t));
    }
    int cx = (mb % width_mbs) * 2, cy = (mb / width_mbs) * 2;
    for (int comp = 0; comp < 2; ++comp)
      for (int r = 0; r < 2; ++r) {
        cin[(static_cast<size_t>(comp) * h2 + cy + r) * w2 + cx] = 0;
        cin[(static_cast<size_t>(comp) * h2 + cy + r) * w2 + cx + 1] = 0;
        cout_[(static_cast<size_t>(comp) * h2 + cy + r) * w2 + cx] = 0;
        cout_[(static_cast<size_t>(comp) * h2 + cy + r) * w2 + cx + 1] =
            0;
      }
  };

  int64_t blk_count = 0;
  int32_t cur_qp = h.qp;
  int32_t prev_qp = qp_out_base;
  int end_mb = n_mbs;
  int mb = static_cast<int>(first_mb);
  bool first_iter = true;
  while (mb < n_mbs) {
    if (!first_iter && !br.more_rbsp_data()) {
      end_mb = mb;
      break;
    }
    if (h.is_p) {
      uint32_t run = br.ue();                    // mb_skip_run
      if (!br.ok || mb + static_cast<int64_t>(run) > n_mbs)
        return kErrBitstream;
      bw.ue(run);                                // skip map is verbatim
      for (uint32_t s = 0; s < run; ++s) zero_mb_cells(mb++);
      if (!br.more_rbsp_data()) {                // slice ends on a run
        end_mb = mb;
        first_iter = false;
        break;
      }
      if (mb >= n_mbs) return kErrBitstream;
    }
    first_iter = false;
    uint32_t raw_type = br.ue();
    if (!br.ok) return kErrBitstream;
    int mb_x = (mb % width_mbs) * 4, mb_y = (mb / width_mbs) * 4;

    if (h.is_p && raw_type < 5) {
      // ---------------- P inter MB: motion verbatim, residuals shift
      int n_sub_mvds = 0;
      int n_parts = 0;
      bool has_refs = raw_type != 4 && h.n_ref > 1;
      if (raw_type <= 2) {
        n_parts = raw_type == 0 ? 1 : 2;
        for (int p = 0; p < n_parts && has_refs; ++p) {
          refs[p] = h.n_ref == 2 ? 1 - br.bit()
                                 : static_cast<int>(br.ue());
          if (refs[p] >= h.n_ref) return kErrBitstream;
        }
        for (int p = 0; p < n_parts; ++p) {
          mvd[p][0] = br.se();
          mvd[p][1] = br.se();
        }
        n_sub_mvds = n_parts;
      } else {
        for (int s = 0; s < 4; ++s) {
          sub_t[s] = br.ue();
          if (sub_t[s] > 3) return kErrBitstream;
        }
        for (int p = 0; p < 4 && has_refs; ++p) {
          refs[p] = h.n_ref == 2 ? 1 - br.bit()
                                 : static_cast<int>(br.ue());
          if (refs[p] >= h.n_ref) return kErrBitstream;
        }
        static const int kSubParts[4] = {1, 2, 2, 4};
        for (int s = 0; s < 4; ++s)
          for (int p = 0; p < kSubParts[sub_t[s]]; ++p) {
            mvd[n_sub_mvds][0] = br.se();
            mvd[n_sub_mvds][1] = br.se();
            ++n_sub_mvds;
          }
      }
      uint32_t code = br.ue();
      if (!br.ok || code >= 48) return kErrBitstream;
      int cbp_in = kCbpInterFromCode[code];
      if (cbp_in) {
        cur_qp += br.se();                       // cumulative (7.4.5)
        if (cur_qp < 0 || cur_qp > 51) return kErrBitstream;
        if (cur_qp + delta_qp > 51) return kErrUnsupported;
      }
      int out_cbp = 0;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mb_x + x4, gy = mb_y + y4;
        if (!((cbp_in >> (b >> 2)) & 1)) {
          tin[static_cast<size_t>(gy) * w4 + gx] = 0;
          std::memset(lv[b], 0, sizeof(lv[b]));
          continue;
        }
        int nC = nc_at(tin, gx, gy);
        int tot;
        if (!decode_residual(br, nC, lv[b], &tot)) return kErrBitstream;
        tin[static_cast<size_t>(gy) * w4 + gx] =
            static_cast<int16_t>(tot);
        if (shift_row(lv[b], 16)) out_cbp |= 1 << (b >> 2);
      }
      int new_ccbp = 0;
      blk_count += 16 + ((cbp_in >> 4) ? 8 : 0);
      if (!parse_chroma(mb, cbp_in >> 4, cur_qp, &new_ccbp))
        return kErrBitstream;
      // ---- emit
      bw.ue(raw_type);
      if (raw_type <= 2) {
        for (int p = 0; p < n_parts && has_refs; ++p) {
          if (h.n_ref == 2)
            bw.bit(1 - refs[p]);
          else
            bw.ue(static_cast<uint32_t>(refs[p]));
        }
        for (int p = 0; p < n_parts; ++p) {
          bw.se(mvd[p][0]);
          bw.se(mvd[p][1]);
        }
      } else {
        for (int s = 0; s < 4; ++s) bw.ue(sub_t[s]);
        for (int p = 0; p < 4 && has_refs; ++p) {
          if (h.n_ref == 2)
            bw.bit(1 - refs[p]);
          else
            bw.ue(static_cast<uint32_t>(refs[p]));
        }
        for (int p = 0; p < n_sub_mvds; ++p) {
          bw.se(mvd[p][0]);
          bw.se(mvd[p][1]);
        }
      }
      int full_cbp = out_cbp | (new_ccbp << 4);
      bw.ue(kCbpInterToCode[full_cbp]);
      if (full_cbp) {
        int32_t qp_out_mb = cur_qp + delta_qp;
        int32_t d = qp_out_mb - prev_qp;
        if (d < -26 || d > 25) return kErrUnsupported;
        bw.se(d);
        prev_qp = qp_out_mb;
      }
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mb_x + x4, gy = mb_y + y4;
        if (!((out_cbp >> (b >> 2)) & 1)) {
          tout[static_cast<size_t>(gy) * w4 + gx] = 0;
          continue;
        }
        int tot;
        if (!encode_residual(bw, lv[b], nc_at(tout, gx, gy), &tot))
          return kErrBitstream;
        tout[static_cast<size_t>(gy) * w4 + gx] =
            static_cast<int16_t>(tot);
      }
      if (!write_chroma(mb, new_ccbp)) return kErrBitstream;
      ++mb;
      continue;
    }

    uint32_t mb_type = h.is_p ? raw_type - 5 : raw_type;
    if (mb_type >= 1 && mb_type <= 24) {
      // ---------------- I_16x16
      int pred = static_cast<int>(mb_type - 1) % 4;
      int chroma_cbp = (static_cast<int>(mb_type - 1) / 4) % 3;
      bool luma15 = mb_type >= 13;
      uint32_t cmode = br.ue();
      cur_qp += br.se();                         // always coded for I16
      if (cur_qp < 12 || cur_qp > 51) return kErrUnsupported;
      if (cur_qp + delta_qp > 51) return kErrUnsupported;
      if (!decode_residual(br, nc_at(tin, mb_x, mb_y), dc))
        return kErrBitstream;
      shift_row(dc, 16);
      bool any_ac = false;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mb_x + x4, gy = mb_y + y4;
        if (!luma15) {
          tin[static_cast<size_t>(gy) * w4 + gx] = 0;
          std::memset(lv[b], 0, sizeof(lv[b]));
          continue;
        }
        int nC = nc_at(tin, gx, gy);
        int tot;
        if (!decode_residual15(br, nC, lv[b], &tot)) return kErrBitstream;
        tin[static_cast<size_t>(gy) * w4 + gx] =
            static_cast<int16_t>(tot);
        any_ac |= shift_row(lv[b], 15);
      }
      int new_ccbp = 0;
      blk_count += 17 + (chroma_cbp ? 8 : 0);
      if (!parse_chroma(mb, chroma_cbp, cur_qp, &new_ccbp))
        return kErrBitstream;
      // ---- emit
      bool out15 = luma15 && any_ac;
      bw.ue((h.is_p ? 5u : 0u) + 1 + pred + 4 * new_ccbp +
            (out15 ? 12 : 0));
      bw.ue(cmode);
      int32_t qp_out_mb = cur_qp + delta_qp;
      int32_t d = qp_out_mb - prev_qp;
      if (d < -26 || d > 25) return kErrUnsupported;
      bw.se(d);
      prev_qp = qp_out_mb;
      if (!encode_residual(bw, dc, nc_at(tout, mb_x, mb_y)))
        return kErrBitstream;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mb_x + x4, gy = mb_y + y4;
        if (!out15) {
          tout[static_cast<size_t>(gy) * w4 + gx] = 0;
          continue;
        }
        int tot;
        if (!encode_residual15(bw, lv[b], nc_at(tout, gx, gy), &tot))
          return kErrBitstream;
        tout[static_cast<size_t>(gy) * w4 + gx] =
            static_cast<int16_t>(tot);
      }
      if (!write_chroma(mb, new_ccbp)) return kErrBitstream;
      ++mb;
      continue;
    }
    if (mb_type != 0) return kErrUnsupported;    // I_PCM etc.
    // ---------------- I_4x4
    for (int b = 0; b < 16; ++b) {
      modes[b][0] = static_cast<uint8_t>(br.bit());
      modes[b][1] =
          static_cast<uint8_t>(modes[b][0] ? 0 : br.bits(3));
    }
    uint32_t cmode = br.ue();
    uint32_t code = br.ue();
    if (!br.ok || code >= 48) return kErrBitstream;
    int cbp_in = kCbpIntraFromCode[code];
    if (cbp_in) {
      cur_qp += br.se();                         // cumulative (7.4.5)
      if (cur_qp < 0 || cur_qp > 51) return kErrBitstream;
      if (cur_qp + delta_qp > 51) return kErrUnsupported;
    }
    int out_cbp = 0;
    for (int b = 0; b < 16; ++b) {
      int x4, y4;
      blk_xy(b, &x4, &y4);
      int gx = mb_x + x4, gy = mb_y + y4;
      if (!((cbp_in >> (b >> 2)) & 1)) {
        tin[static_cast<size_t>(gy) * w4 + gx] = 0;
        std::memset(lv[b], 0, sizeof(lv[b]));
        continue;
      }
      int nC = nc_at(tin, gx, gy);
      int tot;
      if (!decode_residual(br, nC, lv[b], &tot)) return kErrBitstream;
      tin[static_cast<size_t>(gy) * w4 + gx] = static_cast<int16_t>(tot);
      // requant: the +6k shift with the intra deadzone (bit-exact with
      // requant_levels_scalar / ops.transform.h264_requant)
      if (shift_row(lv[b], 16)) out_cbp |= 1 << (b >> 2);
    }
    int new_ccbp = 0;
    blk_count += 16 + ((cbp_in >> 4) ? 8 : 0);
    if (!parse_chroma(mb, cbp_in >> 4, cur_qp, &new_ccbp))
      return kErrBitstream;
    // ---- emit
    bw.ue(h.is_p ? 5u : 0u);                     // mb_type I_4x4
    for (int b = 0; b < 16; ++b) {
      bw.bit(modes[b][0]);
      if (!modes[b][0]) bw.bits(modes[b][1], 3);
    }
    bw.ue(cmode);
    int full_cbp = out_cbp | (new_ccbp << 4);
    bw.ue(kCbpIntraToCode[full_cbp]);
    if (full_cbp) {
      int32_t qp_out_mb = cur_qp + delta_qp;
      int32_t d = qp_out_mb - prev_qp;
      if (d < -26 || d > 25) return kErrUnsupported;
      bw.se(d);
      prev_qp = qp_out_mb;
    }
    for (int b = 0; b < 16; ++b) {
      int x4, y4;
      blk_xy(b, &x4, &y4);
      int gx = mb_x + x4, gy = mb_y + y4;
      if (!((out_cbp >> (b >> 2)) & 1)) {
        tout[static_cast<size_t>(gy) * w4 + gx] = 0;
        continue;
      }
      int tot;
      if (!encode_residual(bw, lv[b], nc_at(tout, gx, gy), &tot))
        return kErrBitstream;
      tout[static_cast<size_t>(gy) * w4 + gx] = static_cast<int16_t>(tot);
    }
    if (!write_chroma(mb, new_ccbp)) return kErrBitstream;
    ++mb;
  }
  if (!br.ok) return kErrBitstream;
  if (mb >= n_mbs) end_mb = n_mbs;
  if (mbs_out) *mbs_out = end_mb - static_cast<int>(first_mb);
  if (blocks_out)
    *blocks_out = static_cast<int32_t>(
        blk_count > INT32_MAX ? INT32_MAX : blk_count);

  bw.trailing();
  std::vector<uint8_t> wire;
  insert_epb(bw.out, wire);
  if (static_cast<int64_t>(wire.size()) + 1 > out_cap) return kErrOverflow;
  out[0] = nal_byte;
  std::memcpy(out + 1, wire.data(), wire.size());
  return static_cast<int32_t>(wire.size()) + 1;
}


// ===================================================================
// CABAC requant (mirrors codecs/h264_cabac.py BIT-EXACTLY; spec
// 9.3.3.2 / 9.3.4 engines, I-slice syntax, ctxBlockCat 0-4).  Tables
// come from h264_tables.h, generated from the Python source of truth.
// ===================================================================

namespace {

constexpr int kSigBase[5] = {105, 120, 134, 149, 152};
constexpr int kLastBase[5] = {166, 181, 195, 210, 213};
constexpr int kAbsBase[5] = {227, 237, 247, 257, 266};

// merged 7-bit state transitions (state = pStateIdx<<1 | valMPS): one
// table lookup replaces shift/mask/branch per bin
struct StateTables {
  uint8_t mps[128], lps[128];
  StateTables() {
    for (int s = 0; s < 128; ++s) {
      int p = s >> 1, m = s & 1;
      mps[s] = static_cast<uint8_t>((kCabacTransMps[p] << 1) | m);
      int m2 = p == 0 ? m ^ 1 : m;
      lps[s] = static_cast<uint8_t>((kCabacTransLps[p] << 1) | m2);
    }
  }
};
const StateTables kST;

inline void cabac_init_states(uint8_t *state, int qp,
                              const int8_t (*table)[2] = kCabacCtxInitI) {
  qp = qp < 0 ? 0 : (qp > 51 ? 51 : qp);
  for (int i = 0; i < 1024; ++i) {
    int pre = ((table[i][0] * qp) >> 4) + table[i][1];
    pre = pre < 1 ? 1 : (pre > 126 ? 126 : pre);
    state[i] = pre <= 63 ? static_cast<uint8_t>((63 - pre) << 1)
                         : static_cast<uint8_t>(((pre - 64) << 1) | 1);
  }
}

struct CabacDec {
  // 9.3.3.2 arithmetic decoder over a 64-bit MSB-aligned bit window:
  // renorm consumes its shift in ONE masked read (CLZ-derived) instead
  // of a bounds-checked per-bit feed — the round-4 engine's dominant
  // cost.  Reads past the RBSP still yield 0-bits with a bounded
  // overrun before the stream is declared corrupt, matching the
  // Python oracle's rule.
  const uint8_t *d = nullptr;
  int64_t nbits = 0;       // RBSP length in bits
  int64_t bytepos = 0;     // next byte to load into the window
  uint64_t win = 0;        // MSB-first lookahead
  int winbits = 0;
  bool ok = true;
  uint32_t range = 510, offset = 0;
  uint8_t state[1024];

  void refill() {
    int64_t avail = (nbits + 7) >> 3;
    if (bytepos + 8 <= avail) {
      // fast path: one unaligned big-endian load tops the window up
      uint64_t v;
      std::memcpy(&v, d + bytepos, 8);
      win |= __builtin_bswap64(v) >> winbits;
      bytepos += (63 - winbits) >> 3;
      winbits |= 56;
      return;
    }
    while (winbits <= 56) {
      uint64_t b = bytepos < avail ? d[bytepos] : 0;
      win |= b << (56 - winbits);
      ++bytepos;
      winbits += 8;
    }
    // consumed position = bytepos*8 - winbits; past the RBSP by more
    // than the Python oracle's 64-bit overrun allowance → corrupt
    if ((bytepos << 3) - winbits > nbits + 64) ok = false;
  }

  inline uint32_t take(int n) {
    if (winbits < n) refill();
    uint32_t v = static_cast<uint32_t>(win >> (64 - n));
    win <<= n;
    winbits -= n;
    return v;
  }

  int init(const uint8_t *data, int64_t nb, int64_t bitpos, int qp,
           const int8_t (*table)[2] = kCabacCtxInitI) {
    d = data;
    nbits = nb;
    int64_t pos = (bitpos + 7) & ~static_cast<int64_t>(7);
    bytepos = pos >> 3;                  // byte-aligned slice data start
    cabac_init_states(state, qp, table);
    offset = take(9);
    return offset >= 510 ? kErrBitstream : 0;
  }

  int decision(int ctx) {
    uint8_t s = state[ctx];
    uint32_t lps = kCabacRangeLps[s >> 1][(range >> 6) & 3];
    range -= lps;
    int binv;
    if (offset >= range) {
      binv = (s & 1) ^ 1;
      offset -= range;
      range = lps;
      state[ctx] = kST.lps[s];
      // LPS renorm: range ∈ [2, 240] → shift fully in one step
      int sh = __builtin_clz(range) - 23;
      range <<= sh;
      offset = (offset << sh) | take(sh);
    } else {
      binv = s & 1;
      state[ctx] = kST.mps[s];
      // MPS renorm: post-subtract range ≥ 128 → at most one shift
      if (range < 256) {
        range <<= 1;
        offset = (offset << 1) | take(1);
      }
    }
    return binv;
  }

  int bypass() {
    offset = (offset << 1) | take(1);
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }

  int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    if (range < 256) {                   // range ≥ 254 here: ≤ one shift
      range <<= 1;
      offset = (offset << 1) | take(1);
    }
    return 0;
  }
};

struct CabacEnc {
  // 9.3.4 encoder over a WIDE low: renorm/bypass shift bits into the
  // pending region above the 10-bit arithmetic window instead of
  // classifying them one at a time (the spec's put/outstanding dance
  // is just carry bookkeeping — here carries resolve arithmetically
  // inside `low`, and bytes are extracted with 0xFF buffering).  The
  // spec's dropped leading bit is the first pending bit, stripped at
  // the first extraction.  Output is byte-exact with the Python
  // oracle's literal 9.3.4 implementation (differential-tested).
  uint64_t low = 0;
  uint32_t range = 510;
  int queue = 0;                        // pending bits above the window
  int ffpend = 0;                       // buffered 0xFF bytes
  bool primed = false;                  // leading bit not yet stripped
  std::vector<uint8_t> bytes;
  uint8_t state[1024];

  inline void push_resolved(uint32_t out9) {
    // out9 = carry bit + 8 payload bits
    uint32_t carry = out9 >> 8;
    uint32_t b = out9 & 0xFF;
    if (carry) {
      // ripple: buffered FFs roll to 00, the last flushed byte gains 1
      // (it is never 0xFF — those are buffered).  With no flushed byte
      // yet the carry lands on the spec's DROPPED leading bit (which
      // was provably 0) and is discarded with it.
      if (!bytes.empty())
        bytes.back() = static_cast<uint8_t>(bytes.back() + 1);
      while (ffpend) {
        bytes.push_back(0x00);
        --ffpend;
      }
    }
    if (b == 0xFF) {
      ++ffpend;
    } else {
      while (ffpend) {
        bytes.push_back(0xFF);
        --ffpend;
      }
      bytes.push_back(static_cast<uint8_t>(b));
    }
  }

  inline void extract() {
    if (!primed) {
      // strip the spec's dropped leading bit: wait for 9 pending bits,
      // resolve any carry INTO that bit, then discard it
      if (queue < 9) return;
      uint32_t out10 = static_cast<uint32_t>(low >> (queue + 1));
      low &= (1ULL << (queue + 1)) - 1;
      queue -= 9;
      // out10 = dropped bit (possibly carried into) + 8 payload bits;
      // a carry cannot pass beyond the dropped bit (it was 0 pre-carry)
      bytes.push_back(static_cast<uint8_t>(out10 & 0xFF));
      if ((out10 & 0xFF) == 0xFF) {     // re-buffer an FF first byte
        bytes.pop_back();
        ++ffpend;
      }
      primed = true;
    }
    while (queue >= 8) {
      uint32_t out9 = static_cast<uint32_t>(low >> (queue + 2));
      low &= (1ULL << (queue + 2)) - 1;
      queue -= 8;
      push_resolved(out9);
    }
  }

  inline void renorm() {
    if (range >= 256) return;
    int sh = __builtin_clz(range) - 23;
    range <<= sh;
    low <<= sh;
    queue += sh;
    // keep queue + 11 bits within the 64-bit low: extract leaves
    // queue < 8, and growth per bin is ≤ 7, so 32 is conservative
    if (queue >= 32) extract();
  }

  void decision(int ctx, int binv) {
    uint8_t s = state[ctx];
    uint32_t lps = kCabacRangeLps[s >> 1][(range >> 6) & 3];
    range -= lps;
    if (static_cast<unsigned>(binv) != (s & 1u)) {
      low += range;
      range = lps;
      state[ctx] = kST.lps[s];
    } else {
      state[ctx] = kST.mps[s];
    }
    renorm();
  }

  void bypass(int binv) {
    low <<= 1;
    if (binv) low += range;
    ++queue;
    if (queue >= 32) extract();
  }

  void finish_bytes() {
    // called after the final terminate(1): everything is in `low`
    extract();
    while (queue > 0) {                 // ≤ 7 leftover pending bits
      int take = queue >= 8 ? 8 : queue;
      uint32_t out = static_cast<uint32_t>(
                         (low >> (queue + 10 - take)) << (8 - take)) &
                     0x1FF;
      low &= (1ULL << (queue + 10 - take)) - 1;
      queue -= take;
      push_resolved(out);               // carry impossible here
    }
    while (ffpend) {
      bytes.push_back(0xFF);
      --ffpend;
    }
  }

  void terminate(int binv) {
    range -= 2;
    if (binv) {
      low += range;
      range = 2;
      renorm();
      // EncodeFlush: bit9, bit8 of the window, then the stop bit; park
      // them as pending so extraction handles carries uniformly
      low = ((low & ~0xFFULL) | 0x80) << 3;   // appends b9, b8, 1
      queue += 3;
      extract();
      // rbsp_alignment_zero_bit: pad pending to a byte boundary
      int pad = (8 - (queue & 7)) & 7;
      low <<= pad;
      queue += pad;
      extract();
    } else {
      renorm();
    }
  }
};

// per-slice neighbor grids for ctxIdxInc derivation (slice-scoped:
// out-of-slice → unavailable; cbf unavailable default is 1 for intra
// MBs and 0 for inter — the rules the Python layer learned from the
// libavcodec differential)
struct CabacNb {
  int w, h;
  std::vector<uint8_t> seen, i4x4, skip;
  std::vector<int32_t> cmode, cbpl, cbpc;
  std::vector<int8_t> dccbf, lcbf, ccbf, cdccbf, refgt0;
  std::vector<int32_t> absmvd;          // [2][4h][4w] per-4x4 |mvd|
  bool last_dqp_nz = false;

  CabacNb(int width_mbs, int height_mbs) : w(width_mbs), h(height_mbs) {
    int n = w * h;
    seen.assign(n, 0);
    i4x4.assign(n, 0);
    skip.assign(n, 0);
    cmode.assign(n, 0);
    cbpl.assign(n, 0);
    cbpc.assign(n, 0);
    dccbf.assign(n, 0);
    lcbf.assign(static_cast<size_t>(4 * h) * 4 * w, -1);
    ccbf.assign(static_cast<size_t>(2) * 2 * h * 2 * w, -1);
    cdccbf.assign(static_cast<size_t>(2) * n, 0);
    refgt0.assign(static_cast<size_t>(2 * h) * 2 * w, 0);
    absmvd.assign(static_cast<size_t>(2) * 4 * h * 4 * w, 0);
  }

  // -- P-slice ctxIdxInc helpers (9.3.3.1.1.1 / .6 / .7) --
  int skip_inc(int mb) const {
    int inc = 0;
    int a = mbok(mb, -1, 0), b = mbok(mb, 0, -1);
    if (a >= 0 && !skip[a]) ++inc;
    if (b >= 0 && !skip[b]) ++inc;
    return inc;
  }
  int ref_inc(int bx, int by) const {
    int a = bx > 0 ? refgt0[static_cast<size_t>(by) * 2 * w + bx - 1] : 0;
    int b = by > 0 ? refgt0[static_cast<size_t>(by - 1) * 2 * w + bx] : 0;
    return a + 2 * b;
  }
  void set_refgt0(int bx, int by, int bw_, int bh_, int v) {
    for (int y = 0; y < bh_; ++y)
      for (int x = 0; x < bw_; ++x)
        refgt0[static_cast<size_t>(by + y) * 2 * w + bx + x] =
            static_cast<int8_t>(v);
  }
  int mvd_inc(int comp, int x4, int y4) const {
    const int32_t *g = absmvd.data() +
                       static_cast<size_t>(comp) * 4 * h * 4 * w;
    int32_t a = x4 > 0 ? g[static_cast<size_t>(y4) * 4 * w + x4 - 1] : 0;
    int32_t b = y4 > 0 ? g[static_cast<size_t>(y4 - 1) * 4 * w + x4] : 0;
    int32_t s = a + b;
    return (s > 2 ? 1 : 0) + (s > 32 ? 1 : 0);
  }
  void set_absmvd(int comp, int x4, int y4, int w4, int h4, int32_t v) {
    int32_t *g = absmvd.data() + static_cast<size_t>(comp) * 4 * h * 4 * w;
    for (int y = 0; y < h4; ++y)
      for (int x = 0; x < w4; ++x)
        g[static_cast<size_t>(y4 + y) * 4 * w + x4 + x] = v;
  }
  void mark_skip(int mb) {
    int mbx4 = (mb % w) * 4, mby4 = (mb / w) * 4;
    int cx = (mb % w) * 2, cy = (mb / w) * 2;
    seen[mb] = 1;
    skip[mb] = 1;
    i4x4[mb] = 0;
    cmode[mb] = 0;
    cbpl[mb] = 0;
    cbpc[mb] = 0;
    dccbf[mb] = 0;
    cdccbf[mb] = 0;
    cdccbf[static_cast<size_t>(w) * h + mb] = 0;
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x)
        lcbf[static_cast<size_t>(mby4 + y) * 4 * w + mbx4 + x] = 0;
    for (int comp = 0; comp < 2; ++comp)
      for (int y = 0; y < 2; ++y)
        for (int x = 0; x < 2; ++x)
          ccbf[static_cast<size_t>(comp) * 2 * h * 2 * w +
               static_cast<size_t>(cy + y) * 2 * w + cx + x] = 0;
    set_refgt0(cx, cy, 2, 2, 0);
    set_absmvd(0, mbx4, mby4, 4, 4, 0);
    set_absmvd(1, mbx4, mby4, 4, 4, 0);
    last_dqp_nz = false;
  }

  int mbok(int mb, int dx, int dy) const {
    int x = mb % w + dx, y = mb / w + dy;
    if (x < 0 || y < 0 || x >= w || y >= h) return -1;
    int n = y * w + x;
    return seen[n] ? n : -1;
  }

  int mb_type_inc(int mb) const {
    int inc = 0;
    int a = mbok(mb, -1, 0), b = mbok(mb, 0, -1);
    if (a >= 0 && !i4x4[a]) ++inc;
    if (b >= 0 && !i4x4[b]) ++inc;
    return inc;
  }

  int chroma_pred_inc(int mb) const {
    // 9.3.3.1.1.8: condTermFlagA + condTermFlagB — both neighbors add 1
    // (not the A + 2B pattern of cbf/cbp; the A+2B form truncated real
    // encoder streams at the first MB with two nonzero-mode neighbors)
    int inc = 0;
    int a = mbok(mb, -1, 0), b = mbok(mb, 0, -1);
    if (a >= 0 && cmode[a] != 0) inc += 1;
    if (b >= 0 && cmode[b] != 0) inc += 1;
    return inc;
  }

  int cbp_luma_inc(int mb, int b8, int cur_bits) const {
    int x8 = b8 & 1, y8 = b8 >> 1;
    int a, b;
    if (x8 == 1) {
      a = ((cur_bits >> (b8 - 1)) & 1) ? 0 : 1;
    } else {
      int n = mbok(mb, -1, 0);
      a = n >= 0 ? (((cbpl[n] >> (b8 + 1)) & 1) ? 0 : 1) : 0;
    }
    if (y8 == 1) {
      b = ((cur_bits >> (b8 - 2)) & 1) ? 0 : 1;
    } else {
      int n = mbok(mb, 0, -1);
      b = n >= 0 ? (((cbpl[n] >> (b8 + 2)) & 1) ? 0 : 1) : 0;
    }
    return a + 2 * b;
  }

  int cbp_chroma_inc(int mb, int binidx) const {
    int inc = 0;
    int a = mbok(mb, -1, 0), b = mbok(mb, 0, -1);
    if (a >= 0 && (binidx == 0 ? cbpc[a] != 0 : cbpc[a] == 2)) inc += 1;
    if (b >= 0 && (binidx == 0 ? cbpc[b] != 0 : cbpc[b] == 2)) inc += 2;
    return inc;
  }

  int cbf_at(const int8_t *g, int y, int x, int H, int W,
             int dflt) const {
    // unavailable/out-of-slice → 1 when the CURRENT MB is intra, 0
    // when inter (9.3.3.1.1.9)
    if (x < 0 || y < 0 || x >= W || y >= H) return dflt;
    int8_t v = g[static_cast<size_t>(y) * W + x];
    return v < 0 ? dflt : v;
  }

  int luma_cbf_inc(int gx, int gy, int intra = 1) const {
    return cbf_at(lcbf.data(), gy, gx - 1, 4 * h, 4 * w, intra) +
           2 * cbf_at(lcbf.data(), gy - 1, gx, 4 * h, 4 * w, intra);
  }

  int chroma_cbf_inc(int comp, int gx, int gy, int intra = 1) const {
    const int8_t *g = ccbf.data() + static_cast<size_t>(comp) * 2 * h * 2 * w;
    return cbf_at(g, gy, gx - 1, 2 * h, 2 * w, intra) +
           2 * cbf_at(g, gy - 1, gx, 2 * h, 2 * w, intra);
  }

  int dc_cbf_inc(int mb) const {
    int a = mbok(mb, -1, 0), b = mbok(mb, 0, -1);
    return (a < 0 ? 1 : dccbf[a]) + 2 * (b < 0 ? 1 : dccbf[b]);
  }

  int cdc_inc(int comp, int mb, int intra = 1) const {
    int a = mbok(mb, -1, 0), b = mbok(mb, 0, -1);
    int va = a < 0 ? intra : cdccbf[static_cast<size_t>(comp) * w * h + a];
    int vb = b < 0 ? intra : cdccbf[static_cast<size_t>(comp) * w * h + b];
    return va + 2 * vb;
  }

  void set_lcbf(int gx, int gy, int v) {
    lcbf[static_cast<size_t>(gy) * 4 * w + gx] = static_cast<int8_t>(v);
  }
  void set_ccbf(int comp, int gx, int gy, int v) {
    ccbf[static_cast<size_t>(comp) * 2 * h * 2 * w +
         static_cast<size_t>(gy) * 2 * w + gx] = static_cast<int8_t>(v);
  }
  void set_cdc(int comp, int mb, int v) {
    cdccbf[static_cast<size_t>(comp) * w * h + mb] =
        static_cast<int8_t>(v);
  }
};

// residual_block_cabac decode (cbf already consumed); levels clamped to
// ±kLevelClip at parse time per the repo clip contract
bool cabac_residual_dec(CabacDec &dc, int cat, int16_t *row, int maxc) {
  int sigpos[16];
  int nsig = 0;
  bool broke = false;
  for (int i = 0; i < maxc - 1; ++i) {
    if (dc.decision(kSigBase[cat] + i)) {
      sigpos[nsig++] = i;
      if (dc.decision(kLastBase[cat] + i)) {
        broke = true;
        break;
      }
    }
  }
  if (!broke) sigpos[nsig++] = maxc - 1;
  int n_eq1 = 0, n_gt1 = 0;
  for (int j = nsig - 1; j >= 0; --j) {
    int ctx0 = kAbsBase[cat] + (n_gt1 ? 0 : (n_eq1 + 1 > 4 ? 4 : n_eq1 + 1));
    int64_t mag = 0;
    if (dc.decision(ctx0)) {
      mag = 1;
      int ctxn = kAbsBase[cat] + 5 + (n_gt1 > 4 ? 4 : n_gt1);
      while (mag < 14 && dc.decision(ctxn)) ++mag;
      if (mag == 14) {                  // UEG0 bypass suffix
        int k = 0;
        while (dc.bypass()) {
          if (++k > 31) return false;
        }
        int64_t add = 0;
        for (int t = 0; t < k; ++t) add = (add << 1) | dc.bypass();
        mag += (1LL << k) - 1 + add;
      }
    }
    int64_t level = mag + 1;
    if (dc.bypass()) level = -level;
    if (level > kLevelClip) level = kLevelClip;
    if (level < -kLevelClip) level = -kLevelClip;
    row[sigpos[j]] = static_cast<int16_t>(level);
    if (mag == 0)
      ++n_eq1;
    else
      ++n_gt1;
  }
  return dc.ok;
}

void cabac_residual_enc(CabacEnc &en, int cat, const int16_t *row,
                        int maxc) {
  int sigpos[16];
  int nsig = 0;
  for (int i = 0; i < maxc; ++i)
    if (row[i]) sigpos[nsig++] = i;
  int last = sigpos[nsig - 1];
  for (int i = 0; i < maxc - 1 && i <= last; ++i) {
    int sig = row[i] ? 1 : 0;
    en.decision(kSigBase[cat] + i, sig);
    if (sig) en.decision(kLastBase[cat] + i, i == last ? 1 : 0);
  }
  int n_eq1 = 0, n_gt1 = 0;
  for (int j = nsig - 1; j >= 0; --j) {
    int level = row[sigpos[j]];
    int mag = (level < 0 ? -level : level) - 1;
    int ctx0 = kAbsBase[cat] + (n_gt1 ? 0 : (n_eq1 + 1 > 4 ? 4 : n_eq1 + 1));
    if (mag == 0) {
      en.decision(ctx0, 0);
    } else {
      en.decision(ctx0, 1);
      int ctxn = kAbsBase[cat] + 5 + (n_gt1 > 4 ? 4 : n_gt1);
      int pre = mag < 14 ? mag : 14;
      for (int t = 0; t < pre - 1; ++t) en.decision(ctxn, 1);
      if (mag < 14) {
        en.decision(ctxn, 0);
      } else {                          // UEG0 bypass suffix
        int rem = mag - 14;
        int k = 0;
        while ((rem + 1) >> (k + 1)) ++k;
        for (int t = 0; t < k; ++t) en.bypass(1);
        en.bypass(0);
        int suffix = rem + 1 - (1 << k);
        for (int t = k - 1; t >= 0; --t) en.bypass((suffix >> t) & 1);
      }
    }
    en.bypass(level < 0 ? 1 : 0);
    if (mag == 0)
      ++n_eq1;
    else
      ++n_gt1;
  }
}

}  // namespace

/* Native CABAC requant, FUSED single pass with I + P slice coverage
 * (mirrors codecs/h264_cabac.py BIT-EXACTLY): each MB is decoded,
 * requantized and re-encoded before the next — decoder and encoder
 * each keep their own neighbor grids (write-side contexts follow the
 * POST-requant cbf/cbp), and the per-MB payload lives in L1 scratch.
 * P slices add mb_skip_flag (ctx 11-13), P mb_type/sub_mb_type
 * binarizations, ref_idx unary coding over a per-8x8 refIdx cache,
 * UEG3 mvd with the |mvdA|+|mvdB| rule over a per-4x4 cache, and the
 * cabac_init_idc inter init tables. */
extern "C" int32_t ed_h264_requant_slice_cabac(
    const uint8_t *nal, int32_t nal_len, uint8_t *out, int32_t out_cap,
    int32_t width_mbs, int32_t height_mbs, int32_t log2_max_frame_num,
    int32_t poc_type, int32_t log2_max_poc_lsb, int32_t pic_init_qp,
    int32_t pps_id, int32_t deblocking_control, int32_t bottom_field_poc,
    int32_t delta_qp, int32_t chroma_qp_offset,
    int32_t num_ref_l0_default, int32_t weighted_pred, int32_t *mbs_out,
    int32_t *blocks_out) {
  if (nal_len < 2 || delta_qp < 6 || delta_qp % 6) return kErrUnsupported;
  uint8_t nal_byte = nal[0];
  int nal_type = nal_byte & 0x1F;
  int nal_ref_idc = (nal_byte >> 5) & 3;
  if (nal_type != 1 && nal_type != 5) return kErrUnsupported;

  std::vector<uint8_t> rbsp;
  strip_epb(nal + 1, nal_len - 1, rbsp);
  BitReader br(rbsp.data(), static_cast<int64_t>(rbsp.size()));
  SliceHeader h{};
  uint32_t first_mb = 0;
  int hrc = parse_islice_header(br, nal_type, nal_ref_idc,
                                log2_max_frame_num, poc_type,
                                log2_max_poc_lsb, pic_init_qp,
                                deblocking_control, bottom_field_poc, &h,
                                &first_mb, num_ref_l0_default,
                                weighted_pred, 1);
  if (hrc) return hrc;

  int n_mbs = width_mbs * height_mbs;
  if (first_mb >= static_cast<uint32_t>(n_mbs)) return kErrBitstream;
  const int8_t(*init_table)[2] =
      h.is_p ? kCabacCtxInitP[h.cabac_init_idc] : kCabacCtxInitI;

  CabacDec dec;
  if (dec.init(rbsp.data(), static_cast<int64_t>(rbsp.size()) * 8, br.pos,
               h.qp, init_table))
    return kErrBitstream;

  BitWriter bw;
  int32_t qp_out_base = h.qp + delta_qp;
  if (qp_out_base > 51) return kErrUnsupported;
  write_islice_header(bw, h, first_mb, pps_id, qp_out_base,
                      log2_max_frame_num, poc_type, log2_max_poc_lsb,
                      pic_init_qp, deblocking_control, 1);
  while (bw.nbits) bw.bit(1);                      // cabac_alignment_one
  CabacEnc enc;
  cabac_init_states(enc.state, qp_out_base, init_table);

  CabacNb nb(width_mbs, height_mbs);               // parse-side contexts
  CabacNb wb(width_mbs, height_mbs);               // write-side contexts

  auto read_dqp = [](CabacDec &dc, CabacNb &grids, int32_t *delta) {
    int val = 0;
    int ctx = 60 + (grids.last_dqp_nz ? 1 : 0);
    while (dc.decision(ctx)) {
      if (++val > 104) return false;
      ctx = val == 1 ? 62 : 63;
    }
    grids.last_dqp_nz = val != 0;
    *delta = (val & 1) ? (val + 1) / 2 : -(val / 2);
    return true;
  };
  auto emit_dqp = [](CabacEnc &en, CabacNb &grids, int32_t delta) {
    if (delta < -26 || delta > 25) return false;   // 7.4.5 bound
    int val = delta > 0 ? 2 * delta - 1 : -2 * delta;
    int ctx = 60 + (grids.last_dqp_nz ? 1 : 0);
    for (int i = 0; i < val; ++i) {
      en.decision(ctx, 1);
      ctx = i == 0 ? 62 : 63;
    }
    en.decision(ctx, 0);
    grids.last_dqp_nz = delta != 0;
    return true;
  };
  auto read_cmode = [](CabacDec &dc, CabacNb &grids, int mbi) {
    int cm;
    if (!dc.decision(64 + grids.chroma_pred_inc(mbi)))
      cm = 0;
    else if (!dc.decision(67))
      cm = 1;
    else
      cm = dc.decision(67) ? 3 : 2;
    grids.cmode[mbi] = cm;
    return cm;
  };
  auto emit_cmode = [](CabacEnc &en, CabacNb &grids, int mbi, int cm) {
    en.decision(64 + grids.chroma_pred_inc(mbi), cm == 0 ? 0 : 1);
    if (cm > 0) {
      en.decision(67, cm == 1 ? 0 : 1);
      if (cm > 1) en.decision(67, cm == 2 ? 0 : 1);
    }
    grids.cmode[mbi] = cm;
  };
  // UEG3 mvd (9.3.2.3): TU prefix cMax 9 over base+{inc,3..6}, EG3
  // bypass suffix, bypass sign
  auto read_mvd = [](CabacDec &dc, int base, int inc, int32_t *v) {
    if (!dc.decision(base + inc)) {
      *v = 0;
      return true;
    }
    int32_t mag = 1;
    int ctxofs = 3;
    while (mag < 9 && dc.decision(base + ctxofs)) {
      ++mag;
      if (ctxofs < 6) ++ctxofs;
    }
    if (mag == 9) {
      int kk = 3;
      while (dc.bypass()) {
        mag += 1 << kk;
        if (++kk > 24) return false;
      }
      while (kk) {
        --kk;
        mag += dc.bypass() << kk;
      }
    }
    *v = dc.bypass() ? -mag : mag;
    return true;
  };
  auto emit_mvd = [](CabacEnc &en, int base, int inc, int32_t v) {
    int32_t mag = v < 0 ? -v : v;
    if (mag == 0) {
      en.decision(base + inc, 0);
      return;
    }
    en.decision(base + inc, 1);
    int ctxofs = 3;
    int n = 1;
    int pre = mag < 9 ? mag : 9;
    while (n < pre) {
      en.decision(base + ctxofs, 1);
      if (ctxofs < 6) ++ctxofs;
      ++n;
    }
    if (mag < 9) {
      en.decision(base + ctxofs, 0);
    } else {
      int32_t rem = mag - 9;
      int kk = 3;
      while (rem >= (1 << kk)) {
        en.bypass(1);
        rem -= 1 << kk;
        ++kk;
      }
      en.bypass(0);
      for (int i = kk - 1; i >= 0; --i) en.bypass((rem >> i) & 1);
    }
    en.bypass(v < 0 ? 1 : 0);
  };

  int k = delta_qp / 6;
  int deadzone = (1 << k) / 3;
  auto qpc_of = [&](int32_t qpy) -> int {
    int q = qpy + chroma_qp_offset;
    q = q < 0 ? 0 : (q > 51 ? 51 : q);
    return kChromaQp[q];
  };
  auto shift_row16 = [&](int16_t *lv, int n) {
    bool any = false;
    for (int i = 0; i < n; ++i) {
      int32_t v = lv[i];
      int32_t a = v < 0 ? -v : v;
      if (a > kLevelClip) a = kLevelClip;
      a = (a + deadzone) >> k;
      lv[i] = static_cast<int16_t>(v < 0 ? -a : a);
      any |= lv[i] != 0;
    }
    return any;
  };

  // ---- per-MB scratch ----
  int16_t rows[17 * 16];                 // row 0 = I16 DC, 1+b = blocks
  int16_t cd[2 * 16], ca[2 * 4 * 16];
  uint8_t modes[16][2];
  uint32_t sub_t[4];
  int refs[4];
  int32_t mvdbuf[16][2];
  // P partition geometry: (x8, y8, w8, h8) per partition
  struct P8 { int8_t x, y, pw, ph; };
  static const P8 kParts16x16[1] = {{0, 0, 2, 2}};
  static const P8 kParts16x8[2] = {{0, 0, 2, 1}, {0, 1, 2, 1}};
  static const P8 kParts8x16[2] = {{0, 0, 1, 2}, {1, 0, 1, 2}};
  static const P8 kParts8x8[4] = {
      {0, 0, 1, 1}, {1, 0, 1, 1}, {0, 1, 1, 1}, {1, 1, 1, 1}};
  // sub partition rects in 4x4 units relative to the 8x8
  struct S4 { int8_t x, y, sw, sh; };
  static const S4 kSub4[4][4] = {
      {{0, 0, 2, 2}, {}, {}, {}},
      {{0, 0, 2, 1}, {0, 1, 2, 1}, {}, {}},
      {{0, 0, 1, 2}, {1, 0, 1, 2}, {}, {}},
      {{0, 0, 1, 1}, {1, 0, 1, 1}, {0, 1, 1, 1}, {1, 1, 1, 1}}};
  static const int kSubN[4] = {1, 2, 2, 4};

  // fused chroma: decode with nb, requant, report new ccbp via
  // *out_ccbp; then encode with wb (called twice, dec then enc phase
  // merged here for locality)
  auto chroma_fused = [&](int mb, int ccbp_in, int32_t qpy, int intra,
                          int *ccbp_out) -> bool {
    int cx2 = (mb % width_mbs) * 2, cy2 = (mb / width_mbs) * 2;
    std::memset(cd, 0, sizeof(cd));
    std::memset(ca, 0, sizeof(ca));
    if (ccbp_in) {
      for (int comp = 0; comp < 2; ++comp) {
        int cbf = dec.decision(85 + 12 + nb.cdc_inc(comp, mb, intra));
        nb.set_cdc(comp, mb, cbf);
        if (cbf && !cabac_residual_dec(dec, 3, cd + comp * 16, 4))
          return false;
      }
    } else {
      nb.set_cdc(0, mb, 0);
      nb.set_cdc(1, mb, 0);
    }
    for (int comp = 0; comp < 2; ++comp)
      for (int b = 0; b < 4; ++b) {
        int gx = cx2 + (b & 1), gy = cy2 + (b >> 1);
        if (ccbp_in == 2) {
          int cbf = dec.decision(85 + 16 +
                                 nb.chroma_cbf_inc(comp, gx, gy, intra));
          nb.set_ccbf(comp, gx, gy, cbf);
          if (cbf &&
              !cabac_residual_dec(dec, 4, ca + (comp * 4 + b) * 16, 15))
            return false;
        } else {
          nb.set_ccbf(comp, gx, gy, 0);
        }
      }
    int ccbp = 0;
    if (ccbp_in) {
      for (int comp = 0; comp < 2; ++comp)
        chroma_requant_comp(cd + comp * 16, ca + comp * 4 * 16,
                            qpc_of(qpy), qpc_of(qpy + delta_qp));
      bool any_dc = false, any_ac = false;
      for (int i = 0; i < 2 * 16; ++i) any_dc |= cd[i] != 0;
      for (int i = 0; i < 2 * 4 * 16; ++i) any_ac |= ca[i] != 0;
      ccbp = any_ac ? 2 : (any_dc ? 1 : 0);
    }
    *ccbp_out = ccbp;
    return true;
  };
  auto chroma_emit = [&](int mb, int ccbp, int intra) {
    int cx2 = (mb % width_mbs) * 2, cy2 = (mb / width_mbs) * 2;
    if (ccbp) {
      for (int comp = 0; comp < 2; ++comp) {
        const int16_t *d = cd + comp * 16;
        bool any = d[0] || d[1] || d[2] || d[3];
        enc.decision(85 + 12 + wb.cdc_inc(comp, mb, intra), any ? 1 : 0);
        wb.set_cdc(comp, mb, any ? 1 : 0);
        if (any) cabac_residual_enc(enc, 3, d, 4);
      }
    } else {
      wb.set_cdc(0, mb, 0);
      wb.set_cdc(1, mb, 0);
    }
    for (int comp = 0; comp < 2; ++comp)
      for (int b = 0; b < 4; ++b) {
        int gx = cx2 + (b & 1), gy = cy2 + (b >> 1);
        if (ccbp == 2) {
          const int16_t *lv = ca + (comp * 4 + b) * 16;
          bool any = false;
          for (int i = 0; i < 15; ++i) any |= lv[i] != 0;
          enc.decision(85 + 16 + wb.chroma_cbf_inc(comp, gx, gy, intra),
                       any ? 1 : 0);
          wb.set_ccbf(comp, gx, gy, any ? 1 : 0);
          if (any) cabac_residual_enc(enc, 4, lv, 15);
        } else {
          wb.set_ccbf(comp, gx, gy, 0);
        }
      }
  };

  int32_t cur_qp = h.qp;
  int32_t prev_qp = qp_out_base;
  int end_mb = static_cast<int>(first_mb);
  int64_t blk_count = 0;
  for (int mb = static_cast<int>(first_mb);; ++mb) {
    if (mb >= n_mbs) return kErrBitstream;         // overran the picture
    int mbx4 = (mb % width_mbs) * 4, mby4 = (mb / width_mbs) * 4;
    int bx2 = (mb % width_mbs) * 2, by2 = (mb / width_mbs) * 2;

    if (h.is_p) {
      int skip = dec.decision(11 + nb.skip_inc(mb));
      enc.decision(11 + wb.skip_inc(mb), skip);
      if (skip) {
        nb.mark_skip(mb);
        wb.mark_skip(mb);
        end_mb = mb + 1;
        int done = dec.terminate();
        enc.terminate(done);
        if (done) break;
        continue;
      }
    }

    std::memset(rows, 0, sizeof(rows));
    int is16 = 0, inter_type = -1;
    if (h.is_p) {
      if (dec.decision(14) == 0) {
        if (dec.decision(15) == 0)
          inter_type = 3 * dec.decision(16);
        else
          inter_type = 2 - dec.decision(17);
      } else if (dec.decision(17) == 0) {
        is16 = 0;
      } else {
        if (dec.terminate()) return kErrUnsupported;  // I_PCM
        is16 = 1;
      }
    } else {
      if (dec.decision(3 + nb.mb_type_inc(mb)) == 0) {
        is16 = 0;
      } else {
        if (dec.terminate()) return kErrUnsupported;  // I_PCM
        is16 = 1;
      }
    }

    if (inter_type >= 0) {
      // ---------------- P inter MB
      nb.seen[mb] = 1;
      nb.i4x4[mb] = 0;
      nb.cmode[mb] = 0;
      const P8 *parts;
      int nparts;
      if (inter_type == 0) {
        parts = kParts16x16;
        nparts = 1;
      } else if (inter_type == 1) {
        parts = kParts16x8;
        nparts = 2;
      } else if (inter_type == 2) {
        parts = kParts8x16;
        nparts = 2;
      } else {
        parts = kParts8x8;
        nparts = 4;
        for (int s = 0; s < 4; ++s) {            // sub_mb_type, ctx 21-23
          if (dec.decision(21))
            sub_t[s] = 0;
          else if (!dec.decision(22))
            sub_t[s] = 1;
          else
            sub_t[s] = dec.decision(23) ? 2 : 3;
        }
      }
      for (int p = 0; p < nparts; ++p) {
        int r = 0;
        if (h.n_ref > 1) {
          int ctx = 54 + nb.ref_inc(bx2 + parts[p].x, by2 + parts[p].y);
          while (dec.decision(ctx)) {
            if (++r > 31) return kErrBitstream;
            ctx = r == 1 ? 58 : 59;
          }
          if (r >= h.n_ref) return kErrBitstream;
        }
        refs[p] = r;
        nb.set_refgt0(bx2 + parts[p].x, by2 + parts[p].y, parts[p].pw,
                      parts[p].ph, r > 0 ? 1 : 0);
      }
      int nmvd = 0;
      auto dec_mvd_rect = [&](int x4, int y4, int w4, int h4) -> bool {
        int32_t mx, my;
        if (!read_mvd(dec, 40, nb.mvd_inc(0, x4, y4), &mx)) return false;
        if (!read_mvd(dec, 47, nb.mvd_inc(1, x4, y4), &my)) return false;
        nb.set_absmvd(0, x4, y4, w4, h4, mx < 0 ? -mx : mx);
        nb.set_absmvd(1, x4, y4, w4, h4, my < 0 ? -my : my);
        mvdbuf[nmvd][0] = mx;
        mvdbuf[nmvd][1] = my;
        ++nmvd;
        return true;
      };
      if (inter_type == 3) {
        for (int s = 0; s < 4; ++s) {
          int ox = mbx4 + (s & 1) * 2, oy = mby4 + (s >> 1) * 2;
          for (int q = 0; q < kSubN[sub_t[s]]; ++q) {
            const S4 &r4 = kSub4[sub_t[s]][q];
            if (!dec_mvd_rect(ox + r4.x, oy + r4.y, r4.sw, r4.sh))
              return kErrBitstream;
          }
        }
      } else {
        for (int p = 0; p < nparts; ++p)
          if (!dec_mvd_rect(mbx4 + parts[p].x * 2, mby4 + parts[p].y * 2,
                            parts[p].pw * 2, parts[p].ph * 2))
            return kErrBitstream;
      }
      int cbp = 0;
      for (int b8 = 0; b8 < 4; ++b8)
        if (dec.decision(73 + nb.cbp_luma_inc(mb, b8, cbp)))
          cbp |= 1 << b8;
      int chroma_cbp = 0;
      if (dec.decision(77 + nb.cbp_chroma_inc(mb, 0)))
        chroma_cbp = dec.decision(81 + nb.cbp_chroma_inc(mb, 1)) ? 2 : 1;
      nb.cbpl[mb] = cbp;
      nb.cbpc[mb] = chroma_cbp;
      if (cbp || chroma_cbp) {
        int32_t delta;
        if (!read_dqp(dec, nb, &delta)) return kErrBitstream;
        cur_qp += delta;
        if (cur_qp < 0 || cur_qp > 51) return kErrBitstream;
        if (cur_qp + delta_qp > 51) return kErrUnsupported;
      } else {
        nb.last_dqp_nz = false;
      }
      nb.dccbf[mb] = 0;
      int out_cbp = 0;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mbx4 + x4, gy = mby4 + y4;
        int16_t *lv = rows + (1 + b) * 16;
        if ((cbp >> (b >> 2)) & 1) {
          int cbf = dec.decision(85 + 8 + nb.luma_cbf_inc(gx, gy, 0));
          nb.set_lcbf(gx, gy, cbf);
          if (cbf && !cabac_residual_dec(dec, 2, lv, 16))
            return kErrBitstream;
          if (shift_row16(lv, 16)) out_cbp |= 1 << (b >> 2);
        } else {
          nb.set_lcbf(gx, gy, 0);
        }
      }
      blk_count += 16 + (chroma_cbp ? 8 : 0);
      int ccbp = 0;
      if (!chroma_fused(mb, chroma_cbp, cur_qp, 0, &ccbp))
        return kErrBitstream;

      // ---- emit
      wb.seen[mb] = 1;
      wb.i4x4[mb] = 0;
      wb.cmode[mb] = 0;
      enc.decision(14, 0);
      if (inter_type == 0 || inter_type == 3) {
        enc.decision(15, 0);
        enc.decision(16, inter_type == 3 ? 1 : 0);
      } else {
        enc.decision(15, 1);
        enc.decision(17, inter_type == 1 ? 1 : 0);
      }
      if (inter_type == 3)
        for (int s = 0; s < 4; ++s) {
          enc.decision(21, sub_t[s] == 0 ? 1 : 0);
          if (sub_t[s] != 0) {
            enc.decision(22, sub_t[s] == 1 ? 0 : 1);
            if (sub_t[s] != 1)
              enc.decision(23, sub_t[s] == 2 ? 1 : 0);
          }
        }
      for (int p = 0; p < nparts; ++p) {
        if (h.n_ref > 1) {
          int ctx = 54 + wb.ref_inc(bx2 + parts[p].x, by2 + parts[p].y);
          for (int i = 0; i < refs[p]; ++i) {
            enc.decision(ctx, 1);
            ctx = i == 0 ? 58 : 59;
          }
          enc.decision(ctx, 0);
        }
        wb.set_refgt0(bx2 + parts[p].x, by2 + parts[p].y, parts[p].pw,
                      parts[p].ph, refs[p] > 0 ? 1 : 0);
      }
      {
        int m = 0;
        auto enc_mvd_rect = [&](int x4, int y4, int w4, int h4) {
          int32_t mx = mvdbuf[m][0], my = mvdbuf[m][1];
          emit_mvd(enc, 40, wb.mvd_inc(0, x4, y4), mx);
          emit_mvd(enc, 47, wb.mvd_inc(1, x4, y4), my);
          wb.set_absmvd(0, x4, y4, w4, h4, mx < 0 ? -mx : mx);
          wb.set_absmvd(1, x4, y4, w4, h4, my < 0 ? -my : my);
          ++m;
        };
        if (inter_type == 3) {
          for (int s = 0; s < 4; ++s) {
            int ox = mbx4 + (s & 1) * 2, oy = mby4 + (s >> 1) * 2;
            for (int q = 0; q < kSubN[sub_t[s]]; ++q) {
              const S4 &r4 = kSub4[sub_t[s]][q];
              enc_mvd_rect(ox + r4.x, oy + r4.y, r4.sw, r4.sh);
            }
          }
        } else {
          for (int p = 0; p < nparts; ++p)
            enc_mvd_rect(mbx4 + parts[p].x * 2, mby4 + parts[p].y * 2,
                         parts[p].pw * 2, parts[p].ph * 2);
        }
      }
      int built = 0;
      for (int b8 = 0; b8 < 4; ++b8) {
        int bit = (out_cbp >> b8) & 1;
        enc.decision(73 + wb.cbp_luma_inc(mb, b8, built), bit);
        built |= bit << b8;
      }
      enc.decision(77 + wb.cbp_chroma_inc(mb, 0), ccbp ? 1 : 0);
      if (ccbp)
        enc.decision(81 + wb.cbp_chroma_inc(mb, 1), ccbp == 2 ? 1 : 0);
      wb.cbpl[mb] = out_cbp;
      wb.cbpc[mb] = ccbp;
      if (out_cbp || ccbp) {
        int32_t qp_out_mb = cur_qp + delta_qp;
        if (!emit_dqp(enc, wb, qp_out_mb - prev_qp))
          return kErrUnsupported;
        prev_qp = qp_out_mb;
      } else {
        wb.last_dqp_nz = false;
      }
      wb.dccbf[mb] = 0;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mbx4 + x4, gy = mby4 + y4;
        const int16_t *lv = rows + (1 + b) * 16;
        if ((out_cbp >> (b >> 2)) & 1) {
          bool any = false;
          for (int i = 0; i < 16; ++i) any |= lv[i] != 0;
          enc.decision(85 + 8 + wb.luma_cbf_inc(gx, gy, 0), any ? 1 : 0);
          wb.set_lcbf(gx, gy, any ? 1 : 0);
          if (any) cabac_residual_enc(enc, 2, lv, 16);
        } else {
          wb.set_lcbf(gx, gy, 0);
        }
      }
      chroma_emit(mb, ccbp, 0);
      if (!dec.ok) return kErrBitstream;
      end_mb = mb + 1;
      int done = dec.terminate();
      enc.terminate(done);
      if (done) break;
      continue;
    }

    if (!is16) {
      // ---------------- I_4x4
      nb.seen[mb] = 1;
      nb.i4x4[mb] = 1;
      for (int b = 0; b < 16; ++b) {
        int flag = dec.decision(68);
        int rem = 0;
        if (!flag)
          rem = dec.decision(69) | (dec.decision(69) << 1) |
                (dec.decision(69) << 2);
        modes[b][0] = static_cast<uint8_t>(flag);
        modes[b][1] = static_cast<uint8_t>(rem);
      }
      int cmode = read_cmode(dec, nb, mb);
      int cbp = 0;
      for (int b8 = 0; b8 < 4; ++b8)
        if (dec.decision(73 + nb.cbp_luma_inc(mb, b8, cbp)))
          cbp |= 1 << b8;
      int chroma_cbp = 0;
      if (dec.decision(77 + nb.cbp_chroma_inc(mb, 0)))
        chroma_cbp = dec.decision(81 + nb.cbp_chroma_inc(mb, 1)) ? 2 : 1;
      nb.cbpl[mb] = cbp;
      nb.cbpc[mb] = chroma_cbp;
      if (cbp || chroma_cbp) {
        int32_t delta;
        if (!read_dqp(dec, nb, &delta)) return kErrBitstream;
        cur_qp += delta;
        if (cur_qp < 0 || cur_qp > 51) return kErrBitstream;
        if (cur_qp + delta_qp > 51) return kErrUnsupported;
      } else {
        nb.last_dqp_nz = false;
      }
      nb.dccbf[mb] = 0;
      int out_cbp = 0;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mbx4 + x4, gy = mby4 + y4;
        int16_t *lv = rows + (1 + b) * 16;
        if ((cbp >> (b >> 2)) & 1) {
          int cbf = dec.decision(85 + 8 + nb.luma_cbf_inc(gx, gy));
          nb.set_lcbf(gx, gy, cbf);
          if (cbf && !cabac_residual_dec(dec, 2, lv, 16))
            return kErrBitstream;
          if (shift_row16(lv, 16)) out_cbp |= 1 << (b >> 2);
        } else {
          nb.set_lcbf(gx, gy, 0);
        }
      }
      blk_count += 16 + (chroma_cbp ? 8 : 0);
      int ccbp = 0;
      if (!chroma_fused(mb, chroma_cbp, cur_qp, 1, &ccbp))
        return kErrBitstream;

      // ---- emit
      wb.seen[mb] = 1;
      wb.i4x4[mb] = 1;
      if (h.is_p) {
        enc.decision(14, 1);
        enc.decision(17, 0);
      } else {
        enc.decision(3 + wb.mb_type_inc(mb), 0);
      }
      for (int b = 0; b < 16; ++b) {
        enc.decision(68, modes[b][0]);
        if (!modes[b][0]) {
          enc.decision(69, modes[b][1] & 1);
          enc.decision(69, (modes[b][1] >> 1) & 1);
          enc.decision(69, (modes[b][1] >> 2) & 1);
        }
      }
      emit_cmode(enc, wb, mb, cmode);
      int built = 0;
      for (int b8 = 0; b8 < 4; ++b8) {
        int bit = (out_cbp >> b8) & 1;
        enc.decision(73 + wb.cbp_luma_inc(mb, b8, built), bit);
        built |= bit << b8;
      }
      enc.decision(77 + wb.cbp_chroma_inc(mb, 0), ccbp ? 1 : 0);
      if (ccbp)
        enc.decision(81 + wb.cbp_chroma_inc(mb, 1), ccbp == 2 ? 1 : 0);
      wb.cbpl[mb] = out_cbp;
      wb.cbpc[mb] = ccbp;
      if (out_cbp || ccbp) {
        int32_t qp_out_mb = cur_qp + delta_qp;
        if (!emit_dqp(enc, wb, qp_out_mb - prev_qp))
          return kErrUnsupported;
        prev_qp = qp_out_mb;
      } else {
        wb.last_dqp_nz = false;
      }
      wb.dccbf[mb] = 0;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mbx4 + x4, gy = mby4 + y4;
        const int16_t *lv = rows + (1 + b) * 16;
        if ((out_cbp >> (b >> 2)) & 1) {
          bool any = false;
          for (int i = 0; i < 16; ++i) any |= lv[i] != 0;
          enc.decision(85 + 8 + wb.luma_cbf_inc(gx, gy), any ? 1 : 0);
          wb.set_lcbf(gx, gy, any ? 1 : 0);
          if (any) cabac_residual_enc(enc, 2, lv, 16);
        } else {
          wb.set_lcbf(gx, gy, 0);
        }
      }
      chroma_emit(mb, ccbp, 1);
    } else {
      // ---------------- I_16x16 (in I slices ctx 6-10; in P 18-20)
      int c_luma15 = h.is_p ? 18 : 6;
      int c_cb0 = h.is_p ? 19 : 7;
      int c_cb1 = h.is_p ? 19 : 8;
      int c_ph = h.is_p ? 20 : 9;
      int c_pl = h.is_p ? 20 : 10;
      int luma15 = dec.decision(c_luma15);
      int chroma_cbp = 0;
      if (dec.decision(c_cb0)) chroma_cbp = dec.decision(c_cb1) ? 2 : 1;
      int pred = (dec.decision(c_ph) << 1) | dec.decision(c_pl);
      nb.seen[mb] = 1;
      nb.i4x4[mb] = 0;
      nb.cbpl[mb] = luma15 ? 15 : 0;
      nb.cbpc[mb] = chroma_cbp;
      int cmode = read_cmode(dec, nb, mb);
      {
        int32_t delta;
        if (!read_dqp(dec, nb, &delta)) return kErrBitstream;
        cur_qp += delta;
        if (cur_qp < 12 || cur_qp > 51) return kErrUnsupported;
        if (cur_qp + delta_qp > 51) return kErrUnsupported;
      }
      int cbf = dec.decision(85 + 0 + nb.dc_cbf_inc(mb));
      nb.dccbf[mb] = static_cast<int8_t>(cbf);
      if (cbf && !cabac_residual_dec(dec, 0, rows, 16))
        return kErrBitstream;
      shift_row16(rows, 16);
      bool any_ac = false;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mbx4 + x4, gy = mby4 + y4;
        int16_t *lv = rows + (1 + b) * 16;
        if (luma15) {
          int c2 = dec.decision(85 + 4 + nb.luma_cbf_inc(gx, gy));
          nb.set_lcbf(gx, gy, c2);
          if (c2 && !cabac_residual_dec(dec, 1, lv, 15))
            return kErrBitstream;
          any_ac |= shift_row16(lv, 15);
        } else {
          nb.set_lcbf(gx, gy, 0);
        }
      }
      blk_count += 17 + (chroma_cbp ? 8 : 0);
      int ccbp = 0;
      if (!chroma_fused(mb, chroma_cbp, cur_qp, 1, &ccbp))
        return kErrBitstream;

      // ---- emit
      wb.seen[mb] = 1;
      wb.i4x4[mb] = 0;
      int out15 = luma15 && any_ac;
      if (h.is_p) {
        enc.decision(14, 1);
        enc.decision(17, 1);
      } else {
        enc.decision(3 + wb.mb_type_inc(mb), 1);
      }
      enc.terminate(0);
      enc.decision(c_luma15, out15);
      enc.decision(c_cb0, ccbp ? 1 : 0);
      if (ccbp) enc.decision(c_cb1, ccbp == 2 ? 1 : 0);
      enc.decision(c_ph, (pred >> 1) & 1);
      enc.decision(c_pl, pred & 1);
      wb.cbpl[mb] = out15 ? 15 : 0;
      wb.cbpc[mb] = ccbp;
      emit_cmode(enc, wb, mb, cmode);
      {
        int32_t qp_out_mb = cur_qp + delta_qp;
        if (!emit_dqp(enc, wb, qp_out_mb - prev_qp))
          return kErrUnsupported;
        prev_qp = qp_out_mb;
      }
      bool any_dc = false;
      for (int i = 0; i < 16; ++i) any_dc |= rows[i] != 0;
      enc.decision(85 + 0 + wb.dc_cbf_inc(mb), any_dc ? 1 : 0);
      wb.dccbf[mb] = any_dc ? 1 : 0;
      if (any_dc) cabac_residual_enc(enc, 0, rows, 16);
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mbx4 + x4, gy = mby4 + y4;
        const int16_t *lv = rows + (1 + b) * 16;
        if (out15) {
          bool any = false;
          for (int i = 0; i < 15; ++i) any |= lv[i] != 0;
          enc.decision(85 + 4 + wb.luma_cbf_inc(gx, gy), any ? 1 : 0);
          wb.set_lcbf(gx, gy, any ? 1 : 0);
          if (any) cabac_residual_enc(enc, 1, lv, 15);
        } else {
          wb.set_lcbf(gx, gy, 0);
        }
      }
      chroma_emit(mb, ccbp, 1);
    }
    if (!dec.ok) return kErrBitstream;
    end_mb = mb + 1;
    int done = dec.terminate();
    enc.terminate(done);
    if (done) break;
  }
  if (mbs_out) *mbs_out = end_mb - static_cast<int>(first_mb);
  if (blocks_out)
    *blocks_out = static_cast<int32_t>(
        blk_count > INT32_MAX ? INT32_MAX : blk_count);

  enc.finish_bytes();
  for (uint8_t byte : enc.bytes) bw.bits(byte, 8);

  std::vector<uint8_t> wire;
  insert_epb(bw.out, wire);
  if (static_cast<int64_t>(wire.size()) + 1 > out_cap) return kErrOverflow;
  out[0] = nal_byte;
  std::memcpy(out + 1, wire.data(), wire.size());
  return static_cast<int32_t>(wire.size()) + 1;
}


// ===================================================================
// SPLIT walk: the fused walk's decode (ed_h264_parse_slice[_cabac])
// and its encode (ed_h264_write_slice[_cabac]) as two calls, with the
// requant between them done elsewhere (B6 on the card).  Each half is
// the fused walk's code for that half, statement for statement; the
// per-macroblock state the fused walk keeps in L1 scratch between its
// decode and its encode lives in the handle (WalkMb records plus the
// level rows), so the write of every rung reads one parse.
// ===================================================================

namespace {

constexpr int kErrArgs = -4;

enum : int8_t { kMbI4 = 0, kMbI16 = 1, kMbInter = 2, kMbSkip = 3 };

// one coded macroblock (or, in CABAC P slices, one P_Skip) of the parse
struct WalkMb {
  int32_t mb;             // macroblock address
  uint32_t skip_run;      // CAVLC P: the mb_skip_run coded before it
  int8_t kind;            // kMb*
  int8_t type;            // inter: CAVLC mb_type 0-4 / CABAC partition
                          // 0-3 (16x16, 16x8, 8x16, 8x8); I16: pred mode
  uint8_t cbp;            // INPUT luma 8x8 bits | chroma << 4 (I16: 15
                          // when its AC is coded)
  uint8_t n_mvd;          // mvd pairs at mvd0
  uint32_t cmode;         // intra_chroma_pred_mode, verbatim
  int32_t qp;             // QPY (7.4.5, accumulated)
  int32_t row0;           // first gather row, -1 for none
  int32_t centry;         // chroma gather entry, -1 for none
  int32_t mvd0;
  uint8_t modes[16][2];   // I_4x4: prev_intra4x4_pred_mode_flag, rem
  uint8_t sub_t[4];
  int32_t refs[4];
};

struct P8 { int8_t x, y, pw, ph; };
constexpr P8 kWParts16x16[1] = {{0, 0, 2, 2}};
constexpr P8 kWParts16x8[2] = {{0, 0, 2, 1}, {0, 1, 2, 1}};
constexpr P8 kWParts8x16[2] = {{0, 0, 1, 2}, {1, 0, 1, 2}};
constexpr P8 kWParts8x8[4] = {
    {0, 0, 1, 1}, {1, 0, 1, 1}, {0, 1, 1, 1}, {1, 1, 1, 1}};
struct S4 { int8_t x, y, sw, sh; };
constexpr S4 kWSub4[4][4] = {
    {{0, 0, 2, 2}, {}, {}, {}},
    {{0, 0, 2, 1}, {0, 1, 2, 1}, {}, {}},
    {{0, 0, 1, 2}, {1, 0, 1, 2}, {}, {}},
    {{0, 0, 1, 1}, {1, 0, 1, 1}, {0, 1, 1, 1}, {1, 1, 1, 1}}};
constexpr int kWSubN[4] = {1, 2, 2, 4};
constexpr int kCavlcSubParts[4] = {1, 2, 2, 4};

inline const P8 *cabac_parts(int inter_type, int *nparts) {
  switch (inter_type) {
    case 0: *nparts = 1; return kWParts16x16;
    case 1: *nparts = 2; return kWParts16x8;
    case 2: *nparts = 2; return kWParts8x16;
    default: *nparts = 4; return kWParts8x8;
  }
}

inline int16_t level16(int64_t v) {
  return static_cast<int16_t>(v > kLevelClip ? kLevelClip
                                             : (v < -kLevelClip ? -kLevelClip
                                                                : v));
}

// the fused CABAC walk's syntax lambdas, as functions
bool cabac_read_dqp(CabacDec &dc, CabacNb &grids, int32_t *delta) {
  int val = 0;
  int ctx = 60 + (grids.last_dqp_nz ? 1 : 0);
  while (dc.decision(ctx)) {
    if (++val > 104) return false;
    ctx = val == 1 ? 62 : 63;
  }
  grids.last_dqp_nz = val != 0;
  *delta = (val & 1) ? (val + 1) / 2 : -(val / 2);
  return true;
}

bool cabac_emit_dqp(CabacEnc &en, CabacNb &grids, int32_t delta) {
  if (delta < -26 || delta > 25) return false;   // 7.4.5 bound
  int val = delta > 0 ? 2 * delta - 1 : -2 * delta;
  int ctx = 60 + (grids.last_dqp_nz ? 1 : 0);
  for (int i = 0; i < val; ++i) {
    en.decision(ctx, 1);
    ctx = i == 0 ? 62 : 63;
  }
  en.decision(ctx, 0);
  grids.last_dqp_nz = delta != 0;
  return true;
}

int cabac_read_cmode(CabacDec &dc, CabacNb &grids, int mbi) {
  int cm;
  if (!dc.decision(64 + grids.chroma_pred_inc(mbi)))
    cm = 0;
  else if (!dc.decision(67))
    cm = 1;
  else
    cm = dc.decision(67) ? 3 : 2;
  grids.cmode[mbi] = cm;
  return cm;
}

void cabac_emit_cmode(CabacEnc &en, CabacNb &grids, int mbi, int cm) {
  en.decision(64 + grids.chroma_pred_inc(mbi), cm == 0 ? 0 : 1);
  if (cm > 0) {
    en.decision(67, cm == 1 ? 0 : 1);
    if (cm > 1) en.decision(67, cm == 2 ? 0 : 1);
  }
  grids.cmode[mbi] = cm;
}

bool cabac_read_mvd(CabacDec &dc, int base, int inc, int32_t *v) {
  if (!dc.decision(base + inc)) {
    *v = 0;
    return true;
  }
  int32_t mag = 1;
  int ctxofs = 3;
  while (mag < 9 && dc.decision(base + ctxofs)) {
    ++mag;
    if (ctxofs < 6) ++ctxofs;
  }
  if (mag == 9) {
    int kk = 3;
    while (dc.bypass()) {
      mag += 1 << kk;
      if (++kk > 24) return false;
    }
    while (kk) {
      --kk;
      mag += dc.bypass() << kk;
    }
  }
  *v = dc.bypass() ? -mag : mag;
  return true;
}

void cabac_emit_mvd(CabacEnc &en, int base, int inc, int32_t v) {
  int32_t mag = v < 0 ? -v : v;
  if (mag == 0) {
    en.decision(base + inc, 0);
    return;
  }
  en.decision(base + inc, 1);
  int ctxofs = 3;
  int n = 1;
  int pre = mag < 9 ? mag : 9;
  while (n < pre) {
    en.decision(base + ctxofs, 1);
    if (ctxofs < 6) ++ctxofs;
    ++n;
  }
  if (mag < 9) {
    en.decision(base + ctxofs, 0);
  } else {
    int32_t rem = mag - 9;
    int kk = 3;
    while (rem >= (1 << kk)) {
      en.bypass(1);
      rem -= 1 << kk;
      ++kk;
    }
    en.bypass(0);
    for (int i = kk - 1; i >= 0; --i) en.bypass((rem >> i) & 1);
  }
  en.bypass(v < 0 ? 1 : 0);
}

}  // namespace

struct ed_h264_walk {
  bool cabac = false;
  uint8_t nal_byte = 0;
  SliceHeader h{};
  uint32_t first_mb = 0;
  int32_t width_mbs = 0, height_mbs = 0, log2_max_frame_num = 0;
  int32_t poc_type = 0, log2_max_poc_lsb = 0, pic_init_qp = 0, pps_id = 0;
  int32_t deblocking_control = 0;
  int32_t end_mb = 0;
  int64_t tail_run = -1;          // CAVLC P: the run the slice ends on
  int32_t max_qp = 0;             // over coded MBs; the slice QP if none
  bool coded = false;
  std::vector<WalkMb> mbs;
  std::vector<int32_t> mvd;       // (x, y) pairs
  std::vector<int16_t> rows;      // [R, 16] as gather_slice orders them
  std::vector<int16_t> cdc;       // [C, 2, 4]
  std::vector<int16_t> cac;       // [C, 2, 4, 15]

  int32_t n_rows() const { return static_cast<int32_t>(rows.size() / 16); }
  int32_t n_centries() const { return static_cast<int32_t>(cdc.size() / 8); }

  void fill_info(int32_t *info) const {
    info[ED_H264_WALK_ROWS] = n_rows();
    info[ED_H264_WALK_CENTRIES] = n_centries();
    info[ED_H264_WALK_BLOCKS] = n_rows() + 8 * n_centries();
    info[ED_H264_WALK_MAX_QP] = max_qp;
    info[ED_H264_WALK_MBS] = end_mb - static_cast<int32_t>(first_mb);
    info[ED_H264_WALK_QP] = h.qp;
  }

  // a coded MB's levels into the gather: I16 a DC row and 16 AC rows
  // (the 16th coefficient 0), otherwise 16 rows
  void put_rows(WalkMb &rec, const int16_t *dc, const int16_t *blocks,
                int stride) {
    rec.row0 = n_rows();
    if (dc) rows.insert(rows.end(), dc, dc + 16);
    for (int b = 0; b < 16; ++b)
      rows.insert(rows.end(), blocks + b * stride, blocks + b * stride + 16);
  }

  // a chroma-bearing MB's DC [2][4] and AC [2][4][15] into the gather
  void put_chroma(WalkMb &rec, const int16_t *dc, int dc_stride,
                  const int16_t *ac, int ac_stride) {
    rec.centry = n_centries();
    for (int comp = 0; comp < 2; ++comp)
      cdc.insert(cdc.end(), dc + comp * dc_stride, dc + comp * dc_stride + 4);
    for (int comp = 0; comp < 2; ++comp)
      for (int b = 0; b < 4; ++b) {
        const int16_t *p = ac + comp * ac_stride + b * 16;
        cac.insert(cac.end(), p, p + 15);
      }
  }

  void note_qp(const WalkMb &rec) {
    if (!coded || rec.qp > max_qp) max_qp = rec.qp;
    coded = true;
  }
};

namespace {

// the write's view of one rung's requantized rows, narrowed to the
// walk's int16 scratch
struct RungRows {
  const int64_t *rows, *cdc, *cac;

  void luma(const WalkMb &rec, int16_t *dc, int16_t *blocks,
            int stride) const {
    const int64_t *r = rows + static_cast<int64_t>(rec.row0) * 16;
    if (dc) {
      for (int i = 0; i < 16; ++i) dc[i] = level16(r[i]);
      r += 16;
    }
    for (int b = 0; b < 16; ++b)
      for (int i = 0; i < 16; ++i)
        blocks[b * stride + i] = level16(r[b * 16 + i]);
  }

  // chroma into dc [2][dc_stride] and ac [2][4][16]; zeros without an
  // entry.  The new chroma CBP (2 any AC, 1 any DC, else 0).
  int chroma(const WalkMb &rec, int16_t *dc, int dc_stride,
             int16_t *ac) const {
    std::memset(dc, 0, 2 * dc_stride * sizeof(int16_t));
    std::memset(ac, 0, 2 * 4 * 16 * sizeof(int16_t));
    if (rec.centry < 0) return 0;
    const int64_t *d = cdc + static_cast<int64_t>(rec.centry) * 8;
    const int64_t *a = cac + static_cast<int64_t>(rec.centry) * 120;
    bool any_dc = false, any_ac = false;
    for (int comp = 0; comp < 2; ++comp) {
      for (int i = 0; i < 4; ++i) {
        dc[comp * dc_stride + i] = level16(d[comp * 4 + i]);
        any_dc |= dc[comp * dc_stride + i] != 0;
      }
      for (int b = 0; b < 4; ++b)
        for (int i = 0; i < 15; ++i) {
          int16_t v = level16(a[(comp * 4 + b) * 15 + i]);
          ac[(comp * 4 + b) * 16 + i] = v;
          any_ac |= v != 0;
        }
    }
    return any_ac ? 2 : (any_dc ? 1 : 0);
  }
};

int32_t finish_nal(const std::vector<uint8_t> &payload, uint8_t nal_byte,
                   uint8_t *out, int32_t out_cap) {
  std::vector<uint8_t> wire;
  insert_epb(payload, wire);
  if (static_cast<int64_t>(wire.size()) + 1 > out_cap) return kErrOverflow;
  out[0] = nal_byte;
  std::memcpy(out + 1, wire.data(), wire.size());
  return static_cast<int32_t>(wire.size()) + 1;
}

int parse_cavlc(ed_h264_walk *w, BitReader &br) {
  const SliceHeader &h = w->h;
  int width_mbs = w->width_mbs;
  int n_mbs = width_mbs * w->height_mbs;
  int w4 = width_mbs * 4, h4 = w->height_mbs * 4;
  int w2 = width_mbs * 2, h2 = w->height_mbs * 2;
  std::vector<int16_t> tin(static_cast<size_t>(h4) * w4, -1);
  std::vector<int16_t> cin(static_cast<size_t>(2) * h2 * w2, -1);
  w->mbs.reserve(static_cast<size_t>(n_mbs - w->first_mb));

  auto nc_at = [&](int gx, int gy) -> int {
    int nA = gx > 0 ? tin[static_cast<size_t>(gy) * w4 + gx - 1] : -1;
    int nB = gy > 0 ? tin[static_cast<size_t>(gy - 1) * w4 + gx] : -1;
    if (nA >= 0 && nB >= 0) return (nA + nB + 1) >> 1;
    if (nA >= 0) return nA;
    if (nB >= 0) return nB;
    return 0;
  };
  auto nc_at_c = [&](int comp, int gx, int gy) -> int {
    const int16_t *g = &cin[static_cast<size_t>(comp) * h2 * w2];
    int nA = gx > 0 ? g[static_cast<size_t>(gy) * w2 + gx - 1] : -1;
    int nB = gy > 0 ? g[static_cast<size_t>(gy - 1) * w2 + gx] : -1;
    if (nA >= 0 && nB >= 0) return (nA + nB + 1) >> 1;
    if (nA >= 0) return nA;
    if (nB >= 0) return nB;
    return 0;
  };

  int16_t dc[16], lv[16][16];
  int16_t cdcr[2][16], cacr[2][4][16];

  // one MB's chroma with the parse-side contexts
  auto parse_chroma = [&](WalkMb &rec, int ccbp) -> bool {
    int mbx2 = (rec.mb % width_mbs) * 2, mby2 = (rec.mb / width_mbs) * 2;
    if (ccbp) {
      for (int comp = 0; comp < 2; ++comp)
        if (!decode_residual_n(br, -1, cdcr[comp], 4)) return false;
    } else {
      std::memset(cdcr, 0, sizeof(cdcr));
    }
    for (int comp = 0; comp < 2; ++comp) {
      int16_t *g = &cin[static_cast<size_t>(comp) * h2 * w2];
      for (int b = 0; b < 4; ++b) {
        int gx = mbx2 + (b & 1), gy = mby2 + (b >> 1);
        if (ccbp != 2) {
          g[static_cast<size_t>(gy) * w2 + gx] = 0;
          std::memset(cacr[comp][b], 0, sizeof(cacr[comp][b]));
          continue;
        }
        int nC = nc_at_c(comp, gx, gy);
        int tot;
        if (!decode_residual_n(br, nC, cacr[comp][b], 15, &tot))
          return false;
        g[static_cast<size_t>(gy) * w2 + gx] = static_cast<int16_t>(tot);
      }
    }
    if (ccbp) w->put_chroma(rec, &cdcr[0][0], 16, &cacr[0][0][0], 64);
    return true;
  };
  auto zero_mb_cells = [&](int mb) {
    int mb_x = (mb % width_mbs) * 4, mb_y = (mb / width_mbs) * 4;
    for (int r = 0; r < 4; ++r)
      std::memset(&tin[static_cast<size_t>(mb_y + r) * w4 + mb_x], 0,
                  4 * sizeof(int16_t));
    int cx = (mb % width_mbs) * 2, cy = (mb / width_mbs) * 2;
    for (int comp = 0; comp < 2; ++comp)
      for (int r = 0; r < 2; ++r) {
        cin[(static_cast<size_t>(comp) * h2 + cy + r) * w2 + cx] = 0;
        cin[(static_cast<size_t>(comp) * h2 + cy + r) * w2 + cx + 1] = 0;
      }
  };

  int32_t cur_qp = h.qp;
  int end_mb = n_mbs;
  int mb = static_cast<int>(w->first_mb);
  bool first_iter = true;
  uint32_t run = 0;
  while (mb < n_mbs) {
    if (!first_iter && !br.more_rbsp_data()) {
      end_mb = mb;
      break;
    }
    if (h.is_p) {
      run = br.ue();                             // mb_skip_run
      if (!br.ok || mb + static_cast<int64_t>(run) > n_mbs)
        return kErrBitstream;
      for (uint32_t s = 0; s < run; ++s) zero_mb_cells(mb++);
      if (!br.more_rbsp_data()) {                // slice ends on a run
        end_mb = mb;
        w->tail_run = run;
        break;
      }
      if (mb >= n_mbs) return kErrBitstream;
    }
    first_iter = false;
    uint32_t raw_type = br.ue();
    if (!br.ok) return kErrBitstream;
    int mb_x = (mb % width_mbs) * 4, mb_y = (mb / width_mbs) * 4;
    WalkMb rec{};
    rec.mb = mb;
    rec.skip_run = run;
    rec.row0 = rec.centry = -1;

    if (h.is_p && raw_type < 5) {
      // ---------------- P inter MB: motion verbatim
      rec.kind = kMbInter;
      rec.type = static_cast<int8_t>(raw_type);
      rec.mvd0 = static_cast<int32_t>(w->mvd.size() / 2);
      int n_mvds = 0;
      bool has_refs = raw_type != 4 && h.n_ref > 1;
      auto read_mvd = [&]() {
        int32_t x = br.se();
        int32_t y = br.se();
        w->mvd.push_back(x);
        w->mvd.push_back(y);
        ++n_mvds;
      };
      if (raw_type <= 2) {
        int n_parts = raw_type == 0 ? 1 : 2;
        for (int p = 0; p < n_parts && has_refs; ++p) {
          rec.refs[p] = h.n_ref == 2 ? 1 - br.bit()
                                     : static_cast<int>(br.ue());
          if (rec.refs[p] >= h.n_ref) return kErrBitstream;
        }
        for (int p = 0; p < n_parts; ++p) read_mvd();
      } else {
        for (int s = 0; s < 4; ++s) {
          uint32_t t = br.ue();
          if (t > 3) return kErrBitstream;
          rec.sub_t[s] = static_cast<uint8_t>(t);
        }
        for (int p = 0; p < 4 && has_refs; ++p) {
          rec.refs[p] = h.n_ref == 2 ? 1 - br.bit()
                                     : static_cast<int>(br.ue());
          if (rec.refs[p] >= h.n_ref) return kErrBitstream;
        }
        for (int s = 0; s < 4; ++s)
          for (int p = 0; p < kCavlcSubParts[rec.sub_t[s]]; ++p) read_mvd();
      }
      rec.n_mvd = static_cast<uint8_t>(n_mvds);
      uint32_t code = br.ue();
      if (!br.ok || code >= 48) return kErrBitstream;
      int cbp_in = kCbpInterFromCode[code];
      if (cbp_in) {
        cur_qp += br.se();                       // cumulative (7.4.5)
        if (cur_qp < 0 || cur_qp > 51) return kErrBitstream;
      }
      rec.cbp = static_cast<uint8_t>(cbp_in);
      rec.qp = cur_qp;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mb_x + x4, gy = mb_y + y4;
        if (!((cbp_in >> (b >> 2)) & 1)) {
          tin[static_cast<size_t>(gy) * w4 + gx] = 0;
          std::memset(lv[b], 0, sizeof(lv[b]));
          continue;
        }
        int tot;
        if (!decode_residual(br, nc_at(gx, gy), lv[b], &tot))
          return kErrBitstream;
        tin[static_cast<size_t>(gy) * w4 + gx] = static_cast<int16_t>(tot);
      }
      w->put_rows(rec, nullptr, &lv[0][0], 16);
      if (!parse_chroma(rec, cbp_in >> 4)) return kErrBitstream;
      w->note_qp(rec);
      w->mbs.push_back(rec);
      ++mb;
      continue;
    }

    uint32_t mb_type = h.is_p ? raw_type - 5 : raw_type;
    if (mb_type >= 1 && mb_type <= 24) {
      // ---------------- I_16x16
      rec.kind = kMbI16;
      rec.type = static_cast<int8_t>((mb_type - 1) % 4);
      int chroma_cbp = (static_cast<int>(mb_type - 1) / 4) % 3;
      bool luma15 = mb_type >= 13;
      rec.cmode = br.ue();
      cur_qp += br.se();                         // always coded for I16
      if (cur_qp < 12 || cur_qp > 51) return kErrUnsupported;
      rec.cbp = static_cast<uint8_t>((luma15 ? 15 : 0) | (chroma_cbp << 4));
      rec.qp = cur_qp;
      if (!decode_residual(br, nc_at(mb_x, mb_y), dc)) return kErrBitstream;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mb_x + x4, gy = mb_y + y4;
        if (!luma15) {
          tin[static_cast<size_t>(gy) * w4 + gx] = 0;
          std::memset(lv[b], 0, sizeof(lv[b]));
          continue;
        }
        int tot;
        if (!decode_residual15(br, nc_at(gx, gy), lv[b], &tot))
          return kErrBitstream;
        tin[static_cast<size_t>(gy) * w4 + gx] = static_cast<int16_t>(tot);
      }
      w->put_rows(rec, dc, &lv[0][0], 16);
      if (!parse_chroma(rec, chroma_cbp)) return kErrBitstream;
      w->note_qp(rec);
      w->mbs.push_back(rec);
      ++mb;
      continue;
    }
    if (mb_type != 0) return kErrUnsupported;    // I_PCM etc.
    // ---------------- I_4x4
    rec.kind = kMbI4;
    for (int b = 0; b < 16; ++b) {
      rec.modes[b][0] = static_cast<uint8_t>(br.bit());
      rec.modes[b][1] =
          static_cast<uint8_t>(rec.modes[b][0] ? 0 : br.bits(3));
    }
    rec.cmode = br.ue();
    uint32_t code = br.ue();
    if (!br.ok || code >= 48) return kErrBitstream;
    int cbp_in = kCbpIntraFromCode[code];
    if (cbp_in) {
      cur_qp += br.se();                         // cumulative (7.4.5)
      if (cur_qp < 0 || cur_qp > 51) return kErrBitstream;
    }
    rec.cbp = static_cast<uint8_t>(cbp_in);
    rec.qp = cur_qp;
    for (int b = 0; b < 16; ++b) {
      int x4, y4;
      blk_xy(b, &x4, &y4);
      int gx = mb_x + x4, gy = mb_y + y4;
      if (!((cbp_in >> (b >> 2)) & 1)) {
        tin[static_cast<size_t>(gy) * w4 + gx] = 0;
        std::memset(lv[b], 0, sizeof(lv[b]));
        continue;
      }
      int tot;
      if (!decode_residual(br, nc_at(gx, gy), lv[b], &tot))
        return kErrBitstream;
      tin[static_cast<size_t>(gy) * w4 + gx] = static_cast<int16_t>(tot);
    }
    w->put_rows(rec, nullptr, &lv[0][0], 16);
    if (!parse_chroma(rec, cbp_in >> 4)) return kErrBitstream;
    w->note_qp(rec);
    w->mbs.push_back(rec);
    ++mb;
  }
  if (!br.ok) return kErrBitstream;
  if (mb >= n_mbs) end_mb = n_mbs;
  w->end_mb = end_mb;
  return 0;
}

int parse_cabac(ed_h264_walk *w, const std::vector<uint8_t> &rbsp,
                const BitReader &br) {
  const SliceHeader &h = w->h;
  int width_mbs = w->width_mbs;
  int n_mbs = width_mbs * w->height_mbs;
  const int8_t(*init_table)[2] =
      h.is_p ? kCabacCtxInitP[h.cabac_init_idc] : kCabacCtxInitI;
  CabacDec dec;
  if (dec.init(rbsp.data(), static_cast<int64_t>(rbsp.size()) * 8, br.pos,
               h.qp, init_table))
    return kErrBitstream;
  CabacNb nb(width_mbs, w->height_mbs);          // parse-side contexts
  w->mbs.reserve(static_cast<size_t>(n_mbs - w->first_mb));

  int16_t rows[17 * 16];                 // row 0 = I16 DC, 1+b = blocks
  int16_t cd[2 * 16], ca[2 * 4 * 16];

  // the fused walk's chroma_fused, decode half
  auto chroma_dec = [&](WalkMb &rec, int ccbp_in, int intra) -> bool {
    int mb = rec.mb;
    int cx2 = (mb % width_mbs) * 2, cy2 = (mb / width_mbs) * 2;
    std::memset(cd, 0, sizeof(cd));
    std::memset(ca, 0, sizeof(ca));
    if (ccbp_in) {
      for (int comp = 0; comp < 2; ++comp) {
        int cbf = dec.decision(85 + 12 + nb.cdc_inc(comp, mb, intra));
        nb.set_cdc(comp, mb, cbf);
        if (cbf && !cabac_residual_dec(dec, 3, cd + comp * 16, 4))
          return false;
      }
    } else {
      nb.set_cdc(0, mb, 0);
      nb.set_cdc(1, mb, 0);
    }
    for (int comp = 0; comp < 2; ++comp)
      for (int b = 0; b < 4; ++b) {
        int gx = cx2 + (b & 1), gy = cy2 + (b >> 1);
        if (ccbp_in == 2) {
          int cbf = dec.decision(85 + 16 +
                                 nb.chroma_cbf_inc(comp, gx, gy, intra));
          nb.set_ccbf(comp, gx, gy, cbf);
          if (cbf &&
              !cabac_residual_dec(dec, 4, ca + (comp * 4 + b) * 16, 15))
            return false;
        } else {
          nb.set_ccbf(comp, gx, gy, 0);
        }
      }
    if (ccbp_in) w->put_chroma(rec, cd, 16, ca, 64);
    return true;
  };
  auto read_cbp = [&](int mb, int *cbp, int *chroma_cbp) {
    *cbp = 0;
    for (int b8 = 0; b8 < 4; ++b8)
      if (dec.decision(73 + nb.cbp_luma_inc(mb, b8, *cbp))) *cbp |= 1 << b8;
    *chroma_cbp = 0;
    if (dec.decision(77 + nb.cbp_chroma_inc(mb, 0)))
      *chroma_cbp = dec.decision(81 + nb.cbp_chroma_inc(mb, 1)) ? 2 : 1;
    nb.cbpl[mb] = *cbp;
    nb.cbpc[mb] = *chroma_cbp;
  };
  // 4x4 luma blocks of an I_4x4 or inter MB (ctxBlockCat 2)
  auto luma_dec = [&](int mb, int cbp, int intra) -> bool {
    int mbx4 = (mb % width_mbs) * 4, mby4 = (mb / width_mbs) * 4;
    for (int b = 0; b < 16; ++b) {
      int x4, y4;
      blk_xy(b, &x4, &y4);
      int gx = mbx4 + x4, gy = mby4 + y4;
      int16_t *lv = rows + (1 + b) * 16;
      if ((cbp >> (b >> 2)) & 1) {
        int cbf = dec.decision(85 + 8 + nb.luma_cbf_inc(gx, gy, intra));
        nb.set_lcbf(gx, gy, cbf);
        if (cbf && !cabac_residual_dec(dec, 2, lv, 16)) return false;
      } else {
        nb.set_lcbf(gx, gy, 0);
      }
    }
    return true;
  };

  int32_t cur_qp = h.qp;
  int end_mb = static_cast<int>(w->first_mb);
  for (int mb = static_cast<int>(w->first_mb);; ++mb) {
    if (mb >= n_mbs) return kErrBitstream;         // overran the picture
    int mbx4 = (mb % width_mbs) * 4, mby4 = (mb / width_mbs) * 4;
    int bx2 = (mb % width_mbs) * 2, by2 = (mb / width_mbs) * 2;
    WalkMb rec{};
    rec.mb = mb;
    rec.row0 = rec.centry = -1;

    if (h.is_p) {
      if (dec.decision(11 + nb.skip_inc(mb))) {
        nb.mark_skip(mb);
        rec.kind = kMbSkip;
        rec.qp = cur_qp;
        w->mbs.push_back(rec);
        end_mb = mb + 1;
        if (dec.terminate()) break;
        continue;
      }
    }

    std::memset(rows, 0, sizeof(rows));
    int is16 = 0, inter_type = -1;
    if (h.is_p) {
      if (dec.decision(14) == 0) {
        if (dec.decision(15) == 0)
          inter_type = 3 * dec.decision(16);
        else
          inter_type = 2 - dec.decision(17);
      } else if (dec.decision(17) == 0) {
        is16 = 0;
      } else {
        if (dec.terminate()) return kErrUnsupported;  // I_PCM
        is16 = 1;
      }
    } else {
      if (dec.decision(3 + nb.mb_type_inc(mb)) == 0) {
        is16 = 0;
      } else {
        if (dec.terminate()) return kErrUnsupported;  // I_PCM
        is16 = 1;
      }
    }

    if (inter_type >= 0) {
      // ---------------- P inter MB
      rec.kind = kMbInter;
      rec.type = static_cast<int8_t>(inter_type);
      nb.seen[mb] = 1;
      nb.i4x4[mb] = 0;
      nb.cmode[mb] = 0;
      int nparts;
      const P8 *parts = cabac_parts(inter_type, &nparts);
      if (inter_type == 3) {
        for (int s = 0; s < 4; ++s) {            // sub_mb_type, ctx 21-23
          if (dec.decision(21))
            rec.sub_t[s] = 0;
          else if (!dec.decision(22))
            rec.sub_t[s] = 1;
          else
            rec.sub_t[s] = dec.decision(23) ? 2 : 3;
        }
      }
      for (int p = 0; p < nparts; ++p) {
        int r = 0;
        if (h.n_ref > 1) {
          int ctx = 54 + nb.ref_inc(bx2 + parts[p].x, by2 + parts[p].y);
          while (dec.decision(ctx)) {
            if (++r > 31) return kErrBitstream;
            ctx = r == 1 ? 58 : 59;
          }
          if (r >= h.n_ref) return kErrBitstream;
        }
        rec.refs[p] = r;
        nb.set_refgt0(bx2 + parts[p].x, by2 + parts[p].y, parts[p].pw,
                      parts[p].ph, r > 0 ? 1 : 0);
      }
      rec.mvd0 = static_cast<int32_t>(w->mvd.size() / 2);
      int nmvd = 0;
      auto dec_mvd_rect = [&](int x4, int y4, int w4, int h4) -> bool {
        int32_t mx, my;
        if (!cabac_read_mvd(dec, 40, nb.mvd_inc(0, x4, y4), &mx))
          return false;
        if (!cabac_read_mvd(dec, 47, nb.mvd_inc(1, x4, y4), &my))
          return false;
        nb.set_absmvd(0, x4, y4, w4, h4, mx < 0 ? -mx : mx);
        nb.set_absmvd(1, x4, y4, w4, h4, my < 0 ? -my : my);
        w->mvd.push_back(mx);
        w->mvd.push_back(my);
        ++nmvd;
        return true;
      };
      if (inter_type == 3) {
        for (int s = 0; s < 4; ++s) {
          int ox = mbx4 + (s & 1) * 2, oy = mby4 + (s >> 1) * 2;
          for (int q = 0; q < kWSubN[rec.sub_t[s]]; ++q) {
            const S4 &r4 = kWSub4[rec.sub_t[s]][q];
            if (!dec_mvd_rect(ox + r4.x, oy + r4.y, r4.sw, r4.sh))
              return kErrBitstream;
          }
        }
      } else {
        for (int p = 0; p < nparts; ++p)
          if (!dec_mvd_rect(mbx4 + parts[p].x * 2, mby4 + parts[p].y * 2,
                            parts[p].pw * 2, parts[p].ph * 2))
            return kErrBitstream;
      }
      rec.n_mvd = static_cast<uint8_t>(nmvd);
      int cbp, chroma_cbp;
      read_cbp(mb, &cbp, &chroma_cbp);
      if (cbp || chroma_cbp) {
        int32_t delta;
        if (!cabac_read_dqp(dec, nb, &delta)) return kErrBitstream;
        cur_qp += delta;
        if (cur_qp < 0 || cur_qp > 51) return kErrBitstream;
      } else {
        nb.last_dqp_nz = false;
      }
      nb.dccbf[mb] = 0;
      rec.cbp = static_cast<uint8_t>(cbp | (chroma_cbp << 4));
      rec.qp = cur_qp;
      if (!luma_dec(mb, cbp, 0)) return kErrBitstream;
      w->put_rows(rec, nullptr, rows + 16, 16);
      if (!chroma_dec(rec, chroma_cbp, 0)) return kErrBitstream;
    } else if (!is16) {
      // ---------------- I_4x4
      rec.kind = kMbI4;
      nb.seen[mb] = 1;
      nb.i4x4[mb] = 1;
      for (int b = 0; b < 16; ++b) {
        int flag = dec.decision(68);
        int rem = 0;
        if (!flag)
          rem = dec.decision(69) | (dec.decision(69) << 1) |
                (dec.decision(69) << 2);
        rec.modes[b][0] = static_cast<uint8_t>(flag);
        rec.modes[b][1] = static_cast<uint8_t>(rem);
      }
      rec.cmode = static_cast<uint32_t>(cabac_read_cmode(dec, nb, mb));
      int cbp, chroma_cbp;
      read_cbp(mb, &cbp, &chroma_cbp);
      if (cbp || chroma_cbp) {
        int32_t delta;
        if (!cabac_read_dqp(dec, nb, &delta)) return kErrBitstream;
        cur_qp += delta;
        if (cur_qp < 0 || cur_qp > 51) return kErrBitstream;
      } else {
        nb.last_dqp_nz = false;
      }
      nb.dccbf[mb] = 0;
      rec.cbp = static_cast<uint8_t>(cbp | (chroma_cbp << 4));
      rec.qp = cur_qp;
      if (!luma_dec(mb, cbp, 1)) return kErrBitstream;
      w->put_rows(rec, nullptr, rows + 16, 16);
      if (!chroma_dec(rec, chroma_cbp, 1)) return kErrBitstream;
    } else {
      // ---------------- I_16x16 (in I slices ctx 6-10; in P 18-20)
      rec.kind = kMbI16;
      int c_luma15 = h.is_p ? 18 : 6;
      int c_cb0 = h.is_p ? 19 : 7;
      int c_cb1 = h.is_p ? 19 : 8;
      int c_ph = h.is_p ? 20 : 9;
      int c_pl = h.is_p ? 20 : 10;
      int luma15 = dec.decision(c_luma15);
      int chroma_cbp = 0;
      if (dec.decision(c_cb0)) chroma_cbp = dec.decision(c_cb1) ? 2 : 1;
      int pred = (dec.decision(c_ph) << 1) | dec.decision(c_pl);
      rec.type = static_cast<int8_t>(pred);
      nb.seen[mb] = 1;
      nb.i4x4[mb] = 0;
      nb.cbpl[mb] = luma15 ? 15 : 0;
      nb.cbpc[mb] = chroma_cbp;
      rec.cmode = static_cast<uint32_t>(cabac_read_cmode(dec, nb, mb));
      {
        int32_t delta;
        if (!cabac_read_dqp(dec, nb, &delta)) return kErrBitstream;
        cur_qp += delta;
        if (cur_qp < 12 || cur_qp > 51) return kErrUnsupported;
      }
      rec.cbp = static_cast<uint8_t>((luma15 ? 15 : 0) | (chroma_cbp << 4));
      rec.qp = cur_qp;
      int cbf = dec.decision(85 + 0 + nb.dc_cbf_inc(mb));
      nb.dccbf[mb] = static_cast<int8_t>(cbf);
      if (cbf && !cabac_residual_dec(dec, 0, rows, 16)) return kErrBitstream;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mbx4 + x4, gy = mby4 + y4;
        int16_t *lv = rows + (1 + b) * 16;
        if (luma15) {
          int c2 = dec.decision(85 + 4 + nb.luma_cbf_inc(gx, gy));
          nb.set_lcbf(gx, gy, c2);
          if (c2 && !cabac_residual_dec(dec, 1, lv, 15)) return kErrBitstream;
        } else {
          nb.set_lcbf(gx, gy, 0);
        }
      }
      w->put_rows(rec, rows, rows + 16, 16);
      if (!chroma_dec(rec, chroma_cbp, 1)) return kErrBitstream;
    }
    w->note_qp(rec);
    w->mbs.push_back(rec);
    if (!dec.ok) return kErrBitstream;
    end_mb = mb + 1;
    if (dec.terminate()) break;
  }
  w->end_mb = end_mb;
  return 0;
}

int32_t parse_entry(const uint8_t *nal, int32_t nal_len, int32_t width_mbs,
                    int32_t height_mbs, int32_t log2_max_frame_num,
                    int32_t poc_type, int32_t log2_max_poc_lsb,
                    int32_t pic_init_qp, int32_t pps_id,
                    int32_t deblocking_control, int32_t bottom_field_poc,
                    int32_t num_ref_l0_default, int32_t weighted_pred,
                    ed_h264_walk **walk_out, int32_t *info_out, int cabac) {
  if (!walk_out || !info_out || (!nal && nal_len > 0)) return kErrArgs;
  *walk_out = nullptr;
  if (nal_len < 2) return kErrUnsupported;
  uint8_t nal_byte = nal[0];
  int nal_type = nal_byte & 0x1F;
  if (nal_type != 1 && nal_type != 5) return kErrUnsupported;
  std::unique_ptr<ed_h264_walk> w(new ed_h264_walk());
  w->cabac = cabac != 0;
  w->nal_byte = nal_byte;
  w->width_mbs = width_mbs;
  w->height_mbs = height_mbs;
  w->log2_max_frame_num = log2_max_frame_num;
  w->poc_type = poc_type;
  w->log2_max_poc_lsb = log2_max_poc_lsb;
  w->pic_init_qp = pic_init_qp;
  w->pps_id = pps_id;
  w->deblocking_control = deblocking_control;
  std::vector<uint8_t> rbsp;
  strip_epb(nal + 1, nal_len - 1, rbsp);
  BitReader br(rbsp.data(), static_cast<int64_t>(rbsp.size()));
  int rc = parse_islice_header(br, nal_type, (nal_byte >> 5) & 3,
                               log2_max_frame_num, poc_type,
                               log2_max_poc_lsb, pic_init_qp,
                               deblocking_control, bottom_field_poc, &w->h,
                               &w->first_mb, num_ref_l0_default,
                               weighted_pred, cabac);
  if (rc) return rc;
  if (w->first_mb >= static_cast<uint32_t>(width_mbs * height_mbs))
    return kErrBitstream;
  w->max_qp = w->h.qp;
  rc = cabac ? parse_cabac(w.get(), rbsp, br) : parse_cavlc(w.get(), br);
  if (rc) return rc;
  w->fill_info(info_out);
  *walk_out = w.release();
  return 0;
}

// the write's common checks: the fused walk's unsupported deltas and its
// QP-51 ceiling (every QP the fused walk tests is the slice QP or a coded
// MB's, so the ceiling is the largest of those)
int32_t write_checks(const ed_h264_walk *w, int cabac, int32_t delta_qp,
                     const int64_t *rows, int32_t n_rows,
                     const int64_t *cdc, const int64_t *cac,
                     int32_t n_centries, const uint8_t *out) {
  if (!w || w->cabac != (cabac != 0) || !out || n_rows != w->n_rows() ||
      n_centries != w->n_centries() || (n_rows && !rows) ||
      (n_centries && (!cdc || !cac)))
    return kErrArgs;
  if (delta_qp < 6 || delta_qp % 6) return kErrUnsupported;
  if (w->h.qp + delta_qp > 51 || w->max_qp + delta_qp > 51)
    return kErrUnsupported;
  return 0;
}

}  // namespace

extern "C" int32_t ed_h264_parse_slice(
    const uint8_t *nal, int32_t nal_len, int32_t width_mbs,
    int32_t height_mbs, int32_t log2_max_frame_num, int32_t poc_type,
    int32_t log2_max_poc_lsb, int32_t pic_init_qp, int32_t pps_id,
    int32_t deblocking_control, int32_t bottom_field_poc,
    int32_t chroma_qp_offset, int32_t num_ref_l0_default,
    int32_t weighted_pred, ed_h264_walk **walk_out, int32_t *info_out) {
  (void)chroma_qp_offset;               // B6 maps the chroma QPs
  return parse_entry(nal, nal_len, width_mbs, height_mbs,
                     log2_max_frame_num, poc_type, log2_max_poc_lsb,
                     pic_init_qp, pps_id, deblocking_control,
                     bottom_field_poc, num_ref_l0_default, weighted_pred,
                     walk_out, info_out, 0);
}

extern "C" int32_t ed_h264_parse_slice_cabac(
    const uint8_t *nal, int32_t nal_len, int32_t width_mbs,
    int32_t height_mbs, int32_t log2_max_frame_num, int32_t poc_type,
    int32_t log2_max_poc_lsb, int32_t pic_init_qp, int32_t pps_id,
    int32_t deblocking_control, int32_t bottom_field_poc,
    int32_t chroma_qp_offset, int32_t num_ref_l0_default,
    int32_t weighted_pred, ed_h264_walk **walk_out, int32_t *info_out) {
  (void)chroma_qp_offset;               // B6 maps the chroma QPs
  return parse_entry(nal, nal_len, width_mbs, height_mbs,
                     log2_max_frame_num, poc_type, log2_max_poc_lsb,
                     pic_init_qp, pps_id, deblocking_control,
                     bottom_field_poc, num_ref_l0_default, weighted_pred,
                     walk_out, info_out, 1);
}

extern "C" int32_t ed_h264_walk_gather(const ed_h264_walk *w, int64_t *rows,
                                       int64_t *qps, int64_t *cdc,
                                       int64_t *cac, int64_t *cqp) {
  if (!w) return kErrArgs;
  for (size_t i = 0; i < w->rows.size(); ++i) rows[i] = w->rows[i];
  for (size_t i = 0; i < w->cdc.size(); ++i) cdc[i] = w->cdc[i];
  for (size_t i = 0; i < w->cac.size(); ++i) cac[i] = w->cac[i];
  for (const WalkMb &rec : w->mbs) {
    if (rec.row0 >= 0) {
      int n = rec.kind == kMbI16 ? 17 : 16;
      for (int r = 0; r < n; ++r) qps[rec.row0 + r] = rec.qp;
    }
    if (rec.centry >= 0) cqp[rec.centry] = rec.qp;
  }
  return 0;
}

extern "C" void ed_h264_walk_free(ed_h264_walk *w) { delete w; }

extern "C" int32_t ed_h264_walk_info_fields(void) {
  return ED_H264_WALK_INFO_FIELDS;
}

extern "C" int32_t ed_h264_write_slice(const ed_h264_walk *w,
                                       int32_t delta_qp, const int64_t *rows,
                                       int32_t n_rows, const int64_t *cdc,
                                       const int64_t *cac,
                                       int32_t n_centries, uint8_t *out,
                                       int32_t out_cap) {
  int32_t rc = write_checks(w, 0, delta_qp, rows, n_rows, cdc, cac,
                            n_centries, out);
  if (rc) return rc;
  const SliceHeader &h = w->h;
  const RungRows rung{rows, cdc, cac};
  int width_mbs = w->width_mbs;
  int w4 = width_mbs * 4, h4 = w->height_mbs * 4;
  int w2 = width_mbs * 2, h2 = w->height_mbs * 2;
  std::vector<int16_t> tout(static_cast<size_t>(h4) * w4, -1);
  std::vector<int16_t> cout_(static_cast<size_t>(2) * h2 * w2, -1);
  auto nc_at = [&](int gx, int gy) -> int {
    int nA = gx > 0 ? tout[static_cast<size_t>(gy) * w4 + gx - 1] : -1;
    int nB = gy > 0 ? tout[static_cast<size_t>(gy - 1) * w4 + gx] : -1;
    if (nA >= 0 && nB >= 0) return (nA + nB + 1) >> 1;
    if (nA >= 0) return nA;
    if (nB >= 0) return nB;
    return 0;
  };
  auto nc_at_c = [&](int comp, int gx, int gy) -> int {
    const int16_t *g = &cout_[static_cast<size_t>(comp) * h2 * w2];
    int nA = gx > 0 ? g[static_cast<size_t>(gy) * w2 + gx - 1] : -1;
    int nB = gy > 0 ? g[static_cast<size_t>(gy - 1) * w2 + gx] : -1;
    if (nA >= 0 && nB >= 0) return (nA + nB + 1) >> 1;
    if (nA >= 0) return nA;
    if (nB >= 0) return nB;
    return 0;
  };

  BitWriter bw;
  int32_t qp_out_base = h.qp + delta_qp;
  write_islice_header(bw, h, w->first_mb, w->pps_id, qp_out_base,
                      w->log2_max_frame_num, w->poc_type,
                      w->log2_max_poc_lsb, w->pic_init_qp,
                      w->deblocking_control, 0);

  int16_t dc[16], lv[16][16];
  int16_t cdcr[2][16], cacr[2][4][16];
  auto write_chroma = [&](int mb, int ccbp) -> bool {
    int mbx2 = (mb % width_mbs) * 2, mby2 = (mb / width_mbs) * 2;
    if (ccbp) {
      for (int comp = 0; comp < 2; ++comp)
        if (!encode_residual_n(bw, cdcr[comp], -1, 4)) return false;
    }
    for (int comp = 0; comp < 2; ++comp) {
      int16_t *g = &cout_[static_cast<size_t>(comp) * h2 * w2];
      for (int b = 0; b < 4; ++b) {
        int gx = mbx2 + (b & 1), gy = mby2 + (b >> 1);
        if (ccbp != 2) {
          g[static_cast<size_t>(gy) * w2 + gx] = 0;
          continue;
        }
        int tot;
        if (!encode_residual_n(bw, cacr[comp][b], nc_at_c(comp, gx, gy), 15,
                               &tot))
          return false;
        g[static_cast<size_t>(gy) * w2 + gx] = static_cast<int16_t>(tot);
      }
    }
    return true;
  };
  auto zero_mb_cells = [&](int mb) {
    int mb_x = (mb % width_mbs) * 4, mb_y = (mb / width_mbs) * 4;
    for (int r = 0; r < 4; ++r)
      std::memset(&tout[static_cast<size_t>(mb_y + r) * w4 + mb_x], 0,
                  4 * sizeof(int16_t));
    int cx = (mb % width_mbs) * 2, cy = (mb / width_mbs) * 2;
    for (int comp = 0; comp < 2; ++comp)
      for (int r = 0; r < 2; ++r) {
        cout_[(static_cast<size_t>(comp) * h2 + cy + r) * w2 + cx] = 0;
        cout_[(static_cast<size_t>(comp) * h2 + cy + r) * w2 + cx + 1] = 0;
      }
  };
  // the luma 4x4 blocks of an I_4x4 or inter MB at out_cbp
  auto write_blocks = [&](int mb_x, int mb_y, int out_cbp) -> bool {
    for (int b = 0; b < 16; ++b) {
      int x4, y4;
      blk_xy(b, &x4, &y4);
      int gx = mb_x + x4, gy = mb_y + y4;
      if (!((out_cbp >> (b >> 2)) & 1)) {
        tout[static_cast<size_t>(gy) * w4 + gx] = 0;
        continue;
      }
      int tot;
      if (!encode_residual(bw, lv[b], nc_at(gx, gy), &tot)) return false;
      tout[static_cast<size_t>(gy) * w4 + gx] = static_cast<int16_t>(tot);
    }
    return true;
  };
  auto luma_cbp = [&]() {
    int cbp = 0;
    for (int b = 0; b < 16; ++b)
      for (int i = 0; i < 16; ++i)
        if (lv[b][i]) {
          cbp |= 1 << (b >> 2);
          break;
        }
    return cbp;
  };

  int32_t prev_qp = qp_out_base;
  for (const WalkMb &rec : w->mbs) {
    int mb = rec.mb;
    if (h.is_p) {
      bw.ue(rec.skip_run);                       // skip map is verbatim
      for (uint32_t s = rec.skip_run; s > 0; --s) zero_mb_cells(mb - s);
    }
    int mb_x = (mb % width_mbs) * 4, mb_y = (mb / width_mbs) * 4;
    int new_ccbp = rung.chroma(rec, &cdcr[0][0], 16, &cacr[0][0][0]);

    if (rec.kind == kMbInter) {
      // ---------------- P inter MB: motion verbatim
      rung.luma(rec, nullptr, &lv[0][0], 16);
      int out_cbp = luma_cbp();
      uint32_t raw_type = static_cast<uint32_t>(rec.type);
      bool has_refs = raw_type != 4 && h.n_ref > 1;
      const int32_t *mvd = w->mvd.data() + 2 * static_cast<size_t>(rec.mvd0);
      bw.ue(raw_type);
      int n_parts = raw_type == 0 ? 1 : (raw_type <= 2 ? 2 : 4);
      if (raw_type > 2)
        for (int s = 0; s < 4; ++s) bw.ue(rec.sub_t[s]);
      for (int p = 0; p < n_parts && has_refs; ++p) {
        if (h.n_ref == 2)
          bw.bit(1 - rec.refs[p]);
        else
          bw.ue(static_cast<uint32_t>(rec.refs[p]));
      }
      for (int p = 0; p < rec.n_mvd; ++p) {
        bw.se(mvd[2 * p]);
        bw.se(mvd[2 * p + 1]);
      }
      int full_cbp = out_cbp | (new_ccbp << 4);
      bw.ue(kCbpInterToCode[full_cbp]);
      if (full_cbp) {
        int32_t qp_out_mb = rec.qp + delta_qp;
        int32_t d = qp_out_mb - prev_qp;
        if (d < -26 || d > 25) return kErrUnsupported;
        bw.se(d);
        prev_qp = qp_out_mb;
      }
      if (!write_blocks(mb_x, mb_y, out_cbp)) return kErrBitstream;
      if (!write_chroma(mb, new_ccbp)) return kErrBitstream;
      continue;
    }
    if (rec.kind == kMbI16) {
      // ---------------- I_16x16
      rung.luma(rec, dc, &lv[0][0], 16);
      bool luma15 = (rec.cbp & 15) != 0;
      bool any_ac = false;
      for (int b = 0; b < 16; ++b)
        for (int i = 0; i < 15; ++i) any_ac |= lv[b][i] != 0;
      bool out15 = luma15 && any_ac;
      bw.ue((h.is_p ? 5u : 0u) + 1 + static_cast<uint32_t>(rec.type) +
            4 * new_ccbp + (out15 ? 12 : 0));
      bw.ue(rec.cmode);
      int32_t qp_out_mb = rec.qp + delta_qp;
      int32_t d = qp_out_mb - prev_qp;
      if (d < -26 || d > 25) return kErrUnsupported;
      bw.se(d);
      prev_qp = qp_out_mb;
      if (!encode_residual(bw, dc, nc_at(mb_x, mb_y))) return kErrBitstream;
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mb_x + x4, gy = mb_y + y4;
        if (!out15) {
          tout[static_cast<size_t>(gy) * w4 + gx] = 0;
          continue;
        }
        int tot;
        if (!encode_residual15(bw, lv[b], nc_at(gx, gy), &tot))
          return kErrBitstream;
        tout[static_cast<size_t>(gy) * w4 + gx] = static_cast<int16_t>(tot);
      }
      if (!write_chroma(mb, new_ccbp)) return kErrBitstream;
      continue;
    }
    // ---------------- I_4x4
    rung.luma(rec, nullptr, &lv[0][0], 16);
    int out_cbp = luma_cbp();
    bw.ue(h.is_p ? 5u : 0u);                     // mb_type I_4x4
    for (int b = 0; b < 16; ++b) {
      bw.bit(rec.modes[b][0]);
      if (!rec.modes[b][0]) bw.bits(rec.modes[b][1], 3);
    }
    bw.ue(rec.cmode);
    int full_cbp = out_cbp | (new_ccbp << 4);
    bw.ue(kCbpIntraToCode[full_cbp]);
    if (full_cbp) {
      int32_t qp_out_mb = rec.qp + delta_qp;
      int32_t d = qp_out_mb - prev_qp;
      if (d < -26 || d > 25) return kErrUnsupported;
      bw.se(d);
      prev_qp = qp_out_mb;
    }
    if (!write_blocks(mb_x, mb_y, out_cbp)) return kErrBitstream;
    if (!write_chroma(mb, new_ccbp)) return kErrBitstream;
  }
  if (w->tail_run >= 0) bw.ue(static_cast<uint32_t>(w->tail_run));
  bw.trailing();
  return finish_nal(bw.out, w->nal_byte, out, out_cap);
}

extern "C" int32_t ed_h264_write_slice_cabac(
    const ed_h264_walk *w, int32_t delta_qp, const int64_t *rows,
    int32_t n_rows, const int64_t *cdc, const int64_t *cac,
    int32_t n_centries, uint8_t *out, int32_t out_cap) {
  int32_t rc = write_checks(w, 1, delta_qp, rows, n_rows, cdc, cac,
                            n_centries, out);
  if (rc) return rc;
  const SliceHeader &h = w->h;
  const RungRows rung{rows, cdc, cac};
  int width_mbs = w->width_mbs;
  const int8_t(*init_table)[2] =
      h.is_p ? kCabacCtxInitP[h.cabac_init_idc] : kCabacCtxInitI;

  BitWriter bw;
  int32_t qp_out_base = h.qp + delta_qp;
  write_islice_header(bw, h, w->first_mb, w->pps_id, qp_out_base,
                      w->log2_max_frame_num, w->poc_type,
                      w->log2_max_poc_lsb, w->pic_init_qp,
                      w->deblocking_control, 1);
  while (bw.nbits) bw.bit(1);                      // cabac_alignment_one
  CabacEnc enc;
  cabac_init_states(enc.state, qp_out_base, init_table);
  CabacNb wb(width_mbs, w->height_mbs);            // write-side contexts

  int16_t rows16[17 * 16];               // row 0 = I16 DC, 1+b = blocks
  int16_t cd[2 * 16], ca[2 * 4 * 16];

  // the fused walk's chroma_emit
  auto chroma_emit = [&](int mb, int ccbp, int intra) {
    int cx2 = (mb % width_mbs) * 2, cy2 = (mb / width_mbs) * 2;
    if (ccbp) {
      for (int comp = 0; comp < 2; ++comp) {
        const int16_t *d = cd + comp * 16;
        bool any = d[0] || d[1] || d[2] || d[3];
        enc.decision(85 + 12 + wb.cdc_inc(comp, mb, intra), any ? 1 : 0);
        wb.set_cdc(comp, mb, any ? 1 : 0);
        if (any) cabac_residual_enc(enc, 3, d, 4);
      }
    } else {
      wb.set_cdc(0, mb, 0);
      wb.set_cdc(1, mb, 0);
    }
    for (int comp = 0; comp < 2; ++comp)
      for (int b = 0; b < 4; ++b) {
        int gx = cx2 + (b & 1), gy = cy2 + (b >> 1);
        if (ccbp == 2) {
          const int16_t *lv = ca + (comp * 4 + b) * 16;
          bool any = false;
          for (int i = 0; i < 15; ++i) any |= lv[i] != 0;
          enc.decision(85 + 16 + wb.chroma_cbf_inc(comp, gx, gy, intra),
                       any ? 1 : 0);
          wb.set_ccbf(comp, gx, gy, any ? 1 : 0);
          if (any) cabac_residual_enc(enc, 4, lv, 15);
        } else {
          wb.set_ccbf(comp, gx, gy, 0);
        }
      }
  };
  auto emit_cbp = [&](int mb, int out_cbp, int ccbp) {
    int built = 0;
    for (int b8 = 0; b8 < 4; ++b8) {
      int bit = (out_cbp >> b8) & 1;
      enc.decision(73 + wb.cbp_luma_inc(mb, b8, built), bit);
      built |= bit << b8;
    }
    enc.decision(77 + wb.cbp_chroma_inc(mb, 0), ccbp ? 1 : 0);
    if (ccbp) enc.decision(81 + wb.cbp_chroma_inc(mb, 1), ccbp == 2 ? 1 : 0);
    wb.cbpl[mb] = out_cbp;
    wb.cbpc[mb] = ccbp;
  };
  // 4x4 luma blocks of an I_4x4 or inter MB (ctxBlockCat 2)
  auto emit_blocks = [&](int mb, int out_cbp, int intra) {
    int mbx4 = (mb % width_mbs) * 4, mby4 = (mb / width_mbs) * 4;
    for (int b = 0; b < 16; ++b) {
      int x4, y4;
      blk_xy(b, &x4, &y4);
      int gx = mbx4 + x4, gy = mby4 + y4;
      const int16_t *lv = rows16 + (1 + b) * 16;
      if ((out_cbp >> (b >> 2)) & 1) {
        bool any = false;
        for (int i = 0; i < 16; ++i) any |= lv[i] != 0;
        enc.decision(85 + 8 + wb.luma_cbf_inc(gx, gy, intra), any ? 1 : 0);
        wb.set_lcbf(gx, gy, any ? 1 : 0);
        if (any) cabac_residual_enc(enc, 2, lv, 16);
      } else {
        wb.set_lcbf(gx, gy, 0);
      }
    }
  };
  auto luma_cbp = [&]() {
    int cbp = 0;
    for (int b = 0; b < 16; ++b)
      for (int i = 0; i < 16; ++i)
        if (rows16[(1 + b) * 16 + i]) {
          cbp |= 1 << (b >> 2);
          break;
        }
    return cbp;
  };

  int32_t prev_qp = qp_out_base;
  size_t n = w->mbs.size();
  for (size_t i = 0; i < n; ++i) {
    const WalkMb &rec = w->mbs[i];
    int done = i + 1 == n ? 1 : 0;
    int mb = rec.mb;
    int mbx4 = (mb % width_mbs) * 4, mby4 = (mb / width_mbs) * 4;
    int bx2 = (mb % width_mbs) * 2, by2 = (mb / width_mbs) * 2;
    if (h.is_p) {
      enc.decision(11 + wb.skip_inc(mb), rec.kind == kMbSkip ? 1 : 0);
      if (rec.kind == kMbSkip) {
        wb.mark_skip(mb);
        enc.terminate(done);
        continue;
      }
    }
    int ccbp = rung.chroma(rec, cd, 16, ca);

    if (rec.kind == kMbInter) {
      // ---------------- P inter MB
      int inter_type = rec.type;
      rung.luma(rec, nullptr, rows16 + 16, 16);
      int out_cbp = luma_cbp();
      int nparts;
      const P8 *parts = cabac_parts(inter_type, &nparts);
      wb.seen[mb] = 1;
      wb.i4x4[mb] = 0;
      wb.cmode[mb] = 0;
      enc.decision(14, 0);
      if (inter_type == 0 || inter_type == 3) {
        enc.decision(15, 0);
        enc.decision(16, inter_type == 3 ? 1 : 0);
      } else {
        enc.decision(15, 1);
        enc.decision(17, inter_type == 1 ? 1 : 0);
      }
      if (inter_type == 3)
        for (int s = 0; s < 4; ++s) {
          enc.decision(21, rec.sub_t[s] == 0 ? 1 : 0);
          if (rec.sub_t[s] != 0) {
            enc.decision(22, rec.sub_t[s] == 1 ? 0 : 1);
            if (rec.sub_t[s] != 1)
              enc.decision(23, rec.sub_t[s] == 2 ? 1 : 0);
          }
        }
      for (int p = 0; p < nparts; ++p) {
        if (h.n_ref > 1) {
          int ctx = 54 + wb.ref_inc(bx2 + parts[p].x, by2 + parts[p].y);
          for (int r = 0; r < rec.refs[p]; ++r) {
            enc.decision(ctx, 1);
            ctx = r == 0 ? 58 : 59;
          }
          enc.decision(ctx, 0);
        }
        wb.set_refgt0(bx2 + parts[p].x, by2 + parts[p].y, parts[p].pw,
                      parts[p].ph, rec.refs[p] > 0 ? 1 : 0);
      }
      {
        const int32_t *mvd =
            w->mvd.data() + 2 * static_cast<size_t>(rec.mvd0);
        int m = 0;
        auto enc_mvd_rect = [&](int x4, int y4, int w4, int h4) {
          int32_t mx = mvd[2 * m], my = mvd[2 * m + 1];
          cabac_emit_mvd(enc, 40, wb.mvd_inc(0, x4, y4), mx);
          cabac_emit_mvd(enc, 47, wb.mvd_inc(1, x4, y4), my);
          wb.set_absmvd(0, x4, y4, w4, h4, mx < 0 ? -mx : mx);
          wb.set_absmvd(1, x4, y4, w4, h4, my < 0 ? -my : my);
          ++m;
        };
        if (inter_type == 3) {
          for (int s = 0; s < 4; ++s) {
            int ox = mbx4 + (s & 1) * 2, oy = mby4 + (s >> 1) * 2;
            for (int q = 0; q < kWSubN[rec.sub_t[s]]; ++q) {
              const S4 &r4 = kWSub4[rec.sub_t[s]][q];
              enc_mvd_rect(ox + r4.x, oy + r4.y, r4.sw, r4.sh);
            }
          }
        } else {
          for (int p = 0; p < nparts; ++p)
            enc_mvd_rect(mbx4 + parts[p].x * 2, mby4 + parts[p].y * 2,
                         parts[p].pw * 2, parts[p].ph * 2);
        }
      }
      emit_cbp(mb, out_cbp, ccbp);
      if (out_cbp || ccbp) {
        int32_t qp_out_mb = rec.qp + delta_qp;
        if (!cabac_emit_dqp(enc, wb, qp_out_mb - prev_qp))
          return kErrUnsupported;
        prev_qp = qp_out_mb;
      } else {
        wb.last_dqp_nz = false;
      }
      wb.dccbf[mb] = 0;
      emit_blocks(mb, out_cbp, 0);
      chroma_emit(mb, ccbp, 0);
    } else if (rec.kind == kMbI4) {
      // ---------------- I_4x4
      rung.luma(rec, nullptr, rows16 + 16, 16);
      int out_cbp = luma_cbp();
      wb.seen[mb] = 1;
      wb.i4x4[mb] = 1;
      if (h.is_p) {
        enc.decision(14, 1);
        enc.decision(17, 0);
      } else {
        enc.decision(3 + wb.mb_type_inc(mb), 0);
      }
      for (int b = 0; b < 16; ++b) {
        enc.decision(68, rec.modes[b][0]);
        if (!rec.modes[b][0]) {
          enc.decision(69, rec.modes[b][1] & 1);
          enc.decision(69, (rec.modes[b][1] >> 1) & 1);
          enc.decision(69, (rec.modes[b][1] >> 2) & 1);
        }
      }
      cabac_emit_cmode(enc, wb, mb, static_cast<int>(rec.cmode));
      emit_cbp(mb, out_cbp, ccbp);
      if (out_cbp || ccbp) {
        int32_t qp_out_mb = rec.qp + delta_qp;
        if (!cabac_emit_dqp(enc, wb, qp_out_mb - prev_qp))
          return kErrUnsupported;
        prev_qp = qp_out_mb;
      } else {
        wb.last_dqp_nz = false;
      }
      wb.dccbf[mb] = 0;
      emit_blocks(mb, out_cbp, 1);
      chroma_emit(mb, ccbp, 1);
    } else {
      // ---------------- I_16x16 (in I slices ctx 6-10; in P 18-20)
      rung.luma(rec, rows16, rows16 + 16, 16);
      int c_luma15 = h.is_p ? 18 : 6;
      int c_cb0 = h.is_p ? 19 : 7;
      int c_cb1 = h.is_p ? 19 : 8;
      int c_ph = h.is_p ? 20 : 9;
      int c_pl = h.is_p ? 20 : 10;
      int pred = rec.type;
      bool any_ac = false;
      for (int b = 0; b < 16; ++b)
        for (int j = 0; j < 15; ++j) any_ac |= rows16[(1 + b) * 16 + j] != 0;
      int out15 = (rec.cbp & 15) && any_ac ? 1 : 0;
      wb.seen[mb] = 1;
      wb.i4x4[mb] = 0;
      if (h.is_p) {
        enc.decision(14, 1);
        enc.decision(17, 1);
      } else {
        enc.decision(3 + wb.mb_type_inc(mb), 1);
      }
      enc.terminate(0);
      enc.decision(c_luma15, out15);
      enc.decision(c_cb0, ccbp ? 1 : 0);
      if (ccbp) enc.decision(c_cb1, ccbp == 2 ? 1 : 0);
      enc.decision(c_ph, (pred >> 1) & 1);
      enc.decision(c_pl, pred & 1);
      wb.cbpl[mb] = out15 ? 15 : 0;
      wb.cbpc[mb] = ccbp;
      cabac_emit_cmode(enc, wb, mb, static_cast<int>(rec.cmode));
      {
        int32_t qp_out_mb = rec.qp + delta_qp;
        if (!cabac_emit_dqp(enc, wb, qp_out_mb - prev_qp))
          return kErrUnsupported;
        prev_qp = qp_out_mb;
      }
      bool any_dc = false;
      for (int j = 0; j < 16; ++j) any_dc |= rows16[j] != 0;
      enc.decision(85 + 0 + wb.dc_cbf_inc(mb), any_dc ? 1 : 0);
      wb.dccbf[mb] = any_dc ? 1 : 0;
      if (any_dc) cabac_residual_enc(enc, 0, rows16, 16);
      for (int b = 0; b < 16; ++b) {
        int x4, y4;
        blk_xy(b, &x4, &y4);
        int gx = mbx4 + x4, gy = mby4 + y4;
        const int16_t *lv = rows16 + (1 + b) * 16;
        if (out15) {
          bool any = false;
          for (int j = 0; j < 15; ++j) any |= lv[j] != 0;
          enc.decision(85 + 4 + wb.luma_cbf_inc(gx, gy), any ? 1 : 0);
          wb.set_lcbf(gx, gy, any ? 1 : 0);
          if (any) cabac_residual_enc(enc, 1, lv, 15);
        } else {
          wb.set_lcbf(gx, gy, 0);
        }
      }
      chroma_emit(mb, ccbp, 1);
    }
    enc.terminate(done);
  }
  enc.finish_bytes();
  for (uint8_t byte : enc.bytes) bw.bits(byte, 8);
  return finish_nal(bw.out, w->nal_byte, out, out_cap);
}
