// Hand-written Hopper kernels of the live relay path (sm_90a).
//
// Built by ops/kernel_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into build/easydarwin_tpu_torch/ and bound with ctypes: plain C entry
// points taking pointers, sizes, strides and the caller's stream.  Each
// entry point launches on that stream, never synchronises, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.
//
// What these replace
//   * ed_parse_packets (K1) replaces the Pallas kernel
//     easydarwin_tpu/ops/parse_pallas.py:_kernel / parse_packets_pallas:
//     [P, W>=96] uint8 prefixes + [P] int32 lengths -> words [P,4] uint32
//     (seq, timestamp, ssrc, payload_start) and flags [P,5] int32
//     (nal_type, keyframe_first, frame_first, frame_last, marker).
//   * ed_relay_window replaces the XLA pass
//     easydarwin_tpu/ops/fanout.py:relay_affine_step_window (the megabatch
//     window step) with K1's parse fused in: [B, P, 100] uint8 rows
//     (96-byte prefix + le32 length) and [B, S, 6] uint32 subscriber state
//     -> [B, 4*S+1] uint32 (seq_off | ts_off | ssrc | chan | newest_kf).
//
// Why the TPU's trick is dropped
//   The TPU kernel avoids per-row dynamic gathers by building each byte at
//   12 + 4*CC + delta from 16 masked static column slices
//   (parse_pallas.py:30-38), because Mosaic lowers that to vector selects.
//   On Hopper one thread owns one packet and simply indexes its own row at
//   12 + 4*CC + delta; the loads hit L1/L2 lines the thread's neighbours
//   are reading anyway.
//
// What bounds it
//   At the megabatch's config-4 size (16 streams x 256 packets x 256
//   subscribers) the window pass reads 16*256*100 B = 410 KB of rows plus
//   16*256*24 B = 98 KB of state and writes 16*1025*4 B = 66 KB: about
//   0.17 us at 3.35 TB/s.  The arithmetic is a few dozen integer ops per
//   packet.  So the pass is bound by launch latency, not by bytes or
//   operations; the design keeps it to ONE launch per shape bucket per
//   wake (parse + keyframe reduction + affine emit in one block per
//   stream) instead of the several launches separate torch ops would take.
//
// Scope
//   Simple and right first: rows are read byte by byte (a 100-byte row is
//   not 4-byte aligned), one block of 256 threads per stream row.
//   Coalesced 16-byte row loads, TMA and a CUDA graph around the wake are
//   for later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kParsePrefix = 96;       // PARSE_PREFIX: where the le32 length sits
constexpr int kMinClassifyLen = 20;    // the reflector's classify floor
constexpr int kThreads = 256;
constexpr int kStateCols = 6;          // ssrc, base_seq, base_ts, seq0, ts0, chan

struct Parsed {
  uint32_t seq, ts, ssrc, hs;
  int32_t nal, kf, ff, fl, marker;
};

// K1's fields for one packet.  ``row`` holds at least kParsePrefix bytes;
// the deepest peek is 12 + 4*15 + 9 = 81 < 96, so no read leaves the row
// whatever the packet's length (the length only gates what a peek means).
__device__ __forceinline__ Parsed parse_row(const uint8_t* __restrict__ row,
                                            int32_t length) {
  Parsed o;
  const int b0 = row[0];
  const int b1 = row[1];
  const int hs = 12 + 4 * (b0 & 0x0F);
  o.seq = (uint32_t(row[2]) << 8) | uint32_t(row[3]);
  o.ts = (uint32_t(row[4]) << 24) | (uint32_t(row[5]) << 16) |
         (uint32_t(row[6]) << 8) | uint32_t(row[7]);
  o.ssrc = (uint32_t(row[8]) << 24) | (uint32_t(row[9]) << 16) |
           (uint32_t(row[10]) << 8) | uint32_t(row[11]);
  o.hs = uint32_t(hs);
  const bool marker = (b1 & 0x80) != 0;
  const bool classifiable = length >= kMinClassifyLen && length > hs;
  const int nal0 = row[hs] & 0x1F;
  int eff = nal0;
  // STAP-A/B, MTAP16/24: the first aggregated NAL's header byte
  const int off = nal0 == 24 ? 3 : nal0 == 25 ? 5 : nal0 == 26 ? 8
                : nal0 == 27 ? 9 : 0;
  if (off != 0 && length > hs + off) eff = row[hs + off] & 0x1F;
  // FU-A/B: the fragmented NAL's type, only on the start fragment
  const int fu_hdr = row[hs + 1];
  const bool fu_start = (nal0 == 28 || nal0 == 29) && length > hs + 1 &&
                        (fu_hdr & 0x80) != 0;
  if (fu_start) eff = fu_hdr & 0x1F;
  if (!classifiable) eff = -1;
  o.nal = eff;
  o.kf = classifiable && (eff == 5 || eff == 7 || eff == 8);
  o.ff = classifiable && ((nal0 >= 1 && nal0 <= 27) || fu_start);
  o.fl = length >= kMinClassifyLen && marker;
  o.marker = marker;
  return o;
}

__global__ void __launch_bounds__(kThreads)
parse_packets_kernel(const uint8_t* __restrict__ prefix, int n_rows,
                     int row_stride, const int32_t* __restrict__ length,
                     uint32_t* __restrict__ words,
                     int32_t* __restrict__ flags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const Parsed p = parse_row(prefix + size_t(i) * row_stride, length[i]);
  uint32_t* w = words + size_t(i) * 4;
  w[0] = p.seq;
  w[1] = p.ts;
  w[2] = p.ssrc;
  w[3] = p.hs;
  int32_t* f = flags + size_t(i) * 5;
  f[0] = p.nal;
  f[1] = p.kf;
  f[2] = p.ff;
  f[3] = p.fl;
  f[4] = p.marker;
}

// One block per stream row b.  Phase 1: every thread parses a strided
// subset of the P rows and keeps the newest keyframe-first row index;
// a warp-shuffle + shared-memory max gives the block's newest (or -1).
// Phase 2: the threads emit the per-subscriber affine columns.
__global__ void __launch_bounds__(kThreads)
relay_window_kernel(const uint8_t* __restrict__ window, int n_pkts,
                    int row_stride, const uint32_t* __restrict__ state,
                    int n_subs, uint32_t* __restrict__ out) {
  const int b = blockIdx.x;
  const uint8_t* rows = window + size_t(b) * n_pkts * row_stride;
  int best = -1;
  for (int p = threadIdx.x; p < n_pkts; p += blockDim.x) {
    const uint8_t* row = rows + size_t(p) * row_stride;
    const uint8_t* lb = row + kParsePrefix;    // unaligned: byte by byte
    const int32_t len = int32_t(uint32_t(lb[0]) | (uint32_t(lb[1]) << 8) |
                                (uint32_t(lb[2]) << 16) |
                                (uint32_t(lb[3]) << 24));
    const Parsed q = parse_row(row, len);
    // padding rows carry length 0: never valid, never a keyframe
    if (q.kf && len > 0) best = p;             // p grows: last hit is max
  }
  for (int o = 16; o > 0; o >>= 1)
    best = max(best, __shfl_down_sync(0xffffffffu, best, o));
  __shared__ int warp_best[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;

  const uint32_t* st = state + size_t(b) * n_subs * kStateCols;
  uint32_t* o = out + size_t(b) * (4 * size_t(n_subs) + 1);
  for (int s = threadIdx.x; s < n_subs; s += blockDim.x) {
    const uint32_t* r = st + size_t(s) * kStateCols;
    o[s] = (r[3] - r[1]) & 0xFFFFu;            // seq_off (mod 2^16)
    o[n_subs + s] = r[4] - r[2];               // ts_off (mod 2^32)
    o[2 * n_subs + s] = r[0];                  // ssrc
    o[3 * n_subs + s] = r[5];                  // interleave channel
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = -1;
    for (int w = 0; w < kThreads / 32; ++w) m = max(m, warp_best[w]);
    o[4 * size_t(n_subs)] = uint32_t(m);       // -1 rides as 0xFFFFFFFF
  }
}

}  // namespace

extern "C" {

int ed_parse_packets(const void* prefix, int n_rows, int row_stride,
                     const void* length, void* words, void* flags,
                     void* stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + kThreads - 1) / kThreads;
    parse_packets_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(prefix), n_rows, row_stride,
        static_cast<const int32_t*>(length), static_cast<uint32_t*>(words),
        static_cast<int32_t*>(flags));
  }
  return int(cudaGetLastError());
}

int ed_relay_window(const void* window, int n_streams, int n_pkts,
                    int row_stride, const void* state, int n_subs, void* out,
                    void* stream) {
  if (n_streams > 0) {
    relay_window_kernel<<<n_streams, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(window), n_pkts, row_stride,
        static_cast<const uint32_t*>(state), n_subs,
        static_cast<uint32_t*>(out));
  }
  return int(cudaGetLastError());
}

const char* ed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
