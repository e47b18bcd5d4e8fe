// Hand-written Hopper kernel of the transcode path (sm_90a): K2.
//
// Built by ops/kernel_lib.py beside relay_kernels.cu into the same shared
// library, with a plain C entry point bound with ctypes: pointers, sizes
// and the caller's stream.  It launches on that stream, never
// synchronises, allocates nothing, and returns cudaGetLastError().
//
// What this replaces
//   ed_decode_blocks (K2) replaces the Pallas kernel
//   easydarwin_tpu/ops/transform.py:172 decode_blocks_pallas
//   (_decode_kernel): for each block r and output pixel c
//     out[r,c] = clamp(rint(sum_k (float(levels[r,k]) * qt[k]) * inv[c,k]
//                           + 128), 0, 255)
//   with inv the 64x64 Kronecker IDCT operator (transform._kron_mats), in
//   fp32, rounding half to even as jnp.round does.  The 128 is added
//   after the sum, and the clamp is taken in float before the conversion
//   to u8, as the reference does.  No fast-math: rintf, fmaf, fminf/fmaxf.
//
// What bounds it
//   At the config-5 batch (16 sources x one 1080p 4:2:0 frame = 783,360
//   blocks) it reads 783,360 x 256 B = 200.5 MB of levels and writes
//   783,360 x 64 B = 50.1 MB: 250.7 MB / 3.35 TB/s = 0.075 ms.  It does
//   2 x 64 x 64 x 783,360 = 6.42 GFLOP in fp32, which has no tensor-core
//   path at full precision (TF32 would move pixels by more than 1):
//   6.42 GFLOP / 67 TFLOP/s = 0.096 ms.  So it is bound by fp32
//   operations, not by bytes.
//
// What the design does about that
//   The TPU kernel feeds the MXU one [256, 64] tile per grid step.  Here
//   the point is to keep the FMA pipes busy rather than the load/store
//   pipe: each block keeps inv (transposed, 16 KB) and qt in shared memory
//   for its whole life and walks tiles of 64 block rows (grid-stride, one
//   resident block set per SM, so inv is staged once per block, not per
//   tile).  A tile is staged dequantized and transposed (xT[k][r]) with
//   coalesced 16-byte loads.  Each of the 128 threads then owns an 8 x 4
//   patch of outputs (8 rows, 4 adjacent pixels): per k it does two
//   16-byte shared loads of x (4 rows each, broadcast across the warp),
//   one 16-byte load of 4 inv entries, and 32 fmaf, accumulating over
//   k = 0..63 in order.  The epilogue packs 4 pixels into one 32-bit
//   store, so a row's 64 bytes leave as 16 adjacent words.
//
// Scope
//   Simple and right first: no tensor cores (fp32 is the contract), no
//   TMA, no software pipelining between tile staging and compute.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;          // block rows per tile
constexpr int kThreads = 128;
constexpr int kPitch = 68;             // xT row pitch (floats): 16 B aligned
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
decode_blocks_kernel(const int32_t* __restrict__ levels, int n_blocks,
                     const float* __restrict__ qtable,
                     const float* __restrict__ inv,
                     uint8_t* __restrict__ out) {
  __shared__ __align__(16) float s_invT[64 * 64];        // s_invT[k][c]
  __shared__ __align__(16) float s_xT[64 * kPitch];      // s_xT[k][r]
  __shared__ float s_qt[64];

  const int t = threadIdx.x;
  // inv[c][k] -> s_invT[k][c]; the 16 KB operator is read once per block
  for (int e = t; e < 64 * 64; e += kThreads) {
    const int k = e >> 6, c = e & 63;
    s_invT[e] = inv[c * 64 + k];
  }
  if (t < 64) s_qt[t] = qtable[t];

  // staging map: a warp covers 8 rows x 4 int4 groups (16 k), so each
  // row's 64 contiguous bytes come in one go
  const int warp = t >> 5, lane = t & 31;
  const int r_lane = lane & 7, kq_lane = lane >> 3;
  // compute map: 4 adjacent pixels, rows rg*4..+3 and 32+rg*4..+3
  const int cg = t & 15, rg = t >> 4;
  const int ra = rg * 4, rb = 32 + rg * 4;

  const int n_tiles = (n_blocks + kTileRows - 1) / kTileRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kTileRows;
    __syncthreads();   // s_invT/s_qt ready; the previous tile's reads done
    for (int it = 0; it < 8; ++it) {
      const int combo = warp + 4 * it;            // 32 (row, k) sub-tiles
      const int r = (combo & 7) * 8 + r_lane;
      const int kq = (combo >> 3) * 4 + kq_lane;  // int4 group, k = 4*kq
      int4 v = make_int4(0, 0, 0, 0);
      if (row0 + r < n_blocks)                    // ragged edge: zeros
        v = reinterpret_cast<const int4*>(
            levels + size_t(row0 + r) * 64)[kq];
      const int k = kq * 4;
      s_xT[(k + 0) * kPitch + r] = float(v.x) * s_qt[k + 0];
      s_xT[(k + 1) * kPitch + r] = float(v.y) * s_qt[k + 1];
      s_xT[(k + 2) * kPitch + r] = float(v.z) * s_qt[k + 2];
      s_xT[(k + 3) * kPitch + r] = float(v.w) * s_qt[k + 3];
    }
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < 64; ++k) {
      const float4 xa = *reinterpret_cast<const float4*>(&s_xT[k * kPitch + ra]);
      const float4 xb = *reinterpret_cast<const float4*>(&s_xT[k * kPitch + rb]);
      const float4 w = *reinterpret_cast<const float4*>(&s_invT[k * 64 + 4 * cg]);
      const float xs[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ws[j], acc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + (i < 4 ? ra + i : rb + i - 4);
      if (row >= n_blocks) continue;
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = fminf(fmaxf(rintf(acc[i][j] + 128.f), 0.f), 255.f);
        word |= uint32_t(y) << (8 * j);                // little-endian bytes
      }
      reinterpret_cast<uint32_t*>(out + size_t(row) * 64)[cg] = word;
    }
  }
}

// Blocks to launch: enough to fill every SM at the kernel's occupancy,
// never more than there are tiles.  Cached per device.
int grid_for(int n_tiles) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return n_tiles;
  int per_device = dev < kMaxDevices ? cached[dev] : 0;
  if (per_device == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_blocks_kernel, kThreads, 0);
    per_device = sms * (per_sm > 0 ? per_sm : 1);
    if (per_device <= 0) per_device = 1;
    if (dev < kMaxDevices) cached[dev] = per_device;
  }
  return n_tiles < per_device ? n_tiles : per_device;
}

}  // namespace

extern "C" {

int ed_decode_blocks(const void* levels, int n_blocks, const void* qtable,
                     const void* inv, void* out, void* stream) {
  if (n_blocks > 0) {
    const int n_tiles = (n_blocks + kTileRows - 1) / kTileRows;
    decode_blocks_kernel<<<grid_for(n_tiles), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(levels), n_blocks,
        static_cast<const float*>(qtable), static_cast<const float*>(inv),
        static_cast<uint8_t*>(out));
  }
  return int(cudaGetLastError());
}

}  // extern "C"
