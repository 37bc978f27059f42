// What the two wgmma int GEMMs (K2 w8a8_gemm.cu, K9 w4a4_gemm.cu) share: the
// persistent grid and the store path of an output tile.
//
// Both kernels run one persistent block per SM: a producer warpgroup that
// keeps a ring of K-step stages filled through TMA, and two consumer
// warpgroups of 64 output rows each that run wgmma m64nNk32.s8 with the int32
// tile in registers. Output tiles are walked with the N tiles of one M stripe
// next to each other, so the blocks that run together share A stripes and the
// whole weight stays in L2.
//
// The store path: in a wgmma accumulator a warp holds 16 full rows of the
// tile, each thread two neighbouring columns out of every eight. Each warp
// stages its rows through 4 KB of shared memory of its own (rows of up to 256
// bytes, 16-byte pieces XOR-swizzled by the row so that neither side has bank
// conflicts beyond the minimum), then writes them out 16 bytes a thread, whole
// row segments at a time. Only __syncwarp is needed, so the two warpgroups
// never meet and one's epilogue runs under the other's products.
#pragma once

#include "sm90.cuh"

namespace wanq {
namespace gemm {

constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kWarpStage = 4096;                        // staging bytes of one consumer warp
constexpr int kStagingBytes = 8 * kWarpStage;

// The first 1024-byte aligned address of the dynamic shared memory.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// Geometry of the staging of a BN-wide tile of ES-byte elements: rows of RB
// bytes hold CC columns, and the tile goes out in BN / CC chunks.
template <int BN, int ES>
struct Staging {
  static constexpr int RB = BN * ES < 256 ? BN * ES : 256;
  static constexpr int CC = RB / ES;
  static constexpr int kChunks = BN / CC;
};

// Byte offset of byte `off` of row `row` in a warp's staging buffer.
template <int RB>
__device__ __forceinline__ uint32_t stage_off(int row, int off) {
  return row * RB + ((((off >> 4) ^ (row & 7)) << 4) | (off & 15));
}

// Writes the warp's 16 staged rows of RB bytes to `out` (row 0, first byte of
// the chunk), rows `pitch` bytes apart, the first `rows_valid` of them.
template <int RB>
__device__ __forceinline__ void stage_flush(const uint8_t* stg, uint8_t* out, long long pitch,
                                            int rows_valid, int lane) {
  constexpr int P = RB / 16;
#pragma unroll
  for (int it = 0; it < 16 * P / 32; ++it) {
    const int idx = it * 32 + lane, row = idx / P, piece = idx % P;
    const uint4 v = *reinterpret_cast<const uint4*>(stg + row * RB + ((piece ^ (row & 7)) << 4));
    if (row < rows_valid) __stcs(reinterpret_cast<uint4*>(out + row * pitch + piece * 16), v);
  }
}

// One persistent block per SM, at most one per tile.
inline int persistent_grid(long long n_tiles) {
  static int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return (int)(n_tiles < sms ? n_tiles : sms);
}

}  // namespace gemm
}  // namespace wanq
