// What the wgmma int GEMMs (K2 w8a8_gemm.cu, K8 w4a8_gemm.cu, K9 w4a4_gemm.cu)
// share: the persistent grid, the store path of an output tile, the unpack of
// a packed int4 weight tile into a wgmma operand (K8, K9), and the dequant
// epilogue of K2 and K8 in its three modes.
//
// All three kernels run one persistent block per SM: a producer warpgroup that
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

// One 32-deep K step of a consumer warpgroup's product: acc (+)= A[64 x 32] .
// W[BN x 32]^T, int8 -> int32, BN = 128 or 256 (K2, K8).
template <int BN>
__device__ __forceinline__ void mma(int (&acc)[BN / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (BN == 256) {
    sm90::wgmma_s8_ss_n256(acc, da, db, accumulate);
  } else {
    sm90::wgmma_s8_ss(acc, da, db, accumulate);
  }
}

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

// ---------------------------------------------------------------------------
// Packed int4 weights (K8, K9). wgmma reads its B operand from shared memory
// only, so a packed tile [rows, 64 B] (K-major: byte j of a row holds k = 2j in
// its low nibble and k = 2j + 1 in its high one), loaded by TMA without a
// swizzle, is turned into the int8 tile [rows, 128 B] in the 128-byte-swizzled
// layout by warps of the producer warpgroup.
// ---------------------------------------------------------------------------

// Four packed bytes (eight codes, k ascending from the low nibble of the
// lowest byte) -> two words of int8 holding 16 * code, k = 0..3 and k = 4..7:
// a nibble at the top of its byte is the code times 16 in two's complement,
// which saves the sign extension. The kernels take the factor out again
// exactly (K9 in s_a, K8 by an arithmetic shift of the int32 sum).
__device__ __forceinline__ uint2 unpack8_x16(uint32_t w) {
  const uint32_t even = (w << 4) & 0xF0F0F0F0u;  // k = 0, 2, 4, 6
  const uint32_t odd = w & 0xF0F0F0F0u;          // k = 1, 3, 5, 7
  return make_uint2(__byte_perm(even, odd, 0x5140), __byte_perm(even, odd, 0x7362));
}

// Piece i of a packed tile (the 16 bytes c = i % 4 of row i / 4, k = 32 c ..
// 32 c + 31) -> the two 16-byte chunks 2 c and 2 c + 1 of the int8 row, at
// their swizzled places.
__device__ __forceinline__ void unpack_piece(uint8_t* dst, int i, uint4 v) {
  const int row = i >> 2, c = i & 3;
  const uint2 x = unpack8_x16(v.x), y = unpack8_x16(v.y);
  const uint2 z = unpack8_x16(v.z), w = unpack8_x16(v.w);
  uint8_t* drow = dst + row * 128;
  *reinterpret_cast<uint4*>(drow + (((2 * c) ^ (row & 7)) << 4)) = make_uint4(x.x, x.y, y.x, y.y);
  *reinterpret_cast<uint4*>(drow + (((2 * c + 1) ^ (row & 7)) << 4)) =
      make_uint4(z.x, z.y, w.x, w.y);
}

// ---------------------------------------------------------------------------
// The dequant epilogue of K2 and K8, for an exact int32 tile acc:
//   h = f32(acc) * (s_a[m] * s_w[n]) + sum_a[m] * (zp_w[n] * s_w[n]) + bias[n]
// written as f32 or bf16, or, in the GELU + quant mode, carried on from h
// rounded to bf16:
//   q = clip(rint(gelu_tanh(f32(bf16(h))) / scale2), -128, 127)    int8 [M, N]
//   rowsum[m] += sum_n q[m, n]                                     int32 [M]
// Every f32 step is an _rn intrinsic in the plain version's order (no FMA
// contraction), the division is a true one and the GELU is PyTorch's
// expression, so all three modes agree with their plain versions bit for bit;
// the row sum is an integer sum, exact in any order.
// ---------------------------------------------------------------------------

enum Mode { kF32 = 0, kBf16 = 1, kGeluQuant = 2 };

struct Epilogue {
  const float* s_a;
  const float* s_w;
  const float* sum_a;   // read only when zp_w is given
  const float* zp_w;    // may be null
  const float* bias;    // may be null
  const float* scale2;  // GELU + quant mode: the static scale, one f32
  void* out;
  int* rowsum;          // GELU + quant mode: int32 [M], zeroed by the caller
  int M, N;
};

inline Epilogue make_epilogue(const void* s_a, const void* s_w, const void* sum_a,
                              const void* zp_w, const void* bias, void* out, int M, int N) {
  Epilogue e;
  e.s_a = static_cast<const float*>(s_a);
  e.s_w = static_cast<const float*>(s_w);
  e.sum_a = static_cast<const float*>(sum_a);
  e.zp_w = static_cast<const float*>(zp_w);
  e.bias = static_cast<const float*>(bias);
  e.scale2 = nullptr;
  e.out = out;
  e.rowsum = nullptr;
  e.M = M; e.N = N;
  return e;
}

// The epilogue of one warp: rows row0 .. row0 + 15 of the tile at column n0.
// kFast, of the GELU + quant mode only, is the straight-line form for the case
// the paths have (zp_w and bias given, the scale in FastDiv's range): without
// branches the compiler interleaves the chains of many elements, which two
// warps a scheduler need to keep their ALUs busy. !kFast takes every case.
template <int BN, int MODE, bool kFast>
__device__ __forceinline__ void epilogue(const Epilogue& p, const int (&acc)[BN / 2], uint8_t* stg,
                                         int row0, int n0, int lane) {
  static_assert(!kFast || MODE == kGeluQuant, "the straight-line form is the GELU + quant mode's");
  constexpr int ES = MODE == kF32 ? 4 : (MODE == kBf16 ? 2 : 1);
  using S = Staging<BN, ES>;
  const int g = lane >> 2, tig = lane & 3;
  const bool has_zp = kFast || p.zp_w != nullptr, has_bias = kFast || p.bias != nullptr;
  float sa[2], su[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = min(row0 + g + 8 * h, p.M - 1);
    sa[h] = p.s_a[r];
    if (has_zp) su[h] = p.sum_a[r];
  }
  float scale2 = 1.f;
  if constexpr (MODE == kGeluQuant) scale2 = *p.scale2;
  const FastDiv fast_div(scale2);
  int rsum[2] = {0, 0};
  uint8_t* out = static_cast<uint8_t*>(p.out) + ((long long)row0 * p.N + n0) * ES;

#pragma unroll
  for (int c = 0; c < S::kChunks; ++c) {
#pragma unroll
    for (int jj = 0; jj < S::CC / 8; ++jj) {
      const int j = c * (S::CC / 8) + jj;
      const int n = n0 + 8 * j + 2 * tig;
      const float2 sw = __ldg(reinterpret_cast<const float2*>(p.s_w + n));
      float2 zsw = make_float2(0.f, 0.f), bi = make_float2(0.f, 0.f);
      if (has_zp) {
        const float2 zp = __ldg(reinterpret_cast<const float2*>(p.zp_w + n));
        zsw = make_float2(__fmul_rn(zp.x, sw.x), __fmul_rn(zp.y, sw.y));
      }
      if (has_bias) bi = __ldg(reinterpret_cast<const float2*>(p.bias + n));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = __fmul_rn((float)acc[4 * j + 2 * h], __fmul_rn(sa[h], sw.x));
        float v1 = __fmul_rn((float)acc[4 * j + 2 * h + 1], __fmul_rn(sa[h], sw.y));
        if (has_zp) {
          v0 = __fadd_rn(v0, __fmul_rn(su[h], zsw.x));
          v1 = __fadd_rn(v1, __fmul_rn(su[h], zsw.y));
        }
        if (has_bias) {
          v0 = __fadd_rn(v0, bi.x);
          v1 = __fadd_rn(v1, bi.y);
        }
        uint8_t* dst = stg + stage_off<S::RB>(g + 8 * h, (8 * jj + 2 * tig) * ES);
        if constexpr (MODE == kF32) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else if constexpr (MODE == kBf16) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          const float2 hb = __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
          const float g0 = wanq::gelu_tanh(hb.x), g1 = wanq::gelu_tanh(hb.y);
          const int q0 = to_code(kFast ? fast_div(g0) : __fdiv_rn(g0, scale2));
          const int q1 = to_code(kFast ? fast_div(g1) : __fdiv_rn(g1, scale2));
          rsum[h] += q0 + q1;
          *reinterpret_cast<uint16_t*>(dst) = (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
        }
      }
    }
    __syncwarp();
    stage_flush<S::RB>(stg, out + c * S::RB, (long long)p.N * ES, p.M - row0, lane);
    __syncwarp();
  }
  if constexpr (MODE == kGeluQuant) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int s = rsum[h];
      s += __shfl_xor_sync(wanq::kFull, s, 1);
      s += __shfl_xor_sync(wanq::kFull, s, 2);
      const int r = row0 + g + 8 * h;
      if (tig == 0 && r < p.M) atomicAdd(p.rowsum + r, s);
    }
  }
}

// Whether this launch may take the straight-line epilogue (uniform over the grid).
template <int MODE>
__device__ __forceinline__ bool fast_epilogue(const Epilogue& p) {
  if constexpr (MODE == kGeluQuant) {
    return p.zp_w != nullptr && p.bias != nullptr && div_is_safe(*p.scale2);
  } else {
    return false;
  }
}

template <int BN, int MODE>
__device__ __forceinline__ void run_epilogue(const Epilogue& p, bool fast, const int (&acc)[BN / 2],
                                             uint8_t* stg, int row0, int n0, int lane) {
  if constexpr (MODE == kGeluQuant) {
    if (fast) {
      epilogue<BN, MODE, true>(p, acc, stg, row0, n0, lane);
      return;
    }
  }
  epilogue<BN, MODE, false>(p, acc, stg, row0, n0, lane);
}

// One persistent block per SM, at most one per tile.
inline int persistent_grid(long long n_tiles) {
  const int sms = sm_count();
  return (int)(n_tiles < sms ? n_tiles : sms);
}

}  // namespace gemm
}  // namespace wanq
