// K10a: the q/k/v int8 producer of the int8 flash attention (K10).
//
// Replaces wanq_tpu/ops/attn_int8.py:52 quantize_qkv_int8, which is plain jnp
// that XLA fuses on the TPU in front of the Pallas kernel attention_int8_pallas
// (:181). In plain PyTorch it is about ten elementwise passes with f32 copies
// over three [B, H, S, 128] tensors, and K10 wants v transposed anyway, so it
// is a kernel here.
//   q, k: one scale per (batch, head, 512-token block):
//           scale = max(absmax / 127, 1e-6), code = clip(rint(x / scale), +-127)
//         codes int8 [B, H, S_pad, 128], scales f32 [B, H, S_pad / 512]
//   v:    one scale per (batch, head, channel) over all tokens, same formula;
//         codes int8 TRANSPOSED and k-permuted [B, H, 128, S_pad] (below),
//         scales f32 [B, H, 128]
// S pads to a multiple of 512 with zero rows. The operands are bf16
// [B, S, H, 128] views read through (seq, head, batch) byte strides.
//
// The v layout: K10's second product P[q, kv] . V[kv, d] runs on the int8
// wgmma, which takes K-major operands only, so v is written [d][kv] with kv
// contiguous. Inside each group of 32 kv the bytes are permuted: K10 builds
// its A fragment from the accumulator of the first product without shuffles,
// which puts the actual kv = 8t + 2i + lo (tile t of 8 columns, thread i of
// the quad, lo in {0, 1}) at fragment position 16 (t / 2) + 4 i + 2 (t % 2)
// + lo; v is stored at that position, so K10 reads its tiles as they lie.
// Positions 0..15 of a group hold kv 0..15 and 16..31 hold kv 16..31; the
// 4-byte word w of a half holds kv (2w, 2w + 1, 8 + 2w, 9 + 2w).
// wanq_tpu_torch/ops/attn_int8.py::v_kernel_layout is the same map in
// PyTorch.
//
// Bound on the H100: memory. The function reads q, k and v once (3 x 2 bytes
// an element) and writes 1 byte an element: 906 MB at [2, 12, 32768, 128],
// 0.270 ms at 3.35 TB/s. v's scale covers every token, so its codes can be
// written only after a pass over all of v: this kernel reads v TWICE, once
// for its absmax and once to quantize it (201 MB each at that shape; 201 MB
// does not stay in the 50 MB L2), and moves 1109 MB (0.33 ms at 3.35 TB/s;
// ops/attn_int8.py::quantize_qkv_int8_traffic counts it). The design:
// - two launches, each of one persistent block of 512 threads an SM: (1)
//   every (q or k, batch, head, 512-token block) tile gets its absmax and its
//   codes, and every (batch, head, 512-token block) tile of v its per-channel
//   absmax, written to a scratch of partial maxima [B, H, S_pad / 512, 128]
//   (no atomics, so no memset); (2) every 256-token tile of v folds those
//   partials into its 128 scales and writes its codes transposed;
// - a tile lands in shared memory as 64-row sub-tiles, each one TMA box of a
//   4-D tensor map over (d, seq, head, batch) counted on an mbarrier: the map
//   takes the strided views of the main path (q and k heads-major, v over the
//   GEMM output [B, S, H * 128]) and any other multiple-of-16-byte strides,
//   and rows past S arrive as zeros, which are the pad rows. A block streams
//   its tiles' sub-tiles through a ring of 13 stages (208 KB), which thread 0
//   refills with the stages the block is done with after each block barrier
//   (so no empty barriers are needed): the next tiles' copies are in flight
//   while a tile is reduced and quantized;
// - a q/k tile is 128 KB, and its codes need its absmax: each thread keeps
//   the first half of its values in registers as they land (32 registers),
//   so those stages are refilled before the scale is known, and reads the
//   second half back from shared memory. A thread quantizes 16 neighbouring
//   values a sub-tile and stores 16 bytes (its two 16-byte loads swapped on
//   every other quad of lanes, so no two lanes of a quarter-warp share a
//   bank). Absmax folds as bf16 pairs (max is exact and order-free);
// - v's tiles in the second launch are 256 rows, so the ring holds the next
//   two tiles' copies while one is quantized; a block takes a contiguous run
//   of tiles and folds the partial maxima only where (b, h) changes. A lane
//   reads 16 rows x 4 channels with conflict-free 8-byte loads, packs each
//   channel's 16 codes in K10's position order in registers and stores them
//   as 16 bytes; lanes l and l + 16 hold the two halves of a 32-kv group, so
//   each store instruction fills 16 whole 32-byte sectors;
// - the quotient is FastDiv::quotient_rn (common.cuh), the correctly rounded
//   x / scale without a branch per element, behind its range guard (uniform
//   over a q/k tile, per lane for v); rint by adding 1.5 * 2^23 (round half to
//   even; the code is the low byte of the sum's bits, since |x / scale| <=
//   127 + 2^-16 by the choice of scale), codes packed with prmt.
// Scales are one __fdiv_rn each and the codes use the exact quotient, so
// scales and codes equal the plain version's exactly.
#include "sm90.cuh"

namespace {

using namespace wanq::sm90;

constexpr int D = 128;
constexpr int BLK = 512;                  // q/k scale block, and the rows of every tile
constexpr int kRows = 64;                 // rows of a sub-tile: one TMA box
constexpr int kSubs = BLK / kRows;        // sub-tiles of a tile
constexpr int kSubBytes = kRows * D * 2;  // 16 KB
constexpr int kChunks = kSubBytes / 16;   // 16-byte pieces of a sub-tile
constexpr int kStages = 13;
constexpr int kHeld = 4;                  // sub-tiles of a q/k tile a thread keeps in registers
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBytes = kStages * kSubBytes + 128;  // + alignment of the ring
constexpr float kEps = 1e-6f;
constexpr float kRound = 12582912.0f;  // 1.5 * 2^23: x + kRound rounds x to an integer

static_assert(kChunks == 2 * kThreads, "a thread takes two 16-byte pieces of a sub-tile");

struct Params {
  CUtensorMap mq, mk, mv;  // bf16 (d, seq, head, batch), boxes of (128, 64, 1, 1)
  int8_t* qi;
  int8_t* ki;
  int8_t* vt;
  float* s_q;
  float* s_k;
  float* s_v;
  float* v_part;  // [B * H, nblk, 128] absmax of v per 512-row block
  int B, H, S_pad, nblk;
};

__device__ __forceinline__ float quant_scale(float absmax) {
  return fmaxf(__fdiv_rn(absmax, 127.0f), kEps);
}

// The codes of four quotients (already x / scale), packed little end first.
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  const uint32_t ia = __float_as_uint(__fadd_rn(a, kRound));
  const uint32_t ib = __float_as_uint(__fadd_rn(b, kRound));
  const uint32_t ic = __float_as_uint(__fadd_rn(c, kRound));
  const uint32_t id = __float_as_uint(__fadd_rn(d, kRound));
  return __byte_perm(__byte_perm(ia, ib, 0x0040), __byte_perm(ic, id, 0x0040), 0x5410);
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 8 bf16 values -> 8 codes
template <typename Div>
__device__ __forceinline__ uint2 codes8(const uint4& r, Div div) {
  return make_uint2(pack4(div(bf_lo(r.x)), div(bf_hi(r.x)), div(bf_lo(r.y)), div(bf_hi(r.y))),
                    pack4(div(bf_lo(r.z)), div(bf_hi(r.z)), div(bf_lo(r.w)), div(bf_hi(r.w))));
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// m[i] = max(m[i], |x|) over the four bf16 pairs of a 16-byte piece
__device__ __forceinline__ void fold_absmax(__nv_bfloat162 (&m)[4], const uint4& r) {
  m[0] = __hmax2(m[0], __habs2(as_bf2(r.x)));
  m[1] = __hmax2(m[1], __habs2(as_bf2(r.y)));
  m[2] = __hmax2(m[2], __habs2(as_bf2(r.z)));
  m[3] = __hmax2(m[3], __habs2(as_bf2(r.w)));
}

// A block's sub-tiles, numbered in the order of its tiles, through a ring of
// kStages stages in shared memory: sub-tile n lands in stage n % kStages.
// Every thread waits for a sub-tile only after thread 0 issued it (issue runs
// kStages ahead of the sub-tiles the block is done with, and only after a
// block barrier), so a parity tells the uses of a stage apart.
struct Ring {
  char* buf;
  uint64_t* full;
  __device__ __forceinline__ const uint4* stage(int n) const {
    return reinterpret_cast<const uint4*>(buf + (n % kStages) * kSubBytes);
  }
  __device__ __forceinline__ void wait(int n) const {
    mbar_wait(full + n % kStages, (uint32_t)((n / kStages) & 1));
  }
  // thread 0: one sub-tile of `map` at rows row0 .. row0 + 63 of (b, h)
  __device__ __forceinline__ void issue(int n, const CUtensorMap* map, int row0, int h,
                                        int b) const {
    const int st = n % kStages;
    mbar_expect_tx(full + st, kSubBytes);
    tma_load_4d(buf + st * kSubBytes, map, full + st, 0, row0, h, b);
  }
};

__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw, uint64_t* full) {
  char* buf = reinterpret_cast<char*>(smem_raw) +
              ((128u - (wanq::smem_addr(smem_raw) & 127u)) & 127u);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  return Ring{buf, full};
}

// Launch 1. Tiles 0 .. 3 * B * H * nblk - 1: q, then k, then v, each
// (b * H + h) * nblk + blk; block g takes tiles g, g + grid, ...
__global__ void __launch_bounds__(kThreads, 1) qkv_absmax_quant_kernel(
    const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ uint64_t full[kStages];
  __shared__ float red[2][kWarps];                   // a q/k tile's warp maxima, by tile parity
  __shared__ __nv_bfloat162 vred[2][kWarps][D / 2];  // a v tile's per-warp channel maxima
  const Ring ring = make_ring(smem_raw, full);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per = p.B * p.H * p.nblk;  // tiles of one tensor
  const int grid = gridDim.x;
  const int mine = (3 * per - (int)blockIdx.x + grid - 1) / grid;
  const int total = mine * kSubs;
  int issued = 0;  // thread 0: sub-tiles issued
  auto issue_to = [&](int limit) {  // thread 0
    for (limit = min(limit, total); issued < limit; ++issued) {
      const int tile = blockIdx.x + (issued / kSubs) * grid;
      const int kind = tile / per, rem = tile % per;
      const int bh = rem / p.nblk, blk = rem % p.nblk;
      const CUtensorMap* map = kind == 0 ? &p.mq : kind == 1 ? &p.mk : &p.mv;
      ring.issue(issued, map, blk * BLK + (issued % kSubs) * kRows, bh % p.H, bh / p.H);
    }
  };
  if (tid == 0) {
    prefetch_tensormap(&p.mq);
    prefetch_tensormap(&p.mk);
    prefetch_tensormap(&p.mv);
  }
  __syncthreads();
  if (tid == 0) issue_to(kStages);

  for (int j = 0, n0 = 0; j < mine; ++j, n0 += kSubs) {
    const int tile = blockIdx.x + j * grid;
    const int kind = tile / per, rem = tile % per;
    const int par = j & 1;
    __nv_bfloat162 m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = as_bf2(0u);

    if (kind == 2) {  // v: per-channel maxima of this block of rows
      // a thread folds pieces tid and tid + 512 of every sub-tile, i.e.
      // channels 8 (tid % 16) .. + 7 of rows tid / 16 and tid / 16 + 32
#pragma unroll
      for (int s = 0; s < kSubs; ++s) {
        ring.wait(n0 + s);
        const uint4* src = ring.stage(n0 + s);
        fold_absmax(m, src[tid]);
        fold_absmax(m, src[tid + kThreads]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        m[i] = __hmax2(m[i], as_bf2(__shfl_xor_sync(wanq::kFull, as_u32(m[i]), 16)));
      if (lane < 16) {
#pragma unroll
        for (int i = 0; i < 4; ++i) vred[par][warp][lane * 4 + i] = m[i];
      }
      __syncthreads();
      if (tid == 0) issue_to(n0 + kSubs + kStages);
      if (tid < D / 2) {
        __nv_bfloat162 a = vred[par][0][tid];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) a = __hmax2(a, vred[par][w][tid]);
        reinterpret_cast<float2*>(p.v_part + (long long)rem * D)[tid] = __bfloat1622float2(a);
      }
      continue;
    }

    // q or k. Thread t takes values 16 t .. 16 t + 15 of each sub-tile (row
    // t / 8, channels 16 (t % 8) ..): pieces 2t + sw and 2t + 1 - sw, read in
    // that order so that no two lanes of a quarter-warp share a bank. The
    // first kHeld sub-tiles stay in registers, so their stages are refilled
    // before the tile's scale is known.
    const int sw = (tid >> 2) & 1;
    const int pa = 2 * tid + sw, pb = 2 * tid + 1 - sw;
    uint4 held[kHeld][2];
#pragma unroll
    for (int s = 0; s < kSubs; ++s) {
      ring.wait(n0 + s);
      const uint4* src = ring.stage(n0 + s);
      const uint4 a = src[pa], b = src[pb];
      fold_absmax(m, a);
      fold_absmax(m, b);
      if (s < kHeld) {
        held[s][0] = a;
        held[s][1] = b;
      }
      if (s == kHeld - 1) {
        __syncthreads();
        if (tid == 0) issue_to(n0 + kHeld + kStages);
      }
    }
    const __nv_bfloat162 mm = __hmax2(__hmax2(m[0], m[1]), __hmax2(m[2], m[3]));
    const float2 mf = __bfloat1622float2(mm);
    float amax = wanq::warp_max(fmaxf(mf.x, mf.y));
    if (lane == 0) red[par][warp] = amax;
    __syncthreads();
    amax = red[par][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, red[par][w]);
    const float scale = quant_scale(amax);
    if (tid == 0) (kind ? p.s_k : p.s_q)[rem] = scale;

    uint4* dst = reinterpret_cast<uint4*>((kind ? p.ki : p.qi) + (long long)rem * BLK * D) + tid;
    auto quantize = [&](auto div) {
#pragma unroll
      for (int s = 0; s < kSubs; ++s) {
        uint4 a, b;
        if (s < kHeld) {
          a = held[s][0];
          b = held[s][1];
        } else {
          const uint4* src = ring.stage(n0 + s);
          a = src[pa];
          b = src[pb];
        }
        const uint2 ca = codes8(a, div), cb = codes8(b, div);
        dst[s * kThreads] = sw ? make_uint4(cb.x, cb.y, ca.x, ca.y)
                               : make_uint4(ca.x, ca.y, cb.x, cb.y);
      }
    };
    if (wanq::div_is_safe(scale)) {  // uniform over the tile
      const wanq::FastDiv fd(scale);
      quantize([&](float x) { return fd.quotient_rn(x); });
    } else {
      quantize([&](float x) { return __fdiv_rn(x, scale); });
    }
    __syncthreads();
    if (tid == 0) issue_to(n0 + kSubs + kStages);
  }
}

// Launch 2. v's tiles of 256 rows, (b * H + h) * (S_pad / 256) + t; block g
// takes a contiguous range of them, so it folds the partial maxima into
// scales only where (b, h) changes. Warp w quantizes rows 32 (w % 8) .. + 31
// of a tile (sub-tile (w % 8) / 2) for channels 64 (w / 8) .. + 63; lane l
// channels 4 (l % 16) .. + 3 of those, rows 16 (l / 16) .. + 15 of the
// warp's, i.e. positions 16 (l / 16) .. + 15 of the warp's 32-kv group.
constexpr int kVRows = 256;
constexpr int kVSubs = kVRows / kRows;

__global__ void __launch_bounds__(kThreads, 1) v_quant_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ uint64_t full[kStages];
  __shared__ float part[2][4][D];  // a (b, h)'s scales as four partial maxima, by change parity
  const Ring ring = make_ring(smem_raw, full);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_bh = p.S_pad / kVRows;
  const long long T = (long long)p.B * p.H * per_bh;
  const int t0 = (int)(T * blockIdx.x / gridDim.x);
  const int mine = (int)(T * (blockIdx.x + 1) / gridDim.x) - t0;
  const int total = mine * kVSubs;
  // the partial maxima of (b, h) = bh: thread t folds channel t % 128 over
  // every fourth 512-row block, starting at t / 128
  auto fold_parts = [&](int bh, int buf) {
    const float* src = p.v_part + (long long)bh * p.nblk * D + (tid & (D - 1));
    float a = 0.f;
    for (int i = tid >> 7; i < p.nblk; i += 4) a = fmaxf(a, src[(long long)i * D]);
    part[buf][tid >> 7][tid & (D - 1)] = a;
  };
  int issued = 0;
  auto issue_to = [&](int limit) {  // thread 0
    for (limit = min(limit, total); issued < limit; ++issued) {
      const int tile = t0 + issued / kVSubs;
      const int bh = tile / per_bh, row0 = (tile % per_bh) * kVRows + (issued % kVSubs) * kRows;
      ring.issue(issued, &p.mv, row0, bh % p.H, bh / p.H);
    }
  };
  if (tid == 0) prefetch_tensormap(&p.mv);
  int buf = 0;
  if (mine > 0) fold_parts(t0 / per_bh, buf);
  __syncthreads();
  if (tid == 0) issue_to(kStages);

  const int rg = warp & 7, ch0 = 64 * (warp >> 3) + 4 * (lane & 15), hv = lane >> 4;
  for (int j = 0, n0 = 0; j < mine; ++j, n0 += kVSubs) {
    const int tile = t0 + j;
    const int bh = tile / per_bh, row0 = (tile % per_bh) * kVRows;
    float scale[4];
    bool safe = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ch0 + i;
      const float a = fmaxf(fmaxf(part[buf][0][c], part[buf][1][c]),
                            fmaxf(part[buf][2][c], part[buf][3][c]));
      scale[i] = quant_scale(a);
      safe = safe && wanq::div_is_safe(scale[i]);
    }
    if (row0 == 0 && rg == 0 && hv == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) p.s_v[(long long)bh * D + ch0 + i] = scale[i];
    }

    const int n = n0 + (rg >> 1);
    ring.wait(n);
    // row r of this lane's 16: channels ch0 .. + 3 of sub-tile row 32 (rg % 2) + 16 hv + r
    const uint2* src =
        reinterpret_cast<const uint2*>(ring.stage(n)) + (32 * (rg & 1) + 16 * hv) * (D / 4) + ch0 / 4;
    int8_t* dst = p.vt + ((long long)bh * D + ch0) * p.S_pad + row0 + 32 * rg + 16 * hv;
    auto transpose = [&](auto div) {
      uint32_t out[4][4];  // [channel][word]: word w holds rows 2w, 2w + 1, 8 + 2w, 9 + 2w
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint2 r0 = src[(2 * w) * (D / 4)], r1 = src[(2 * w + 1) * (D / 4)];
        const uint2 r2 = src[(8 + 2 * w) * (D / 4)], r3 = src[(9 + 2 * w) * (D / 4)];
        const uint32_t a0[2] = {r0.x, r0.y}, a1[2] = {r1.x, r1.y};
        const uint32_t a2[2] = {r2.x, r2.y}, a3[2] = {r3.x, r3.y};
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // channels 2i (low halves) and 2i + 1 (high)
          out[2 * i][w] = pack4(div(bf_lo(a0[i]), 2 * i), div(bf_lo(a1[i]), 2 * i),
                                div(bf_lo(a2[i]), 2 * i), div(bf_lo(a3[i]), 2 * i));
          out[2 * i + 1][w] =
              pack4(div(bf_hi(a0[i]), 2 * i + 1), div(bf_hi(a1[i]), 2 * i + 1),
                    div(bf_hi(a2[i]), 2 * i + 1), div(bf_hi(a3[i]), 2 * i + 1));
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint4*>(dst + (long long)c * p.S_pad) =
            make_uint4(out[c][0], out[c][1], out[c][2], out[c][3]);
    };
    if (safe) {  // per lane; uniform unless a scale lies outside FastDiv's range
      const wanq::FastDiv fd[4] = {wanq::FastDiv(scale[0]), wanq::FastDiv(scale[1]),
                                   wanq::FastDiv(scale[2]), wanq::FastDiv(scale[3])};
      transpose([&](float x, int c) { return fd[c].quotient_rn(x); });
    } else {
      transpose([&](float x, int c) { return __fdiv_rn(x, scale[c]); });
    }
    const bool change = j + 1 < mine && (tile + 1) / per_bh != bh;
    if (change) fold_parts((tile + 1) / per_bh, buf ^ 1);
    __syncthreads();
    buf ^= change;
    if (tid == 0) issue_to(n0 + kVSubs + kStages);
  }
}

// One operand's 4-D map: (d, seq, head, batch) with the byte strides of seq,
// head and batch, unswizzled boxes of 64 whole rows.
bool make_map(CUtensorMap* map, const void* base, int S, int H, long long B,
              long long ss, long long sh, long long sb) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t st[3] = {(cuuint64_t)ss, (cuuint64_t)sh, (cuuint64_t)sb};
  const cuuint32_t box[4] = {D, kRows, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, st, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename K>
int launch(K kernel, int tiles, const Params& p, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = tiles < wanq::sm_count() ? tiles : wanq::sm_count();
  kernel<<<grid, kThreads, kSmemBytes, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16, head dim 128 contiguous, bases 16-byte aligned; the byte
// strides of (seq, head, batch) of each, positive multiples of 16. qi/ki
// [B,H,S_pad,128], vt [B,H,128,S_pad], s_q/s_k [B,H,S_pad/512], s_v [B,H,128],
// v_part [B,H,S_pad/512,128] f32 scratch (any content). S_pad is S rounded up
// to a multiple of 512.
WANQ_API int wanq_quantize_qkv_int8(const void* q, const void* k, const void* v, long long q_ss,
                                    long long q_sh, long long q_sb, long long k_ss,
                                    long long k_sh, long long k_sb, long long v_ss,
                                    long long v_sh, long long v_sb, void* qi, void* ki, void* vt,
                                    void* s_q, void* s_k, void* s_v, void* v_part, long long B,
                                    int H, int S, int S_pad, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (S_pad % BLK || S_pad < S || S_pad - S >= BLK || 3 * B * H * (S_pad / BLK) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Params p;
  if (!make_map(&p.mq, q, S, H, B, q_ss, q_sh, q_sb) ||
      !make_map(&p.mk, k, S, H, B, k_ss, k_sh, k_sb) ||
      !make_map(&p.mv, v, S, H, B, v_ss, v_sh, v_sb))
    return (int)cudaErrorInvalidValue;
  p.qi = static_cast<int8_t*>(qi);
  p.ki = static_cast<int8_t*>(ki);
  p.vt = static_cast<int8_t*>(vt);
  p.s_q = static_cast<float*>(s_q);
  p.s_k = static_cast<float*>(s_k);
  p.s_v = static_cast<float*>(s_v);
  p.v_part = static_cast<float*>(v_part);
  p.B = (int)B;
  p.H = H;
  p.S_pad = S_pad;
  p.nblk = S_pad / BLK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = (int)B * H * p.nblk;
  const int e = launch(qkv_absmax_quant_kernel, 3 * per, p, st);
  if (e != 0) return e;
  return launch(v_quant_kernel, per * (BLK / kVRows), p, st);
}
