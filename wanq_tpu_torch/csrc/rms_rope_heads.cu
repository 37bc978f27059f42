// K3: RMSNorm over the model dim -> 3D RoPE -> heads-major write.
//
// Replaces the TPU kernels wanq_tpu/ops/rmsnorm_rope.py:62 rms_rope_heads
// (kernel _kernel :31) and, with the rope off, :144 rms_split_heads (kernel
// _rms_split_kernel :135). For x [B, S, H*128] bf16:
//   xn = bf16(x * rsqrt(mean(x^2) + eps) * w)        norm over all H*128 channels
//   y  = xn * ca[s] + pairswap(xn) * sb[s]           (rope on; tables f32 [S, 128],
//                                                     identity tail past the valid
//                                                     tokens, q-scaled or not)
//   out[b, h, s, :] = bf16(y)                        [B, H, S, 128]
// The TPU kernel swaps adjacent feature pairs with a 128x128 permutation
// matmul; here the pair sits in one lane's registers and the swap is an
// element swap.
//
// Bound on the H100: memory. Per element it reads 2 bytes and writes 2, with a
// dozen instructions; the rope tables add 1 KB a token position. The design is
// about the memory system:
// - a group of WPR warps owns a token position s for every batch row b, so
//   each table row crosses device memory once (rows of one position lie
//   S * C * 2 bytes apart, 200 MB at the 1.3B shape: ordered b-major, the
//   second batch row's table row is long gone from the 50 MB L2);
// - a row crosses device memory once, and each lane holds its 16-byte pieces
//   as the loaded bf16 in registers (48 values a lane at C = 1536 with one
//   warp a row; four warps a row up to C = 6144): the sum of squares and the
//   normalized write both come from those registers;
// - a group streams its rows through a ring of three stages in shared memory,
//   each landed by bulk copies (TMA) that one lane issues and an mbarrier
//   counts: the row of x and, where a row starts a position, its table rows.
//   Two rows are in flight while the third is worked on, and neither the bytes
//   in flight nor their requests occupy the lanes;
// - groups are persistent: each walks every (groups)-th position, so the card
//   reads and writes neighbouring positions at a time, and keeps its 48 gains
//   w and its fixed head-dim offset in registers. A lane's 16 bytes lie at
//   d = (lane % 16) * 8 of one head for every piece (the stride of a lane,
//   256 channels, is a multiple of D = 128), so a lane needs 8 ca and 8 sb
//   values a position and no division;
// - stores take the default cache policy (K1 found the streaming hints
//   slower).
// Rounding is the unfused chain's (rmsnorm_rope.py:38): the normalized value
// rounds to bf16, then the rope is computed in f32 and rounds once more;
// r = 1 / sqrt(mean + eps) as a true division and square root, _rn
// intrinsics so that no fused multiply-add changes a rounding. Only the f32
// sum of squares runs in another order than the plain version's (one chain a
// lane, then a butterfly).
#include "sm90.cuh"

namespace {

constexpr int kD = 128;        // the head dim the kernel is built for
constexpr int kWarps = 4;      // warps a block: 4 one-warp groups, or one four-warp group
constexpr int kThreads = kWarps * 32;
constexpr int kNV = 6;         // 16-byte pieces of x a lane and row (48 bf16)
constexpr int kMaxWpr = 4;
constexpr int kStages = 3;     // rows of a group in its ring: two in flight, one in use

struct Params {
  const __nv_bfloat16* x;
  const float* w;
  const float* ca;  // null: no rope (rms_split_heads)
  const float* sb;
  __nv_bfloat16* out;
  int B, S, H;
  float eps;
};

// a stage of a group's ring: the row of x, then the table rows ca and sb of
// its position (rope on); an mbarrier a stage after the rings
__host__ __device__ constexpr int stage_bytes(int C, bool rope) {
  return C * 2 + (rope ? 2 * kD * 4 : 0);
}

template <int WPR, bool kRope>
__global__ void __launch_bounds__(kThreads) rms_rope_heads_kernel(const Params p) {
  constexpr int LANES = 32 * WPR;          // lanes of a row
  constexpr int GROUPS = kWarps / WPR;     // row groups of a block
  extern __shared__ __align__(16) char rings[];  // [group][stage][x row | ca | sb] | mbarriers
  __shared__ float red[2][kWarps];         // a four-warp row's partial sums, by row parity

  const int C = p.H * kD, nvec = C / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = (warp % WPR) * 32 + lane;  // lane within the row
  const int d = (lane & 15) * 8;            // the same for every piece of this lane
  const int sbytes = stage_bytes(C, kRope);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rings + GROUPS * kStages * sbytes);
  char* ring = rings + (warp / WPR) * kStages * sbytes;
  uint64_t* full = bars + (warp / WPR) * kStages;
  const bool producer = lr == 0;

  // positions gg, gg + groups, ...: the groups of the card work on neighbouring
  // positions at a time, so its reads and its heads-major writes stay close
  const int groups = gridDim.x * GROUPS;
  const int gg = blockIdx.x * GROUPS + warp / WPR;

  if (threadIdx.x == 0) {
    for (int i = 0; i < GROUPS * kStages; ++i) wanq::sm90::mbar_init(bars + i, 1);
    wanq::sm90::mbar_fence_init();
  }
  float wr[kNV * 8];
#pragma unroll
  for (int j = 0; j < kNV; ++j) {
    const int v = j * LANES + lr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 w4 = v < nvec ? __ldg(reinterpret_cast<const float4*>(p.w) + 2 * v + h)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      wr[j * 8 + 4 * h + 0] = w4.x;
      wr[j * 8 + 4 * h + 1] = w4.y;
      wr[j * 8 + 4 * h + 2] = w4.z;
      wr[j * 8 + 4 * h + 3] = w4.w;
    }
  }
  __syncthreads();

  // row (s, b) into stage st by bulk copies (TMA): the row of x, and the
  // table rows of position s when the row starts it
  auto issue = [&](int st, int s, int b) {
    char* dst = ring + st * sbytes;
    const bool tables = kRope && b == 0;
    wanq::sm90::mbar_expect_tx(full + st, C * 2 + (tables ? 2 * kD * 4 : 0));
    wanq::sm90::bulk_load_1d(dst, p.x + ((long long)b * p.S + s) * C, C * 2, full + st);
    if (tables) {
      wanq::sm90::bulk_load_1d(dst + C * 2, p.ca + (long long)s * kD, kD * 4, full + st);
      wanq::sm90::bulk_load_1d(dst + C * 2 + kD * 4, p.sb + (long long)s * kD, kD * 4,
                               full + st);
    }
  };
  auto next = [&](int& s, int& b) {
    if (++b == p.B) {
      b = 0;
      s += groups;
    }
  };

  int is = gg, ib = 0;  // the next row to issue
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (is < p.S) {
      if (producer) issue(k, is, ib);
      next(is, ib);
    }
  }

  float4 tab[4] = {};  // unused without the rope
  wanq::sm90::Ring<kStages> at;  // the stage and phase of the row being worked on
  int parity = 0;
  for (int s = gg, b = 0; s < p.S; parity ^= 1) {
    // the row kStages - 1 ahead goes into the stage the last row freed, once
    // every lane of the group is done with it (a four-warp group passed a
    // barrier since)
    if constexpr (WPR == 1) __syncwarp();
    if (is < p.S) {
      if (producer) issue(at.stage == 0 ? kStages - 1 : at.stage - 1, is, ib);
      next(is, ib);
    }
    wanq::sm90::mbar_wait(full + at.stage, at.phase);  // this row has landed
    const char* stage = ring + at.stage * sbytes;
    const uint4* src = reinterpret_cast<const uint4*>(stage);
    uint4 raw[kNV];
#pragma unroll
    for (int j = 0; j < kNV; ++j)
      raw[j] = j * LANES + lr < nvec ? src[j * LANES + lr] : make_uint4(0u, 0u, 0u, 0u);
    if (kRope && b == 0) {
      const float4* t = reinterpret_cast<const float4*>(stage + C * 2);
      tab[0] = t[d / 4];
      tab[1] = t[d / 4 + 1];
      tab[2] = t[kD / 4 + d / 4];
      tab[3] = t[kD / 4 + d / 4 + 1];
    }
    at.advance();

    // sum of squares, one chain a lane in channel order, then the warp's
    // butterfly: at one warp a row this is the order the paths' recorded
    // outputs were made with (PERF.md), so the design does not move them (the
    // pad lanes hold zeros)
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      float e[8];
      wanq::Vec16<__nv_bfloat16>::unpack(raw[j], e);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, __fmul_rn(e[i], e[i]));
    }
    float ss = wanq::warp_sum(acc);
    if constexpr (WPR > 1) {
      if (lane == 0) red[parity][warp] = ss;
      __syncthreads();  // one group a block: every warp walks the same rows
      ss = red[parity][0];
#pragma unroll
      for (int i = 1; i < WPR; ++i) ss += red[parity][i];
    }
    const float ms = __fdiv_rn(ss, (float)C);
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, p.eps)));

    const float ca[8] = {tab[0].x, tab[0].y, tab[0].z, tab[0].w,
                         tab[1].x, tab[1].y, tab[1].z, tab[1].w};
    const float sb[8] = {tab[2].x, tab[2].y, tab[2].z, tab[2].w,
                         tab[3].x, tab[3].y, tab[3].z, tab[3].w};
    __nv_bfloat16* dst = p.out + ((long long)b * p.H * p.S + s) * kD + d;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      const int v = j * LANES + lr;
      if (v < nvec) {
        float e[8], xn[8], y[8];
        wanq::Vec16<__nv_bfloat16>::unpack(raw[j], e);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          xn[i] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(__fmul_rn(e[i], r),
                                                                 wr[j * 8 + i])));
#pragma unroll
        for (int i = 0; i < 8; ++i)
          y[i] = kRope ? __fadd_rn(__fmul_rn(xn[i], ca[i]), __fmul_rn(xn[i ^ 1], sb[i])) : xn[i];
        uint4 packed;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int i = 0; i < 4; ++i) o2[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
        // head v / 16 of this row: S * 128 elements a head
        *reinterpret_cast<uint4*>(dst + (long long)(v >> 4) * p.S * kD) = packed;
      }
    }
    next(s, b);
  }
}

template <int WPR, bool kRope>
int launch(const Params& p, cudaStream_t st) {
  auto kern = rms_rope_heads_kernel<WPR, kRope>;
  const int smem = kWarps / WPR * kStages * (stage_bytes(p.H * kD, kRope) + (int)sizeof(uint64_t));
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * wanq::sm_count();
  const long long need = (p.S + kWarps / WPR - 1) / (kWarps / WPR);  // a position a group
  kern<<<(unsigned)(need < blocks ? need : blocks), kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <bool kRope>
int run(const Params& p, cudaStream_t st) {
  const int C = p.H * kD;
  if (C <= 32 * kNV * 8) return launch<1, kRope>(p, st);
  if (C <= kMaxWpr * 32 * kNV * 8) return launch<kMaxWpr, kRope>(p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ca/sb null: no rope (rms_split_heads). D must be 128 and H * 128 <= 6144;
// x, w, ca, sb and out 16-byte aligned, B * S < 2^31.
WANQ_API int wanq_rms_rope_heads(const void* x, const void* w, const void* ca, const void* sb,
                                 void* out, long long B, int S, int H, int D, float eps,
                                 void* stream) {
  if (B * S == 0) return 0;
  if (D != kD || H <= 0 || B * S > 0x7fffffffLL || (ca == nullptr) != (sb == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const float*>(w);
  p.ca = static_cast<const float*>(ca);
  p.sb = static_cast<const float*>(sb);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = (int)B; p.S = S; p.H = H;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ca ? run<true>(p, st) : run<false>(p, st);
}
