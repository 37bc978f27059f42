// K7: optional tanh-GELU, optional SmoothQuant channel scale, then
// per-token symmetric int8 quant + scaled row sum.
//
// Replaces the TPU kernel wanq_tpu/ops/fused.py:126 quant_sum_pallas
// (kernel body _quant_sum_kernel :109; the dispatcher quant_sum :214 runs
// the same math in XLA, with the channel scale). For x [M, C]:
//   y  = gelu_tanh(x) if gelu else x                 (f32)
//   y  = y * channel_scale                           (when given)
//   s  = max(absmax(y) / 127, 1e-6),  q = clip(rint(y / s), -128, 127)
//   sum = s * sum(q)
// outputs q int8 [M, C], s f32 [M], sum f32 [M].
//
// Bound on the H100: memory, once the arithmetic fits. Per element it reads
// 2 bytes (bf16 x) and writes 1 (~1.76 GB at the ffn.2 input [65536, 8960],
// 0.53 ms at 3.35 TB/s). The element's arithmetic decides whether that bound
// is reached: a tanhf, an f32 round trip through shared memory and a division
// with a branch came to ~50 lane instructions an element, which the card
// issues in ~1.1 ms at that shape. The design:
// - the row crosses device memory once, and its y stays in registers as f32
//   (48 values a lane) between the absmax and the codes: one warp a row up to C = 1536 (no barrier; K1's structure),
//   and above that a block of ceil(C / 1536) warps a row, which shares one
//   max and one integer sum through a few words of shared memory;
// - blocks are persistent: each warp (or a wide row's block) takes every
//   (units)-th row, so the card works on neighbouring rows at a time, and
//   streams them through a ring of three rows in shared memory, each landed
//   by one bulk copy (TMA) that one lane issues and an mbarrier counts: two
//   rows are in flight while the third is worked on, and neither the bytes in
//   flight nor their requests occupy the lanes;
// - GELU of a bf16 x is a table lookup: gelu_tanh(x) = (0.5 x) * f with
//   f = 1 + tanh(inner(x)) rounded to f32 (common.cuh), a function of the 16
//   bits of x. Each block tabulates f with gelu_tanh_factor itself for the
//   8192 bf16 values with 2^-28 <= |x| < 16 (32 KB of shared memory); below
//   2^-28, 1 + tanh(inner) rounds to 1 exactly, and from 16 up tanh is +-1
//   exactly, so f is 1, 2 (x > 0) or 0 (x < 0), which the table's two end
//   entries of each sign hold (a NaN or -inf x then gives NaN, as
//   gelu_tanh does). The product is gelu_tanh's own last multiply, so the
//   value is gelu_tanh(x) bit for bit: chip_smoke.py checks all 65536 inputs
//   (wanq_gelu_bf16_check). With it an element costs ~17 lane instructions
//   (the SASS: ~8 for the lookup and the product, 1 for the absmax, ~7 for
//   the division, rounding and packing), against tanhf's branches and
//   exponential; the tanhf form of this kernel was the slower of the two at
//   the ffn.2 input on an H100. f32 inputs keep tanhf;
// - y / s is the branch-free FastDiv (common.cuh) quotient_rn, correctly
//   rounded for every f32 y when 2^-40 <= s <= 2^20, __fdiv_rn otherwise;
//   cvt.rni (round half to even), codes packed with prmt and summed with
//   dp4a. |y| <= absmax and s >= fl(absmax / 127) keep |y / s| below 127.5,
//   so no code needs the clip;
// - the channel scale lies in shared memory as f32 quads, laid out so that
//   the lanes of a warp read neighbouring 16 bytes.
// The channel scale and the sum use _rn intrinsics, so no fused multiply-add
// changes a rounding.
#include "sm90.cuh"

namespace {

constexpr int kLaneVals = 48;  // f32 values of a row a lane holds
constexpr int kRowWarps = 8;   // one-warp-a-row form: warps a block
constexpr int kMaxWarps = 12;  // the widest row: 12 warps x 32 lanes x 48 values
constexpr int kStages = 3;     // rows of a warp (block) in its ring: two in flight, one in use

// the bf16 GELU factor table: magnitudes [kTabLo, kTabHi) of each sign, with
// f = 1 below and f = 2 / 0 (x > 0 / x < 0) from kTabHi up at the two ends
constexpr int kTabLo = (127 - 28) << 7;   // bf16 magnitude bits of 2^-28
constexpr int kTabHi = (127 + 4) << 7;    // of 16
constexpr int kTabSpan = kTabHi - kTabLo;
constexpr int kTabSign = kTabSpan + 2;    // entries a sign
constexpr int kTabEntries = 2 * kTabSign;

enum Gelu { kNone = 0, kTanh = 1, kTable = 2 };

struct Params {
  const void* x;
  const float* channel_scale;  // may be null
  int8_t* q;
  float* s_out;
  float* sum_out;
  long long rows;
  int C;
};

__device__ __forceinline__ void build_gelu_table(float* tab) {
  for (int i = threadIdx.x; i < kTabEntries; i += blockDim.x) {
    const int neg = i >= kTabSign;
    const int k = i - neg * kTabSign;
    float f;
    if (k == 0) {
      f = 1.0f;
    } else if (k == kTabSpan + 1) {
      f = neg ? 0.0f : 2.0f;
    } else {
      const uint32_t u = ((uint32_t)neg << 15) | (uint32_t)(kTabLo + k - 1);
      f = wanq::gelu_tanh_factor(__uint_as_float(u << 16));
    }
    tab[i] = f;
  }
}

// gelu_tanh of the bf16 value with bits u (the low 16 bits)
__device__ __forceinline__ float gelu_bf16(uint32_t u, const float* tab) {
  const int k = min(max((int)(u & 0x7fffu) - kTabLo + 1, 0), kTabSpan + 1);
  return __fmul_rn(0.5f * __uint_as_float(u << 16), tab[(int)(u >> 15) * kTabSign + k]);
}

// The values of one 16-byte load: gelu'd (or not) as f32.
template <typename T, int kGelu>
__device__ __forceinline__ void load_values(const uint4& raw, float* e, const float* tab) {
  if constexpr (kGelu == kTable) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[2 * i] = gelu_bf16(w[i] & 0xffffu, tab);
      e[2 * i + 1] = gelu_bf16(w[i] >> 16, tab);
    }
  } else {
    wanq::Vec16<T>::unpack(raw, e);
    if constexpr (kGelu == kTanh) {
#pragma unroll
      for (int i = 0; i < wanq::Vec16<T>::N; ++i) e[i] = wanq::gelu_tanh(e[i]);
    }
  }
}

// kMulti: a block of blockDim.x / 32 warps owns a row at a time; otherwise
// each warp of the block owns its rows.
template <typename T, int kGelu, bool kMulti>
__global__ void __launch_bounds__(kMulti ? kMaxWarps * 32 : kRowWarps * 32)
    quant_sum_kernel(const Params p) {
  using V = wanq::Vec16<T>;
  constexpr int VN = V::N;            // values of one 16-byte load
  constexpr int NV = kLaneVals / VN;  // loads a lane and row
  constexpr int QV = VN / 4;          // f32 quads of one load's columns
  // GELU table | channel scale quads | rings [unit][stage][row] | mbarriers [unit][stage]
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_f[2][kMaxWarps];
  __shared__ int red_i[2][kMaxWarps];

  const float* tab = smem;
  const bool has_cs = p.channel_scale != nullptr;
  const int C = p.C, nvec = C / VN;
  const float4* cs4 = reinterpret_cast<const float4*>(smem + (kGelu == kTable ? kTabEntries : 0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int lanes = kMulti ? (int)blockDim.x : 32;
  const int lr = kMulti ? (int)threadIdx.x : lane;
  // this unit's ring: kStages rows, each landed by one bulk copy and counted
  // on its stage's mbarrier; one ring a warp (one ring for a kMulti block)
  const int row_bytes = C * (int)sizeof(T);
  const int units_here = kMulti ? 1 : nwarps;
  char* rings = reinterpret_cast<char*>(smem + (kGelu == kTable ? kTabEntries : 0) +
                                        (has_cs ? C : 0));
  uint64_t* bars = reinterpret_cast<uint64_t*>(rings + units_here * kStages * row_bytes);
  char* ring = rings + (kMulti ? 0 : warp) * kStages * row_bytes;
  uint64_t* full = bars + (kMulti ? 0 : warp) * kStages;
  const bool producer = lr == 0;
  // rows unit, unit + units, ... for this block (kMulti) or warp: the card
  // works on neighbouring rows at a time
  const long long units = kMulti ? gridDim.x : (long long)gridDim.x * nwarps;
  const long long unit = kMulti ? blockIdx.x : (long long)blockIdx.x * nwarps + warp;

  if (threadIdx.x == 0) {
    for (int i = 0; i < units_here * kStages; ++i) wanq::sm90::mbar_init(bars + i, 1);
    wanq::sm90::mbar_fence_init();
  }
  if constexpr (kGelu == kTable) build_gelu_table(smem);
  if (has_cs) {
    float4* dst = const_cast<float4*>(cs4);
    for (int i = threadIdx.x; i < nvec * QV; i += blockDim.x)
      dst[(i % QV) * nvec + i / QV] = __ldg(reinterpret_cast<const float4*>(p.channel_scale) + i);
  }
  __syncthreads();

  auto issue = [&](int st, long long row) {
    wanq::sm90::mbar_expect_tx(full + st, row_bytes);
    wanq::sm90::bulk_load_1d(ring + st * row_bytes, static_cast<const T*>(p.x) + row * C,
                             row_bytes, full + st);
  };

  long long next = unit;  // the next row to issue
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k, next += units) {
    if (producer && next < p.rows) issue(k, next);
  }
  wanq::sm90::Ring<kStages> at;  // the stage and phase of the row being worked on
  int parity = 0;
  for (long long row = unit; row < p.rows; row += units, parity ^= 1) {
    // the row kStages - 1 ahead goes into the stage the last row freed, once
    // every lane is done with it (a kMulti block passed two barriers since)
    if constexpr (!kMulti) __syncwarp();
    if (producer && next < p.rows) issue(at.stage == 0 ? kStages - 1 : at.stage - 1, next);
    next += units;
    wanq::sm90::mbar_wait(full + at.stage, at.phase);  // this row has landed
    const uint4* src = reinterpret_cast<const uint4*>(ring + at.stage * row_bytes);
    uint4 raw[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      raw[j] = j * lanes + lr < nvec ? src[j * lanes + lr] : make_uint4(0u, 0u, 0u, 0u);
    at.advance();

    // y in registers; the pad lanes hold zeros
    float y[kLaneVals];
    float amx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = j * lanes + lr;
      float* e = y + j * VN;
      load_values<T, kGelu>(raw[j], e, tab);
      if (v < nvec) {
        if (has_cs) {
#pragma unroll
          for (int h = 0; h < QV; ++h) {
            const float4 cs = cs4[h * nvec + v];
            e[4 * h] = __fmul_rn(e[4 * h], cs.x);
            e[4 * h + 1] = __fmul_rn(e[4 * h + 1], cs.y);
            e[4 * h + 2] = __fmul_rn(e[4 * h + 2], cs.z);
            e[4 * h + 3] = __fmul_rn(e[4 * h + 3], cs.w);
          }
        }
#pragma unroll
        for (int i = 0; i < VN; ++i) amx[i & 3] = fmaxf(amx[i & 3], fabsf(e[i]));
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) e[i] = 0.f;
      }
    }

    float amax = wanq::warp_max(fmaxf(fmaxf(amx[0], amx[1]), fmaxf(amx[2], amx[3])));
    if constexpr (kMulti) {
      if (lane == 0) red_f[parity][warp] = amax;
      __syncthreads();
      amax = red_f[parity][0];
      for (int w = 1; w < nwarps; ++w) amax = fmaxf(amax, red_f[parity][w]);
    }
    const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-6f);

    int isum = 0;
    int8_t* qr = p.q + row * C;
    auto quantize = [&](auto div) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        uint32_t packed[QV];
#pragma unroll
        for (int h = 0; h < QV; ++h) {
          int c4[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) c4[i] = __float2int_rn(div(y[j * VN + 4 * h + i]));
          packed[h] = __byte_perm(__byte_perm(c4[0], c4[1], 0x0040),
                                  __byte_perm(c4[2], c4[3], 0x0040), 0x5410);
          isum = __dp4a((int)packed[h], 0x01010101, isum);
        }
        const int v = j * lanes + lr;
        if (v < nvec) {
          if constexpr (QV == 2) {
            reinterpret_cast<uint2*>(qr)[v] = make_uint2(packed[0], packed[1]);
          } else {
            reinterpret_cast<uint32_t*>(qr)[v] = packed[0];
          }
        }
      }
    };
    if (wanq::div_is_safe(s)) {  // uniform over the row
      const wanq::FastDiv fd(s);
      quantize([&](float a) { return fd.quotient_rn(a); });
    } else {
      quantize([&](float a) { return __fdiv_rn(a, s); });
    }
    isum = wanq::warp_isum(isum);
    if constexpr (kMulti) {
      if (lane == 0) red_i[parity][warp] = isum;
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int w = 1; w < nwarps; ++w) isum += red_i[parity][w];
      }
    }
    if (lr == 0) {
      p.s_out[row] = s;
      p.sum_out[row] = __fmul_rn(s, (float)isum);
    }
  }
}

template <typename T, int kGelu, bool kMulti>
int launch(const Params& p, cudaStream_t st) {
  auto kern = quant_sum_kernel<T, kGelu, kMulti>;
  constexpr int VN = wanq::Vec16<T>::N;
  const int nvec = p.C / VN;
  const int warps = kMulti ? (nvec + 32 * (kLaneVals / VN) - 1) / (32 * (kLaneVals / VN))
                           : kRowWarps;
  const int units_here = kMulti ? 1 : kRowWarps;
  const int smem = (int)sizeof(float) * ((kGelu == kTable ? kTabEntries : 0) +
                                         (p.channel_scale ? p.C : 0)) +
                   units_here * kStages * (p.C * (int)sizeof(T) + (int)sizeof(uint64_t));
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, warps * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const long long need = kMulti ? p.rows : (p.rows + kRowWarps - 1) / kRowWarps;
  const long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * wanq::sm_count();
  kern<<<(unsigned)(need < blocks ? need : blocks), warps * 32, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int kGelu>
int run(const Params& p, cudaStream_t st) {
  const int row_of_warp = 32 * kLaneVals;
  if (p.C <= row_of_warp) return launch<T, kGelu, false>(p, st);
  if (p.C <= kMaxWarps * row_of_warp) return launch<T, kGelu, true>(p, st);
  return (int)cudaErrorInvalidValue;
}

// every bf16 value x (bits u = the index): gelu_bf16 through a table built by
// build_gelu_table, and wanq::gelu_tanh itself
__global__ void __launch_bounds__(256) gelu_bf16_check_kernel(float* table_out,
                                                              float* direct_out) {
  extern __shared__ __align__(16) float tab[];
  build_gelu_table(tab);
  __syncthreads();
  for (uint32_t u = blockIdx.x * blockDim.x + threadIdx.x; u < 65536u;
       u += gridDim.x * blockDim.x) {
    table_out[u] = gelu_bf16(u, tab);
    direct_out[u] = wanq::gelu_tanh(__uint_as_float(u << 16));
  }
}

}  // namespace

// x_bf16: 1 when x is bf16, 0 when f32; gelu: 1 for tanh-GELU first (bf16 x:
// through the factor table, f32 x through tanhf).
// channel_scale [C] f32 may be null. C must be a multiple of 8 (bf16) or 4
// (f32) and at most 18432 (bf16) or 13824 (f32: the ring then fills shared
// memory); x and channel_scale 16-byte aligned.
WANQ_API int wanq_quant_sum(const void* x, int x_bf16, int gelu, const void* channel_scale,
                            void* q, void* s, void* sum, long long rows, int C, void* stream) {
  if (rows == 0) return 0;
  if (C <= 0 || C % (x_bf16 ? 8 : 4) != 0 || C > (x_bf16 ? 18432 : 13824) ||
      rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.channel_scale = static_cast<const float*>(channel_scale);
  p.q = static_cast<int8_t*>(q);
  p.s_out = static_cast<float*>(s);
  p.sum_out = static_cast<float*>(sum);
  p.rows = rows;
  p.C = C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return gelu ? run<__nv_bfloat16, kTable>(p, st) : run<__nv_bfloat16, kNone>(p, st);
  return gelu ? run<float, kTanh>(p, st) : run<float, kNone>(p, st);
}

// table_out, direct_out: f32 [65536], gelu_tanh of the bf16 value with bits i
// through K7's table and directly.
WANQ_API int wanq_gelu_bf16_check(void* table_out, void* direct_out, void* stream) {
  const int smem = kTabEntries * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(gelu_bf16_check_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  gelu_bf16_check_kernel<<<64, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table_out), static_cast<float*>(direct_out));
  return (int)cudaGetLastError();
}
