// K1: LayerNorm (no affine) + adaLN modulate + per-token symmetric int8
// quant + scaled row sum.
//
// Replaces the TPU kernel wanq_tpu/ops/fused.py:172 ln_modulate_quant_pallas
// (kernel body _ln_mod_quant_kernel :156). For x [B, N, C]:
//   mu = mean(x), var = mean((x - mu)^2), ln = (x - mu) / sqrt(var + eps)
//   y  = ln * (1 + scale[b, r]) + shift[b, r]      (optionally * channel_scale)
//   s  = max(absmax(y) / 127, 1e-6),  q = clip(rint(y / s), -128, 127)
//   sum = s * sum(q)
// outputs q int8 [B, N, C], s f32 [B, N], sum f32 [B, N]. shift and scale are
// rows of C floats: one a sample (Wan2.1's one timestep a sample), or a table
// of R rows a sample, row r serving tokens [r * tpr, (r + 1) * tpr) and the
// last row every token past it (Wan2.2's per-frame timesteps: a row a latent
// frame, the pad tokens on the last). Each operand has its own batch and row
// strides, so the block passes a column of its [B, R, 6, C] modulation as it
// lies and norm3's [C] vectors broadcast over B at stride 0.
//
// Bound on the H100: memory. Per element it reads 2 bytes (bf16 x) and
// writes 1; the arithmetic is a few flops per byte, far under the card's
// ~300 flop/byte balance point. So the design is about the memory system and
// the instruction count around it:
// - a row is read from device memory once, 16 bytes a lane and load, and stays
//   in registers as f32 (48 values a lane): one warp holds a row of up to 1536
//   channels, two warps one of up to 3072 (Wan2.2 TI2V-5B's width, which four
//   warps would hold with half of their registers idle and a block-wide sync
//   every 2 tokens in place of every 4), four warps one of up to 6144. Mean
//   and variance are two passes
//   over the registers (the plain version's arithmetic), y is computed once
//   and kept between the absmax and the quantize step;
// - the next row's 16-byte loads are issued before this row's arithmetic, so a
//   warp does not wait for memory once a row (for bf16 rows without a
//   channel_scale, the paths' case; the other forms have no registers to
//   spare for it at two blocks an SM and load at the top of the row);
// - a tile's tokens lie in one row of the table (tiles do not cross a row's
//   end); a block walks a run of tiles and keeps its row's (1 + scale), shift
//   and channel_scale in shared memory as f32 quads, laid out so that the
//   lanes of a warp read neighbouring 16 bytes; it restages them only where
//   its run crosses into the next row (at most once or twice a block: a row
//   is hundreds of tiles). With one row a sample (kRows false: Wan2.1's
//   calls) the tiles are those of a plain walk over each batch row's N
//   tokens, located without the table's per-tile divisions;
// - loads and stores take the default cache policy: the streaming hints
//   (ld.cs / st.cs) read 8% slower at the paths' shape;
// - y / s is the branch-free FastDiv (common.cuh), the correctly rounded
//   quotient for 2^-40 <= s <= 2^20; a row whose scale lies outside takes
//   __fdiv_rn. rint rounds half to even, and the multiply/add chain uses _rn
//   intrinsics so no fused multiply-add changes the rounding.
// Nothing but the reductions of a four-warp row and the restaging crosses
// warps.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLaneVals = 48;  // f32 values of the row a lane holds
constexpr int kMaxWpr = 4;     // warps per row: 1 (C <= 1536), 2 (C <= 3072) or 4 (C <= 6144)

struct Params {
  const void* x;
  const float* shift;
  const float* scale_mod;
  const float* channel_scale;  // may be null
  int8_t* q;
  float* s_out;
  float* sum_out;
  long long shift_bs, shift_rs, scale_bs, scale_rs;  // batch / row strides, in floats
  int B, N, C;
  int rows, tpr;  // table rows a sample, tokens a row (the last row takes the rest)
  float eps;
};

// tiles of one batch row: rows - 1 full rows of tpr tokens, then the rest
__host__ __device__ inline int tiles_per_batch(int N, int rows, int tpr, int rpt) {
  const int full = (tpr + rpt - 1) / rpt;
  return (rows - 1) * full + (N - (rows - 1) * tpr + rpt - 1) / rpt;
}

// A reduction over the row: over the warp, and for a row of WPR warps through
// one slot of shared memory per reduction of the pass (`slot`), which the
// __syncthreads of the pass's later reductions protect until the next pass.
template <int WPR, typename T, typename Op>
__device__ __forceinline__ T row_reduce(T v, Op op, T (*red)[kWarps], int slot, int warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(wanq::kFull, v, o));
  if constexpr (WPR > 1) {
    const int lane = threadIdx.x & 31;
    if (lane == 0) red[slot][warp] = v;
    __syncthreads();
    const int w0 = warp / WPR * WPR;
    v = red[slot][w0];
#pragma unroll
    for (int i = 1; i < WPR; ++i) v = op(v, red[slot][w0 + i]);
  }
  return v;
}

template <typename T, int WPR, bool kChannelScale, bool kRows>
__global__ void __launch_bounds__(kThreads, 2) ln_mod_quant_kernel(const Params p) {
  using V = wanq::Vec16<T>;
  constexpr int VN = V::N;             // values of one 16-byte load
  constexpr int NV = kLaneVals / VN;   // loads a lane and row
  constexpr int QV = VN / 4;           // f32 quads of one load's columns
  constexpr int LANES = 32 * WPR;      // lanes of a row
  constexpr int RPT = kWarps / WPR;    // rows of a tile (one pass of the block)
  constexpr bool kPrefetch = sizeof(T) == 2 && !kChannelScale;
  extern __shared__ __align__(16) float smod[];  // 1 + scale | shift | channel_scale
  __shared__ float red_f[4][kWarps];
  __shared__ int red_i[1][kWarps];

  const int C = p.C, nvec = C / VN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_in_tile = warp / WPR;
  const int lane_in_row = (warp % WPR) * 32 + lane;
  // quad h of vector v lies at [h][v], so a warp's lanes read neighbouring quads
  const float4* sc1 = reinterpret_cast<const float4*>(smod);
  const float4* shf = sc1 + nvec * QV;
  const float4* chs = shf + nvec * QV;

  // tiles of RPT tokens that cross neither a batch row nor a table row;
  // B * N < 2^31 (the entry point)
  const int per_batch = tiles_per_batch(p.N, p.rows, p.tpr, RPT);
  const int full_tiles = (p.tpr + RPT - 1) / RPT;  // tiles of a table row but the last
  const long long n_tiles = (long long)per_batch * p.B;
  const int t0 = (int)(n_tiles * blockIdx.x / gridDim.x);
  const int t1 = (int)(n_tiles * (blockIdx.x + 1) / gridDim.x);

  // a tile's batch row b, table row r, this thread's token n and whether it
  // lies inside the table row (and N)
  auto locate = [&](int tile, int& b, int& r, int& n) {
    b = tile / per_batch;
    const int in_b = tile - b * per_batch;
    if constexpr (kRows) {
      r = min(in_b / full_tiles, p.rows - 1);
      n = r * p.tpr + (in_b - r * full_tiles) * RPT + row_in_tile;
      return n < (r == p.rows - 1 ? p.N : (r + 1) * p.tpr);
    } else {
      r = 0;
      n = in_b * RPT + row_in_tile;
      return n < p.N;
    }
  };

  // the 16-byte pieces of row (b, n) that this lane holds; zeros past C or N
  auto load_row = [&](uint4 (&raw)[NV], int tile) {
    int b, r, n;
    const bool row_ok = tile < t1 && locate(tile, b, r, n);
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const T*>(p.x) + ((long long)b * p.N + (row_ok ? n : 0)) * C);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = j * LANES + lane_in_row;
      raw[j] = row_ok && v < nvec ? src[v] : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  uint4 raw[NV];
  if (kPrefetch && t0 < t1) load_row(raw, t0);
  int staged_b = -1, staged_r = -1;
  for (int tile = t0; tile < t1; ++tile) {
    int b, r, n;
    const bool row_ok = locate(tile, b, r, n);
    const long long row = (long long)b * p.N + (row_ok ? n : 0);
    if (b != staged_b || (kRows && r != staged_r)) {  // uniform over the block
      __syncthreads();
      float4* dst = reinterpret_cast<float4*>(smod);
      const float4* sc_src =
          reinterpret_cast<const float4*>(p.scale_mod + b * p.scale_bs + r * p.scale_rs);
      const float4* sh_src =
          reinterpret_cast<const float4*>(p.shift + b * p.shift_bs + r * p.shift_rs);
      for (int i = threadIdx.x; i < nvec * QV; i += kThreads) {
        const int at = (i % QV) * nvec + i / QV;
        const float4 sc = __ldg(sc_src + i);
        dst[at] = make_float4(__fadd_rn(1.0f, sc.x), __fadd_rn(1.0f, sc.y),
                              __fadd_rn(1.0f, sc.z), __fadd_rn(1.0f, sc.w));
        dst[nvec * QV + at] = __ldg(sh_src + i);
        if constexpr (kChannelScale)
          dst[2 * nvec * QV + at] = __ldg(reinterpret_cast<const float4*>(p.channel_scale) + i);
      }
      __syncthreads();
      staged_b = b;
      staged_r = r;
    }

    float y[kLaneVals];
    if constexpr (!kPrefetch) load_row(raw, tile);
#pragma unroll
    for (int j = 0; j < NV; ++j) V::unpack(raw[j], y + j * VN);
    if constexpr (kPrefetch) load_row(raw, tile + 1);  // in flight under this row's arithmetic

    // four partial sums a lane, so the adds of a pass are four short chains
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kLaneVals; ++i) acc[i & 3] += y[i];  // the pad lanes hold zeros
    auto add = [](float a, float c) { return a + c; };
    const float mu = __fdiv_rn(
        row_reduce<WPR>((acc[0] + acc[1]) + (acc[2] + acc[3]), add, red_f, 0, warp), (float)C);

#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j * LANES + lane_in_row < nvec) {
#pragma unroll
        for (int i = 0; i < VN; ++i) {
          const float d = __fsub_rn(y[j * VN + i], mu);
          y[j * VN + i] = d;  // kept for the modulate step
          acc[i & 3] = __fadd_rn(acc[i & 3], __fmul_rn(d, d));
        }
      }
    }
    const float var = __fdiv_rn(
        row_reduce<WPR>((acc[0] + acc[1]) + (acc[2] + acc[3]), add, red_f, 1, warp), (float)C);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, p.eps)));

    float amx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = j * LANES + lane_in_row;
      if (v < nvec) {
#pragma unroll
        for (int h = 0; h < QV; ++h) {
          const float4 s1 = sc1[h * nvec + v], sh = shf[h * nvec + v];
          const float s1a[4] = {s1.x, s1.y, s1.z, s1.w}, sha[4] = {sh.x, sh.y, sh.z, sh.w};
          float csa[4] = {1.f, 1.f, 1.f, 1.f};
          if constexpr (kChannelScale) {
            const float4 cs = chs[h * nvec + v];
            csa[0] = cs.x; csa[1] = cs.y; csa[2] = cs.z; csa[3] = cs.w;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float& e = y[j * VN + 4 * h + i];  // holds x - mu
            e = __fadd_rn(__fmul_rn(__fmul_rn(e, rstd), s1a[i]), sha[i]);
            if constexpr (kChannelScale) e = __fmul_rn(e, csa[i]);
            amx[i] = fmaxf(amx[i], fabsf(e));
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) y[j * VN + i] = 0.f;
      }
    }
    auto mx = [](float a, float c) { return fmaxf(a, c); };
    const float amax = row_reduce<WPR>(fmaxf(fmaxf(amx[0], amx[1]), fmaxf(amx[2], amx[3])), mx,
                                       red_f, 2, warp);
    const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-6f);

    // codes: |y| <= amax and s >= fl(amax / 127), so |y / s| < 127.5 and the
    // rounded quotient needs no clip; FastDiv's quotient is exact wherever s
    // is in its range. Four codes pack into a word, whose bytes dp4a sums.
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
        const int v = j * LANES + lane_in_row;
        if (row_ok && v < nvec) {
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
    auto iadd = [](int a, int c) { return a + c; };
    isum = row_reduce<WPR>(isum, iadd, red_i, 0, warp);
    if (row_ok && lane_in_row == 0) {
      p.s_out[row] = s;
      p.sum_out[row] = __fmul_rn(s, (float)isum);
    }
  }
}

template <typename T, int WPR, bool kChannelScale, bool kRows>
int launch(const Params& p, cudaStream_t st) {
  auto kern = ln_mod_quant_kernel<T, WPR, kChannelScale, kRows>;
  const int smem = (kChannelScale ? 3 : 2) * p.C * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = (long long)p.B * tiles_per_batch(p.N, p.rows, p.tpr, kWarps / WPR);
  const long long blocks = 2LL * wanq::sm_count();  // two blocks an SM (__launch_bounds__)
  kern<<<(unsigned)(n_tiles < blocks ? n_tiles : blocks), kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool kChannelScale, bool kRows>
int run_rows(const Params& p, cudaStream_t st) {
  constexpr int kRowOfWarp = 32 * kLaneVals;
  if (p.C <= kRowOfWarp) return launch<T, 1, kChannelScale, kRows>(p, st);
  if (p.C <= 2 * kRowOfWarp) return launch<T, 2, kChannelScale, kRows>(p, st);
  if (p.C <= kMaxWpr * kRowOfWarp) return launch<T, kMaxWpr, kChannelScale, kRows>(p, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kChannelScale>
int run(const Params& p, cudaStream_t st) {
  return p.rows > 1 ? run_rows<T, kChannelScale, true>(p, st)
                    : run_rows<T, kChannelScale, false>(p, st);
}

}  // namespace

// x_bf16: 1 when x is bf16, 0 when f32. channel_scale may be null. shift and
// scale_mod: rows of C floats, row r of sample b at b * *_bs + r * *_rs
// floats; rows >= 1 a sample, row r serving tokens [r * tpr, (r + 1) * tpr),
// the last row the rest, (rows - 1) * tpr < N (one row a sample: rows 1, any
// tpr). C must be a multiple of 8 (bf16) or 4 (f32) and at most 6144; the
// strides multiples of 4; x, shift, scale_mod and channel_scale 16-byte aligned.
WANQ_API int wanq_ln_modulate_quant(const void* x, int x_bf16, const void* shift,
                                    long long shift_bs, long long shift_rs,
                                    const void* scale_mod, long long scale_bs,
                                    long long scale_rs, int rows, long long tpr,
                                    const void* channel_scale, void* q, void* s, void* sum,
                                    long long B, long long N, int C, float eps, void* stream) {
  if (B * N == 0) return 0;
  if (C <= 0 || C % (x_bf16 ? 8 : 4) != 0 || B * N > 0x7fffffffLL || rows < 1 ||
      (shift_bs | shift_rs | scale_bs | scale_rs) % 4 != 0 || shift_bs < 0 || shift_rs < 0 ||
      scale_bs < 0 || scale_rs < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 1) tpr = N;
  if (tpr < 1 || (rows - 1) * tpr >= N) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.shift = static_cast<const float*>(shift);
  p.scale_mod = static_cast<const float*>(scale_mod);
  p.channel_scale = static_cast<const float*>(channel_scale);
  p.q = static_cast<int8_t*>(q);
  p.s_out = static_cast<float*>(s);
  p.sum_out = static_cast<float*>(sum);
  p.shift_bs = shift_bs; p.shift_rs = shift_rs;
  p.scale_bs = scale_bs; p.scale_rs = scale_rs;
  p.B = (int)B; p.N = (int)N; p.C = C;
  p.rows = rows; p.tpr = (int)tpr;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (channel_scale)
    return x_bf16 ? run<__nv_bfloat16, true>(p, st) : run<float, true>(p, st);
  return x_bf16 ? run<__nv_bfloat16, false>(p, st) : run<float, false>(p, st);
}
