// K1: LayerNorm (no affine) + adaLN modulate + per-token symmetric int8
// quant + scaled row sum.
//
// Replaces the TPU kernel wanq_tpu/ops/fused.py:172 ln_modulate_quant_pallas
// (kernel body _ln_mod_quant_kernel :156). For x [B, N, C]:
//   mu = mean(x), var = mean((x - mu)^2), ln = (x - mu) / sqrt(var + eps)
//   y  = ln * (1 + scale[b]) + shift[b]            (optionally * channel_scale)
//   s  = max(absmax(y) / 127, 1e-6),  q = clip(rint(y / s), -128, 127)
//   sum = s * sum(q)
// outputs q int8 [B, N, C], s f32 [B, N], sum f32 [B, N].
//
// Bound on the H100: memory. Per element it reads 2 bytes (bf16 x) and
// writes 1; the arithmetic is a few flops per byte, far under the card's
// ~300 flop/byte balance point. Design: one warp owns one token row and
// reads it with 16-byte vector loads; the four passes (mean, variance,
// absmax, quantize) re-read the row, which stays in L1/L2 (3 KB at
// C = 1536), so device memory sees the row about once. The reductions are
// warp shuffles; nothing crosses warps, so there is no shared memory and no
// block barrier. Rounding follows the reference exactly: y / s is a true
// IEEE division (no reciprocal), rint rounds half to even, and the
// multiply/add chain uses _rn intrinsics so no fused multiply-add changes
// the rounding.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float modulated(float x, float mu, float rstd, float sc, float sh,
                                           float cs) {
  float ln = __fmul_rn(__fsub_rn(x, mu), rstd);
  float y = __fadd_rn(__fmul_rn(ln, __fadd_rn(1.0f, sc)), sh);
  return __fmul_rn(y, cs);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    ln_mod_quant_kernel(const T* __restrict__ x, const float* __restrict__ shift,
                        const float* __restrict__ scale_mod,
                        const float* __restrict__ channel_scale, int8_t* __restrict__ q,
                        float* __restrict__ s_out, float* __restrict__ sum_out, long long rows,
                        int n_per_batch, int C, float eps) {
  using V = wanq::Vec16<T>;
  constexpr int VN = V::N;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long b = row / n_per_batch;
  const T* xr = x + row * C;
  const float* sh = shift + b * C;
  const float* sc = scale_mod + b * C;
  float v[VN];

  float acc = 0.f;
  for (int c = lane * VN; c < C; c += 32 * VN) {
    V::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < VN; ++i) acc += v[i];
  }
  const float mu = __fdiv_rn(wanq::warp_sum(acc), (float)C);

  acc = 0.f;
  for (int c = lane * VN; c < C; c += 32 * VN) {
    V::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      float d = __fsub_rn(v[i], mu);
      acc = __fadd_rn(acc, __fmul_rn(d, d));
    }
  }
  const float var = __fdiv_rn(wanq::warp_sum(acc), (float)C);
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));

  float amax = 0.f;
  for (int c = lane * VN; c < C; c += 32 * VN) {
    V::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      float cs = channel_scale ? channel_scale[c + i] : 1.0f;
      amax = fmaxf(amax, fabsf(modulated(v[i], mu, rstd, sc[c + i], sh[c + i], cs)));
    }
  }
  amax = wanq::warp_max(amax);
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-6f);

  int isum = 0;
  int8_t* qr = q + row * C;
  for (int c = lane * VN; c < C; c += 32 * VN) {
    V::load(xr + c, v);
    uint32_t packed[VN / 4] = {};
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      float cs = channel_scale ? channel_scale[c + i] : 1.0f;
      float y = modulated(v[i], mu, rstd, sc[c + i], sh[c + i], cs);
      float r = fminf(fmaxf(rintf(__fdiv_rn(y, s)), -128.f), 127.f);
      int qi = (int)r;
      isum += qi;
      packed[i >> 2] |= (uint32_t)(uint8_t)(int8_t)qi << (8 * (i & 3));
    }
    if constexpr (VN == 8) {
      *reinterpret_cast<uint2*>(qr + c) = make_uint2(packed[0], packed[1]);
    } else {
      *reinterpret_cast<uint32_t*>(qr + c) = packed[0];
    }
  }
  isum = wanq::warp_isum(isum);
  if (lane == 0) {
    s_out[row] = s;
    sum_out[row] = __fmul_rn(s, (float)isum);
  }
}

}  // namespace

// x_bf16: 1 when x is bf16, 0 when f32. channel_scale may be null.
// C must be a multiple of 8 (bf16) or 4 (f32), and x 16-byte aligned.
WANQ_API int wanq_ln_modulate_quant(const void* x, int x_bf16, const void* shift,
                                    const void* scale_mod, const void* channel_scale, void* q,
                                    void* s, void* sum, long long B, long long N, int C,
                                    float eps, void* stream) {
  const long long rows = B * N;
  if (rows == 0) return 0;
  dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    ln_mod_quant_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(shift),
        static_cast<const float*>(scale_mod), static_cast<const float*>(channel_scale),
        static_cast<int8_t*>(q), static_cast<float*>(s), static_cast<float*>(sum), rows,
        (int)N, C, eps);
  } else {
    ln_mod_quant_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(shift),
        static_cast<const float*>(scale_mod), static_cast<const float*>(channel_scale),
        static_cast<int8_t*>(q), static_cast<float*>(s), static_cast<float*>(sum), rows,
        (int)N, C, eps);
  }
  return (int)cudaGetLastError();
}
