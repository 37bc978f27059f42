// K3: RMSNorm over the model dim -> 3D RoPE -> heads-major write.
//
// Replaces the TPU kernels wanq_tpu/ops/rmsnorm_rope.py:62 rms_rope_heads
// (kernel _kernel :31) and, with the rope off, :144 rms_split_heads (kernel
// _rms_split_kernel :135). For x [B, S, H*D] bf16:
//   xn = bf16(x * rsqrt(mean(x^2) + eps) * w)        norm over all H*D channels
//   y  = xn * ca[s] + pairswap(xn) * sb[s]           (rope on; tables f32 [S, D],
//                                                     pre-scaled / identity tail)
//   out[b, h, s, :] = bf16(y)                        [B, H, S, D]
// The TPU kernel swaps adjacent feature pairs with a 128x128 permutation
// matmul; here the pair sits in one thread's registers and the swap is an
// element swap.
//
// Bound on the H100: memory (2 bytes in, 2 bytes out per element, plus the
// rope tables, which L2 serves to every batch row). Design: one warp per
// token row, 16-byte vector loads and stores; pass one reduces the sum of
// squares with warp shuffles, pass two re-reads the row (L1/L2 resident),
// normalizes, rounds to bf16 exactly where the unfused chain does
// (rmsnorm_rope.py:38), applies the rope and writes 16 contiguous bytes of
// one head's row. No shared memory, no block barrier.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
    rms_rope_heads_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ ca, const float* __restrict__ sb,
                          __nv_bfloat16* __restrict__ out, long long rows, int S, int H, int D,
                          float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int C = H * D;
  const long long b = row / S;
  const int s = (int)(row - b * S);
  const __nv_bfloat16* xr = x + row * C;
  float v[8];

  float acc = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    wanq::Vec16<__nv_bfloat16>::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, __fmul_rn(v[i], v[i]));
  }
  const float ms = __fdiv_rn(wanq::warp_sum(acc), (float)C);
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));

  for (int c = lane * 8; c < C; c += 256) {
    wanq::Vec16<__nv_bfloat16>::load(xr + c, v);
    const int h = c / D;
    const int d = c - h * D;
    float xn[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xn[i] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(__fmul_rn(v[i], r), w[c + i])));
    }
    float y[8];
    if (ca != nullptr) {
      const float* car = ca + (long long)s * D + d;
      const float* sbr = sb + (long long)s * D + d;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        y[i] = __fadd_rn(__fmul_rn(xn[i], car[i]), __fmul_rn(xn[i ^ 1], sbr[i]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = xn[i];
    }
    uint4 packed;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) o2[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    __nv_bfloat16* dst = out + (((b * H + h) * (long long)S + s) * D + d);
    *reinterpret_cast<uint4*>(dst) = packed;
  }
}

}  // namespace

// ca/sb null: no rope (rms_split_heads). D must be a multiple of 8.
WANQ_API int wanq_rms_rope_heads(const void* x, const void* w, const void* ca, const void* sb,
                                 void* out, long long B, int S, int H, int D, float eps,
                                 void* stream) {
  const long long rows = B * S;
  if (rows == 0) return 0;
  dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  rms_rope_heads_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(ca), static_cast<const float*>(sb),
      static_cast<__nv_bfloat16*>(out), rows, S, H, D, eps);
  return (int)cudaGetLastError();
}
