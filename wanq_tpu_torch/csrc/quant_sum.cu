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
// Bound on the H100: memory. Per element it reads 2 bytes (bf16 x) and
// writes 1, with a tanh and an IEEE division -- far under the card's
// balance point (~1.76 GB moved per ffn.2 call at [65536, 8960]: ~0.53 ms
// at 3.35 TB/s). Rows are long (8960 bf16 = 17.5 KB at ffn.2), so one
// block of 256 threads owns one row, which device memory delivers once:
// the first pass reads it with 16-byte loads, computes y (GELU once per
// element) and keeps it in shared memory as f32 (35 KB at C = 8960), the
// block max gives the scale, and the second pass quantizes from shared
// memory. Each thread re-reads only the values it wrote, so the only block
// barriers are those of the two reductions. Rounding follows the
// reference: y / s is a true IEEE division (no reciprocal), rint rounds
// half to even, the channel scale and the sum use _rn intrinsics; the GELU
// is written as torch's own CUDA kernel writes it, so nvcc contracts it the
// same way.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_sum_kernel(const T* __restrict__ x, int gelu, const float* __restrict__ channel_scale,
                     int8_t* __restrict__ q, float* __restrict__ s_out,
                     float* __restrict__ sum_out, int C) {
  extern __shared__ __align__(16) float ys[];  // the row's y, f32 [C]
  __shared__ float red_max[kWarps];
  __shared__ int red_sum[kWarps];
  using V = wanq::Vec16<T>;
  constexpr int VN = V::N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x;
  const T* xr = x + row * C;

  float amax = 0.f;
  for (int c = threadIdx.x * VN; c < C; c += kThreads * VN) {
    float v[VN];
    V::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      float y = gelu ? wanq::gelu_tanh(v[i]) : v[i];
      if (channel_scale) y = __fmul_rn(y, channel_scale[c + i]);
      v[i] = y;
      amax = fmaxf(amax, fabsf(y));
    }
#pragma unroll
    for (int i = 0; i < VN; i += 4)
      *reinterpret_cast<float4*>(ys + c + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
  amax = wanq::warp_max(amax);
  if (lane == 0) red_max[warp] = amax;
  __syncthreads();
  amax = red_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, red_max[w]);
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-6f);

  int isum = 0;
  int8_t* qr = q + row * C;
  for (int c = threadIdx.x * VN; c < C; c += kThreads * VN) {
    uint32_t packed[VN / 4] = {};
#pragma unroll
    for (int i4 = 0; i4 < VN; i4 += 4) {
      const float4 y4 = *reinterpret_cast<const float4*>(ys + c + i4);
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = (int)fminf(fmaxf(rintf(__fdiv_rn(y[i], s)), -128.f), 127.f);
        isum += qi;
        packed[i4 >> 2] |= (uint32_t)(uint8_t)(int8_t)qi << (8 * i);
      }
    }
    if constexpr (VN == 8) {
      *reinterpret_cast<uint2*>(qr + c) = make_uint2(packed[0], packed[1]);
    } else {
      *reinterpret_cast<uint32_t*>(qr + c) = packed[0];
    }
  }
  isum = wanq::warp_isum(isum);
  if (lane == 0) red_sum[warp] = isum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red_sum[w];
    s_out[row] = s;
    sum_out[row] = __fmul_rn(s, (float)total);
  }
}

template <typename T>
int launch(const void* x, int gelu, const void* channel_scale, void* q, void* s, void* sum,
           long long rows, int C, cudaStream_t st) {
  const size_t smem = (size_t)C * sizeof(float);
  auto kern = quant_sum_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(unsigned)rows, kThreads, smem, st>>>(
      static_cast<const T*>(x), gelu, static_cast<const float*>(channel_scale),
      static_cast<int8_t*>(q), static_cast<float*>(s), static_cast<float*>(sum), C);
  return (int)cudaGetLastError();
}

}  // namespace

// x_bf16: 1 when x is bf16, 0 when f32; gelu: 1 for tanh-GELU first.
// channel_scale [C] f32 may be null. C must be a multiple of 8 (bf16) or
// 4 (f32) and at most 56K (the row lives in shared memory); x 16-byte
// aligned.
WANQ_API int wanq_quant_sum(const void* x, int x_bf16, int gelu, const void* channel_scale,
                            void* q, void* s, void* sum, long long rows, int C, void* stream) {
  if (rows == 0) return 0;
  if (C <= 0 || C % (x_bf16 ? 8 : 4) != 0 || (size_t)C * sizeof(float) > 227 * 1024 ||
      rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, gelu, channel_scale, q, s, sum, rows, C, st)
                : launch<float>(x, gelu, channel_scale, q, s, sum, rows, C, st);
}
