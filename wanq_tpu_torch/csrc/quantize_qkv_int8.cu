// K10a: the q/k/v int8 producer of the int8 flash attention (K10).
//
// Replaces wanq_tpu/ops/attn_int8.py:52 quantize_qkv_int8, which is plain jnp
// that XLA fuses on the TPU. In plain PyTorch it is about ten elementwise
// passes with f32 copies over three [B, H, S, 128] tensors, and K10 wants v
// transposed anyway, so it is a kernel here.
//   q, k: one scale per (batch, head, 512-token block):
//           scale = max(absmax / 127, 1e-6), code = clip(rint(x / scale), +-127)
//         codes int8 [B, H, S_pad, 128], scales f32 [B, H, S_pad / 512]
//   v:    one scale per (batch, head, channel) over all tokens, same formula;
//         codes int8 TRANSPOSED and k-permuted [B, H, 128, S_pad] (below),
//         scales f32 [B, H, 128]
// S pads to a multiple of 512 with zero rows. The operands are bf16
// [B, S, H, 128] read through (batch, seq, head) strides.
//
// The v layout: K10's second product P[q, kv] . V[kv, d] runs on the int8
// wgmma, which takes K-major operands only, so v is written [d][kv] with kv
// contiguous. Inside each group of 32 kv the bytes are permuted: K10 builds
// its A fragment from the accumulator of the first product without shuffles,
// which puts the actual kv = 8t + 2i + lo (tile t of 8 columns, thread i of
// the quad, lo in {0, 1}) at fragment position 16 (t / 2) + 4 i + 2 (t % 2)
// + lo; v is stored at that position, so K10 reads its tiles as they lie.
// wanq_tpu_torch/ops/attn_int8.py::v_kernel_layout is the same map in
// PyTorch.
//
// Bound on the H100: memory (3 x B*S*H*128 bf16 read, as many int8 written:
// 453 MB at [2, 32768, 12, 128]; v is read twice, the second time mostly
// from L2). Design: max is order-free and the division is __fdiv_rn, so
// scales and codes equal the plain version's exactly. q/k: one block of 512
// threads per (512-token block, head, batch, tensor) keeps its 128 KB tile in
// registers (16 bytes x 16 per thread) between the absmax and the quantize
// pass. v: a partial absmax per 512-token chunk folded with atomicMax on the
// float's bits (non-negative floats order like unsigned ints), then a
// quantize pass that transposes 128 x 128 tiles through shared memory.
#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int BLK = 512;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float quant_scale(float absmax) {
  return fmaxf(__fdiv_rn(absmax, 127.0f), kEps);
}

__device__ __forceinline__ int quant_code(float x, float scale) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.0f), 127.0f);
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

struct Src {
  const __nv_bfloat16* p;
  long long sb, ss, sh;  // element strides of batch, seq, head
};

// q and k: grid (S_pad / 512, H, 2 B); z < B is q, else k.
__global__ void __launch_bounds__(512) qk_quant_kernel(Src q, Src k, int8_t* qi, int8_t* ki,
                                                       float* s_q, float* s_k, int B, int H,
                                                       int S, int S_pad) {
  __shared__ float red[16];
  const bool is_k = (int)blockIdx.z >= B;
  const Src src = is_k ? k : q;
  const int b = is_k ? blockIdx.z - B : blockIdx.z;
  const int h = blockIdx.y, blk = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, l16 = lane & 15;  // 16 lanes cover one 256-byte row

  const __nv_bfloat16* base = src.p + b * src.sb + h * src.sh + l16 * 8;
  uint4 raw[16];
  float amax = 0.f;
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int tok = blk * BLK + it * 32 + warp * 2 + half;
    raw[it] = make_uint4(0u, 0u, 0u, 0u);
    if (tok < S) raw[it] = *reinterpret_cast<const uint4*>(base + (long long)tok * src.ss);
    float f[8];
    unpack8(raw[it], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
  amax = wanq::warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < 16; ++w) amax = fmaxf(amax, red[w]);
  const float scale = quant_scale(amax);
  const long long bh = (long long)b * H + h;
  if (tid == 0) (is_k ? s_k : s_q)[bh * (S_pad / BLK) + blk] = scale;

  int8_t* dst = (is_k ? ki : qi) + bh * S_pad * D + l16 * 8;
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int tok = blk * BLK + it * 32 + warp * 2 + half;
    float f[8];
    unpack8(raw[it], f);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i >> 2] |= (uint32_t)(quant_code(f[i], scale) & 0xFF) << (8 * (i & 3));
    *reinterpret_cast<uint2*>(dst + (long long)tok * D) = make_uint2(w[0], w[1]);
  }
}

// v, pass 1: grid (ceil(S / 512), H, B), 256 threads; thread = (16 rows) x
// (16 groups of 8 channels). absmax bits fold into amax_bits [B, H, 128].
__global__ void __launch_bounds__(256) v_absmax_kernel(Src v, unsigned* amax_bits, int H, int S) {
  __shared__ float red[16][D];
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, cg = tid & 15, rl = tid >> 4;
  const __nv_bfloat16* base = v.p + b * v.sb + h * v.sh + cg * 8;
  float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int t0 = blockIdx.x * BLK;
  for (int r = rl; r < BLK; r += 16) {
    const int tok = t0 + r;
    if (tok >= S) break;
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(base + (long long)tok * v.ss), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = fmaxf(m[i], fabsf(f[i]));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[rl][cg * 8 + i] = m[i];
  __syncthreads();
  if (tid < D) {
    float a = red[0][tid];
#pragma unroll
    for (int r = 1; r < 16; ++r) a = fmaxf(a, red[r][tid]);
    atomicMax(amax_bits + ((long long)b * H + h) * D + tid, __float_as_uint(a));
  }
}

// Position of the actual kv offset a (0..127 in a tile) in the k-permuted
// layout (see the header).
__device__ __forceinline__ int kperm_pos(int a) {
  const int a32 = a & 31, t = a32 >> 3, w = a32 & 7;
  return (a & ~31) + (t >> 1) * 16 + (w >> 1) * 4 + (t & 1) * 2 + (w & 1);
}

// v, pass 2: grid (S_pad / 128, H, B), 256 threads; a 128-token x 128-channel
// tile is quantized, transposed through shared memory and written
// [channel][token] with 16-byte stores.
__global__ void __launch_bounds__(256) v_quant_kernel(Src v, const unsigned* amax_bits,
                                                      int8_t* vt, float* s_v, int H, int S,
                                                      int S_pad) {
  constexpr int kRow = 128 + 16;
  __shared__ __align__(16) int8_t tile[D * kRow];
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, cg = tid & 15, rl = tid >> 4;
  const long long bh = (long long)b * H + h;
  float scale[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) scale[i] = quant_scale(__uint_as_float(amax_bits[bh * D + cg * 8 + i]));
  if (blockIdx.x == 0 && rl == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s_v[bh * D + cg * 8 + i] = scale[i];
  }
  const __nv_bfloat16* base = v.p + b * v.sb + h * v.sh + cg * 8;
  const int t0 = blockIdx.x * 128;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int r = it * 16 + rl, tok = t0 + r;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (tok < S) unpack8(*reinterpret_cast<const uint4*>(base + (long long)tok * v.ss), f);
    const int pos = kperm_pos(r);
#pragma unroll
    for (int i = 0; i < 8; ++i) tile[(cg * 8 + i) * kRow + pos] = (int8_t)quant_code(f[i], scale[i]);
  }
  __syncthreads();
  int8_t* dst = vt + bh * D * S_pad + t0;
  for (int id = tid; id < D * 8; id += 256) {
    const int row = id >> 3, ch = (id & 7) * 16;
    *reinterpret_cast<uint4*>(dst + (long long)row * S_pad + ch) =
        *reinterpret_cast<const uint4*>(tile + row * kRow + ch);
  }
}

}  // namespace

// q, k, v: bf16, head dim 128 contiguous, strides in elements and multiples
// of 8, bases 16-byte aligned. qi/ki [B,H,S_pad,128], vt [B,H,128,S_pad],
// s_q/s_k [B,H,S_pad/512], s_v [B,H,128], amax_scratch [B,H,128] (4 bytes
// each, any content). S_pad is S rounded up to a multiple of 512.
WANQ_API int wanq_quantize_qkv_int8(const void* q, const void* k, const void* v, long long q_sb,
                                    long long q_ss, long long q_sh, long long k_sb,
                                    long long k_ss, long long k_sh, long long v_sb,
                                    long long v_ss, long long v_sh, void* qi, void* ki, void* vt,
                                    void* s_q, void* s_k, void* s_v, void* amax_scratch,
                                    long long B, int H, int S, int S_pad, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (S_pad % BLK || S_pad < S || 2 * B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Src qs{static_cast<const __nv_bfloat16*>(q), q_sb, q_ss, q_sh};
  const Src ks{static_cast<const __nv_bfloat16*>(k), k_sb, k_ss, k_sh};
  const Src vs{static_cast<const __nv_bfloat16*>(v), v_sb, v_ss, v_sh};
  cudaError_t e = cudaMemsetAsync(amax_scratch, 0, (size_t)B * H * D * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  qk_quant_kernel<<<dim3(S_pad / BLK, H, (unsigned)(2 * B)), 512, 0, st>>>(
      qs, ks, static_cast<int8_t*>(qi), static_cast<int8_t*>(ki), static_cast<float*>(s_q),
      static_cast<float*>(s_k), (int)B, H, S, S_pad);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  v_absmax_kernel<<<dim3((S + BLK - 1) / BLK, H, (unsigned)B), 256, 0, st>>>(
      vs, static_cast<unsigned*>(amax_scratch), H, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  v_quant_kernel<<<dim3(S_pad / 128, H, (unsigned)B), 256, 0, st>>>(
      vs, static_cast<const unsigned*>(amax_scratch), static_cast<int8_t*>(vt),
      static_cast<float*>(s_v), H, S, S_pad);
  return (int)cudaGetLastError();
}
