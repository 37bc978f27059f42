// K13: the DiT block's gated residual update, in one pass.
//
//   out[b, s, c] = round_to(x.dtype)( f32(x[b, s, c]) + (y[b, s, c] + bias[c]) * gate[b, c] )
//
// x [B, S, C] is the residual stream (bf16 on the shipped configs, f32 on the
// small ones), y [B, S, C] f32 the sub-layer's output (qlinear's f32 on every
// route), gate f32 rows of C (one a sample, or a table of R rows a sample, row
// r serving tokens [r * tpr, (r + 1) * tpr) and the last row the rest: Wan2.2's
// per-frame timesteps, a row a latent frame; batch and row strides of their
// own, so the block passes a view of its [B, (R,) 6, C] modulation) and bias
// f32 [C] each optional; out is a new tensor of x's dtype. A block runs it three times: after self-attention with
// the gate e2, after cross-attention with none, after the ffn with e5; where an
// o projection runs FP, its f32 bias comes here instead of a pass of its own.
//
// Replaces no Pallas kernel: wanq_tpu's gate_residual (wanq_tpu/ops/fused.py:98)
// is left to XLA, which fuses it into one pass on the TPU; the upstream ViDiT-Q
// code fused it by hand (GateResidualQuantFuse). The port ran it as eager
// PyTorch: a cast of x to f32, the product, the sum and the cast back, each a
// pass over device memory, 32 bytes an element (24 without a gate).
//
// Bound on the H100: memory. One pass reads x (2 bytes, bf16) and y (4) and
// writes out (2): 8 bytes an element, 0.24 ms at [2, 32768, 1536] and 0.80 ms at
// [2, 32768, 5120] against 3.35 TB/s. The design streams: each thread takes 8
// consecutive elements of a row (C is a multiple of 8), so x is one 16-byte
// load, y two and out one store, every one coalesced across the warp; two such
// vectors a thread, loaded before either is computed, keep enough bytes in
// flight. x, y and out are touched once, so they load and store with the
// streaming hints (evict first); gate and bias are a few KB that every block
// reads again, through the read-only path, where they stay in L1 / L2.
//
// The bits are the plain chain's (ops/fused.py gate_residual_plain): each step
// is its own IEEE round-to-nearest operation, __fadd_rn for the bias, __fmul_rn
// for the gate, __fadd_rn for the residual, then __float2bfloat16_rn, so nvcc
// cannot contract the product and the sum into one fused multiply-add (which
// would round once and change bits). Without a bias or a gate that step is left
// out, not done with 0 or 1: y + 0 would turn a -0 into +0.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // 8-element vectors a thread, in flight together

// 8 elements of x or out: one 16-byte word (bf16) or two (f32)
template <typename T>
struct Pack {
  static constexpr int kWords = sizeof(T) / 2;
  uint4 w[kWords];
};

template <typename T>
__device__ __forceinline__ void unpack8(const Pack<T>& p, float* f) {
#pragma unroll
  for (int i = 0; i < Pack<T>::kWords; ++i)
    wanq::Vec16<T>::unpack(p.w[i], f + i * wanq::Vec16<T>::N);
}

__device__ __forceinline__ void pack8(const float* f, Pack<__nv_bfloat16>& p) {
  uint32_t* u = reinterpret_cast<uint32_t*>(&p.w[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    u[i] = *reinterpret_cast<uint32_t*>(&h);
  }
}

__device__ __forceinline__ void pack8(const float* f, Pack<float>& p) {
  p.w[0] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  p.w[1] = make_uint4(__float_as_uint(f[4]), __float_as_uint(f[5]), __float_as_uint(f[6]),
                      __float_as_uint(f[7]));
}

__device__ __forceinline__ void load8_f32(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

struct Params {
  const void* x;
  const float* y;
  const float* bias;  // [C] or null
  const float* gate;  // rows of C or null
  void* out;
  long long gate_stride;      // floats between samples' rows
  long long gate_row_stride;  // floats between a sample's rows (a table)
  unsigned n_vecs;      // B * S * C / 8, below 2^31
  unsigned row_vecs;    // C / 8
  unsigned batch_vecs;  // S * C / 8
  unsigned rows, tpr;   // table rows a sample (> 1 with kRows), tokens a row
};

// kRows: the gate is a table of rows; without it, one row a sample (the
// Wan2.1 form, which computes no token index)
template <typename T, bool kBias, bool kGate, bool kRows>
__global__ void __launch_bounds__(kThreads) gate_residual_kernel(Params p) {
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const unsigned first = blockIdx.x * (kThreads * kVecs) + threadIdx.x;
  Pack<T> xr[kVecs];
  float4 ya[kVecs], yb[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const unsigned v = first + i * kThreads;
    if (v < p.n_vecs) {
      const uint4* xs = reinterpret_cast<const uint4*>(x + (size_t)v * 8);
#pragma unroll
      for (int w = 0; w < Pack<T>::kWords; ++w) xr[i].w[w] = __ldcs(xs + w);
      const float4* ys = reinterpret_cast<const float4*>(p.y + (size_t)v * 8);
      ya[i] = __ldcs(ys);
      yb[i] = __ldcs(ys + 1);
    }
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const unsigned v = first + i * kThreads;
    if (v >= p.n_vecs) continue;
    float xf[8];
    unpack8(xr[i], xf);
    float t[8] = {ya[i].x, ya[i].y, ya[i].z, ya[i].w, yb[i].x, yb[i].y, yb[i].z, yb[i].w};
    const unsigned c0 = (v % p.row_vecs) * 8;
    if constexpr (kBias) {
      float bv[8];
      load8_f32(p.bias + c0, bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = __fadd_rn(t[e], bv[e]);
    }
    if constexpr (kGate) {
      float gv[8];
      const unsigned b = v / p.batch_vecs;
      const float* g = p.gate + (long long)b * p.gate_stride + c0;
      if constexpr (kRows) {
        const unsigned tok = (v - b * p.batch_vecs) / p.row_vecs;
        g += (long long)min(tok / p.tpr, p.rows - 1) * p.gate_row_stride;
      }
      load8_f32(g, gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = __fmul_rn(t[e], gv[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) t[e] = __fadd_rn(xf[e], t[e]);
    Pack<T> o;
    pack8(t, o);
    uint4* os = reinterpret_cast<uint4*>(out + (size_t)v * 8);
#pragma unroll
    for (int w = 0; w < Pack<T>::kWords; ++w) __stcs(os + w, o.w[w]);
  }
}

template <typename T>
cudaError_t run(const Params& p, cudaStream_t st) {
  const unsigned blocks = (p.n_vecs + kThreads * kVecs - 1) / (kThreads * kVecs);
  const bool table = p.gate && p.rows > 1;
  if (p.bias && table) {
    gate_residual_kernel<T, true, true, true><<<blocks, kThreads, 0, st>>>(p);
  } else if (table) {
    gate_residual_kernel<T, false, true, true><<<blocks, kThreads, 0, st>>>(p);
  } else if (p.bias && p.gate) {
    gate_residual_kernel<T, true, true, false><<<blocks, kThreads, 0, st>>>(p);
  } else if (p.bias) {
    gate_residual_kernel<T, true, false, false><<<blocks, kThreads, 0, st>>>(p);
  } else if (p.gate) {
    gate_residual_kernel<T, false, true, false><<<blocks, kThreads, 0, st>>>(p);
  } else {
    gate_residual_kernel<T, false, false, false><<<blocks, kThreads, 0, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: [B, S, C] bf16 (x_bf16) or f32; y f32 [B, S, C]; bias f32 [C] or
// null; gate f32 rows of C, or null: `rows` a sample, sample b's row r at b *
// gate_stride + r * gate_row_stride floats (either stride may be 0: a row
// broadcast), row r serving tokens [r * tpr, (r + 1) * tpr), the last the
// rest, (rows - 1) * tpr < S (one row a sample: tpr and gate_row_stride
// unread). Every pointer 16-byte aligned, C a
// multiple of 8 and the strides of 4, B * S * C / 8 below 2^31.
WANQ_API int wanq_gate_residual(const void* x, int x_bf16, const void* y, const void* bias,
                                const void* gate, long long gate_stride,
                                long long gate_row_stride, int rows, long long tpr, void* out,
                                long long batches, long long seq, int C, void* stream) {
  const long long n = batches * seq * (long long)C;
  if (n == 0) return 0;
  if (C <= 0 || C % 8 != 0 || batches < 0 || seq < 0 || n / 8 >= (1LL << 31) || rows < 1 ||
      (gate && (gate_stride < 0 || gate_stride % 4 != 0)) ||
      (gate && rows > 1 && (gate_row_stride < 0 || gate_row_stride % 4 != 0 || tpr < 1 ||
                            (rows - 1) * tpr >= seq)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.y = static_cast<const float*>(y);
  p.bias = static_cast<const float*>(bias);
  p.gate = static_cast<const float*>(gate);
  p.out = out;
  p.gate_stride = gate_stride;
  p.gate_row_stride = gate_row_stride;
  p.rows = gate ? (unsigned)rows : 1u;
  p.tpr = rows > 1 ? (unsigned)tpr : 1u;
  p.n_vecs = (unsigned)(n / 8);
  p.row_vecs = (unsigned)(C / 8);
  p.batch_vecs = (unsigned)(seq * C / 8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? run<__nv_bfloat16>(p, st) : run<float>(p, st));
}
