// K4: bf16 flash attention forward, head dim 128, non-causal, kv-prefix mask,
// strided operands.
//
// Replaces the TPU kernels that wanq_tpu/models/attention.py drives: the
// splash self-attention (:179 _splash_kernel, :256 _splash_heads_major, with
// the kv-prefix mask :94 kv < valid) and the flash cross-attention
// (:347 cross_attention_heads_major, :464 attention; segment-id kv mask).
//   out[b, s, h, :] = softmax(scale * q[b,h,s,:] . k[b,h,t,:], t < kv_valid) @ v
// q, k, v are read through explicit (batch, head, seq) strides with a
// contiguous head dim, so one kernel reads q heads-major [B,H,S,D] (the K3
// output), v seq-major [B,S,H*D] (the GEMM output -- this is the head split
// the TPU did in a separate pass), and the cross-attention k/v [B,Sk,H,D].
// The output is written seq-major [B,S,H,D], so the head merge before the
// o-projection is a view, not a pass. Pad q rows (>= kv_valid) attend the
// valid prefix like every other row.
//
// Bound on the H100: tensor-core throughput (4*S^2*D flops per head against
// O(S*D) bytes). Design: FlashAttention-2 forward. A block of 4 warps owns
// 64 query rows (16 per warp); K/V tiles of 64 rows stream through a
// 2-stage cp.async double buffer in shared memory (rows padded to 272 bytes:
// conflict-free fragment loads and ldmatrix); S = QK^T and O += PV run on
// bf16 mma.sync m16n8k16 with f32 accumulators; the softmax is online in
// f32 (exp2 with the scale folded in). KV tiles wholly past kv_valid are
// never visited, so a band mask can later skip tiles the same way; a row
// whose running max is still -inf uses 0 as its exponent base, so a fully
// masked tile cannot produce exp(-inf - -inf) = NaN. wgmma/TMA and warp
// specialisation are later work.
#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int BQ = 64, BKV = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = D + 8;  // padded shared row, elements (272 bytes)
constexpr int kTileElems = BKV * kPad;
constexpr int kSmemBytes = (BQ * kPad + 4 * kTileElems) * 2;  // Q + 2 x (K, V)

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, Sq, Sk, kv_valid;
  float scale_log2;
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(wanq::smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// rows x 128 bf16 from global (row stride `rs`, rows clamped to `rmax`) into
// shared rows of kPad elements; 16 chunks of 16 bytes per row.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long rs, int r0, int rmax, int rows, int tid) {
  for (int id = tid; id < rows * 16; id += kThreads) {
    int r = id >> 4, c = (id & 15) * 8;
    int gr = min(r0 + r, rmax);
    wanq::cp_async16(dst + r * kPad + c, src + (long long)gr * rs + c);
  }
}

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  __nv_bfloat16* sQ = sm;
  __nv_bfloat16* sK = sm + BQ * kPad;         // 2 stages
  __nv_bfloat16* sV = sK + 2 * kTileElems;    // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int n_tiles = (p.kv_valid + BKV - 1) / BKV;

  load_rows(sQ, qb, p.q_ss, q0, p.Sq - 1, BQ, tid);
  load_rows(sK, kb, p.k_ss, 0, p.Sk - 1, BKV, tid);
  load_rows(sV, vb, p.v_ss, 0, p.Sk - 1, BKV, tid);
  wanq::cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int st = (t + 1) & 1;
      load_rows(sK + st * kTileElems, kb, p.k_ss, (t + 1) * BKV, p.Sk - 1, BKV, tid);
      load_rows(sV + st * kTileElems, vb, p.v_ss, (t + 1) * BKV, p.Sk - 1, BKV, tid);
      wanq::cp_async_commit();
      wanq::cp_async_wait<1>();
    } else {
      wanq::cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      const __nv_bfloat16* qr = sQ + (warp * 16 + g) * kPad + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(qr + kk * 16);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * kPad + kk * 16);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * kPad + kk * 16 + 8);
      }
    }
    const __nv_bfloat16* cK = sK + (t & 1) * kTileElems;
    const __nv_bfloat16* cV = sV + (t & 1) * kTileElems;

    // S = Q K^T for this warp's 16 rows x 64 kv columns
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const __nv_bfloat16* kr = cK + (j * 8 + g) * kPad + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
    }

    // online softmax (rows g and g + 8 of the warp's 16)
    const int col0 = t * BKV + tig * 2;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + j * 8 + (e & 1);
        float val = s[j][e] * p.scale_log2;
        if (col >= p.kv_valid) val = -INFINITY;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(wanq::kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(wanq::kFull, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      base[r] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[r] = exp2f(m_run[r] - base[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    uint32_t pf[BKV / 16][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = exp2f(s[j][e] - base[e >> 1]);
        l_run[e >> 1] += pe[e];
      }
      // S accumulator layout == A fragment layout of the PV mma
      pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(pe[0], pe[1]);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pe[2], pe[3]);
    }

    // O += P V
    const int mat = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const __nv_bfloat16* vrow = cV + (kk * 16 + (mat & 1) * 8 + mr) * kPad + (mat >> 1) * 8;
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + jd * 16);
        mma_bf16(o[2 * jd], pf[kk], bv[0], bv[1]);
        mma_bf16(o[2 * jd + 1], pf[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(wanq::kFull, l, 1);
    l += __shfl_xor_sync(wanq::kFull, l, 2);
    inv[r] = l > 0.f ? 1.0f / l : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sq = q0 + warp * 16 + g + r * 8;
    if (sq >= p.Sq) continue;
    __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh + sq * p.o_ss + tig * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
    }
  }
}

}  // namespace

// q/k/v/o: bf16, head dim 128 contiguous; strides in elements, multiples of 8.
// 1 <= kv_valid <= Sk.
WANQ_API int wanq_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  long long B, int H, int Sq, int Sk, long long q_sb,
                                  long long q_sh, long long q_ss, long long k_sb,
                                  long long k_sh, long long k_ss, long long v_sb,
                                  long long v_sh, long long v_ss, long long o_sb,
                                  long long o_sh, long long o_ss, int kv_valid, float scale,
                                  void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (kv_valid < 1 || kv_valid > Sk) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.H = H; p.Sq = Sq; p.Sk = Sk; p.kv_valid = kv_valid;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, H, (unsigned)B);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
