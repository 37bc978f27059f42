// K10: int8 flash attention forward, head dim 128, non-causal, kv-prefix mask.
//
// Replaces wanq_tpu/ops/attn_int8.py:181 attention_int8_pallas (kernel
// _flash_int8_kernel :122). For each (batch, head, query row), over kv blocks
// of 512 columns, in the TPU kernel's order:
//   s      = f32(q_int . k_int) * (s_q[b,h,iq] * s_k[b,h,ik] * sm_scale)
//            columns >= kv_len get -1e30
//   m_new  = max(m, rowmax(s));  alpha = exp(m - m_new);  p = exp(s - m_new)
//   l      = l * alpha + sum(p)
//   p_int  = rint(127 p)                          (the 127-level map quant)
//   acc    = acc * alpha + f32(p_int . v_int)     (the int32 sum is exact)
//   out    = acc / (127 max(l, 1e-6)) * s_v[b,h,:]
// The running max moves once per 512-wide block, and p_int is rounded
// against that value: the rounding grid is part of the function, so the
// kernel keeps the 512-block definition whatever its own tile sizes are.
//
// Operands (the K10a producer's outputs): q_int, k_int int8 [B,H,S,128];
// v_int int8 transposed and k-permuted [B,H,128,S] (quantize_qkv_int8.cu
// explains the layout); s_q, s_k f32 [B,H,S/512]; s_v f32 [B,H,128]. The
// output is f32, written seq-major [B,S,H,128] through strides, so the head
// merge before the o-projection is a view.
//
// Bound on the H100: the int8 tensor cores (4 S^2 128 operations per head
// against O(S 128) bytes). Design: a block of 8 warps owns 128 query rows
// (16 per warp) with its q fragments in registers. Per 512-kv block it runs
// the first product TWICE on mma.sync.m16n8k32.s8: a max pass that only
// tracks the row maximum of the int32 scores (f32(x) * scale is monotonic in
// x, so the integer maximum gives the f32 one), then a p pass that recomputes
// 32 columns at a time, rounds p to int8 and feeds the second product. That
// is 1.5x the MMA work of a one-pass kernel, taken because the alternative,
// holding the 128 x 512 score strip, does not fit beside the operands; the
// redesign on wgmma is later work. The C fragment of the first product
// becomes the A fragment of the second without shuffles: a thread packs its
// columns {2i, 2i+1} of two neighbouring 8-column tiles into one register,
// which permutes kv inside each 32-deep step; the producer stores v with the
// same permutation, and the order of k inside a dot product is free. The
// int32 sum of one block (<= 512 * 127 * 127 < 2^24) stays in int32
// accumulators across the block and joins the f32 accumulator once per
// block, as on the TPU. exp is expf (not __expf), products and sums use _rn
// intrinsics so no FMA contraction changes a rounding; what remains against
// the plain version is the order of the f32 sum of p and the last bit of
// exp, which flips a p_int by one step on rare elements.
// Shared memory: two whole k blocks (512 rows padded to 144 bytes, double
// buffered with cp.async: the next block loads during the max pass) and two
// stages of 64-kv v tiles (128 rows padded to 80 bytes); both paddings make
// the 32-bit fragment loads conflict-free. 164 KB, one block per SM. kv
// blocks wholly past kv_len are never visited (they add p = 0 exactly).
#include <climits>

#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int BQ = 128;
constexpr int BLK = 512;
constexpr int SUB = 64;  // kv columns per v stage
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKRow = D + 16;    // 144 bytes
constexpr int kVRow = SUB + 16;  // 80 bytes
constexpr int kKBuf = BLK * kKRow;
constexpr int kVBuf = D * kVRow;
constexpr int kSmemBytes = 2 * kKBuf + 2 * kVBuf;
constexpr float kNegInf = -1e30f;
constexpr float kLevels = 127.0f;

struct Params {
  const int8_t* q;
  const int8_t* k;
  const int8_t* vt;
  const float* s_q;
  const float* s_k;
  const float* s_v;
  float* o;
  long long o_sb, o_ss, o_sh;
  int H, Sq, Sk, kv_len;
  float sm_scale;
};

// One k block: 512 rows x 128 bytes -> padded shared rows.
__device__ __forceinline__ void load_k_block(int8_t* dst, const int8_t* src, int tid) {
  for (int id = tid; id < BLK * 8; id += kThreads) {
    const int r = id >> 3, c = (id & 7) * 16;
    wanq::cp_async16(dst + r * kKRow + c, src + (long long)r * D + c);
  }
}

// One v stage: 128 channel rows x 64 kv bytes (row stride Sk in global).
__device__ __forceinline__ void load_v_stage(int8_t* dst, const int8_t* src, int Sk, int tid) {
  for (int id = tid; id < D * 4; id += kThreads) {
    const int r = id >> 2, c = (id & 3) * 16;
    wanq::cp_async16(dst + r * kVRow + c, src + (long long)r * Sk + c);
  }
}

// Scores of the warp's 16 rows against 32 kv rows starting at `kr0` of the
// shared k block: 4 tiles of 8 columns.
__device__ __forceinline__ void scores32(int (&s)[4][4], const uint32_t (&qf)[4][4],
                                         const int8_t* kb, int kr0, int g, int tig) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0;
    const int8_t* kr = kb + (kr0 + nt * 8 + g) * kKRow + tig * 4;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t bf[2];
      bf[0] = *reinterpret_cast<const uint32_t*>(kr + ks * 32);
      bf[1] = *reinterpret_cast<const uint32_t*>(kr + ks * 32 + 16);
      wanq::mma_s8(s[nt], qf[ks], bf);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) attn_int8_kernel(const Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sK = smem;               // 2 whole k blocks
  int8_t* sV = smem + 2 * kKBuf;   // 2 stages of 64 kv

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * p.H + h;
  const int iq = q0 / BLK;
  const int nkb_all = p.Sk / BLK;
  const int n_blocks = (p.kv_len + BLK - 1) / BLK;

  const int8_t* kbase = p.k + bh * p.Sk * D;
  const int8_t* vbase = p.vt + bh * D * p.Sk;

  load_k_block(sK, kbase, tid);
  wanq::cp_async_commit();

  uint32_t qf[4][4];
  {
    const int8_t* qr = p.q + (bh * p.Sq + q0 + warp * 16 + g) * D + tig * 4;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(qr + ks * 32);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * D + ks * 32);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(qr + ks * 32 + 16);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * D + ks * 32 + 16);
    }
  }
  const float sq = p.s_q[bh * (p.Sq / BLK) + iq];

  float acc[D / 8][4];
  int pv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = 0.f;
      pv[j][e] = 0;
    }
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int ib = 0; ib < n_blocks; ++ib) {
    const int8_t* cK = sK + (ib & 1) * kKBuf;
    const int base = ib * BLK;
    const bool partial = base + BLK > p.kv_len;
    // v stage 0 of this block, then the next k block; then wait for this k block
    load_v_stage(sV, vbase + base, p.Sk, tid);
    wanq::cp_async_commit();
    if (ib + 1 < n_blocks)
      load_k_block(sK + ((ib + 1) & 1) * kKBuf, kbase + (long long)(base + BLK) * D, tid);
    wanq::cp_async_commit();
    wanq::cp_async_wait<2>();
    __syncthreads();

    const float scale = __fmul_rn(__fmul_rn(sq, p.s_k[bh * nkb_all + ib]), p.sm_scale);

    // max pass over the block's 512 columns
    int imax[2] = {INT_MIN, INT_MIN};
#pragma unroll 1
    for (int c = 0; c < BLK / 32; ++c) {
      int s[4][4];
      scores32(s, qf, cK, c * 32, g, tig);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = base + c * 32 + nt * 8 + tig * 2 + (e & 1);
          if (!partial || col < p.kv_len) imax[e >> 1] = max(imax[e >> 1], s[nt][e]);
        }
    }
    float alpha[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      imax[r] = max(imax[r], __shfl_xor_sync(wanq::kFull, imax[r], 1));
      imax[r] = max(imax[r], __shfl_xor_sync(wanq::kFull, imax[r], 2));
      const float m_blk = imax[r] == INT_MIN ? kNegInf : __fmul_rn((float)imax[r], scale);
      m_new[r] = fmaxf(m_run[r], m_blk);
      alpha[r] = expf(__fsub_rn(m_run[r], m_new[r]));
      m_run[r] = m_new[r];
      l_run[r] = __fmul_rn(l_run[r], alpha[r]);
    }

    // p pass: 8 v stages of 64 kv, two 32-column groups each
#pragma unroll 1
    for (int j = 0; j < BLK / SUB; ++j) {
      if (j + 1 < BLK / SUB)
        load_v_stage(sV + ((j + 1) & 1) * kVBuf, vbase + base + (j + 1) * SUB, p.Sk, tid);
      wanq::cp_async_commit();
      wanq::cp_async_wait<1>();
      __syncthreads();
      const int8_t* cV = sV + (j & 1) * kVBuf;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = j * SUB + half * 32;
        int s[4][4];
        scores32(s, qf, cK, c0, g, tig);
        uint32_t pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = base + c0 + nt * 8 + tig * 2 + (e & 1);
            const int r = e >> 1;
            float pe = 0.f;
            if (!partial || col < p.kv_len)
              pe = expf(__fsub_rn(__fmul_rn((float)s[nt][e], scale), m_new[r]));
            l_run[r] = __fadd_rn(l_run[r], pe);
            const uint32_t pi = (uint32_t)(int)rintf(__fmul_rn(pe, kLevels));
            // a0/a1: tiles 0, 1 (rows g / g + 8); a2/a3: tiles 2, 3
            pa[(nt >> 1) * 2 + r] |= pi << (8 * ((nt & 1) * 2 + (e & 1)));
          }
        const int8_t* vr = cV + g * kVRow + half * 32 + tig * 4;
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd) {
          uint32_t bf[2];
          bf[0] = *reinterpret_cast<const uint32_t*>(vr + jd * 8 * kVRow);
          bf[1] = *reinterpret_cast<const uint32_t*>(vr + jd * 8 * kVRow + 16);
          wanq::mma_s8(pv[jd], pa, bf);
        }
      }
      __syncthreads();
    }

    // acc = acc * alpha + pv, once per 512-block
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[jd][e] = __fadd_rn(__fmul_rn(acc[jd][e], alpha[e >> 1]), (float)pv[jd][e]);
        pv[jd][e] = 0;
      }
  }
  wanq::cp_async_wait<0>();

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(wanq::kFull, l, 1);
    l += __shfl_xor_sync(wanq::kFull, l, 2);
    denom[r] = __fmul_rn(kLevels, fmaxf(l, 1e-6f));
  }
  const float* sv = p.s_v + bh * D + tig * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    float* orow = p.o + b * p.o_sb + (long long)row * p.o_ss + h * p.o_sh + tig * 2;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const float2 s2 = *reinterpret_cast<const float2*>(sv + jd * 8);
      float2 o2;
      o2.x = __fmul_rn(__fdiv_rn(acc[jd][2 * r], denom[r]), s2.x);
      o2.y = __fmul_rn(__fdiv_rn(acc[jd][2 * r + 1], denom[r]), s2.y);
      *reinterpret_cast<float2*>(orow + jd * 8) = o2;
    }
  }
}

}  // namespace

// q, k int8 [B,H,Sq|Sk,128] and vt int8 [B,H,128,Sk] contiguous, 16-byte
// aligned; Sq and Sk multiples of 512; s_q [B,H,Sq/512], s_k [B,H,Sk/512],
// s_v [B,H,128] f32; 1 <= kv_len <= Sk. out f32 with element strides of
// batch, seq and head (multiples of 2) and a contiguous head dim.
WANQ_API int wanq_attention_int8(const void* q, const void* k, const void* vt, const void* s_q,
                                 const void* s_k, const void* s_v, void* out, long long B, int H,
                                 int Sq, int Sk, int kv_len, float sm_scale, long long o_sb,
                                 long long o_ss, long long o_sh, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Sq % BLK || Sk % BLK || kv_len < 1 || kv_len > Sk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.vt = static_cast<const int8_t*>(vt);
  p.s_q = static_cast<const float*>(s_q);
  p.s_k = static_cast<const float*>(s_k);
  p.s_v = static_cast<const float*>(s_v);
  p.o = static_cast<float*>(out);
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.H = H; p.Sq = Sq; p.Sk = Sk; p.kv_len = kv_len;
  p.sm_scale = sm_scale;
  cudaError_t e = cudaFuncSetAttribute(attn_int8_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Sq / BQ, H, (unsigned)B);
  attn_int8_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
