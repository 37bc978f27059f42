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
// Bound on the H100: the int8 tensor cores by the operation count (4 S^2 128
// per head against O(S 128) bytes); in practice the ordinary instructions
// that turn a score into a rounded prob (thirteen per score, eight of them
// expf) cost more instruction slots than the MMAs. Design, on K4's skeleton (sm90.cuh): a block
// owns 128 query rows and has three warpgroups. One thread of the producer
// warpgroup streams 128-key tiles through TMA into two rings of 16 KB
// stages, K tiles [128 keys, 128 B] and v^T tiles [128 channels, 128 keys],
// each row one 128-byte swizzle span; two consumer warpgroups own 64 query
// rows each and run both products on wgmma m64n128k32.s8, which takes
// K-major operands only: Q and K from shared memory, P from registers and v^T
// as the producer stores it. Per 512-key block the first product runs TWICE:
// a max pass that only tracks the row maximum of the int32 scores (f32(x) *
// scale is monotonic in x, so the integer maximum gives the f32 one), then a
// p pass that recomputes each tile, rounds p to int8 and feeds the second
// product. Recomputing costs 1.5x the MMA work, which on this card is cheaper
// than holding the 64 x 512 int32 strip of a warpgroup (128 KB) in shared
// memory; the K tiles of the p pass come from L2 again. Inside the p pass the
// second product of tile t - 1 runs under the probs of tile t. The S accumulator
// becomes the A fragment of the second product without shuffles: a thread
// packs its columns {2i, 2i+1} of two neighbouring 8-column tiles into one
// register, which permutes kv inside each 32-deep step; the producer stores v
// with the same permutation, and the order of k inside a dot product is free.
// The int32 sum of one block (<= 512 * 127 * 127 < 2^24) stays in int32
// accumulators across the block and joins the f32 accumulator once per block,
// as on the TPU; that f32 accumulator is touched once per block, so it lives
// in shared memory (each thread its own 64 words) and leaves the registers to
// the two products. exp is expf (not __expf), products and sums use _rn
// intrinsics so no FMA contraction changes a rounding of a score; rint(127 p)
// is one fma with 1.5 * 2^23, which rounds to nearest-even like rintf and
// leaves the code in the low byte (against rint of the rounded product it
// differs only where 127 p lies within 2^-24 of a tie); what remains against
// the plain version is that, the order of the f32 sum of p and the last bit
// of exp, each of which flips a p_int by one step on rare elements. kv tiles
// wholly past kv_len are never visited (they add p = 0 exactly).
#include <climits>

#include "sm90.cuh"

namespace {

using namespace wanq::sm90;

constexpr int D = 128;
constexpr int BQ = 128;
constexpr int BLK = 512;
constexpr int TK = 128;                 // keys per tile
constexpr int kKStages = 4, kVStages = 3;
constexpr int kThreads = 384;           // producer warpgroup + 2 consumer warpgroups
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * 24 + 256 * 240 <= 65536
constexpr int kTile = 128 * 128;        // one int8 tile: 16 KB
constexpr int kAccBytes = 64 * 256 * 4; // the f32 accumulators of 256 consumer threads
constexpr int kBarBytes = 256;
constexpr int kSmemBytes = 1024 + kTile * (1 + kKStages + kVStages) + kAccBytes + kBarBytes;
constexpr float kNegInf = -1e30f;
constexpr float kLevels = 127.0f;
constexpr float kRoundMagic = 12582912.0f;  // 1.5 * 2^23

struct Params {
  CUtensorMap q, k, vt;
  const float* s_q;
  const float* s_k;
  const float* s_v;
  float* o;
  long long o_sb, o_ss, o_sh;
  int H, Sq, Sk, kv_len;
  float sm_scale;
};

struct Bars {
  uint64_t q_full;
  uint64_t k_full[kKStages], k_empty[kKStages];
  uint64_t v_full[kVStages], v_empty[kVStages];
};
static_assert(sizeof(Bars) <= kBarBytes, "barrier block");

__global__ void __launch_bounds__(kThreads, 1) attn_int8_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (wanq::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + kTile;
  uint8_t* sV = sK + kKStages * kTile;
  float* sAcc = reinterpret_cast<float*>(sV + kVStages * kTile);
  Bars* bars = reinterpret_cast<Bars*>(reinterpret_cast<uint8_t*>(sAcc) + kAccBytes);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.H + h;
  const int n_blocks = (p.kv_len + BLK - 1) / BLK;

  if (tid == 0) {
    mbar_init(&bars->q_full, 1);
#pragma unroll
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&bars->k_full[s], 1);
      mbar_init(&bars->k_empty[s], 8);  // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&bars->v_full[s], 1);
      mbar_init(&bars->v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: per block K x nt (max pass), then (K, v^T) x nt (p pass) ----
    reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      prefetch_tensormap(&p.q);
      prefetch_tensormap(&p.k);
      prefetch_tensormap(&p.vt);
      mbar_expect_tx(&bars->q_full, kTile);
      tma_load_2d(sQ, &p.q, &bars->q_full, 0, bh * p.Sq + q0);
      Ring<kKStages> kr;
      Ring<kVStages> vr;
      for (int ib = 0; ib < n_blocks; ++ib) {
        const int base = ib * BLK;
        const int nt = min(BLK / TK, (p.kv_len - base + TK - 1) / TK);
        for (int pass = 0; pass < 2; ++pass) {
          for (int t = 0; t < nt; ++t) {
            mbar_wait(&bars->k_empty[kr.stage], kr.phase ^ 1);
            mbar_expect_tx(&bars->k_full[kr.stage], kTile);
            tma_load_2d(sK + kr.stage * kTile, &p.k, &bars->k_full[kr.stage], 0,
                        bh * p.Sk + base + t * TK);
            kr.advance();
            if (pass == 1) {
              mbar_wait(&bars->v_empty[vr.stage], vr.phase ^ 1);
              mbar_expect_tx(&bars->v_full[vr.stage], kTile);
              tma_load_2d(sV + vr.stage * kTile, &p.vt, &bars->v_full[vr.stage], base + t * TK,
                          bh * D);
              vr.advance();
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int g = lane >> 2, tig = lane & 3;
    const uint64_t q_desc = kmajor_desc(wanq::smem_addr(sQ) + cw * 64 * 128);
    const uint64_t k_desc0 = kmajor_desc(wanq::smem_addr(sK));
    const uint64_t v_desc0 = kmajor_desc(wanq::smem_addr(sV));
    float* acc = sAcc + (tid - 128);  // word i of this thread at acc[256 i]: conflict-free
    const float sq = p.s_q[(long long)bh * (p.Sq / BLK) + q0 / BLK];
    const float* s_k = p.s_k + (long long)bh * (p.Sk / BLK);

    int s[64], pv[64];
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[256 * i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    Ring<kKStages> kr;
    Ring<kVStages> vr;

    // Starts S = Q K^T for the next K tile of the ring as one wgmma group.
    auto start_scores = [&]() {
      mbar_wait(&bars->k_full[kr.stage], kr.phase);
      const uint64_t k_desc = desc_advance(k_desc0, kr.stage * kTile);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 32; ++ks)
        wgmma_s8_ss(s, desc_advance(q_desc, ks * 32), desc_advance(k_desc, ks * 32), ks > 0);
      wgmma_commit();
    };
    // After the wait that completed it: S may be read, the K stage is free.
    auto scores_done = [&]() {
      fence_regs(s);
      if (lane == 0) mbar_arrive(&bars->k_empty[kr.stage]);
      kr.advance();
    };
    // Starts pv (+)= P v^T for the next v^T tile of the ring as one wgmma group.
    auto start_pv = [&](bool first) {
      mbar_wait(&bars->v_full[vr.stage], vr.phase);
      const uint64_t v_desc = desc_advance(v_desc0, vr.stage * kTile);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TK / 32; ++ks)
        wgmma_s8_rs(pv, pa[4 * ks], pa[4 * ks + 1], pa[4 * ks + 2], pa[4 * ks + 3],
                    desc_advance(v_desc, ks * 32), !first || (ks > 0));
      wgmma_commit();
    };
    auto pv_done = [&]() {
      fence_regs(pv);
      if (lane == 0) mbar_arrive(&bars->v_empty[vr.stage]);
      vr.advance();
    };
    // Scores of one tile -> rint(127 p) in the low byte of each s[i]: the sum
    // with 1.5 * 2^23 rounds to nearest-even like rintf. Only the block's last
    // visited tile can be partial, and only it pays for the mask.
    auto probs = [&](int col0, float scale, const float (&m_new)[2]) {
      if (col0 - tig * 2 + TK > p.kv_len) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          float pe = expf(__fsub_rn(__fmul_rn((float)s[i], scale), m_new[r]));
          if (col0 + (i >> 2) * 8 + (i & 1) >= p.kv_len) pe = 0.f;
          l_run[r] = __fadd_rn(l_run[r], pe);
          s[i] = __float_as_int(__fmaf_rn(pe, kLevels, kRoundMagic));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          const float pe = expf(__fsub_rn(__fmul_rn((float)s[i], scale), m_new[r]));
          l_run[r] = __fadd_rn(l_run[r], pe);
          s[i] = __float_as_int(__fmaf_rn(pe, kLevels, kRoundMagic));
        }
      }
    };
    // A fragments: k step ks takes column tiles 4 ks .. 4 ks + 3; register
    // 2 hh + r holds row g + 8 r of tiles 4 ks + 2 hh and 4 ks + 2 hh + 1.
    auto pack = [&]() {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i0 = 4 * (4 * ks + 2 * hh) + 2 * r, i1 = i0 + 4;
            const uint32_t lo = __byte_perm(s[i0], s[i0 + 1], 0x0040);
            const uint32_t hi = __byte_perm(s[i1], s[i1 + 1], 0x0040);
            pa[4 * ks + 2 * hh + r] = __byte_perm(lo, hi, 0x5410);
          }
    };

    mbar_wait(&bars->q_full, 0);
    for (int ib = 0; ib < n_blocks; ++ib) {
      const int base = ib * BLK;
      const int nt = min(BLK / TK, (p.kv_len - base + TK - 1) / TK);
      const float scale = __fmul_rn(__fmul_rn(sq, s_k[ib]), p.sm_scale);

      // max pass
      int imax[2] = {INT_MIN, INT_MIN};
      for (int t = 0; t < nt; ++t) {
        start_scores();
        wgmma_wait<0>();
        scores_done();
        const int col0 = base + t * TK + tig * 2;
        if (col0 - tig * 2 + TK > p.kv_len) {  // the partial tile
#pragma unroll
          for (int i = 0; i < 64; ++i)
            if (col0 + (i >> 2) * 8 + (i & 1) < p.kv_len)
              imax[(i >> 1) & 1] = max(imax[(i >> 1) & 1], s[i]);
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) imax[(i >> 1) & 1] = max(imax[(i >> 1) & 1], s[i]);
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

      // p pass: the second product of tile t - 1 runs under the probs of tile t
      start_scores();
      wgmma_wait<0>();
      scores_done();
      probs(base + tig * 2, scale, m_new);
      pack();
      for (int t = 1; t < nt; ++t) {
        start_scores();
        start_pv(t == 1);
        wgmma_wait<1>();  // S of tile t is there; pv of tile t - 1 still runs
        scores_done();
        probs(base + t * TK + tig * 2, scale, m_new);
        wgmma_wait<0>();
        pv_done();
        pack();
      }
      start_pv(nt == 1);
      wgmma_wait<0>();
      pv_done();

      // acc = acc * alpha + pv, once per 512-block
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[256 * i] = __fadd_rn(__fmul_rn(acc[256 * i], alpha[(i >> 1) & 1]), (float)pv[i]);
    }

    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(wanq::kFull, l, 1);
      l += __shfl_xor_sync(wanq::kFull, l, 2);
      denom[r] = __fmul_rn(kLevels, fmaxf(l, 1e-6f));
    }
    const float* sv = p.s_v + (long long)bh * D + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + cw * 64 + warp * 16 + g + r * 8;
      float* orow = p.o + b * p.o_sb + (long long)row * p.o_ss + h * p.o_sh + tig * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(sv + j * 8);
        float2 o2;
        o2.x = __fmul_rn(__fdiv_rn(acc[256 * (4 * j + 2 * r)], denom[r]), s2.x);
        o2.y = __fmul_rn(__fdiv_rn(acc[256 * (4 * j + 2 * r + 1)], denom[r]), s2.y);
        *reinterpret_cast<float2*>(orow + j * 8) = o2;
      }
    }
  }
}

// A 2-D map over int8 [rows, cols] (cols contiguous) with [128, 128] boxes.
bool make_map(CUtensorMap* map, const void* base, long long rows, long long cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128, 128};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box);
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
  if (Sq % BLK || Sk % BLK || kv_len < 1 || kv_len > Sk || B > 65535 || H > 65535 ||
      B * H * (long long)max(Sq, Sk) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Params p;
  if (!make_map(&p.q, q, B * H * Sq, D) || !make_map(&p.k, k, B * H * Sk, D) ||
      !make_map(&p.vt, vt, B * H * D, Sk))
    return (int)cudaErrorInvalidValue;
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
