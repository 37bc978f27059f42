// K4: bf16 flash attention forward, head dim 128, non-causal, kv-prefix mask
// or temporal band, strided operands.
//
// Replaces the TPU kernels that wanq_tpu/models/attention.py drives: the
// splash self-attention (:179 _splash_kernel, :256 _splash_heads_major, with
// the kv-prefix mask :94 kv < valid, or the temporal band mask :132) and the
// flash cross-attention (:347 cross_attention_heads_major, :464 attention;
// segment-id kv mask).
//   out[b, s, h, :] = softmax(scale * q[b,h,s,:] . k[b,h,t,:], t in band(s)) @ v
// Dense mode: band(s) = [0, kv_valid). Band mode (tokens_per_frame tpf > 0, a
// radius r_h per head): band(s) = the columns of frames s/tpf - r_h ..
// s/tpf + r_h inside [0, kv_valid), and [0, kv_valid) for a pad row s >=
// kv_valid, so no softmax row is empty (splash's pad_rows term).
// q, k, v are read through (batch, head, seq) byte strides with a contiguous
// head dim, so one kernel reads q heads-major [B,H,S,D] (the K3 output), v
// seq-major [B,S,H*D] (the GEMM output -- this is the head split the TPU did
// in a separate pass), and the cross-attention k/v [B,Sk,H,D]. The output is
// written seq-major [B,S,H,D], so the head merge before the o-projection is a
// view, not a pass. Pad q rows (>= kv_valid) attend the valid prefix like
// every other row.
//
// Bound on the H100: tensor-core throughput (4*S^2*D flops per head against
// O(S*D) bytes). Design (sm90.cuh has the parts): a block owns 128 query
// rows and has three warpgroups. One thread of the producer warpgroup loads Q
// once and then K and V tiles of 128 keys through TMA into two-stage rings
// (K and V have their own full/empty mbarriers, so the next K tile lands
// while V is still read); each operand has one 4-D tensor map (d, seq, head,
// batch) built per launch from the strides, and a [rows, 128] bf16 tile is two
// 128-byte-swizzled [rows, 64] sub-tiles. The k/v maps end at kv_valid, so
// rows past it arrive as zeros. Two consumer warpgroups own 64 query rows
// each and run both products on wgmma m64n128k16: S = Q K^T from shared
// memory through descriptors, O += P V with P from registers (the S
// accumulator layout is the A fragment layout) and V read as it lies, as an
// MN-major B operand. The softmax is online in f32 on exp2 with the scale
// folded in (ex2.approx). Inside a warpgroup the first product of tile j is
// started together with the second product of tile j - 1, and the softmax of
// tile j runs while that second product is in flight; the two warpgroups take
// turns at starting their products through a pair of named barriers, so one's
// exponentials run under the other's MMAs (S, O and P of a consumer thread are
// 160 registers: setmaxnreg hands the consumers 240 and leaves the producer
// 24). Only the last visited tile can be partial and only it is masked; tiles
// wholly past kv_valid are never visited; a row whose running max is still
// -inf uses 0 as its exponent base, so a fully masked tile cannot produce
// exp(-inf - -inf) = NaN. The output goes through shared memory (Q's rows of
// the same warpgroup, same swizzle) and a TMA store, which clips the rows past
// Sq.
//
// Band mode is the same pipeline over a window of kv tiles. A q tile [q0, q0 +
// 128) visits only the tiles [j_lo, j_hi) that hold a column of some row's band
// (band_tiles; every tile if it holds a pad row), so the work falls with the
// band: at r = 1 and 1560 tokens a frame (1.3B 480p) ~15% of the dense tiles.
// Producer and consumers derive the same window from the block index and count
// ring stages and phases from the iteration i = j - j_lo, never from j. Each
// consumer thread keeps the column bounds [lo, hi) of its two rows (one
// division a row per block); a tile that is not inside both is masked with two
// integer compares an element. A row may see nothing of a visited tile (the
// tile serves the block's other rows): the -inf guard above keeps it finite,
// and every valid row sees its own frame, so l > 0 at the end.
//
// Residual mode (training, models/attention.py's autograd function): the same
// launch also writes each row's log-sum-exp of the scaled scores, f32 [B, H,
// Sq], lse = m * scale + ln(l) with m the raw row max and l the row sum of the
// online softmax. It replaces the l and m residuals of the TPU flash forward
// (jax/experimental/pallas/ops/tpu/flash_attention.py:758, save_residuals),
// which K11 and K12 (flash_attention_bwd.cu) read to recompute P. A row that
// sees no key (l = 0) gets +inf, so the backward's P is 0 there. Only the
// epilogue differs; the plain launch passes no lse pointer.
#include "sm90.cuh"

namespace {

using namespace wanq::sm90;

constexpr int D = 128;
constexpr int BQ = 128, BKV = 128;
constexpr int kStages = 2;
constexpr int kThreads = 384;             // producer warpgroup + 2 consumer warpgroups
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * 24 + 256 * 240 <= 65536
constexpr int kHalf = 128 * 64 * 2;       // one [128, 64] bf16 sub-tile: 16 KB
constexpr int kTile = 2 * kHalf;          // one [128, 128] bf16 tile: 32 KB
constexpr int kBarBytes = 128;
constexpr int kSmemBytes = 1024 + kTile * (1 + 2 * kStages) + kBarBytes;
constexpr int kSchedBar = 1;              // named barriers 1, 2: the consumers' turns
constexpr int kEpiBar = 3;                // named barriers 3, 4: one per consumer, epilogue
constexpr int kMaxHeads = 64;             // band mode: radii in the launch parameters

struct Params {
  CUtensorMap q, k, v, o;
  int kv_valid;
  float scale_log2;
  int tpf;                                // band mode: tokens per latent frame
  int radius[kMaxHeads];                  // band mode: each head's radius, in frames
  float* lse;                             // residual mode: [B, H, Sq] f32, or null
  int sq;
};

// The kv columns [lo, hi) that query row q sees in band mode.
__device__ __forceinline__ void row_band(int q, int tpf, int r, int valid, int& lo, int& hi) {
  if (q >= valid) {
    lo = 0;
    hi = valid;
  } else {
    const int f = q / tpf;
    lo = max(0, (f - r) * tpf);
    hi = min(valid, (f + r + 1) * tpf);
  }
}

// The kv tiles [j_lo, j_hi) that the q tile [q0, q0 + BQ) visits in band mode:
// from the first column of its first row's band to the last of its last row's,
// or the whole valid prefix if it holds a pad row. Mirrored on the host by
// models/attention.py::band_kv_tiles.
__device__ __forceinline__ void band_tiles(int q0, int tpf, int r, int valid, int& j_lo,
                                           int& j_hi) {
  if (q0 + BQ > valid) {
    j_lo = 0;
    j_hi = (valid + BKV - 1) / BKV;
  } else {
    j_lo = max(0, q0 / tpf - r) * tpf / BKV;
    j_hi = (min(((q0 + BQ - 1) / tpf + r + 1) * tpf, valid) + BKV - 1) / BKV;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

struct Bars {
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
};
static_assert(sizeof(Bars) <= kBarBytes, "barrier block");

// S = Q K^T for the warpgroup's 64 rows and one 128-key tile (not committed).
__device__ __forceinline__ void start_qk(float (&s)[64], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kHalf + (kk & 3) * 32;
    wgmma_bf16_ss(s, desc_advance(q_desc, off), desc_advance(k_desc, off), kk > 0);
  }
}

// O += P V for one 128-key tile, P packed in the A fragment layout.
__device__ __forceinline__ void start_pv(float (&o)[64], const uint32_t (&p)[32],
                                         uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_bf16_rs_mn(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                     desc_advance(v_desc, kk * 2048), 1);
}

// Online-softmax step on the raw scores of one tile: masks (dense: the last
// partial tile, columns >= hi; band: a tile not inside both rows' bands,
// columns outside [lo, hi) of their row), moves the running max, turns s into
// the unnormalised probs, adds their row sums, and returns the factors by which
// earlier sums shrink.
template <bool kBand>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], float scale_log2, bool masked,
                                             int col0, const int (&lo)[2], const int (&hi)[2]) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = col0 + (i >> 2) * 8 + (i & 1);
      if constexpr (kBand) {
        if (col < lo[(i >> 1) & 1] || col >= hi[(i >> 1) & 1]) s[i] = -INFINITY;
      } else {
        if (col >= hi[0]) s[i] = -INFINITY;
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(wanq::kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(wanq::kFull, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    base[r] = (m_new == -INFINITY) ? 0.f : m_new * scale_log2;
    alpha[r] = ex2_approx(m_run[r] * scale_log2 - base[r]);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = ex2_approx(fmaf(s[i], scale_log2, -base[(i >> 1) & 1]));
    l_run[(i >> 1) & 1] += s[i];
  }
}

// Probs -> bf16 A fragments of the second product: k step kk (16 keys) takes
// column tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_probs(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

__device__ __forceinline__ void scale_rows(float (&o)[64], const float (&f)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= f[(i >> 1) & 1];
}

template <bool kBand>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (wanq::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + kTile;
  uint8_t* sV = sK + kStages * kTile;
  Bars* bars = reinterpret_cast<Bars*>(sV + kStages * kTile);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  // kv tiles j_lo .. j_lo + n_tiles - 1; ring stage and phase follow i = j - j_lo
  int j_lo = 0, n_tiles = (p.kv_valid + BKV - 1) / BKV;
  if constexpr (kBand) {
    int j_hi;
    band_tiles(q0, p.tpf, p.radius[h], p.kv_valid, j_lo, j_hi);
    n_tiles = j_hi - j_lo;
  }

  if (tid == 0) {
    mbar_init(&bars->q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars->k_full[s], 1);
      mbar_init(&bars->v_full[s], 1);
      mbar_init(&bars->k_empty[s], 8);  // one arrival per consumer warp
      mbar_init(&bars->v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      prefetch_tensormap(&p.q);
      prefetch_tensormap(&p.k);
      prefetch_tensormap(&p.v);
      mbar_expect_tx(&bars->q_full, kTile);
      tma_load_4d(sQ, &p.q, &bars->q_full, 0, q0, h, b);
      tma_load_4d(sQ + kHalf, &p.q, &bars->q_full, 64, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, col = (j_lo + i) * BKV;
        const uint32_t ph = (i / kStages) & 1;
        mbar_wait(&bars->k_empty[st], ph ^ 1);
        mbar_expect_tx(&bars->k_full[st], kTile);
        tma_load_4d(sK + st * kTile, &p.k, &bars->k_full[st], 0, col, h, b);
        tma_load_4d(sK + st * kTile + kHalf, &p.k, &bars->k_full[st], 64, col, h, b);
        mbar_wait(&bars->v_empty[st], ph ^ 1);
        mbar_expect_tx(&bars->v_full[st], kTile);
        tma_load_4d(sV + st * kTile, &p.v, &bars->v_full[st], 0, col, h, b);
        tma_load_4d(sV + st * kTile + kHalf, &p.v, &bars->v_full[st], 64, col, h, b);
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
    const uint64_t v_desc0 = mnmajor_desc(wanq::smem_addr(sV), kHalf);
    const bool tail_partial = (p.kv_valid % BKV) != 0;
    const float scale_log2 = p.scale_log2;
    // the column bounds of this thread's two rows (dense: [0, kv_valid))
    int lo[2] = {0, 0}, hi[2] = {p.kv_valid, p.kv_valid};
    if constexpr (kBand) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        row_band(q0 + cw * 64 + warp * 16 + g + r * 8, p.tpf, p.radius[h], p.kv_valid, lo[r],
                 hi[r]);
    }
    // whether tile i needs the mask
    auto masked = [&](int i) {
      if constexpr (kBand) {
        const int c0 = (j_lo + i) * BKV;
        return c0 < max(lo[0], lo[1]) || c0 + BKV > min(hi[0], hi[1]);
      } else {
        return tail_partial && i == n_tiles - 1;
      }
    };

    float o[64], s[64];
    uint32_t pfrag[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float alpha[2];

    mbar_wait(&bars->q_full, 0);
    // The first consumer takes the first turn: it completes its own barrier.
    if (cw == 0) bar_arrive(kSchedBar, 256);
    mbar_wait(&bars->k_full[0], 0);
    bar_sync(kSchedBar + cw, 256);
    wgmma_fence();
    start_qk(s, q_desc, k_desc0);
    wgmma_commit();
    bar_arrive(kSchedBar + (cw ^ 1), 256);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&bars->k_empty[0]);
    softmax_tile<kBand>(s, m_run, l_run, alpha, scale_log2, masked(0), j_lo * BKV + tig * 2,
                        lo, hi);
    pack_probs(pfrag, s);
    // unrolled by the ring's depth, so each stage and phase is a constant:
    // without it the band build ran measurably slower than the dense build
    // over the same tiles (chip_smoke.py times the two side by side)
#pragma unroll 2
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages, sv = (i - 1) % kStages;
      const uint32_t ph = (i / kStages) & 1, ph_v = ((i - 1) / kStages) & 1;
      mbar_wait(&bars->k_full[st], ph);
      bar_sync(kSchedBar + cw, 256);
      wgmma_fence();
      start_qk(s, q_desc, desc_advance(k_desc0, st * kTile));
      wgmma_commit();
      scale_rows(o, alpha);  // by the factors of tile i - 1, whose probs pfrag holds
      mbar_wait(&bars->v_full[sv], ph_v);
      wgmma_fence();
      start_pv(o, pfrag, desc_advance(v_desc0, sv * kTile));
      wgmma_commit();
      bar_arrive(kSchedBar + (cw ^ 1), 256);
      wgmma_wait<1>();  // S of tile i is there; O += P V of tile i - 1 still runs
      fence_regs(s);
      if (lane == 0) mbar_arrive(&bars->k_empty[st]);
      softmax_tile<kBand>(s, m_run, l_run, alpha, scale_log2, masked(i),
                          (j_lo + i) * BKV + tig * 2, lo, hi);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&bars->v_empty[sv]);
      pack_probs(pfrag, s);
    }
    {
      const int sv = (n_tiles - 1) % kStages;
      scale_rows(o, alpha);
      mbar_wait(&bars->v_full[sv], ((n_tiles - 1) / kStages) & 1);
      wgmma_fence();
      start_pv(o, pfrag, desc_advance(v_desc0, sv * kTile));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }

    // ---- epilogue: O / l -> bf16 -> shared (this warpgroup's Q rows) -> TMA store ----
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(wanq::kFull, l, 1);
      l += __shfl_xor_sync(wanq::kFull, l, 2);
      inv[r] = l > 0.f ? 1.0f / l : 0.f;
      if (p.lse != nullptr && tig == 0) {
        const int row = q0 + cw * 64 + warp * 16 + g + r * 8;
        if (row < p.sq)
          p.lse[((long long)b * gridDim.y + h) * p.sq + row] =
              l > 0.f ? (m_run[r] * p.scale_log2 + log2f(l)) * 0.6931471805599453f : INFINITY;
      }
    }
    uint8_t* sO = sQ + cw * 64 * 128;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + r * 8;  // row & 7 == g
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint8_t* dst = sO + (j >> 3) * kHalf + row * 128 + (((j & 7) ^ g) << 4) + tig * 4;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
    fence_proxy_async();
    bar_sync(kEpiBar + cw, 128);
    if ((tid & 127) == 0) {
      tma_store_4d(&p.o, sO, 0, q0 + cw * 64, h, b);
      tma_store_4d(&p.o, sO + kHalf, 64, q0 + cw * 64, h, b);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// One operand's 4-D map: (d, seq, head, batch), byte strides of seq, head and
// batch, a box of [box_rows, 64].
bool make_map(CUtensorMap* map, const void* base, long long seq, int heads, long long batch,
              const long long* strides, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t st[3] = {(cuuint64_t)strides[0], (cuuint64_t)strides[1],
                            (cuuint64_t)strides[2]};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, st, box);
}

}  // namespace

// q/k/v/o: bf16, head dim 128 contiguous, bases 16-byte aligned; `strides`
// holds the byte strides of (seq, head, batch) for q, k, v and o in turn,
// multiples of 16. 1 <= kv_valid <= Sk; scale > 0. tpf = 0: dense mode; tpf
// >= 1: band mode with radii[h] >= 0 (a host array of H <= 64 ints) frames.
// lse: null, or f32 [B, H, Sq] contiguous for the residual mode's log-sum-exp.
WANQ_API int wanq_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  long long B, int H, int Sq, int Sk, long long q_ss,
                                  long long q_sh, long long q_sb, long long k_ss,
                                  long long k_sh, long long k_sb, long long v_ss,
                                  long long v_sh, long long v_sb, long long o_ss,
                                  long long o_sh, long long o_sb, int kv_valid, float scale,
                                  int tpf, const int* radii, float* lse, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (kv_valid < 1 || kv_valid > Sk || !(scale > 0.f) || B > 65535 || H > 65535 || tpf < 0)
    return (int)cudaErrorInvalidValue;
  const long long qs[3] = {q_ss, q_sh, q_sb}, ks[3] = {k_ss, k_sh, k_sb};
  const long long vs[3] = {v_ss, v_sh, v_sb}, os[3] = {o_ss, o_sh, o_sb};
  Params p;
  // the k/v maps end at kv_valid: the rows past it load as zeros
  if (!make_map(&p.q, q, Sq, H, B, qs, BQ) || !make_map(&p.k, k, kv_valid, H, B, ks, BKV) ||
      !make_map(&p.v, v, kv_valid, H, B, vs, BKV) || !make_map(&p.o, o, Sq, H, B, os, 64))
    return (int)cudaErrorInvalidValue;
  p.kv_valid = kv_valid;
  p.lse = lse;
  p.sq = Sq;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.tpf = 0;
  if (tpf > 0) {
    if (radii == nullptr || H > kMaxHeads) return (int)cudaErrorInvalidValue;
    // a frame longer than the sequence, or a radius past its last frame, is
    // the same band as one that just covers it: clamping keeps (f + r + 1) * tpf
    // within 5 * max(Sq, Sk)
    const int s_max = Sq > Sk ? Sq : Sk;
    p.tpf = tpf < s_max ? tpf : s_max;
    const int n_frames = (s_max + p.tpf - 1) / p.tpf;
    for (int h = 0; h < H; ++h) {
      if (radii[h] < 0) return (int)cudaErrorInvalidValue;
      p.radius[h] = radii[h] < n_frames ? radii[h] : n_frames;
    }
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, (unsigned)B);
  auto kernel = p.tpf > 0 ? flash_fwd_kernel<true> : flash_fwd_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
