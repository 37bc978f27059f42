// K11 flash_bwd_dkv and K12 flash_bwd_dq: the bf16 flash-attention backward,
// head dim 128, non-causal, kv-prefix mask, strided operands.
//
// Replace the two backward kernels of the TPU flash attention that
// wanq_tpu/models/attention.py drives when `trainable`
// (jax/experimental/pallas/ops/tpu/flash_attention.py: _flash_attention_bwd_dkv
// :941, call :1121; _flash_attention_bwd_dq :1287, call :1456), with the same
// two-kernel split and no atomics, so the gradients are deterministic:
//   P  = exp(scale * Q K^T - lse)             (lse from K4's residual mode)
//   dS = P * (dO V^T - di),  di = sum_d O * dO  (one torch reduction, as the
//                                                TPU version takes it from XLA)
//   K12: dQ = scale * dS K      one block per 128 query rows walks the kv tiles
//   K11: dV = P^T dO, dK = scale * dS^T Q
//                               one block per 128 keys walks the query steps
// Sums are f32, P and dS enter their products as bf16, the outputs are bf16,
// written contiguous [B, S, H, D]. Every output element is summed by one
// thread in a fixed order, so two calls give equal bits.
//
// The accumulate mode (kAcc; entry points wanq_flash_bwd_dq_acc and
// wanq_flash_bwd_dkv_acc) is one hop of the ring attention's backward
// (parallel/ring.py): q and dO are the rank's rows, k and v the shard the hop
// holds, kv_valid its valid keys, and the row table is the caller's, built
// once a layer from the folded (global) LSE and output. Each thread adds its
// dQ, or dK and dV, in f32 into caller-given contiguous [B, S, H, D] f32
// buffers (a read-add-write of the elements it owns, in place of the bf16
// store), so a rank's hops sum in f32 in launch order, with no atomics.
//
// Bound on the H100: tensor-core throughput. K12 does three S-sized products
// (S, dP, dQ) and K11 four (S, dP, dV, dK), 2 S_q S_k D flops each per head,
// against O(S D) bytes. Design (sm90.cuh has the parts; the pipeline is K4's,
// flash_attention.cu): a block has three warpgroups. One thread of the
// producer warpgroup issues every load by TMA into mbarrier rings (4-D tensor
// maps over byte strides, a [rows, 128] bf16 tile as two 128-byte-swizzled
// [rows, 64] sub-tiles); two consumer warpgroups own 64 rows each and run
// every product on wgmma with the sums in registers (setmaxnreg: 240 / 232 a
// consumer thread, 24 / 40 a producer thread in K12 / K11).
//
// K12 (flash_bwd_dq_kernel): Q and dO of the block's 128 query rows load once;
// K and V tiles of 128 keys stream through two-stage rings, each with its own
// full and empty barriers. Per tile a consumer runs S = Q K^T and dP = dO V^T
// (m64n128k16, both operands from shared memory), forms P = exp2(S scale log2e
// - lse log2e) and dS = P (dP - di) in registers, and runs dQ += dS K with dS
// as the A fragments (the accumulator layout is the A fragment layout) and K
// read as it lies, an MN-major B operand. V is released after dP's product, K
// after dQ's. A consumer thread holds dQ, S and dP: 192 registers of sums.
//
// K11 (flash_bwd_dkv_kernel): K and V of the block's 128 keys stay resident
// (64 KB); query steps of 64 rows stream through a three-stage ring, each
// stage holding Q and dO (TMA) and the step's lse log2e and di rows (two bulk
// copies of 256 bytes). Per step a consumer (64 keys) runs S^T = K Q^T and
// dP^T = V dO^T (m64n64k16), forms P^T and dS^T in registers with the
// per-column lse and di read from shared memory, and runs dV += P^T dO and
// dK += dS^T Q with dO and Q read as MN-major B operands. A consumer thread
// holds dK, dV, S^T and dP^T: 192 registers.
//
// In both, the two consumers take turns at issuing their products through a
// pair of named barriers, two turns a tile or step (the score products, then
// the gradient products), so one's exponentials run under the other's MMAs.
//
// Masks: the k/v maps end at kv_valid, so keys past it load as zeros; only
// the last kv tile of K12 when it is partial, and a K11 block that straddles
// kv_valid, mask P to 0 by key index, so dK = dV = 0 exactly there. A K11 block
// wholly past kv_valid walks no step and stores zeros. Query rows past Sq load
// as zeros, and the wrapper's row table (models/attention.py flash_bwd_rows)
// pads lse log2e with +inf and di with 0 to a multiple of 128 rows, so P = 0
// there and no read of the table needs a bound. The TMA stores clip the rows
// past Sq and Sk.
#include "sm90.cuh"

namespace {

using namespace wanq::sm90;

constexpr int D = 128;
constexpr int kRows = 128;                    // rows a block owns: 2 consumers x 64
constexpr int BKV = 128;                      // K12: keys a tile
constexpr int BQ = 64;                        // K11: query rows a step
constexpr int kRowPad = 128;                  // the row table's padding of Sq
constexpr int kThreads = 384;                 // producer warpgroup + 2 consumer warpgroups
// setmaxnreg budgets (128 p + 256 c = 168 * 384, what the launch holds): K12's
// producer is K4's; K11's also walks the row table, so it takes 40
constexpr int kDqProducerRegs = 24, kDqConsumerRegs = 240;
constexpr int kDkvProducerRegs = 40, kDkvConsumerRegs = 232;
constexpr int kTile = kRows * D * 2;          // one [128, 128] bf16 tile: 32 KB
constexpr int kHalf = kTile / 2;              // its [128, 64] sub-tile: 16 KB
constexpr int kStep = BQ * D * 2;             // one [64, 128] bf16 tile: 16 KB
constexpr int kStepHalf = kStep / 2;          // its [64, 64] sub-tile: 8 KB
constexpr int kStatBytes = 2 * BQ * 4;        // a step's lse log2e and di rows
constexpr int kBarBytes = 128;
constexpr int kSchedBar = 1;                  // named barriers 1, 2: the consumers' turns
constexpr int kEpiBar = 3;                    // named barriers 3, 4: one per consumer, epilogue
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kDqStages = 2;
constexpr int kSmemDq = 1024 + kTile * (2 + 2 * kDqStages) + kBarBytes;            // 193 KB
constexpr int kDkvStages = 3;
constexpr int kSmemDkv = 1024 + 2 * kTile + kDkvStages * (2 * kStep + kStatBytes) + kBarBytes;

struct Params {
  CUtensorMap q, k, v, dout;
  CUtensorMap out_a, out_b;                   // K12: dq; K11: dk, dv
  float* acc_a;                               // the accumulate mode's f32 [B, S, H, 128]:
  float* acc_b;                               //   K12 dq; K11 dk, dv
  int out_rows;                               // S of those: K12 Sq, K11 Sk
  const float* rows;                          // [B, H, 2, sq_pad]: lse log2e, di
  int sq_pad;
  int kv_valid;
  int n_iter;                                 // K12: kv tiles; K11: query steps
  float scale, scale_log2;
};

struct DqBars {
  uint64_t qdo_full;
  uint64_t k_full[kDqStages], k_empty[kDqStages];
  uint64_t v_full[kDqStages], v_empty[kDqStages];
};
static_assert(sizeof(DqBars) <= kBarBytes, "barrier block");

struct DkvBars {
  uint64_t kv_full;
  uint64_t full[kDkvStages], empty[kDkvStages];
};
static_assert(sizeof(DkvBars) <= kBarBytes, "barrier block");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d = A[64 x 128] . B[N x 128]^T over the head dim (S = Q K^T, dP = dO V^T and
// their transposes; not committed): A and B K-major tiles whose [rows, 64]
// sub-tiles lie `a_half` and `b_half` bytes apart. N = 128 or 64 columns, 64
// or 32 registers a thread.
template <int N>
__device__ __forceinline__ void score_product(float (&d)[N / 2], uint64_t a, uint32_t a_half,
                                              uint64_t b, uint32_t b_half) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_advance(a, (kk >> 2) * a_half + (kk & 3) * 32);
    const uint64_t db = desc_advance(b, (kk >> 2) * b_half + (kk & 3) * 32);
    if constexpr (N == 128)
      wgmma_bf16_ss(d, da, db, kk > 0);
    else
      wgmma_bf16_ss_n64(d, da, db, kk > 0);
  }
}

// d[64 x 128] += A[64 x 16 KS] . B[16 KS x 128] (dQ += dS K, dV += P^T dO,
// dK += dS^T Q; not committed): A packed in the A fragment layout, B an
// MN-major tile in shared memory (its rows the product's depth).
template <int KS>
__device__ __forceinline__ void grad_product(float (&d)[64], const uint32_t (&a)[4 * KS],
                                             uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_bf16_rs_mn(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                     desc_advance(b, kk * 2048), 1);
}

// An accumulator tile of N = 4 R columns (R registers) -> bf16 A fragments of
// the next product: k step kk (16 columns) takes column tiles 2 kk, 2 kk + 1.
template <int R>
__device__ __forceinline__ void pack_frags(uint32_t (&f)[R / 2], const float (&s)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    f[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    f[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    f[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    f[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// acc * scale -> bf16 -> the warpgroup's 64 rows of a [128, 128] swizzled
// tile (`rows64` its first row in sub-tile 0, sub-tile 1 kHalf further).
__device__ __forceinline__ void stage_out(uint8_t* rows64, const float (&acc)[64], float scale,
                                          int warp, int g, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;  // row & 7 == g
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint8_t* dst = rows64 + (j >> 3) * kHalf + row * 128 + (((j & 7) ^ g) << 4) + tig * 4;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// acc * scale added in f32 into rows row0 .. row0 + 63 (the warpgroup's) of
// head h, batch b of a contiguous [B, n_rows, H, 128] f32 buffer; rows past
// n_rows are skipped. The thread owns columns 8 j + 2 tig, + 1 of its two rows.
__device__ __forceinline__ void add_rows(float* out, const float (&acc)[64], float scale,
                                         int row0, int n_rows, int h, int b, int H, int warp,
                                         int g, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + r * 8;
    if (row >= n_rows) continue;
    float* dst = out + (((long long)b * n_rows + row) * H + h) * D + tig * 2;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float2* d2 = reinterpret_cast<float2*>(dst + j * 8);
      float2 cur = *d2;
      cur.x += acc[4 * j + 2 * r] * scale;
      cur.y += acc[4 * j + 2 * r + 1] * scale;
      *d2 = cur;
    }
  }
}

// The warpgroup's staged 64 rows -> rows row0 .. row0 + 63 of `map`'s (h, b).
__device__ __forceinline__ void store_rows(const CUtensorMap* map, const uint8_t* rows64,
                                           int row0, int h, int b) {
  tma_store_4d(map, rows64, 0, row0, h, b);
  tma_store_4d(map, rows64 + kHalf, 64, row0, h, b);
}

// K12: dQ for the 128 query rows of block x, head y, batch z.
template <bool kAcc>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (wanq::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* sQ = smem;
  uint8_t* sDO = sQ + kTile;
  uint8_t* sK = sDO + kTile;
  uint8_t* sV = sK + kDqStages * kTile;
  DqBars* bars = reinterpret_cast<DqBars*>(sV + kDqStages * kTile);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = p.n_iter;

  if (tid == 0) {
    mbar_init(&bars->qdo_full, 1);
#pragma unroll
    for (int s = 0; s < kDqStages; ++s) {
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
    reg_dealloc<kDqProducerRegs>();
    if (tid == 0) {
      prefetch_tensormap(&p.q);
      prefetch_tensormap(&p.dout);
      prefetch_tensormap(&p.k);
      prefetch_tensormap(&p.v);
      mbar_expect_tx(&bars->qdo_full, 2 * kTile);
      tma_load_4d(sQ, &p.q, &bars->qdo_full, 0, q0, h, b);
      tma_load_4d(sQ + kHalf, &p.q, &bars->qdo_full, 64, q0, h, b);
      tma_load_4d(sDO, &p.dout, &bars->qdo_full, 0, q0, h, b);
      tma_load_4d(sDO + kHalf, &p.dout, &bars->qdo_full, 64, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j & 1, col = j * BKV;
        const uint32_t ph = (j >> 1) & 1;
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
    reg_alloc<kDqConsumerRegs>();
    const int cw = wg - 1;
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int g = lane >> 2, tig = lane & 3;
    const uint64_t q_desc = kmajor_desc(wanq::smem_addr(sQ) + cw * 64 * 128);
    const uint64_t do_desc = kmajor_desc(wanq::smem_addr(sDO) + cw * 64 * 128);
    const uint64_t k_desc0 = kmajor_desc(wanq::smem_addr(sK));
    const uint64_t v_desc0 = kmajor_desc(wanq::smem_addr(sV));
    const uint64_t kt_desc0 = mnmajor_desc(wanq::smem_addr(sK), kHalf);
    const float scale_log2 = p.scale_log2;
    // this thread's two rows: lse log2e and di (the table is padded past Sq)
    const float* rows = p.rows + (long long)(b * gridDim.y + h) * 2 * p.sq_pad;
    float lse2[2], di[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + cw * 64 + warp * 16 + g + r * 8;
      lse2[r] = rows[row];
      di[r] = rows[p.sq_pad + row];
    }
    // the valid keys of the last tile (1 .. BKV); only a partial one is masked
    const int tail = p.kv_valid - (n_tiles - 1) * BKV;

    float dq[64];
    uint32_t ds[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;

    mbar_wait(&bars->qdo_full, 0);
    // The first consumer takes the first turn: it completes its own barrier.
    if (cw == 0) bar_arrive(kSchedBar, 256);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j & 1;
      const uint32_t ph = (j >> 1) & 1;
      float s[64], dp[64];
      mbar_wait(&bars->k_full[st], ph);
      mbar_wait(&bars->v_full[st], ph);
      bar_sync(kSchedBar + cw, 256);
      wgmma_fence();
      score_product<128>(s, q_desc, kHalf, desc_advance(k_desc0, st * kTile), kHalf);
      score_product<128>(dp, do_desc, kHalf, desc_advance(v_desc0, st * kTile), kHalf);
      wgmma_commit();
      bar_arrive(kSchedBar + (cw ^ 1), 256);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (lane == 0) mbar_arrive(&bars->v_empty[st]);
      const bool masked = j == n_tiles - 1 && tail < BKV;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        float pr = ex2_approx(fmaf(s[i], scale_log2, -lse2[r]));
        if (masked && (i >> 2) * 8 + tig * 2 + (i & 1) >= tail) pr = 0.f;
        s[i] = pr * (dp[i] - di[r]);  // dS
      }
      pack_frags(ds, s);
      bar_sync(kSchedBar + cw, 256);
      wgmma_fence();
      grad_product<BKV / 16>(dq, ds, desc_advance(kt_desc0, st * kTile));
      wgmma_commit();
      bar_arrive(kSchedBar + (cw ^ 1), 256);
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(&bars->k_empty[st]);
    }

    if constexpr (kAcc) {
      // ---- epilogue: dQ scale added into the caller's f32 dq ----
      add_rows(p.acc_a, dq, p.scale, q0 + cw * 64, p.out_rows, h, b, gridDim.y, warp, g, tig);
    } else {
      // ---- epilogue: dQ scale -> bf16 -> shared (this consumer's Q rows) -> TMA store ----
      uint8_t* sO = sQ + cw * 64 * 128;
      stage_out(sO, dq, p.scale, warp, g, tig);
      fence_proxy_async();
      bar_sync(kEpiBar + cw, 128);
      if ((tid & 127) == 0) {
        store_rows(&p.out_a, sO, q0 + cw * 64, h, b);
        tma_store_commit();
        tma_store_wait_read();
      }
    }
  }
}

// K11: dK and dV for the 128 keys of block x, head y, batch z.
template <bool kAcc>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (wanq::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* sK = smem;
  uint8_t* sV = sK + kTile;
  uint8_t* sQ = sV + kTile;  // stage st: Q at + st * 2 kStep, dO kStep after
  float* sStat = reinterpret_cast<float*>(sQ + kDkvStages * 2 * kStep);  // stage st: lse2, di
  DkvBars* bars = reinterpret_cast<DkvBars*>(sStat + kDkvStages * 2 * BQ);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  // a block wholly past kv_valid walks nothing and stores zeros
  const int n_steps = k0 < p.kv_valid ? p.n_iter : 0;

  if (tid == 0) {
    mbar_init(&bars->kv_full, 1);
#pragma unroll
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&bars->full[s], 1);
      mbar_init(&bars->empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<kDkvProducerRegs>();
    if (tid == 0 && n_steps > 0) {
      prefetch_tensormap(&p.k);
      prefetch_tensormap(&p.v);
      prefetch_tensormap(&p.q);
      prefetch_tensormap(&p.dout);
      mbar_expect_tx(&bars->kv_full, 2 * kTile);
      tma_load_4d(sK, &p.k, &bars->kv_full, 0, k0, h, b);
      tma_load_4d(sK + kHalf, &p.k, &bars->kv_full, 64, k0, h, b);
      tma_load_4d(sV, &p.v, &bars->kv_full, 0, k0, h, b);
      tma_load_4d(sV + kHalf, &p.v, &bars->kv_full, 64, k0, h, b);
      const float* rows = p.rows + (long long)(b * gridDim.y + h) * 2 * p.sq_pad;
      Ring<kDkvStages> ring;
      for (int i = 0; i < n_steps; ++i, ring.advance()) {
        uint64_t* full = &bars->full[ring.stage];
        uint8_t* sq = sQ + ring.stage * 2 * kStep;
        float* stat = sStat + ring.stage * 2 * BQ;
        const int row0 = i * BQ;
        mbar_wait(&bars->empty[ring.stage], ring.phase ^ 1);
        mbar_expect_tx(full, 2 * kStep + kStatBytes);
        tma_load_4d(sq, &p.q, full, 0, row0, h, b);
        tma_load_4d(sq + kStepHalf, &p.q, full, 64, row0, h, b);
        tma_load_4d(sq + kStep, &p.dout, full, 0, row0, h, b);
        tma_load_4d(sq + kStep + kStepHalf, &p.dout, full, 64, row0, h, b);
        bulk_load_1d(stat, rows + row0, BQ * 4, full);
        bulk_load_1d(stat + BQ, rows + p.sq_pad + row0, BQ * 4, full);
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    reg_alloc<kDkvConsumerRegs>();
    const int cw = wg - 1;
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int g = lane >> 2, tig = lane & 3;
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    if (n_steps > 0) {
      const uint64_t k_desc = kmajor_desc(wanq::smem_addr(sK) + cw * 64 * 128);
      const uint64_t v_desc = kmajor_desc(wanq::smem_addr(sV) + cw * 64 * 128);
      const uint64_t q_desc0 = kmajor_desc(wanq::smem_addr(sQ));
      const uint64_t do_desc0 = kmajor_desc(wanq::smem_addr(sQ + kStep));
      const uint64_t qt_desc0 = mnmajor_desc(wanq::smem_addr(sQ), kStepHalf);
      const uint64_t dot_desc0 = mnmajor_desc(wanq::smem_addr(sQ + kStep), kStepHalf);
      const float scale_log2 = p.scale_log2;
      // the keys of this thread's two rows at or past kv_valid get P = 0; only
      // a block that straddles kv_valid has any
      const int key = k0 + cw * 64 + warp * 16 + g;
      const bool dead0 = key >= p.kv_valid, dead1 = key + 8 >= p.kv_valid;
      const bool straddles = k0 + kRows > p.kv_valid;

      mbar_wait(&bars->kv_full, 0);
      if (cw == 0) bar_arrive(kSchedBar, 256);
      Ring<kDkvStages> ring;
      for (int i = 0; i < n_steps; ++i, ring.advance()) {
        const uint32_t off = ring.stage * 2 * kStep;
        float s[32], dp[32];
        uint32_t pf[16], dsf[16];
        mbar_wait(&bars->full[ring.stage], ring.phase);
        bar_sync(kSchedBar + cw, 256);
        wgmma_fence();
        score_product<64>(s, k_desc, kHalf, desc_advance(q_desc0, off), kStepHalf);
        score_product<64>(dp, v_desc, kHalf, desc_advance(do_desc0, off), kStepHalf);
        wgmma_commit();
        bar_arrive(kSchedBar + (cw ^ 1), 256);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // column (query row) 8 j + 2 tig + e % 2 of S^T: its lse log2e and di
        const float* lse2 = sStat + ring.stage * 2 * BQ;
        const float* di = lse2 + BQ;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * tig);
          const float2 d = *reinterpret_cast<const float2*>(di + 8 * j + 2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i4 = 4 * j + e;
            float pr = ex2_approx(fmaf(s[i4], scale_log2, -((e & 1) ? l.y : l.x)));
            if (straddles && ((e >> 1) ? dead1 : dead0)) pr = 0.f;
            s[i4] = pr;                                       // P^T
            dp[i4] = pr * (dp[i4] - ((e & 1) ? d.y : d.x));   // dS^T
          }
        }
        pack_frags(pf, s);
        pack_frags(dsf, dp);
        bar_sync(kSchedBar + cw, 256);
        wgmma_fence();
        grad_product<BQ / 16>(dv, pf, desc_advance(dot_desc0, off));
        grad_product<BQ / 16>(dk, dsf, desc_advance(qt_desc0, off));
        wgmma_commit();
        bar_arrive(kSchedBar + (cw ^ 1), 256);
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        if (lane == 0) mbar_arrive(&bars->empty[ring.stage]);
      }
    }

    if constexpr (kAcc) {
      // ---- epilogue: dK scale and dV added into the caller's f32 dk, dv ----
      add_rows(p.acc_a, dk, p.scale, k0 + cw * 64, p.out_rows, h, b, gridDim.y, warp, g, tig);
      add_rows(p.acc_b, dv, 1.f, k0 + cw * 64, p.out_rows, h, b, gridDim.y, warp, g, tig);
    } else {
      // ---- epilogue: dK scale and dV -> bf16 -> shared (this consumer's K and V
      // rows) -> TMA stores ----
      uint8_t* sOk = sK + cw * 64 * 128;
      uint8_t* sOv = sV + cw * 64 * 128;
      stage_out(sOk, dk, p.scale, warp, g, tig);
      stage_out(sOv, dv, 1.f, warp, g, tig);
      fence_proxy_async();
      bar_sync(kEpiBar + cw, 128);
      if ((tid & 127) == 0) {
        store_rows(&p.out_a, sOk, k0 + cw * 64, h, b);
        store_rows(&p.out_b, sOv, k0 + cw * 64, h, b);
        tma_store_commit();
        tma_store_wait_read();
      }
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

// A contiguous [B, S, H, 128] bf16 output, stored 64 rows at a time.
bool out_map(CUtensorMap* map, void* base, long long S, int H, long long B) {
  const long long st[3] = {(long long)H * D * 2, (long long)D * 2, S * H * D * 2};
  return make_map(map, base, S, H, B, st, 64);
}

// The operand maps (q and dout with boxes of `q_box` rows, k and v of 128 rows
// ending at kv_valid) and the scalars; false on what the kernels do not take.
bool fill_params(Params& p, const void* q, const void* k, const void* v, const void* dout,
                 const float* rows, const long long* st, long long B, int H, int Sq, int Sk,
                 int kv_valid, float scale, int q_box) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Sq < 1 || kv_valid < 1 || kv_valid > Sk ||
      !(scale > 0.f) || reinterpret_cast<uintptr_t>(rows) % 16)
    return false;
  // the k/v maps end at kv_valid: the keys past it load as zeros
  if (!make_map(&p.q, q, Sq, H, B, st, q_box) || !make_map(&p.k, k, kv_valid, H, B, st + 3, BKV) ||
      !make_map(&p.v, v, kv_valid, H, B, st + 6, BKV) ||
      !make_map(&p.dout, dout, Sq, H, B, st + 9, q_box))
    return false;
  p.rows = rows;
  p.sq_pad = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  p.kv_valid = kv_valid;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return true;
}

// K12 into a bf16 map (out_a) or, accumulating, into acc_a.
template <bool kAcc>
int launch_dq(Params& p, int Sq, long long B, int H, void* stream) {
  p.n_iter = (p.kv_valid + BKV - 1) / BKV;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<kAcc>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + kRows - 1) / kRows, H, (unsigned)B);
  flash_bwd_dq_kernel<kAcc><<<grid, kThreads, kSmemDq, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// K11 into bf16 maps (out_a, out_b) or, accumulating, into acc_a, acc_b.
template <bool kAcc>
int launch_dkv(Params& p, int Sq, int Sk, long long B, int H, void* stream) {
  p.n_iter = (Sq + BQ - 1) / BQ;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<kAcc>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDkv);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sk + kRows - 1) / kRows, H, (unsigned)B);
  flash_bwd_dkv_kernel<kAcc><<<grid, kThreads, kSmemDkv, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Operands q [B, Sq, H, 128], k/v [B, Sk, H, 128], dout [B, Sq, H, 128], bf16
// with a contiguous head dim, 16-byte aligned bases, and `strides` the byte
// strides of (seq, head, batch) of q, k, v and dout in turn, multiples of 16;
// rows: f32 [B, H, 2, Sq_pad] contiguous, Sq_pad = Sq rounded up to 128, lse
// log2e (+inf past Sq) then di (0 past Sq). dq: bf16 [B, Sq, H, 128]
// contiguous. 1 <= kv_valid <= Sk; scale > 0.
WANQ_API int wanq_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const float* rows, void* dq, long long B, int H, int Sq, int Sk,
                               const long long* strides, int kv_valid, float scale,
                               void* stream) {
  Params p;
  if (!fill_params(p, q, k, v, dout, rows, strides, B, H, Sq, Sk, kv_valid, scale, kRows) ||
      !out_map(&p.out_a, dq, Sq, H, B))
    return (int)cudaErrorInvalidValue;
  p.out_b = p.out_a;
  p.acc_a = p.acc_b = nullptr;
  p.out_rows = Sq;
  return launch_dq<false>(p, Sq, B, H, stream);
}

// The same operands; dk, dv: bf16 [B, Sk, H, 128] contiguous, zero at keys >=
// kv_valid.
WANQ_API int wanq_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* rows, void* dk, void* dv, long long B, int H,
                                int Sq, int Sk, const long long* strides, int kv_valid,
                                float scale, void* stream) {
  Params p;
  if (!fill_params(p, q, k, v, dout, rows, strides, B, H, Sq, Sk, kv_valid, scale, BQ) ||
      !out_map(&p.out_a, dk, Sk, H, B) || !out_map(&p.out_b, dv, Sk, H, B))
    return (int)cudaErrorInvalidValue;
  p.acc_a = p.acc_b = nullptr;
  p.out_rows = Sk;
  return launch_dkv<false>(p, Sq, Sk, B, H, stream);
}

// The accumulate mode of K12: the same operands and row table (the caller's);
// dq_acc: f32 [B, Sq, H, 128] contiguous, 8-byte aligned, to which scale dS K
// is added.
WANQ_API int wanq_flash_bwd_dq_acc(const void* q, const void* k, const void* v,
                                   const void* dout, const float* rows, float* dq_acc,
                                   long long B, int H, int Sq, int Sk, const long long* strides,
                                   int kv_valid, float scale, void* stream) {
  Params p;
  if (!fill_params(p, q, k, v, dout, rows, strides, B, H, Sq, Sk, kv_valid, scale, kRows) ||
      reinterpret_cast<uintptr_t>(dq_acc) % 8)
    return (int)cudaErrorInvalidValue;
  p.acc_a = p.acc_b = dq_acc;
  p.out_rows = Sq;
  return launch_dq<true>(p, Sq, B, H, stream);
}

// The accumulate mode of K11: dk_acc, dv_acc f32 [B, Sk, H, 128] contiguous,
// 8-byte aligned, to which scale dS^T Q and P^T dO are added (nothing at keys
// >= kv_valid).
WANQ_API int wanq_flash_bwd_dkv_acc(const void* q, const void* k, const void* v,
                                    const void* dout, const float* rows, float* dk_acc,
                                    float* dv_acc, long long B, int H, int Sq, int Sk,
                                    const long long* strides, int kv_valid, float scale,
                                    void* stream) {
  Params p;
  if (!fill_params(p, q, k, v, dout, rows, strides, B, H, Sq, Sk, kv_valid, scale, BQ) ||
      reinterpret_cast<uintptr_t>(dk_acc) % 8 || reinterpret_cast<uintptr_t>(dv_acc) % 8)
    return (int)cudaErrorInvalidValue;
  p.acc_a = dk_acc;
  p.acc_b = dv_acc;
  p.out_rows = Sk;
  return launch_dkv<true>(p, Sq, Sk, B, H, stream);
}
