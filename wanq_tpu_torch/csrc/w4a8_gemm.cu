// K8: W4A8 GEMM -- int8 activations x packed int4 weights, unpacked on chip,
// with K2's per-token x per-channel dequant epilogue in all its three modes
// (f32, bf16, and GELU + static int8 quant + row sum).
//
// Replaces the TPU kernel wanq_tpu/ops/qgemm.py:282 w4a8_linear_pallas
// (kernel _w4a8_kernel :251, which unpacks the weight block in VMEM before
// the int8 MXU dot). For A int8 [M, K] (row-major) and the packed weight
// Wp int8 [N, K/2] (K-major: byte j of row n holds k = 2j in its low nibble
// and k = 2j + 1 in its high nibble, codes in [-8, 7]):
//   acc = A @ unpack(Wp)^T                            exact int32
//   h   = f32(acc) * (s_a[m] * s_w[n]) + sum_a[m] * (zp_w[n] * s_w[n]) + bias[n]
// out = h as f32 or bf16 [M, N]; zp_w/sum_a (asymmetric weights) and bias
// optional. In the GELU + quant mode (an ffn.0 on 4-bit weights in front of an
// ffn.2 with a static activation scale; in the JAX package XLA fuses the same
// elementwise chain, wanq_tpu/models/dit.py:947-957, into the ffn.0 GEMM) the
// epilogue goes on from h rounded to bf16 to the int8 codes and their row
// sums, as K2's does: the epilogue is K2's own code (gemm_sm90.cuh), so every
// mode matches its plain version bit for bit by the same argument.
//
// Bound on the H100: tensor-core throughput by the operation count, as K2
// (M = 65536 against (K, N) = (1536, 8960) and (8960, 1536)); the packed weight
// halves the W bytes, which matter little at this M. What this design leans on
// is shared-memory bandwidth: there is no int4 tensor-core type on this card
// and a wgmma reads its B operand from shared memory only, so the packed tile
// has to be unpacked into shared memory. Per 128-deep K step of a 128 x 256
// tile (8.4 M operations, ~980 cycles of an SM at the int8 peak) TMA writes
// 32 KB, the unpack reads 16 KB and writes 32 KB, and the two warpgroups'
// products read 80 KB: ~160 KB against 128 bytes a cycle (K2 moves ~128 KB).
// Design (gemm_sm90.cuh, sm90.cuh): K2's skeleton with K9's packed-weight
// stage. One persistent block per SM walks the output tiles, N tiles of one M
// stripe next to each other; the tile is 128 x 256 where 256 divides N, else
// 128 x 128. One thread of the producer warpgroup streams K steps through TMA
// into two rings: A [128 rows, 128 B] with the 128-byte swizzle (rows past M
// load as zeros) and the packed tile [BN rows, 64 B] unswizzled. The
// producer's other three warps turn each packed tile into the int8 tile [BN,
// 128 B] in the swizzled layout wgmma reads (a third ring), fence it towards
// the async proxy and arrive on its barrier. They write each code times 16
// (the nibble moved to the top of its byte, which sign-extends for free), so
// the int32 tile holds 16 * acc -- no overflow for K < 2^17, |acc| <= K * 128 *
// 8 -- and an arithmetic shift by 4 in front of the epilogue gives acc back
// bit for bit. Two consumer warpgroups of 64 rows each run four wgmma
// m64nBNk32.s8 per stage with the int32 tile in registers and free the A and W
// stages as soon as the next stage's products are queued; their epilogues are
// not synchronised with each other.
#include "gemm_sm90.cuh"

namespace {

using namespace wanq::sm90;
using namespace wanq::gemm;

constexpr int BM = 128, BK = 128;
constexpr int kATile = BM * BK;
constexpr int kMaxStages = 4;
constexpr int kUnpackWarps = 3;  // producer warps 1..3
constexpr int kUnpackThreads = 32 * kUnpackWarps;
constexpr int kInFlight = 2;     // packed pieces a thread loads before it unpacks them
constexpr int kBarBytes = 256;
// the unpack warps need more registers than a thread that only issues TMA
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65536

template <int BN>
struct Cfg {
  static constexpr int kWTile = BN * BK;       // the int8 tile wgmma reads
  static constexpr int kPkTile = BN * BK / 2;  // the packed tile TMA writes
  static constexpr int kItems = kPkTile / 16;  // its 16-byte pieces
  static constexpr int kStageBytes = kATile + kWTile + kPkTile;
  static constexpr int kStages = BN == 256 ? 3 : 4;  // of each of the three rings
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kStagingBytes + kBarBytes;
  static_assert(kStages <= kMaxStages && kSmemBytes <= 227 * 1024, "shared memory");
};

struct Params {
  CUtensorMap a, wp;
  Epilogue e;
  int K;
};

struct Bars {
  uint64_t a_full[kMaxStages], a_empty[kMaxStages];    // A tiles (TMA -> consumers)
  uint64_t pk_full[kMaxStages], pk_empty[kMaxStages];  // packed W tiles (TMA -> unpack warps)
  uint64_t w_full[kMaxStages], w_empty[kMaxStages];    // int8 W tiles (unpack warps -> consumers)
};
static_assert(sizeof(Bars) <= kBarBytes, "barrier block");

template <int BN, int MODE>
__global__ void __launch_bounds__(kThreads, 1) w4a8_gemm_kernel(const __grid_constant__ Params p) {
  using C = Cfg<BN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sA = align_1024(smem_raw);
  uint8_t* sW = sA + C::kStages * kATile;
  uint8_t* sOut = sW + C::kStages * C::kWTile;
  uint8_t* sPk = sOut + kStagingBytes;
  Bars* bars = reinterpret_cast<Bars*>(sPk + C::kStages * C::kPkTile);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int tiles_n = p.e.N / BN;
  const int n_tiles = ((p.e.M + BM - 1) / BM) * tiles_n;
  const int KT = p.K / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&bars->a_full[s], 1);
      mbar_init(&bars->a_empty[s], 8);  // one arrival per consumer warp
      mbar_init(&bars->pk_full[s], 1);
      mbar_init(&bars->pk_empty[s], kUnpackWarps);
      mbar_init(&bars->w_full[s], kUnpackWarps);
      mbar_init(&bars->w_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      // ---- TMA: per K step the packed tile and the A tile ----
      prefetch_tensormap(&p.a);
      prefetch_tensormap(&p.wp);
      Ring<C::kStages> r;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < KT; ++kt) {
          const int s = r.stage;
          mbar_wait(&bars->pk_empty[s], r.phase ^ 1);
          mbar_expect_tx(&bars->pk_full[s], C::kPkTile);
          tma_load_2d(sPk + s * C::kPkTile, &p.wp, &bars->pk_full[s], kt * (BK / 2), n0);
          mbar_wait(&bars->a_empty[s], r.phase ^ 1);
          mbar_expect_tx(&bars->a_full[s], kATile);
          tma_load_2d(sA + s * kATile, &p.a, &bars->a_full[s], kt * BK, m0);
          r.advance();
        }
      }
    } else if (tid >= 32) {
      // ---- unpack: packed [BN n, 64 B] -> int8 [BN n, 128 B], swizzled ----
      const int ut = tid - 32;
      Ring<C::kStages> r;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&bars->pk_full[r.stage], r.phase);
          mbar_wait(&bars->w_empty[r.stage], r.phase ^ 1);
          const uint8_t* src = sPk + r.stage * C::kPkTile;
          uint8_t* dst = sW + r.stage * C::kWTile;
          // kItems pieces over 96 threads, kInFlight at a time a thread (that
          // loop is not unrolled: more would not fit the producer's registers);
          // the ragged end is uniform over a warp (kItems % 32 == 0)
          constexpr int kBatched = C::kItems / (kInFlight * kUnpackThreads) * kInFlight;
#pragma unroll 1
          for (int u = 0; u < kBatched; u += kInFlight) {
            uint4 v[kInFlight];
#pragma unroll
            for (int f = 0; f < kInFlight; ++f)
              v[f] = *reinterpret_cast<const uint4*>(src + (ut + (u + f) * kUnpackThreads) * 16);
#pragma unroll
            for (int f = 0; f < kInFlight; ++f)
              unpack_piece(dst, ut + (u + f) * kUnpackThreads, v[f]);
          }
#pragma unroll
          for (int u = kBatched; u * kUnpackThreads < C::kItems; ++u) {
            const int i = ut + u * kUnpackThreads;
            if (i < C::kItems) unpack_piece(dst, i, *reinterpret_cast<const uint4*>(src + i * 16));
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(&bars->w_full[r.stage]);
            mbar_arrive(&bars->pk_empty[r.stage]);
          }
          r.advance();
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of every tile each ----
    reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = (tid >> 5) & 3;
    uint8_t* stg = sOut + (cw * 4 + warp) * kWarpStage;
    const uint32_t a_base = wanq::smem_addr(sA) + cw * 64 * BK;
    const uint32_t w_base = wanq::smem_addr(sW);
    const bool fast = fast_epilogue<MODE>(p.e);

    int acc[BN / 2];
    Ring<C::kStages> r;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&bars->a_full[r.stage], r.phase);
        mbar_wait(&bars->w_full[r.stage], r.phase);
        const uint64_t da = kmajor_desc(a_base + r.stage * kATile);
        const uint64_t db = kmajor_desc(w_base + r.stage * C::kWTile);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks)
          mma<BN>(acc, desc_advance(da, ks * 32), desc_advance(db, ks * 32), (kt | ks) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the stage before this one has been read
        if (kt > 0 && lane == 0) {
          mbar_arrive(&bars->a_empty[prev]);
          mbar_arrive(&bars->w_empty[prev]);
        }
        prev = r.stage;
        r.advance();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) {
        mbar_arrive(&bars->a_empty[prev]);
        mbar_arrive(&bars->w_empty[prev]);
      }
      // the unpack wrote 16 * code: acc holds 16 * the integer sum, exactly
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] >>= 4;
      run_epilogue<BN, MODE>(p.e, fast, acc, stg, m0 + cw * 64 + warp * 16, n0, lane);
    }
  }
}

template <int BN, int MODE>
int launch(const Params& p, cudaStream_t st) {
  using C = Cfg<BN>;
  auto kern = w4a8_gemm_kernel<BN, MODE>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = (long long)((p.e.M + BM - 1) / BM) * (p.e.N / BN);
  kern<<<persistent_grid(n_tiles), kThreads, C::kSmemBytes, st>>>(p);
  return (int)cudaGetLastError();
}

// The output tile is 128 x 256 where 256 divides N, as it does every width of
// the Wan models; the 128 x 128 tile serves the rest of the contract
// N % 128 == 0. K < 2^17 keeps 16 * acc inside an int32.
template <int MODE>
int run(Params& p, const void* a, const void* wp, cudaStream_t st) {
  const int M = p.e.M, N = p.e.N;
  if (M == 0) return 0;
  const int tile_n = N % 256 == 0 ? 256 : 128;
  if (N <= 0 || N % tile_n != 0 || p.K % BK != 0 || p.K <= 0 || p.K >= (1 << 17) ||
      (long long)((M + BM - 1) / BM) * (N / tile_n) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!encode_map_bytes_2d(&p.a, a, M, p.K, BM, BK) ||
      !encode_map_bytes_2d(&p.wp, wp, N, p.K / 2, tile_n, BK / 2, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  return tile_n == 256 ? launch<256, MODE>(p, st) : launch<128, MODE>(p, st);
}

}  // namespace

// a [M, K] int8, wp [N, K/2] packed int4 (both 16-byte aligned), s_a/sum_a [M]
// f32, s_w/zp_w/bias [N] f32. N % 128 == 0, K % 128 == 0 (all Wan linears);
// sum_a, zp_w, bias may be null (sum_a is read only when zp_w is given).
WANQ_API int wanq_w4a8_gemm(const void* a, const void* wp, const void* s_a, const void* s_w,
                            const void* sum_a, const void* zp_w, const void* bias, void* out,
                            int out_bf16, int M, int N, int K, void* stream) {
  Params p;
  p.e = make_epilogue(s_a, s_w, sum_a, zp_w, bias, out, M, N);
  p.K = K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? run<kBf16>(p, a, wp, st) : run<kF32>(p, a, wp, st);
}

// The GELU + static quant mode: the operands as above, scale2 one f32 on the
// device; out_q int8 [M, N] gets the codes and rowsum int32 [M], which the
// caller has zeroed, their row sums.
WANQ_API int wanq_w4a8_gemm_gelu_quant(const void* a, const void* wp, const void* s_a,
                                       const void* s_w, const void* sum_a, const void* zp_w,
                                       const void* bias, const void* scale2, void* out_q,
                                       void* rowsum, int M, int N, int K, void* stream) {
  Params p;
  p.e = make_epilogue(s_a, s_w, sum_a, zp_w, bias, out_q, M, N);
  p.e.scale2 = static_cast<const float*>(scale2);
  p.e.rowsum = static_cast<int*>(rowsum);
  p.K = K;
  return run<kGeluQuant>(p, a, wp, static_cast<cudaStream_t>(stream));
}
