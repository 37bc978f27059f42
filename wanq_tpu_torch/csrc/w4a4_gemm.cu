// K9: Atom-style W4A4 GEMM -- int4 activations x packed int4 weights, each
// with one scale per 128-wide K group, scaled into an f32 accumulator.
//
// Replaces the TPU kernel wanq_tpu/ops/qgemm.py:492 w4a4_linear_pallas
// (kernel _w4a4_kernel :455). For A int4 codes in int8 containers [M, K]
// (values in [-8, 7]), the packed weight Wp int8 [N, K/2] (K-major: byte j
// of row n holds k = 2j in its low nibble and k = 2j + 1 in its high one),
// s_a f32 [M, G] and s_w f32 [G, N] with G = K / 128:
//   for g = 0 .. G-1, in this order:
//     acc[m, n] = acc + f32(A_g @ unpack(Wp)_g^T) * (s_a[m, g] * s_w[g, n])
//   out = acc + bias[n]                               (f32 or bf16)
// which is the reference's loop (w4a4_linear_xla, qgemm.py:440-451). Every
// f32 step is an _rn intrinsic in that order (no FMA contraction) and
// int32 -> f32 is exact (|partial| <= 128 * 64, times 16 as the kernel holds
// it), so the result matches the plain version bit for bit. The weight stays
// packed in device memory.
//
// Bound on the H100: the tensor cores by the operation count, and level with
// them the ordinary instructions of the per-group rescale: a 128 x 128 tile
// and one group are 4.19 M int8 operations, ~490 cycles of an SM at the card's
// peak, and the rescale is four instructions per accumulator (I2F,
// s_a * s_w, multiply, add) x 16384 accumulators over 128 lanes, ~510 cycles.
// So the kernel can approach twice its tensor-core bound only if the two run
// at the same time, and the design is built around that. A third limit sits
// beside them: shared-memory bandwidth. Per tile and group the two
// warpgroups' wgmma read 48 KB of operands (each reads the W tile anew), TMA
// writes 24.5 KB and the unpack moves 24 KB, with the s_w reads ~110 KB, ~860
// cycles at 128 bytes a cycle.
// Design (gemm_sm90.cuh, sm90.cuh): one persistent block per SM walks 128 x
// 128 output tiles; one K step is one group. There is no int4 tensor-core
// type on this card, so the codes ride wgmma m64n128k32.s8 in int8
// containers, and the B operand of a wgmma is read from shared memory only:
// the packed tile has to be unpacked into shared memory. The producer
// warpgroup does it, beside the consumers. Its first warp issues the TMA
// loads into three rings of four stages: A [128 rows, 128 B] with the 128-byte
// swizzle, the packed tile [128 n, 64 B] unswizzled and the group's 512 bytes
// of s_w. Its other three warps turn each packed tile (gemm_sm90.cuh unpack_piece) into the int8 tile
// [128 n, 128 B] in the swizzled layout wgmma reads (a fourth ring), fence it
// towards the async proxy and arrive on its barrier. They write each code times 16 (the nibble moved to the top of its
// byte, which sign-extends for free: five instructions per eight codes), and
// the consumers fold the 1/16 into s_a: both scalings are by powers of two, so
// every rounding is the one of the unscaled product (as long as s_a / 16
// stays a normal number). Each of the two consumer warpgroups (64 rows) holds
// two int32 accumulator sets and one f32 set (192 registers): the product of
// group g + 1 is queued into the other set before the rescale of group g runs,
// so the tensor cores work under the rescale, and the two warpgroups are free
// to drift apart. The A and W stages are released as soon as the product has
// been read, the s_w slot after the rescale. s_a[m, g] (two rows a thread) is
// loaded a group ahead from device memory. The epilogue (+ bias, f32 or bf16)
// is K2's store path: 16 rows a warp staged through shared memory, 16 bytes a
// thread.
#include "gemm_sm90.cuh"

namespace {

using namespace wanq::sm90;
using namespace wanq::gemm;

constexpr int BM = 128, BN = 128, BK = 128;  // BK = the quant group
constexpr int kStages = 4;  // of each of the four rings
constexpr int kATile = BM * BK, kWTile = BN * BK;  // int8 tiles, 16 KB each
constexpr int kPkTile = BN * BK / 2;               // the packed weight tile, 8 KB
constexpr int kSwBytes = BN * 4;                   // one group's s_w of the tile
constexpr int kUnpackWarps = 3;                    // producer warps 1..3
constexpr int kUnpackThreads = 32 * kUnpackWarps;
constexpr int kItems = BN * 4;                     // 16-byte pieces of a packed tile
constexpr int kBarBytes = 384;
// the unpack warps need more registers than a thread that only issues TMA
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65536
constexpr int kSmemBytes = 1024 + kStages * (kATile + kWTile + kPkTile + kSwBytes) +
                           kStagingBytes + kBarBytes;
static_assert(kSmemBytes <= 227 * 1024, "shared memory");

struct Params {
  CUtensorMap a, wp;
  const float* s_a;
  const float* s_w;
  const float* bias;
  void* out;
  int M, N, K;
};

struct Bars {
  uint64_t a_full[kStages], a_empty[kStages];    // A tiles (TMA -> consumers)
  uint64_t pk_full[kStages], pk_empty[kStages];  // packed W tiles (TMA -> unpack warps)
  uint64_t w_full[kStages], w_empty[kStages];    // int8 W tiles (unpack warps -> consumers)
  uint64_t sw_full[kStages], sw_empty[kStages];  // s_w slices (TMA -> consumers)
};
static_assert(sizeof(Bars) <= kBarBytes, "barrier block");

template <bool kBf16Out>
__global__ void __launch_bounds__(kThreads, 1) w4a4_gemm_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sA = align_1024(smem_raw);
  uint8_t* sW = sA + kStages * kATile;
  uint8_t* sOut = sW + kStages * kWTile;
  uint8_t* sPk = sOut + kStagingBytes;
  uint8_t* sSw = sPk + kStages * kPkTile;
  Bars* bars = reinterpret_cast<Bars*>(sSw + kStages * kSwBytes);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int tiles_n = p.N / BN;
  const int n_tiles = ((p.M + BM - 1) / BM) * tiles_n;
  const int G = p.K / BK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars->a_full[s], 1);
      mbar_init(&bars->a_empty[s], 8);  // one arrival per consumer warp
      mbar_init(&bars->pk_full[s], 1);
      mbar_init(&bars->pk_empty[s], kUnpackWarps);
      mbar_init(&bars->w_full[s], kUnpackWarps);
      mbar_init(&bars->w_empty[s], 8);
      mbar_init(&bars->sw_full[s], 1);
      mbar_init(&bars->sw_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      // ---- TMA: per group the packed tile, the A tile and the s_w slice ----
      prefetch_tensormap(&p.a);
      prefetch_tensormap(&p.wp);
      Ring<kStages> r;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int g = 0; g < G; ++g) {
          const int s = r.stage;
          mbar_wait(&bars->pk_empty[s], r.phase ^ 1);
          mbar_expect_tx(&bars->pk_full[s], kPkTile);
          tma_load_2d(sPk + s * kPkTile, &p.wp, &bars->pk_full[s], g * (BK / 2), n0);
          mbar_wait(&bars->a_empty[s], r.phase ^ 1);
          mbar_expect_tx(&bars->a_full[s], kATile);
          tma_load_2d(sA + s * kATile, &p.a, &bars->a_full[s], g * BK, m0);
          mbar_wait(&bars->sw_empty[s], r.phase ^ 1);
          mbar_expect_tx(&bars->sw_full[s], kSwBytes);
          bulk_load_1d(sSw + s * kSwBytes, p.s_w + (long long)g * p.N + n0, kSwBytes,
                       &bars->sw_full[s]);
          r.advance();
        }
      }
    } else if (tid >= 32) {
      // ---- unpack: packed [128 n, 64 B] -> int8 [128 n, 128 B], swizzled ----
      const int ut = tid - 32;
      Ring<kStages> r;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int g = 0; g < G; ++g) {
          mbar_wait(&bars->pk_full[r.stage], r.phase);
          mbar_wait(&bars->w_empty[r.stage], r.phase ^ 1);
          const uint8_t* src = sPk + r.stage * kPkTile;
          uint8_t* dst = sW + r.stage * kWTile;
          // 512 pieces over 96 threads: five each, and 32 more for the first warp
#pragma unroll
          for (int u = 0; u < 4; u += 2) {
            const int i0 = ut + u * kUnpackThreads, i1 = i0 + kUnpackThreads;
            const uint4 v0 = *reinterpret_cast<const uint4*>(src + i0 * 16);
            const uint4 v1 = *reinterpret_cast<const uint4*>(src + i1 * 16);
            unpack_piece(dst, i0, v0);
            unpack_piece(dst, i1, v1);
          }
          {
            const int i0 = ut + 4 * kUnpackThreads, i1 = i0 + kUnpackThreads;
            const uint4 v0 = *reinterpret_cast<const uint4*>(src + i0 * 16);
            if (i1 < kItems) {  // uniform over a warp
              const uint4 v1 = *reinterpret_cast<const uint4*>(src + i1 * 16);
              unpack_piece(dst, i1, v1);
            }
            unpack_piece(dst, i0, v0);
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
    // ---- consumers: 64 rows of the tile each ----
    reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = (tid >> 5) & 3;
    const int gq = lane >> 2, tig = lane & 3;
    uint8_t* stg = sOut + (cw * 4 + warp) * kWarpStage;
    const uint32_t a_base = wanq::smem_addr(sA) + cw * 64 * BK;
    const uint32_t w_base = wanq::smem_addr(sW);

    int ia[64], ib[64];
    float facc[64];
    Ring<kStages> r;   // the stage of the next product to queue
    Ring<kStages> rr;  // the stage of the next group to release and rescale

    // Queues the product of the next group into `acc` as one wgmma group.
    auto start = [&](int (&acc)[64]) {
      mbar_wait(&bars->a_full[r.stage], r.phase);
      mbar_wait(&bars->w_full[r.stage], r.phase);
      const uint64_t da = kmajor_desc(a_base + r.stage * kATile);
      const uint64_t db = kmajor_desc(w_base + r.stage * kWTile);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        wgmma_s8_ss(acc, desc_advance(da, ks * 32), desc_advance(db, ks * 32), ks > 0);
      wgmma_commit();
      r.advance();
    };
    // After the wait that completed the oldest product in flight: its A and W
    // stages are free, and facc += f32(acc) * (s_a[m, g] * s_w[g, n]) with acc
    // holding 16 x the integer sum and sa holding s_a / 16.
    auto rescale = [&](int (&acc)[64], const float (&sa)[2]) {
      fence_regs(acc);
      if (lane == 0) {
        mbar_arrive(&bars->a_empty[rr.stage]);
        mbar_arrive(&bars->w_empty[rr.stage]);
      }
      mbar_wait(&bars->sw_full[rr.stage], rr.phase);
      const float* sw = reinterpret_cast<const float*>(sSw + rr.stage * kSwBytes) + 2 * tig;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 w2 = *reinterpret_cast<const float2*>(sw + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          facc[4 * j + 2 * h] = __fadd_rn(
              facc[4 * j + 2 * h], __fmul_rn((float)acc[4 * j + 2 * h], __fmul_rn(sa[h], w2.x)));
          facc[4 * j + 2 * h + 1] =
              __fadd_rn(facc[4 * j + 2 * h + 1],
                        __fmul_rn((float)acc[4 * j + 2 * h + 1], __fmul_rn(sa[h], w2.y)));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars->sw_empty[rr.stage]);
      rr.advance();
    };

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      const int row0 = m0 + cw * 64 + warp * 16;
      const int sa_lo = min(row0 + gq, p.M - 1) * G, sa_hi = min(row0 + gq + 8, p.M - 1) * G;
      auto load_sa = [&](float (&sa)[2], int g) {  // s_a / 16, exact
        sa[0] = __fmul_rn(__ldg(p.s_a + sa_lo + g), 0.0625f);
        sa[1] = __fmul_rn(__ldg(p.s_a + sa_hi + g), 0.0625f);
      };
#pragma unroll
      for (int i = 0; i < 64; ++i) facc[i] = 0.f;

      float sa0[2], sa1[2];
      load_sa(sa0, 0);
      start(ia);
      int g = 0;
      for (; g + 2 < G; g += 2) {
        load_sa(sa1, g + 1);
        start(ib);
        wgmma_wait<1>();
        rescale(ia, sa0);
        load_sa(sa0, g + 2);
        start(ia);
        wgmma_wait<1>();
        rescale(ib, sa1);
      }
      // one or two groups are left; ia holds group g, queued
      if (g + 1 < G) {
        load_sa(sa1, g + 1);
        start(ib);
        wgmma_wait<1>();
        rescale(ia, sa0);
        wgmma_wait<0>();
        rescale(ib, sa1);
      } else {
        wgmma_wait<0>();
        rescale(ia, sa0);
      }

      // out = facc + bias, through the warp's staging rows
      constexpr int ES = kBf16Out ? 2 : 4;
      using S = Staging<BN, ES>;
      uint8_t* out = static_cast<uint8_t*>(p.out) + ((long long)row0 * p.N + n0) * ES;
#pragma unroll
      for (int c = 0; c < S::kChunks; ++c) {
#pragma unroll
        for (int jj = 0; jj < S::CC / 8; ++jj) {
          const int j = c * (S::CC / 8) + jj;
          float2 bi = make_float2(0.f, 0.f);
          if (p.bias) bi = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + 8 * j + 2 * tig));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = facc[4 * j + 2 * h], v1 = facc[4 * j + 2 * h + 1];
            if (p.bias) {
              v0 = __fadd_rn(v0, bi.x);
              v1 = __fadd_rn(v1, bi.y);
            }
            uint8_t* dst = stg + stage_off<S::RB>(gq + 8 * h, (8 * jj + 2 * tig) * ES);
            if constexpr (kBf16Out) {
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
            } else {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            }
          }
        }
        __syncwarp();
        stage_flush<S::RB>(stg, out + c * S::RB, (long long)p.N * ES, p.M - row0, lane);
        __syncwarp();
      }
    }
  }
}

template <bool kBf16Out>
int launch(const Params& p, cudaStream_t st) {
  auto kern = w4a4_gemm_kernel<kBf16Out>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = (long long)((p.M + BM - 1) / BM) * (p.N / BN);
  kern<<<persistent_grid(n_tiles), kThreads, kSmemBytes, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// a [M, K] int8 (int4 codes), wp [N, K/2] packed int4, s_a [M, K/128] f32,
// s_w [K/128, N] f32, bias [N] f32 or null; a, wp and s_w 16-byte aligned.
// N % 128 == 0, K % 128 == 0; the quant group is 128.
WANQ_API int wanq_w4a4_gemm(const void* a, const void* wp, const void* s_a, const void* s_w,
                            const void* bias, void* out, int out_bf16, int M, int N, int K,
                            void* stream) {
  if (M == 0) return 0;
  if (N % BN != 0 || K % BK != 0 || K <= 0 || (long long)M * (K / BK) > 0x7fffffffLL ||
      (long long)((M + BM - 1) / BM) * (N / BN) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  if (!encode_map_bytes_2d(&p.a, a, M, K, BM, BK) ||
      !encode_map_bytes_2d(&p.wp, wp, N, K / 2, BN, BK / 2, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  p.s_a = static_cast<const float*>(s_a);
  p.s_w = static_cast<const float*>(s_w);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.M = M; p.N = N; p.K = K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<true>(p, st) : launch<false>(p, st);
}
