// K8: W4A8 GEMM -- int8 activations x packed int4 weights, unpacked on chip,
// with K2's per-token x per-channel dequant epilogue.
//
// Replaces the TPU kernel wanq_tpu/ops/qgemm.py:282 w4a8_linear_pallas
// (kernel _w4a8_kernel :251, which unpacks the weight block in VMEM before
// the int8 MXU dot). For A int8 [M, K] (row-major) and the packed weight
// Wp int8 [N, K/2] (K-major: byte j of row n holds k = 2j in its low nibble
// and k = 2j + 1 in its high nibble, codes in [-8, 7]):
//   acc = A @ unpack(Wp)^T                            exact int32
//   out = f32(acc) * (s_a[m] * s_w[n]) + sum_a[m] * (zp_w[n] * s_w[n]) + bias[n]
// out f32 or bf16 [M, N]; zp_w/sum_a (asymmetric weights) and bias optional.
//
// Bound on the H100: tensor-core throughput, as K2 (M = 65536 against
// (K, N) = (1536, 8960) and (8960, 1536)); the packed weight halves the B
// bytes, which matter little at this M. Design: the skeleton of the port's
// first int GEMMs (K2 and K9 have since moved to wgmma and TMA,
// gemm_sm90.cuh; K8 is next) -- a 128x128 output tile per block of 8 warps
// (each 64x32), K in 64-deep steps through a 3-stage cp.async ring, int8
// mma.sync m16n8k32, ragged M clamped on load and masked on store -- with the
// B operand packed: the ring holds the
// PACKED [128, 32-byte] weight tile (half K2's bytes), and each thread
// unpacks its B fragment in registers right before the MMA. So that one
// 32-bit load and two byte permutes feed both B registers, k is permuted
// the same way in A and B inside each 32-deep step (common.cuh
// load_*_kperm); the int32 sums are unchanged. Shared rows are padded (A to
// 96, B to 48 bytes) so the 64-bit A and 32-bit B reads are free of bank
// conflicts. The epilogue (common.cuh dequant_epilogue) is K2's arithmetic,
// so the result matches the plain version (unpack, then K2's plain product)
// bit for bit.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kStages = 3;
constexpr int kRowA = BK + 32;      // padded shared A row, bytes (24 words mod 32)
constexpr int kRowB = BK / 2 + 16;  // padded shared packed-B row, bytes (12 words)
constexpr int kThreads = 256;
constexpr int kStageBytes = BM * kRowA + BN * kRowB;
constexpr int kSmemBytes = kStages * kStageBytes;

__device__ __forceinline__ void load_stage(int8_t* sa, int8_t* sb, const int8_t* __restrict__ A,
                                           const int8_t* __restrict__ Wp, int M, int K, int m0,
                                           int n0, int k0, int tid) {
  // A: 128 rows x 64 bytes = 512 16-byte chunks, 2 per thread
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int id = tid + i * kThreads;
    int r = id >> 2, c16 = (id & 3) * 16;
    int gm = min(m0 + r, M - 1);
    wanq::cp_async16(sa + r * kRowA + c16, A + (long long)gm * K + k0 + c16);
  }
  // packed B: 128 rows x 32 bytes = 256 chunks, 1 per thread
  {
    int r = tid >> 1, c16 = (tid & 1) * 16;
    wanq::cp_async16(sb + r * kRowB + c16, Wp + (long long)(n0 + r) * (K / 2) + k0 / 2 + c16);
  }
}

template <bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
    w4a8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Wp,
                     const float* __restrict__ s_a, const float* __restrict__ s_w,
                     const float* __restrict__ sum_a, const float* __restrict__ zp_w,
                     const float* __restrict__ bias, void* __restrict__ out, int M, int N,
                     int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, warp tile 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = K / BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) {
      int8_t* base = smem + s * kStageBytes;
      load_stage(base, base + BM * kRowA, A, Wp, M, K, m0, n0, s * BK, tid);
    }
    wanq::cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    wanq::cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      int nk = kt + kStages - 1;
      if (nk < KT) {
        int8_t* base = smem + (nk % kStages) * kStageBytes;
        load_stage(base, base + BM * kRowA, A, Wp, M, K, m0, n0, nk * BK, tid);
      }
      wanq::cp_async_commit();
    }
    const int8_t* stage = smem + (kt % kStages) * kStageBytes;
    const int8_t* sa = stage + wm * 64 * kRowA;
    const int8_t* sb = stage + BM * kRowA + wn * 32 * kRowB;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[4][4], bfr[4][2];
      wanq::load_a_frags_kperm(af, sa + ks * 32, kRowA, g, tig);
      wanq::load_b_frags_int4_kperm(bfr, sb + ks * 16, kRowB, g, tig);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) wanq::mma_s8(acc[mt][nt], af[mt], bfr[nt]);
    }
  }
  wanq::cp_async_wait<0>();

  wanq::dequant_epilogue<kBf16Out>(acc, s_a, s_w, sum_a, zp_w, bias, out, M, N, m0 + wm * 64,
                                   n0 + wn * 32, g, tig);
}

template <bool kBf16Out>
int launch(const void* a, const void* wp, const void* s_a, const void* s_w, const void* sum_a,
           const void* zp_w, const void* bias, void* out, int M, int N, int K,
           cudaStream_t st) {
  auto kern = w4a8_gemm_kernel<kBf16Out>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  kern<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(wp),
      static_cast<const float*>(s_a), static_cast<const float*>(s_w),
      static_cast<const float*>(sum_a), static_cast<const float*>(zp_w),
      static_cast<const float*>(bias), out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// a [M, K] int8, wp [N, K/2] packed int4, s_a/sum_a [M] f32, s_w/zp_w/bias
// [N] f32. N % 128 == 0, K % 128 == 0 (all Wan linears); sum_a, zp_w, bias
// may be null (sum_a is read only when zp_w is given).
WANQ_API int wanq_w4a8_gemm(const void* a, const void* wp, const void* s_a, const void* s_w,
                            const void* sum_a, const void* zp_w, const void* bias, void* out,
                            int out_bf16, int M, int N, int K, void* stream) {
  if (M == 0) return 0;
  if (N % BN != 0 || K % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<true>(a, wp, s_a, s_w, sum_a, zp_w, bias, out, M, N, K, st)
                  : launch<false>(a, wp, s_a, s_w, sum_a, zp_w, bias, out, M, N, K, st);
}
