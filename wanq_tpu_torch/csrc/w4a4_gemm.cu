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
// which is the reference's loop (w4a4_linear_xla, qgemm.py:440-451).
//
// Bound on the H100: tensor-core throughput (M = 65536, K and N in
// {1536, 8960}), plus the per-group rescale, which is a multiply and an
// add per accumulator every 128 k (one f32 op per 64 int MACs). Design:
// K2/K8's skeleton (128x128 output tile per block of 8 warps, 3-stage
// cp.async ring, int8 mma.sync m16n8k32, ragged M clamped on load and
// masked on store, the packed B tile unpacked in registers with K8's
// k-permuted fragment loads; A rows padded to 160 bytes) with one K tile
// equal to one group: the tile's int32 MMA sum is exact, and at the tile's
// end each thread scales its 64 int32 partial sums by s_a[m, g] * s_w[g, n]
// into 64 f32 accumulators and clears them. The scales of the group are
// loaded at the top of the tile, so their latency hides behind the MMAs.
// Every f32 step is an _rn intrinsic in the reference's order (no FMA
// contraction), and int32 -> f32 is exact (|partial| <= 128 * 64), so the
// result matches the plain version bit for bit. Two accumulator sets take
// ~240 registers, so one block runs per SM.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 128;  // BK = the quant group
constexpr int kStages = 3;
constexpr int kRowA = BK + 32;      // padded shared A row, bytes (8 words mod 32)
constexpr int kRowB = BK / 2 + 16;  // padded shared packed-B row, bytes (20 words)
constexpr int kThreads = 256;
constexpr int kStageBytes = BM * kRowA + BN * kRowB;
constexpr int kSmemBytes = kStages * kStageBytes;

__device__ __forceinline__ void load_stage(int8_t* sa, int8_t* sb, const int8_t* __restrict__ A,
                                           const int8_t* __restrict__ Wp, int M, int K, int m0,
                                           int n0, int k0, int tid) {
  // A: 128 rows x 128 bytes = 1024 16-byte chunks, 4 per thread
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int id = tid + i * kThreads;
    int r = id >> 3, c16 = (id & 7) * 16;
    int gm = min(m0 + r, M - 1);
    wanq::cp_async16(sa + r * kRowA + c16, A + (long long)gm * K + k0 + c16);
  }
  // packed B: 128 rows x 64 bytes = 512 chunks, 2 per thread
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int id = tid + i * kThreads;
    int r = id >> 2, c16 = (id & 3) * 16;
    wanq::cp_async16(sb + r * kRowB + c16, Wp + (long long)(n0 + r) * (K / 2) + k0 / 2 + c16);
  }
}

template <bool kBf16Out>
__global__ void __launch_bounds__(kThreads, 1)
    w4a4_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Wp,
                     const float* __restrict__ s_a, const float* __restrict__ s_w,
                     const float* __restrict__ bias, void* __restrict__ out, int M, int N,
                     int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, warp tile 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int G = K / BK;

  // this thread's 8 rows (mt, half) and 8 columns (nt, j)
  int rows[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      rows[mt][half] = min(m0 + wm * 64 + mt * 16 + g + half * 8, M - 1);
  const int col0 = n0 + wn * 32 + tig * 2;

  float facc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < G) {
      int8_t* base = smem + s * kStageBytes;
      load_stage(base, base + BM * kRowA, A, Wp, M, K, m0, n0, s * BK, tid);
    }
    wanq::cp_async_commit();
  }

  for (int kt = 0; kt < G; ++kt) {
    float sa_v[4][2], sw_v[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        sa_v[mt][half] = s_a[(long long)rows[mt][half] * G + kt];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) sw_v[nt][j] = s_w[(long long)kt * N + col0 + nt * 8 + j];

    wanq::cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      int nk = kt + kStages - 1;
      if (nk < G) {
        int8_t* base = smem + (nk % kStages) * kStageBytes;
        load_stage(base, base + BM * kRowA, A, Wp, M, K, m0, n0, nk * BK, tid);
      }
      wanq::cp_async_commit();
    }
    const int8_t* stage = smem + (kt % kStages) * kStageBytes;
    const int8_t* sa = stage + wm * 64 * kRowA;
    const int8_t* sb = stage + BM * kRowA + wn * 32 * kRowB;

    int iacc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) iacc[i][j][e] = 0;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[4][4], bfr[4][2];
      wanq::load_a_frags_kperm(af, sa + ks * 32, kRowA, g, tig);
      wanq::load_b_frags_int4_kperm(bfr, sb + ks * 16, kRowB, g, tig);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) wanq::mma_s8(iacc[mt][nt], af[mt], bfr[nt]);
    }
    // acc += f32(partial) * (s_a[m, g] * s_w[g, n])
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sc = __fmul_rn(sa_v[mt][e >> 1], sw_v[nt][e & 1]);
          facc[mt][nt][e] = __fadd_rn(facc[mt][nt][e], __fmul_rn((float)iacc[mt][nt][e], sc));
        }
  }
  wanq::cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = col0 + nt * 8;
    const float b0 = bias ? bias[n] : 0.f, b1 = bias ? bias[n + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 64 + mt * 16 + g + half * 8;
        if (m >= M) continue;
        float o0 = facc[mt][nt][half * 2], o1 = facc[mt][nt][half * 2 + 1];
        if (bias) {
          o0 = __fadd_rn(o0, b0);
          o1 = __fadd_rn(o1, b1);
        }
        wanq::store_pair<kBf16Out>(out, (long long)m * N + n, o0, o1);
      }
  }
}

template <bool kBf16Out>
int launch(const void* a, const void* wp, const void* s_a, const void* s_w, const void* bias,
           void* out, int M, int N, int K, cudaStream_t st) {
  auto kern = w4a4_gemm_kernel<kBf16Out>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  kern<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(wp),
      static_cast<const float*>(s_a), static_cast<const float*>(s_w),
      static_cast<const float*>(bias), out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// a [M, K] int8 (int4 codes), wp [N, K/2] packed int4, s_a [M, K/128] f32,
// s_w [K/128, N] f32, bias [N] f32 or null. N % 128 == 0, K % 128 == 0;
// the quant group is 128.
WANQ_API int wanq_w4a4_gemm(const void* a, const void* wp, const void* s_a, const void* s_w,
                            const void* bias, void* out, int out_bf16, int M, int N, int K,
                            void* stream) {
  if (M == 0) return 0;
  if (N % BN != 0 || K % BK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<true>(a, wp, s_a, s_w, bias, out, M, N, K, st)
                  : launch<false>(a, wp, s_a, s_w, bias, out, M, N, K, st);
}
