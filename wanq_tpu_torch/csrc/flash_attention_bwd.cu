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
//   K12: dQ = scale * dS K      one block per 64 query rows walks the kv tiles
//   K11: dV = P^T dO, dK = scale * dS^T Q
//                               one block per 64 keys walks the query tiles
// Keys at or past kv_valid are masked (P = 0), so their dK and dV are zero;
// query rows past Sq load as zeros with lse = +inf. Sums are f32, the outputs
// bf16, written contiguous [B, S, H, D].
//
// Bound on the H100: tensor-core throughput. K12 does three S-sized products
// (S, dP, dQ) and K11 four (S, dP, dV, dK), 2 S_q S_k D flops each per head,
// against O(S D) bytes. Design, the simple first one (a later PR makes it
// fast): four warps, each owning 16 rows of the block's 64, run mma.sync
// m16n8k16 bf16 with f32 accumulators; operand tiles [rows, 128] bf16 reach
// shared memory by cp.async (16 bytes a thread, a two-stage ring for the tiles
// the loop walks) in a layout whose 16-byte chunk c of row r lies at c ^ (r %
// 8), so the ldmatrix reads of eight rows hit eight distinct bank groups. The
// probabilities and dS go from the accumulators of one product straight into
// the A fragments of the next (the m16n8 accumulator layout is the m16k16 A
// layout), as in K4.
#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int BM = 64;                   // rows a block owns: 4 warps x 16
constexpr int kThreads = 128;
constexpr int kRowBytes = D * 2;         // 256: one row of a tile
constexpr int kBnDq = 64;                // K12: keys a loop step
constexpr int kBnDkv = 32;               // K11: query rows a loop step
constexpr float kLog2e = 1.4426950408889634f;

struct Operand {
  const __nv_bfloat16* ptr;
  long long ss, sh, sb;                  // element strides of seq, head, batch
};

struct Params {
  Operand q, k, v, dout;
  const float* lse;                      // [B, H, Sq], natural log
  const float* di;                       // [B, H, Sq]
  __nv_bfloat16* out_a;                  // K12: dq; K11: dk
  __nv_bfloat16* out_b;                  // K11: dv
  int H, Sq, Sk, kv_valid;
  float scale, scale_log2;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte address of element (row, col) of a [rows, 128] tile, col a multiple of 8.
__device__ __forceinline__ uint32_t tile_at(uint32_t base, int row, int col) {
  return base + row * kRowBytes + ((((col >> 3) ^ row) & 7) | ((col >> 3) & 8)) * 16;
}

// Rows [row0, row0 + ROWS) of one (batch, head) of `op` into a tile; rows at
// or past `limit` are zeros.
template <int ROWS>
__device__ __forceinline__ void load_tile(uint32_t base, const Operand& op, int b, int h, int row0,
                                          int limit) {
#pragma unroll
  for (int j = 0; j < ROWS * 16 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i >> 4, c = (i & 15) * 8;
    const bool ok = row0 + r < limit;
    const __nv_bfloat16* src =
        op.ptr + (ok ? b * op.sb + (long long)(row0 + r) * op.ss + h * op.sh + c : 0);
    cp_async16(tile_at(base, r, c), src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc[16 x 8 NT] = A[a_row0 .. a_row0 + 16, :] . B[0 .. 8 NT, :]^T over the
// 128 columns, A and B tiles in shared memory (the warp's slice of S = Q K^T,
// dP = dO V^T and their transposes).
template <int NT>
__device__ __forceinline__ void rows_x_tile_t(float (&acc)[NT][4], uint32_t a_base, int a_row0,
                                              uint32_t b_base) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, tile_at(a_base, a_row0 + (lane & 15), kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, tile_at(b_base, np * 16 + (lane & 7) + ((lane >> 4) << 3),
                          kk * 16 + ((lane >> 3) & 1) * 8));
      mma_bf16(acc[2 * np], a, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// acc[16 x 128] += P[16 x 8 NT] . B[0 .. 8 NT, :], P in accumulator registers
// (rounded to bf16 here) and B a tile in shared memory whose rows are the
// product's depth (dQ += dS K, dV += P^T dO, dK += dS^T Q).
template <int NT>
__device__ __forceinline__ void regs_x_tile(float (&acc)[16][4], const float (&p)[NT][4],
                                            uint32_t b_base) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ldsm_x4_t(bf, tile_at(b_base, kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            dp * 16 + (lane >> 4) * 8));
      mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
    }
  }
}

// The warp's 16 rows of a [B, S, H, D] contiguous bf16 output, times `scale`;
// rows at or past `limit` are not written.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[16][4],
                                           float scale, int b, int h, int H, int S, int row0,
                                           int limit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= limit) continue;
    __nv_bfloat16* dst = out + (((long long)b * S + row) * H + h) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
  }
}

constexpr int kTileDq = BM * kRowBytes;                       // 16 KB
constexpr int kSmemDq = 2 * kTileDq + 2 * 2 * kBnDq * kRowBytes;  // Q, dO, 2 x (K, V): 96 KB

// K12: dQ for the 64 query rows of block x, head y, batch z.
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_q = wanq::smem_addr(smem), s_do = s_q + kTileDq;
  const uint32_t s_kv = s_do + kTileDq;  // stage st: K at + st * 2 tiles, V one tile after
  constexpr int kKv = kBnDq * kRowBytes;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int n_tiles = (p.kv_valid + kBnDq - 1) / kBnDq;

  load_tile<BM>(s_q, p.q, b, h, q0, p.Sq);
  load_tile<BM>(s_do, p.dout, b, h, q0, p.Sq);
  load_tile<kBnDq>(s_kv, p.k, b, h, 0, p.kv_valid);
  load_tile<kBnDq>(s_kv + kKv, p.v, b, h, 0, p.kv_valid);
  cp_async_commit();

  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    const long long at = ((long long)b * p.H + h) * p.Sq + row;
    lse2[r] = row < p.Sq ? p.lse[at] * kLog2e : INFINITY;
    di[r] = row < p.Sq ? p.di[at] : 0.f;
  }
  float dq[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t s_k = s_kv + (j & 1) * 2 * kKv, s_v = s_k + kKv;
    if (j + 1 < n_tiles) {
      const uint32_t n_k = s_kv + ((j + 1) & 1) * 2 * kKv;
      load_tile<kBnDq>(n_k, p.k, b, h, (j + 1) * kBnDq, p.kv_valid);
      load_tile<kBnDq>(n_k + kKv, p.v, b, h, (j + 1) * kBnDq, p.kv_valid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_x_tile_t<8>(s, s_q, warp * 16, s_k);
    rows_x_tile_t<8>(dp, s_do, warp * 16, s_v);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kBnDq + nt * 8 + tig * 2 + (e & 1);
        const float pr = col < p.kv_valid ? ex2_approx(fmaf(s[nt][e], p.scale_log2, -lse2[e >> 1]))
                                          : 0.f;
        s[nt][e] = pr * (dp[nt][e] - di[e >> 1]);  // dS
      }
    }
    regs_x_tile<8>(dq, s, s_k);
    __syncthreads();
  }
  store_rows(p.out_a, dq, p.scale, b, h, p.H, p.Sq, q0 + warp * 16, p.Sq);
}

constexpr int kTileDkv = BM * kRowBytes;                       // 16 KB: K or V
constexpr int kStepDkv = kBnDkv * kRowBytes;                    // 8 KB: 32 rows of Q or dO
constexpr int kSmemDkv = 2 * kTileDkv + 4 * kStepDkv + 2 * 2 * kBnDkv * 4;

// K11: dK and dV for the 64 keys of block x, head y, batch z.
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_k = wanq::smem_addr(smem), s_v = s_k + kTileDkv;
  const uint32_t s_qd = s_v + kTileDkv;  // stage st: Q at + st * 2 steps, dO one step after
  // stage st: the 32 rows' lse (log2 units) and di
  float* s_rows = reinterpret_cast<float*>(smem + 2 * kTileDkv + 4 * kStepDkv);
  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  float dk[16][4], dv[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  if (k0 < p.kv_valid) {
    const int n_steps = (p.Sq + kBnDkv - 1) / kBnDkv;
    const long long rows_at = ((long long)b * p.H + h) * p.Sq;
    auto stage_rows = [&](int st, int q0) {
      if (threadIdx.x < kBnDkv) {
        const int row = q0 + threadIdx.x;
        s_rows[st * 2 * kBnDkv + threadIdx.x] =
            row < p.Sq ? p.lse[rows_at + row] * kLog2e : INFINITY;
        s_rows[st * 2 * kBnDkv + kBnDkv + threadIdx.x] = row < p.Sq ? p.di[rows_at + row] : 0.f;
      }
    };
    load_tile<BM>(s_k, p.k, b, h, k0, p.kv_valid);
    load_tile<BM>(s_v, p.v, b, h, k0, p.kv_valid);
    load_tile<kBnDkv>(s_qd, p.q, b, h, 0, p.Sq);
    load_tile<kBnDkv>(s_qd + kStepDkv, p.dout, b, h, 0, p.Sq);
    cp_async_commit();
    stage_rows(0, 0);
    int key[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) key[r] = k0 + warp * 16 + g + r * 8;

    for (int i = 0; i < n_steps; ++i) {
      const int st = i & 1;
      const uint32_t s_q = s_qd + st * 2 * kStepDkv, s_do = s_q + kStepDkv;
      if (i + 1 < n_steps) {
        const uint32_t n_q = s_qd + (st ^ 1) * 2 * kStepDkv;
        load_tile<kBnDkv>(n_q, p.q, b, h, (i + 1) * kBnDkv, p.Sq);
        load_tile<kBnDkv>(n_q + kStepDkv, p.dout, b, h, (i + 1) * kBnDkv, p.Sq);
        stage_rows(st ^ 1, (i + 1) * kBnDkv);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();

      const float* lse2 = s_rows + st * 2 * kBnDkv;
      const float* di = lse2 + kBnDkv;
      float pt[4][4], dst[4][4];
      rows_x_tile_t<4>(pt, s_k, warp * 16, s_q);    // S^T = K Q^T
      rows_x_tile_t<4>(dst, s_v, warp * 16, s_do);  // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + tig * 2 + (e & 1);
          const float pr = key[e >> 1] < p.kv_valid
                               ? ex2_approx(fmaf(pt[nt][e], p.scale_log2, -lse2[qc]))
                               : 0.f;
          pt[nt][e] = pr;                             // P^T
          dst[nt][e] = pr * (dst[nt][e] - di[qc]);    // dS^T
        }
      }
      regs_x_tile<4>(dv, pt, s_do);   // dV += P^T dO
      regs_x_tile<4>(dk, dst, s_q);   // dK += dS^T Q
      __syncthreads();
    }
  }
  store_rows(p.out_a, dk, p.scale, b, h, p.H, p.Sk, k0 + warp * 16, p.Sk);
  store_rows(p.out_b, dv, 1.f, b, h, p.H, p.Sk, k0 + warp * 16, p.Sk);
}

bool fill_params(Params& p, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* di, const long long* st, int H, int Sq, int Sk,
                 int kv_valid, float scale, long long B) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || kv_valid < 1 || kv_valid > Sk || Sq < 1 ||
      !(scale > 0.f))
    return false;
  const void* ptrs[4] = {q, k, v, dout};
  Operand* ops[4] = {&p.q, &p.k, &p.v, &p.dout};
  for (int i = 0; i < 4; ++i) {
    // 16-byte cp.async reads: every row must start on 16 bytes
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 || st[3 * i] % 8 || st[3 * i + 1] % 8 ||
        st[3 * i + 2] % 8)
      return false;
    *ops[i] = {static_cast<const __nv_bfloat16*>(ptrs[i]), st[3 * i], st[3 * i + 1],
               st[3 * i + 2]};
  }
  p.lse = lse;
  p.di = di;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.kv_valid = kv_valid;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return true;
}

}  // namespace

// Operands q [B, Sq, H, 128], k/v [B, Sk, H, 128], dout [B, Sq, H, 128], bf16
// through element strides (seq, head, batch) each (`strides`: q, k, v, dout
// in turn), multiples of 8 with 16-byte aligned bases; lse and di f32 [B, H,
// Sq] contiguous. dq: bf16 [B, Sq, H, 128] contiguous. 1 <= kv_valid <= Sk.
WANQ_API int wanq_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* di, void* dq, long long B, int H,
                               int Sq, int Sk, const long long* strides, int kv_valid,
                               float scale, void* stream) {
  Params p;
  if (!fill_params(p, q, k, v, dout, lse, di, strides, H, Sq, Sk, kv_valid, scale, B))
    return (int)cudaErrorInvalidValue;
  p.out_a = static_cast<__nv_bfloat16*>(dq);
  p.out_b = nullptr;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BM - 1) / BM, H, (unsigned)B);
  flash_bwd_dq_kernel<<<grid, kThreads, kSmemDq, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The same operands; dk, dv: bf16 [B, Sk, H, 128] contiguous, zero at keys >=
// kv_valid.
WANQ_API int wanq_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* di, void* dk, void* dv,
                                long long B, int H, int Sq, int Sk, const long long* strides,
                                int kv_valid, float scale, void* stream) {
  Params p;
  if (!fill_params(p, q, k, v, dout, lse, di, strides, H, Sq, Sk, kv_valid, scale, B))
    return (int)cudaErrorInvalidValue;
  p.out_a = static_cast<__nv_bfloat16*>(dk);
  p.out_b = static_cast<__nv_bfloat16*>(dv);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDkv);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sk + BM - 1) / BM, H, (unsigned)B);
  flash_bwd_dkv_kernel<<<grid, kThreads, kSmemDkv, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
