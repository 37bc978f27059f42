// Hopper-only building blocks shared by the attention kernels (K4
// flash_attention.cu, K10 attention_int8.cu, K11 / K12 flash_attention_bwd.cu)
// and the int GEMMs (K2 w8a8_gemm.cu, K8 w4a8_gemm.cu, K9 w4a4_gemm.cu):
// mbarriers, TMA tile loads and
// stores, wgmma (warpgroup MMA) with its shared-memory descriptors, named
// barriers, setmaxnreg, and the host-side tensor-map encoder.
//
// The kernels built from these share one skeleton: a block of three
// warpgroups, one producer (a single thread of it starts TMA loads into a ring
// of 128-byte-swizzled tiles, each stage guarded by a full and an empty
// mbarrier) and two consumers of 64 rows each, which run the products on
// wgmma with the accumulators in registers.
//
// Shared-memory tiles are [rows][128 bytes] with the 128-byte swizzle (the
// 16-byte chunk c of row r lies at chunk c ^ (r % 8)), as TMA writes them
// under CU_TENSOR_MAP_SWIZZLE_128B; every tile base is 1024-byte aligned.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

namespace wanq {
namespace sm90 {

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A freshly
// initialised barrier counts as having completed a phase of parity 1, so a
// producer's first wait on an empty barrier (parity 1) passes at once. The
// loop holds nothing but the try_wait: a __trap() on a timeout in here makes
// ptxas give up on the per-role register budgets of setmaxnreg (every wgmma is
// then serialised and the accumulators spill).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Position in a ring of N stages, each guarded by a full and an empty barrier:
// a consumer waits for full[stage] at `phase`, a producer for empty[stage] at
// `phase ^ 1`. A parity tells apart only two neighbouring uses of a stage, so
// every thread that waits on a ring walks all of its uses in order.
template <int N>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == N) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Box of `map` at coordinates (c0 innermost) -> shared `dst`; the bytes are
// counted on `bar`. Out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory at `src` -> shared
// `dst`, both 16-byte aligned; the bytes are counted on `bar`.
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared `src` -> box of `map`; elements outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the committed stores have read their shared-memory source.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders ordinary shared-memory writes before later TMA / wgmma reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// warpgroup roles
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barriers (ids 1..15; 0 is __syncthreads): sync blocks until `count`
// threads have arrived, arrive does not block.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Before the first wgmma, and whenever registers that a later wgmma reads or
// accumulates into were written by ordinary instructions.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers at this point of the program, so the compiler
// moves no read or write of them across a wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor for a 128-byte-swizzled operand at shared
// address `addr`. K-major operands ([rows][k], k contiguous; `kmajor_desc`):
// groups of 8 rows lie 1024 bytes apart (SBO), the leading offset is unused;
// one k step of 32 bytes advances the address by 32. MN-major operands
// ([k][mn], mn contiguous, 64 elements = 128 bytes a row; `mnmajor_desc`):
// groups of 8 k rows lie 1024 bytes apart (SBO) and the next 64 mn elements
// `lbo` bytes away; one k step of 16 rows advances the address by 2048.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return make_desc(addr, 16, 1024); }

__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t lbo) {
  return make_desc(addr, lbo, 1024);
}

// Descriptor of the same operand `bytes` further on (a multiple of 16).
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

#define WANQ_R8(m, a, o) \
  m(a[o]), m(a[o + 1]), m(a[o + 2]), m(a[o + 3]), m(a[o + 4]), m(a[o + 5]), m(a[o + 6]), m(a[o + 7])
#define WANQ_R64(m, a)                                                                     \
  WANQ_R8(m, a, 0), WANQ_R8(m, a, 8), WANQ_R8(m, a, 16), WANQ_R8(m, a, 24), WANQ_R8(m, a, 32), \
      WANQ_R8(m, a, 40), WANQ_R8(m, a, 48), WANQ_R8(m, a, 56)
#define WANQ_INOUT_F(x) "+f"(x)
#define WANQ_INOUT_R(x) "+r"(x)
#define WANQ_ACC64                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// A 64 x 128 accumulator tile of a warpgroup, 64 registers a thread: thread
// (warp w of the group, g = lane / 4, tig = lane % 4) holds in d[4 j + e] the
// element of row 16 w + g + 8 (e / 2), column 8 j + 2 tig + (e % 2) -- the
// mma.sync m16n8 C fragment, tiled over the columns.

// d (+)= A[64 x 16] . B[128 x 16]^T, bf16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WANQ_ACC64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WANQ_R64(WANQ_INOUT_F, d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#define WANQ_R32(m, a) WANQ_R8(m, a, 0), WANQ_R8(m, a, 8), WANQ_R8(m, a, 16), WANQ_R8(m, a, 24)
#define WANQ_ACC32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// The same at half the width: d (+)= A[64 x 16] . B[64 x 16]^T into a 64 x 64
// tile, 32 registers a thread, d[4 j + e] as above with j < 8.
__device__ __forceinline__ void wgmma_bf16_ss_n64(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WANQ_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WANQ_R32(WANQ_INOUT_F, d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A[64 x 16] . B[16 x 128], bf16, A from registers (the mma.sync
// m16n8k16 A fragment: a0 row g, k 2 tig..; a1 row g + 8; a2, a3 the
// same rows at k + 8), B MN-major in shared memory (transposed read).
__device__ __forceinline__ void wgmma_bf16_rs_mn(float (&d)[64], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WANQ_ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WANQ_R64(WANQ_INOUT_F, d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// d (+)= A[64 x 32] . B[128 x 32]^T, int8 -> int32, both K-major in shared
// memory (integer wgmma takes K-major operands only).
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WANQ_ACC64
      ", %64, %65, p;\n"
      "}\n"
      : WANQ_R64(WANQ_INOUT_R, d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#define WANQ_R128(m, a)                                                                  \
  WANQ_R64(m, a), WANQ_R8(m, a, 64), WANQ_R8(m, a, 72), WANQ_R8(m, a, 80), WANQ_R8(m, a, 88), \
      WANQ_R8(m, a, 96), WANQ_R8(m, a, 104), WANQ_R8(m, a, 112), WANQ_R8(m, a, 120)
#define WANQ_ACC128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// The same at twice the width: d (+)= A[64 x 32] . B[256 x 32]^T into a
// 64 x 256 tile, 128 registers a thread, d[4 j + e] as above with j < 32.
__device__ __forceinline__ void wgmma_s8_ss_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WANQ_ACC128
      ", %128, %129, p;\n"
      "}\n"
      : WANQ_R128(WANQ_INOUT_R, d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The same with A from registers (the mma.sync m16n8k32 A fragment: a0 row
// g, k bytes 4 tig..4 tig + 3; a1 row g + 8; a2, a3 at k + 16).
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WANQ_ACC64
      ", {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : WANQ_R64(WANQ_INOUT_R, d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda that the CUDA runtime has
// already mapped into the process, so the library links against no stub of it.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A tiled map over `rank` dimensions (innermost first) with the 128-byte
// swizzle: `dims` in elements, `strides` in bytes for dimensions 1..rank-1
// (multiples of 16), `box` the tile in elements (its innermost extent spans at
// most 128 bytes), or unswizzled (rows of the box packed densely) when
// `swizzle` says so. Returns false if libcuda refuses the map.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map over bytes [rows, row_bytes] (row_bytes contiguous, a multiple of
// 16) with boxes of `box_rows` rows x `box_bytes` bytes (at most 256 x 128).
// Boxes may reach past either extent: what lies outside loads as zeros.
inline bool encode_map_bytes_2d(CUtensorMap* map, const void* base, long long rows,
                                long long row_bytes, int box_rows, int box_bytes,
                                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_bytes, (cuuint32_t)box_rows};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box, swizzle);
}

}  // namespace sm90
}  // namespace wanq
