// Hopper (sm_90a) tensor-core and copy helpers shared by the hand-written
// kernels of repro_torch: warpgroup wgmma with its shared-memory
// descriptors, mbarriers, TMA loads and the tensor-map encoder, and the
// row staging and bf16 packing of the flash-attention kernels (forward and
// backward).  One copy, so every kernel uses the same layouts.
#pragma once

#include <cuda.h>   // CUtensorMap (types only: the encoder is fetched at run time)

#include "common.cuh"

namespace repro {

// --- wgmma (sm_90a) operands in shared memory, 128-byte swizzle -------------
// A tile is stored as 64-column panels; a panel is rows x 128 bytes, its
// 16-byte chunks XOR-swizzled by row % 8, so 8 rows form one 1024-byte
// swizzle atom (panel bases 1024-byte aligned).  TMA writes this layout.
template <int R>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {   // c: 16-byte chunk
  return static_cast<uint32_t>((c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Matrix descriptor: start address, leading / stride byte offsets, 128B swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// d (64 x N f32 per warp group) (+)= a (64 x 16 bf16, registers) . b (16 x N
// bf16, shared memory through desc); N = 8 NT.  TB 0: b is K-major (its N
// rows are k-contiguous); TB 1: b is N-contiguous and read transposed.
// scale_d 0 ignores d's old values.  Each warp supplies its 16 rows of a as
// an m16n8k16 A fragment and holds its 16 rows of d (d[i] = columns 8 i ..).
#define REPRO_ACC1(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define REPRO_ACC2(i) REPRO_ACC1(i), REPRO_ACC1(i + 1)
#define REPRO_ACC4(i) REPRO_ACC2(i), REPRO_ACC2(i + 2)
#define REPRO_ACC8(i) REPRO_ACC4(i), REPRO_ACC4(i + 4)
#define REPRO_ACC16(i) REPRO_ACC8(i), REPRO_ACC8(i + 8)
// one wgmma of N columns: D, A, desc, scale_d and TB are the operand numbers
#define REPRO_WGMMA_RS(N, D, A, DESC, SD, TBO, ACC)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SD ", 0;\n"                     \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32.bf16.bf16 "           \
               "{" D "}, {" A "}, " DESC ", p, 1, 1, " TBO ";\n}\n"               \
               : ACC                                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), \
                 "n"(TB))
template <int NT, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[NT][4], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  static_assert(NT == 1 || NT == 2 || NT == 4 || NT == 8 || NT == 16, "N is 8 .. 128");
  if constexpr (NT == 1)
    REPRO_WGMMA_RS("8", "%0, %1, %2, %3",
                   "%4, %5, %6, %7", "%8", "%9", "%10", REPRO_ACC1(0));
  if constexpr (NT == 2)
    REPRO_WGMMA_RS("16", "%0, %1, %2, %3, %4, %5, %6, %7",
                   "%8, %9, %10, %11", "%12", "%13", "%14", REPRO_ACC2(0));
  if constexpr (NT == 4)
    REPRO_WGMMA_RS("32", "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15",
                   "%16, %17, %18, %19", "%20", "%21", "%22", REPRO_ACC4(0));
  if constexpr (NT == 8)
    REPRO_WGMMA_RS("64", "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31",
                   "%32, %33, %34, %35", "%36", "%37", "%38", REPRO_ACC8(0));
  if constexpr (NT == 16)
    REPRO_WGMMA_RS("128", "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63",
                   "%64, %65, %66, %67", "%68", "%69", "%70", REPRO_ACC16(0));
}
#undef REPRO_WGMMA_RS
#undef REPRO_ACC16
#undef REPRO_ACC8
#undef REPRO_ACC4
#undef REPRO_ACC2
#undef REPRO_ACC1

// d (64 x 64 f32 per warp group) (+)= a (64 x 16 bf16) . b (16 x 64 bf16),
// both from shared memory through descriptors, both K-major; scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// --- flash attention's register and staging helpers --------------------------
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage R rows into a swizzled tile by 16-byte cp.async (the caller
// commits).  row_of(r) gives row r's first element, or nullptr for a
// padding row; padding rows and columns past hd become zeros.
template <int HD, int R, int THREADS, typename RowOf>
__device__ __forceinline__ void stage_rows(char* tile, int hd, const __nv_bfloat16* any,
                                           RowOf row_of) {
  constexpr int CPR = HD / 8;              // 16-byte chunks per row
  const uint32_t base = smem_u32(tile);
  for (int i = threadIdx.x; i < R * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const __nv_bfloat16* row = row_of(r);
    const bool live = row != nullptr && c * 8 < hd;
    cp_async<16>(base + tile_off<R>(r, c), live ? row + c * 8 : any, live ? 16 : 0);
  }
}

// --- mbarriers and TMA (sm_90) ---------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// one box of a 3-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (d0, d1, d2) tensor, d0 contiguous, as boxes of (b0, b1, 1): bf16 rows
// (hd, rows, heads) in 64 x 64 boxes in the 128-byte swizzle, or f32 in
// plain boxes.  False if the encoder refuses it.
inline bool tensor_map_3d(CUtensorMap* map, const void* base, bool is_f32, int d0, int d1,
                          int d2, int b0, int b1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t e = is_f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {dims[0] * e, dims[0] * dims[1] * e};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, is_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            is_f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace repro
