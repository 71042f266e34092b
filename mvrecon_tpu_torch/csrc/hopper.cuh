// Hopper building blocks shared by the SYRK kernels: mbarriers, TMA tile
// loads into 128-byte-swizzled shared memory, wgmma descriptors and the
// m64n128 wgmma products, the tile walk over the lower 512-tile pairs, and
// the host-side encoding of TMA tensor maps.
//
// Both kernels have the same shape: one producer warpgroup keeps a ring of
// operand stages in flight with TMA, each stage completing on its "full"
// mbarrier; two consumer warpgroups run wgmma on each stage as it lands
// and release it on its "empty" mbarrier. Blocks are persistent, one per
// SM, and walk the 128 x 128 sub-tiles of the lower 512-tile pairs, so one
// sub-tile's epilogue overlaps the loads of the next.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kTile = 512;          // lower-triangle granularity of the output
constexpr int kBM = 128;            // output sub-tile side
constexpr int kSub = kTile / kBM;   // sub-tiles per tile side
constexpr int kSubs = kSub * kSub;  // sub-tiles per tile
constexpr int kThreads = 384;       // warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumerWarps = 8;

// (row0, col0) of sub-tile `t` in the packed order of the lower tile pairs
// (ti >= tj): output rows row0.., output columns col0..
__device__ __forceinline__ void sub_tile_origin(int t, int& row0, int& col0) {
  const int pair = t / kSubs;
  const int sub = t % kSubs;
  int ti = (int)((sqrtf(8.0f * (float)pair + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= pair) ++ti;
  while (ti * (ti + 1) / 2 > pair) --ti;
  const int tj = pair - ti * (ti + 1) / 2;
  row0 = ti * kTile + (sub / kSub) * kBM;
  col0 = tj * kTile + (sub % kSub) * kBM;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA ----------------------------------------------------------------

// the box at (c0 innermost, c1) of `map` into shared memory; completion is
// counted in bytes on `bar`; elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory writes of this thread become visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- named barriers -------------------------------------------------------

// named barrier `id` (1 to 15) over `threads` threads: bar_sync waits
// until all have arrived, bar_arrive counts this warp in and goes on
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- register budget ----------------------------------------------------

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- wgmma --------------------------------------------------------------

// shared-memory matrix descriptor of a 128-byte-swizzled operand; the
// start address must lie in a 1024-byte-aligned swizzle atom (or an
// offset into one along the 128-byte row, for K-major operands)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma that writes them
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_D64_OUT                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_D64_REGS                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),             \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),             \
  "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),             \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),             \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),             \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),             \
  "+f"(d[62]), "+f"(d[63])

// d (64 x 128, f32) = A (64 x 16) B (16 x 128) + (accumulate ? d : 0), bf16
// operands both MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_bf16_mn(float (&d)[64], uint64_t a, uint64_t b,
                                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_OUT
      ", %64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D64_REGS
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) = A (64 x 8) B (8 x 128) + (accumulate ? d : 0), tf32;
// A from registers, per warp the m16n8k8 A fragment of its 16 rows: a0
// (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) for lane = 4 g
// + t; B K-major in shared memory (the tensor cores read the top 19 bits
// of each float)
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " HOPPER_D64_OUT
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : HOPPER_D64_REGS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef HOPPER_D64_OUT
#undef HOPPER_D64_REGS

// ---- host side ----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through cudaGetDriverEntryPointByVersion, so the
// library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// tensor map of a 2-D row-major array (rows x cols, `row_bytes` apart) cut
// into boxes of box_rows x box_cols, swizzled by 128 bytes in shared
// memory; box_cols * element size must be 128 bytes. Out-of-range elements
// load as zeros. Returns false if the encoding fails.
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                      uint64_t rows, uint64_t cols, uint64_t row_bytes, uint32_t box_rows,
                      uint32_t box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// persistent grid: one block per SM, or fewer if there are fewer sub-tiles
inline int persistent_blocks(int sub_tiles) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sub_tiles < sms ? sub_tiles : sms;
}

}  // namespace hopper
