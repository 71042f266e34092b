// Accumulating lower-tile SYRK of the fused Schur build (kernel K2):
//
//     acc[i, j] += sum_k Y[k, i] * Y[k, j]   for tile_row(i) >= tile_col(j)
//
// with 512 x 512 tiles, acc (n, n) float32 row-major, Y (k_rows, n) bf16
// row-major, n a multiple of 512. Elements of the strictly upper 512-tiles
// are neither read nor written; finish_schur mirrors the lower tiles once
// after all chunks.
//
// Replaces mvrecon_tpu/ops/pallas_schur.py::_syrk_acc_kernel (launched by
// syrk_acc there). At the 100k x 1000 north-star chunk (Y 2304 x 9216,
// 171 lower tile pairs) the work is ~2.1e11 FLOP against ~0.40 GB of
// traffic, so the kernel is bound by the tensor cores, not by memory: the
// design keeps the bf16 products on the tensor cores (wmma 16x16x16,
// float32 accumulators) and reads and writes each accumulator element once
// per launch, holding it in registers in between.
//
// One thread block owns one 128 x 128 sub-tile of a lower 512-tile and
// works out its position from blockIdx (closed-form triangular index, no
// host map). Eight warps each hold a 32 x 64 slab of the sub-tile in
// registers. The block walks the k_rows of Y in steps of 32, staging both
// operand panels in shared memory and prefetching the next step's panels
// into registers while the tensor cores work on the current one. Each
// step's 32-row product is summed on the tensor cores from zero and then
// added to the running sum with IEEE float32 adds, which keeps the result
// within 1e-5 of a float64-summed product at 2304 rows. Each acc element
// has exactly one owner, so there are no atomics. Rows past k_rows read as
// zero.
//
// Plain C entry point for ctypes; returns cudaGetLastError() after the
// launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kTile = 512;            // lower-triangle granularity of acc
constexpr int kBM = 128;              // output sub-tile side of one block
constexpr int kBK = 32;               // rows of Y per step
constexpr int kSub = kTile / kBM;     // sub-tiles per tile side
constexpr int kSubs = kSub * kSub;    // sub-tiles per tile
constexpr int kThreads = 256;         // 8 warps: 4 (rows) x 2 (cols)
constexpr int kLds = kBM + 8;         // padded shared row, a multiple of 8
constexpr int kVecs = kBK * kBM / 8;  // 16-byte vectors per panel
constexpr int kVecsPerThread = kVecs / kThreads;

__device__ __forceinline__ void load_panel(uint4 (&regs)[kVecsPerThread],
                                           const __nv_bfloat16* __restrict__ y,
                                           int k0, int col0, int k_rows, int n) {
#pragma unroll
  for (int r = 0; r < kVecsPerThread; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int krow = k0 + v / (kBM / 8);
    const int c = col0 + (v % (kBM / 8)) * 8;
    regs[r] = krow < k_rows
                  ? *reinterpret_cast<const uint4*>(y + (size_t)krow * n + c)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_panel(__nv_bfloat16 (*s)[kLds],
                                            const uint4 (&regs)[kVecsPerThread]) {
#pragma unroll
  for (int r = 0; r < kVecsPerThread; ++r) {
    const int v = threadIdx.x + r * kThreads;
    *reinterpret_cast<uint4*>(&s[v / (kBM / 8)][(v % (kBM / 8)) * 8]) = regs[r];
  }
}

__global__ void __launch_bounds__(kThreads)
syrk_acc_kernel(float* __restrict__ acc, const __nv_bfloat16* __restrict__ y,
                int k_rows, int n) {
  // lower tile pair (ti >= tj) from the packed triangular index
  const int pair = blockIdx.x / kSubs;
  const int sub = blockIdx.x % kSubs;
  int ti = (int)((sqrtf(8.0f * (float)pair + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= pair) ++ti;
  while (ti * (ti + 1) / 2 > pair) --ti;
  const int tj = pair - ti * (ti + 1) / 2;
  const int row0 = ti * kTile + (sub / kSub) * kBM;  // acc rows = Y columns
  const int col0 = tj * kTile + (sub % kSub) * kBM;

  __shared__ __align__(128) __nv_bfloat16 sa[kBK][kLds];  // Y[k, row0 + m]
  __shared__ __align__(128) __nv_bfloat16 sb[kBK][kLds];  // Y[k, col0 + n]

  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32;  // warp's first row in the sub-tile
  const int wc = (warp % 2) * 64;  // warp's first column

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::load_matrix_sync(
          c[i][j], acc + (size_t)(row0 + wr + 16 * i) * n + col0 + wc + 16 * j, n,
          wmma::mem_row_major);

  uint4 ra[kVecsPerThread], rb[kVecsPerThread];
  load_panel(ra, y, 0, row0, k_rows, n);
  load_panel(rb, y, 0, col0, k_rows, n);
  for (int k0 = 0; k0 < k_rows; k0 += kBK) {
    store_panel(sa, ra);
    store_panel(sb, rb);
    __syncthreads();
    if (k0 + kBK < k_rows) {
      load_panel(ra, y, k0 + kBK, row0, k_rows, n);
      load_panel(rb, y, k0 + kBK, col0, k_rows, n);
    }
    // this step's 32-row product starts from zero on the tensor cores and
    // is then added into the running sum with IEEE float32 adds: the
    // tensor cores' own accumulation, run over all 2304 rows on top of the
    // accumulator, drifts past 1e-5 of the largest entry
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> p[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(p[i][j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A(m, k) = Y[k, row0 + m]: column-major view of the staged panel
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &sa[kk][wr + 16 * i], kLds);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], &sb[kk][wc + 16 * j], kLds);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(p[i][j], fa[i], fb[j], p[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < p[i][j].num_elements; ++e) c[i][j].x[e] += p[i][j].x[e];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(
          acc + (size_t)(row0 + wr + 16 * i) * n + col0 + wc + 16 * j, c[i][j], n,
          wmma::mem_row_major);
}

}  // namespace

extern "C" int syrk_acc_bf16(float* acc, const void* y, int k_rows, int n, void* stream) {
  const int nt = n / kTile;
  const int blocks = nt * (nt + 1) / 2 * kSubs;
  syrk_acc_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      acc, static_cast<const __nv_bfloat16*>(y), k_rows, n);
  return static_cast<int>(cudaGetLastError());
}
