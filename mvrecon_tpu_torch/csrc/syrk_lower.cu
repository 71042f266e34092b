// Packed lower-triangle SYRK of the streamed Schur build (kernel K1):
//
//     S[i, j] = sum_k Y[k, i] * Y[k, j]   for tile_row(i) >= tile_col(j)
//
// with 512 x 512 tiles, Y (k_rows, n) float32 with unit column stride and
// row stride ld (ld >= n, ld a multiple of 4), and S (n_pad, n_pad)
// float32 row-major, n_pad = n rounded up to 512. Rows past k_rows and
// columns past n read as zero, so the caller pads nothing. Elements of
// the strictly upper 512-tiles are never written; the caller mirrors the
// lower tiles.
//
// Replaces mvrecon_tpu/ops/pallas_syrk.py::_syrk_kernel (launched by
// syrk_lower there). The callers pin Precision.HIGHEST, so the products
// must keep float32 accuracy. At the host-streamed chunk, Y (49152, 4500),
// the caller uses the element-wise lower triangle of S: 4500 * 4501 *
// 49152 = 9.96e11 FLOP against ~0.93 GB of traffic. That is bound by
// operations, 6.0 ms at the float32-accurate 3xTF32 tensor-core rate
// (495 / 3 = 165 TFLOP/s) and 14.9 ms at the 67 TFLOP/s float32 rate
// outside the tensor cores (SXM data sheet). Memory is no limit: each
// block reads its two 128-column panels of Y once, so Y is read 8 times
// from L2 and the output is written once. Rows that start on 128-byte
// lines (ld a multiple of 32) load about 4 % faster than rows of 4500
// floats (PERF.md, Findings), so the streamed path lays Y out so.
//
// Float32 accuracy from the tensor cores by 3xTF32. One block of eight
// warps owns one 128 x 128 sub-tile of a lower tile pair; each warp owns
// 64 x 32 of it as 4 x 4 mma.sync m16n8k8 TF32 tiles whose fragments are
// read straight from shared memory into registers (rows padded to 136
// floats, so the reads are free of bank conflicts). Each operand is split
// into a TF32 "big" part and a TF32 "small" remainder, and small*big +
// big*small + big*big are summed (small*small, ~2^-22 of the product, is
// dropped). Y moves to shared memory with cp.async in double-buffered
// stages of 16 rows, so the next stage loads while the tensor cores work
// on this one. At the streamed chunk this ran about 14 % faster than
// register-tiled FFMA, the other float32-accurate route (PERF.md,
// Findings).
//
// Each 32 rows are summed from zero and then added into the running sum
// with IEEE float32 adds: a single running sum over all 49152 rows would
// drift by ~eps*sqrt(K) of a diagonal entry. Each output element has
// exactly one owner, so there are no atomics. The block's position comes
// from blockIdx through the closed-form packed triangular index (no host
// map).
//
// Plain C entry point for ctypes; returns cudaGetLastError() after the
// launch on the caller's stream. Nothing is allocated.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;          // lower-triangle granularity of S
constexpr int kBM = 128;            // output sub-tile side of one block
constexpr int kSub = kTile / kBM;   // sub-tiles per tile side
constexpr int kSubs = kSub * kSub;  // sub-tiles per tile
constexpr int kThreads = 256;

// (row0, col0) of this block's sub-tile: S rows = Y columns row0.., S
// columns = Y columns col0..
__device__ __forceinline__ void block_origin(int& row0, int& col0) {
  const int pair = blockIdx.x / kSubs;
  const int sub = blockIdx.x % kSubs;
  int ti = (int)((sqrtf(8.0f * (float)pair + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= pair) ++ti;
  while (ti * (ti + 1) / 2 > pair) --ti;
  const int tj = pair - ti * (ti + 1) / 2;
  row0 = ti * kTile + (sub / kSub) * kBM;
  col0 = tj * kTile + (sub % kSub) * kBM;
}

constexpr int kBK = 16;        // rows of Y per cp.async stage
constexpr int kFold = 2;       // stages summed from zero before the running add
constexpr int kLds = kBM + 8;  // padded shared row: fragment loads are conflict-free

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small + O(2^-22 v), both TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// d += a * b for one m16n8k8 TF32 tile, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared without passing through registers; only the
// first `bytes` are read and the rest is zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr), "l"(src), "r"(bytes));
}

// bytes of the 4-float vector at column col that lie inside Y's n columns
__device__ __forceinline__ int inside_bytes(int col, int n) {
  return 4 * min(max(n - col, 0), 4);
}

// one stage: kBK rows of the two 128-column panels; what lies past k_rows
// or n is zero-filled
__device__ __forceinline__ void stage_panels(float (*sa)[kLds], float (*sb)[kLds],
                                             const float* __restrict__ y, int k0, int row0,
                                             int col0, int k_rows, int n, int ld) {
#pragma unroll
  for (int r = 0; r < kBK * kBM / 4 / kThreads; ++r) {
    const int v = threadIdx.x + r * kThreads;
    const int k = k0 + v / (kBM / 4);
    const int c = (v % (kBM / 4)) * 4;
    const bool row_ok = k < k_rows;
    const int a_bytes = row_ok ? inside_bytes(row0 + c, n) : 0;
    const int b_bytes = row_ok ? inside_bytes(col0 + c, n) : 0;
    const float* src = y + (size_t)(row_ok ? k : 0) * ld;
    cp_async16(&sa[v / (kBM / 4)][c], a_bytes ? src + row0 + c : y, a_bytes);
    cp_async16(&sb[v / (kBM / 4)][c], b_bytes ? src + col0 + c : y, b_bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, 1)
syrk_lower_3xtf32_kernel(float* __restrict__ s, const float* __restrict__ y, int k_rows,
                         int n, int ld, int n_pad) {
  int row0, col0;
  block_origin(row0, col0);

  __shared__ __align__(16) float sa[2][kBK][kLds];  // Y[k, row0 + m]
  __shared__ __align__(16) float sb[2][kBK][kLds];  // Y[k, col0 + n]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;          // fragment row group
  const int t = lane % 4;          // thread in group
  const int wr = (warp / 4) * 64;  // warp's 64 x 32 patch of the sub-tile
  const int wc = (warp % 4) * 32;

  float c[4][4][4];  // [m16 tile][n8 tile][fragment element]
  float p[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;

  const int n_steps = (k_rows + kBK - 1) / kBK;
  if (n_steps > 0) stage_panels(sa[0], sb[0], y, 0, row0, col0, k_rows, n, ld);
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < n_steps;
    if (more) {
      // the other buffer was last read in the previous step, which every
      // thread finished before that step's closing barrier
      stage_panels(sa[buf ^ 1], sb[buf ^ 1], y, (step + 1) * kBK, row0, col0, k_rows, n, ld);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();

    if (step % kFold == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[i][j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      // A(m, k) = Y[k, row0 + m]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      uint32_t a_big[4][4], a_small[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* at = &sa[buf][kk + t][wr + 16 * i + g];
        split_tf32(at[0], a_big[i][0], a_small[i][0]);
        split_tf32(at[8], a_big[i][1], a_small[i][1]);
        split_tf32(at[4 * kLds], a_big[i][2], a_small[i][2]);
        split_tf32(at[4 * kLds + 8], a_big[i][3], a_small[i][3]);
      }
      // B(k, n) = Y[k, col0 + n]: b0 (t, g), b1 (t + 4, g)
      uint32_t b_big[4][2], b_small[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* bt = &sb[buf][kk + t][wc + 8 * j + g];
        split_tf32(bt[0], b_big[j][0], b_small[j][0]);
        split_tf32(bt[4 * kLds], b_big[j][1], b_small[j][1]);
      }
      // each tile takes small*big, big*small, big*big in that order; the
      // 16 tiles interleave, so no product waits on the one before it
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(p[i][j], a_small[i], b_big[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(p[i][j], a_big[i], b_small[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(p[i][j], a_big[i], b_big[j]);
    }
    if (step % kFold == kFold - 1 || !more) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[i][j][e] += p[i][j][e];
    }
    __syncthreads();
  }

  // c0, c1 at (g, 2t), (g, 2t + 1); c2, c3 at (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = s + (size_t)(row0 + wr + 16 * i + g) * n_pad + col0 + wc + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dst) = make_float2(c[i][j][0], c[i][j][1]);
      *reinterpret_cast<float2*>(dst + 8 * (size_t)n_pad) = make_float2(c[i][j][2], c[i][j][3]);
    }
}

}  // namespace

extern "C" int syrk_lower_f32(float* s, const float* y, int k_rows, int n, int ld,
                              void* stream) {
  if (n < 0 || k_rows < 0 || ld < n || ld % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nt = (n + kTile - 1) / kTile;
  const int blocks = nt * (nt + 1) / 2 * kSubs;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  syrk_lower_3xtf32_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, y, k_rows, n, ld, nt * kTile);
  return static_cast<int>(cudaGetLastError());
}
