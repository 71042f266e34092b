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
// traffic, so the kernel is bound by the tensor cores (0.21 ms at the
// bf16 peak), and the read-modify-write of acc is half of the bytes.
//
// Design (hopper.cuh): persistent blocks, one per SM, walk the 128 x 128
// sub-tiles of the lower tile pairs. A producer warpgroup streams, per
// 64-row step of Y, the two 128-column panels Y[k, row0..] and
// Y[k, col0..] by TMA into a 4-stage ring of 128-byte-swizzled shared
// memory. Both operands of S = YᵀY are MN-major there (Y's columns are
// contiguous), which bf16 wgmma takes through its transpose bits, so no
// thread touches the operands. Two consumer warpgroups each own 64 x 128
// of the sub-tile and run wgmma m64n128k16 on every stage as it lands,
// taking turns to start them (named barriers 2 and 3), so that one warpgroup
// adds its step into the running sum while the other's products run.
// Each 64-row step is summed on the tensor cores from zero and then added
// into a separate float32 running sum in registers: summing all 2304 rows
// in the tensor cores' accumulator drifts past 1e-5 of the largest entry.
// While the main loop runs, the producer brings the sub-tile's old acc
// values into shared memory by TMA, so the epilogue reads them from there
// and only writes acc; meanwhile the ring already fills with the next
// sub-tile's panels. Rows past k_rows arrive as zeros. Each acc element
// has exactly one owner, so there are no atomics.
//
// Plain C entry point for ctypes; returns cudaGetLastError() after the
// launch on the caller's stream (or cudaErrorInvalidValue if a tensor map
// cannot be encoded).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;                       // rows of Y per stage
constexpr int kStages = 4;                    // ring depth
constexpr int kBox = kBK * 128;               // one 64-column x 64-row bf16 box
constexpr int kStageBytes = 4 * kBox;         // two boxes per panel, two panels
constexpr int kAccBox = kBM * 128;            // 32 acc columns x 128 rows, f32
constexpr int kAccBytes = 4 * kAccBox;
constexpr int kSmemBytes = kStages * kStageBytes + kAccBytes + 1024 /* barriers */ +
                           1024 /* alignment */;

struct Barriers {
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t acc_full;
  uint64_t acc_empty;
};

__global__ void __launch_bounds__(kThreads, 1)
syrk_acc_kernel(const __grid_constant__ CUtensorMap y_map,
                const __grid_constant__ CUtensorMap acc_map, float* __restrict__ acc,
                int k_rows, int n, int n_sub) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem;
  uint8_t* acc_tile = smem + kStages * kStageBytes;
  Barriers& bar = *reinterpret_cast<Barriers*>(acc_tile + kAccBytes);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], kConsumerWarps);
    }
    mbar_init(&bar.acc_full, 1);
    mbar_init(&bar.acc_empty, kConsumerWarps);
    mbar_init_fence();
  }
  __syncthreads();

  const int nk = (k_rows + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // producer: one thread starts every TMA load
    reg_dealloc<40>();
    if (threadIdx.x != 0) return;
    int slot = 0;
    uint32_t phase = 0, acc_phase = 0;
    const int acc_at = (nk < kStages ? nk : kStages) - 1;
    for (int t = blockIdx.x; t < n_sub; t += gridDim.x) {
      int row0, col0;
      sub_tile_origin(t, row0, col0);
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&bar.empty[slot], phase ^ 1);
        uint8_t* st = ring + slot * kStageBytes;
        mbar_expect_tx(&bar.full[slot], kStageBytes);
        tma_load_2d(st, &y_map, &bar.full[slot], row0, ks * kBK);
        tma_load_2d(st + kBox, &y_map, &bar.full[slot], row0 + 64, ks * kBK);
        tma_load_2d(st + 2 * kBox, &y_map, &bar.full[slot], col0, ks * kBK);
        tma_load_2d(st + 3 * kBox, &y_map, &bar.full[slot], col0 + 64, ks * kBK);
        if (ks == acc_at) {
          // the old acc values, once the previous sub-tile's epilogue has
          // read its own; by now the ring holds this sub-tile's first stages
          mbar_wait(&bar.acc_empty, acc_phase ^ 1);
          mbar_expect_tx(&bar.acc_full, kAccBytes);
          for (int b = 0; b < 4; ++b)
            tma_load_2d(acc_tile + b * kAccBox, &acc_map, &bar.acc_full, col0 + 32 * b, row0);
          acc_phase ^= 1;
        }
        if (++slot == kStages) { slot = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the sub-tile
  reg_alloc<232>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int last = ((n_sub - blockIdx.x + gridDim.x - 1) / gridDim.x) * nk - 1;
  int slot = 0, g = 0;
  uint32_t phase = 0, acc_phase = 0;
  float sum[64], part[64];

  for (int t = blockIdx.x; t < n_sub; t += gridDim.x) {
    int row0, col0;
    sub_tile_origin(t, row0, col0);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks, ++g) {
      mbar_wait(&bar.full[slot], phase);
      uint8_t* st = ring + slot * kStageBytes;
      // A: rows of this warpgroup = the cw-th 64-column box of the first
      // panel; B: both boxes of the second panel, kBox bytes apart along N;
      // 8-row groups of K are 1024 bytes apart in both
      const uint64_t a = sw128_desc(st + cw * kBox, 0, 1024);
      const uint64_t b = sw128_desc(st + 2 * kBox, kBox, 1024);
      if (g > 0 || cw == 1) bar_sync(2 + cw, 256);
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // 16 rows = 2048 bytes = 128 units
        wgmma_m64n128k16_bf16_mn(part, a + 128 * kk, b + 128 * kk, kk);
      wgmma_commit();
      if (g < last || cw == 0) bar_arrive(2 + (cw ^ 1), 256);
      wgmma_wait<0>();
      fence_regs(part);
      if (lane == 0) mbar_arrive(&bar.empty[slot]);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += part[i];
      if (++slot == kStages) { slot = 0; phase ^= 1; }
    }

    // epilogue: acc = old acc (shared, 128-byte-swizzled 32-column boxes)
    // + sum. Fragment element 4 j + e sits at row 16 warp + lane / 4
    // (+ 8 for e >= 2), column 8 j + 2 (lane % 4) (+ 1 for odd e).
    mbar_wait(&bar.acc_full, acc_phase);
    acc_phase ^= 1;
    const int r = 64 * cw + 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        const float2 old = *reinterpret_cast<const float2*>(
            acc_tile + (c / 32) * kAccBox + rr * 128 + ((((c % 32) / 4) ^ (rr % 8)) * 16) +
            (c % 4) * 4);
        *reinterpret_cast<float2*>(acc + (size_t)(row0 + rr) * n + col0 + c) =
            make_float2(old.x + sum[4 * j + 2 * h], old.y + sum[4 * j + 2 * h + 1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar.acc_empty);
  }
}

}  // namespace

extern "C" int syrk_acc_bf16(float* acc, const void* y, int k_rows, int n, void* stream) {
  if (n <= 0 || n % kTile != 0 || k_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k_rows == 0) return static_cast<int>(cudaSuccess);
  CUtensorMap y_map, acc_map;
  if (!encode_2d(&y_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, y, k_rows, n, (uint64_t)n * 2, kBK,
                 64) ||
      !encode_2d(&acc_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, acc, n, n, (uint64_t)n * 4, kBM,
                 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(syrk_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    attr_set = true;
  }
  const int nt = n / kTile;
  const int n_sub = nt * (nt + 1) / 2 * kSubs;
  syrk_acc_kernel<<<persistent_blocks(n_sub), kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(y_map, acc_map, acc, k_rows, n, n_sub);
  return static_cast<int>(cudaGetLastError());
}
