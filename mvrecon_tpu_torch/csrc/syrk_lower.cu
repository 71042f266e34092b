// Packed lower-triangle SYRK of the streamed Schur build (kernel K1):
//
//     S[i, j] = sum_k Y[k, i] * Y[k, j]   for tile_row(i) >= tile_col(j)
//
// with 512 x 512 tiles, Y (k_rows, n) float32 stored K-major (column j of
// Y is contiguous at y + j * ld, ld >= k_rows, ld a multiple of 4), and S
// (n_pad, n_pad) float32 row-major, n_pad = n rounded up to 512. Rows past
// k_rows and columns past n read as zero, so the caller pads nothing.
// Elements of the strictly upper 512-tiles are never written; the caller
// mirrors the lower tiles.
//
// Replaces mvrecon_tpu/ops/pallas_syrk.py::_syrk_kernel (launched by
// syrk_lower there). The callers pin Precision.HIGHEST, so the products
// must keep float32 accuracy. At the host-streamed chunk, Y (49152, 4500),
// the caller uses the element-wise lower triangle of S: 4500 * 4501 *
// 49152 = 9.96e11 FLOP against ~0.93 GB of traffic. That is bound by
// operations: 6.0 ms at the float32-accurate 3xTF32 tensor-core rate
// (495 / 3 = 165 TFLOP/s).
//
// Float32 accuracy from the tensor cores by 3xTF32 on wgmma. TF32 wgmma
// reads both operands from shared memory K-major only, so the streamed
// path writes Y K-major in the first place, and TMA brings each operand
// tile straight into a 5-stage ring of 128-byte-swizzled shared memory.
// Design (hopper.cuh): persistent blocks, one per SM, walk the 128 x 128
// sub-tiles of the lower tile pairs; a producer warpgroup keeps the ring
// full, 32 rows of Y per stage (the two 128-column panels Y[k, row0..] and
// Y[k, col0..], 16 KB each). Each float is split into a TF32 "big" part,
// its top 19 bits, and the TF32-rounded remainder, the "small" part. Two
// consumer warpgroups each own 64 x 128 of the sub-tile. Each takes its
// A operand from registers, loaded and split there from the ring, and its
// B operand from shared memory: the big parts straight from the ring
// (the tensor cores read only a float's top 19 bits), the small parts
// from one of two planes that the consumers write laid out like the ring
// (an elementwise pass, blind to the swizzle). Per 8 rows they run wgmma
// m64n128k8 for small*big, big*small and big*big (small*small, ~2^-22 of
// the product, is dropped), and while those run they load and split the
// next stage. A in registers takes two thirds of the operand reads off
// shared memory, and each thread splits its A values once per stage.
//
// Each 32-row stage is summed on the tensor cores from zero and then
// added into a separate float32 running sum in registers: a single
// running sum over all 49152 rows would drift by ~eps*sqrt(K) of a
// diagonal entry. Each output element has exactly one owner, so there are
// no atomics.
//
// Plain C entry point for ctypes; returns cudaGetLastError() after the
// launch on the caller's stream (or cudaErrorInvalidValue for a layout it
// does not take or a tensor map that cannot be encoded). Nothing is allocated.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 32;                   // rows of Y per stage: one 128-byte line
constexpr int kStages = 5;                // ring depth
constexpr int kPanel = kBM * 128;         // 128 columns of Y x 32 rows, f32
constexpr int kStageBytes = 2 * kPanel;   // both panels
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kPanel + 1024 /* barriers */ +
                           1024 /* alignment */;

struct Barriers {
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// the TF32 part of v that the tensor cores read (its top 19 bits) and the
// remainder rounded to TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v) & 0xFFFFE000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(v - __uint_as_float(big)));
}

// half `half` of the second panel of a stage -> its small parts, in the
// same (swizzled) places of `plane`; four floats at a time
__device__ __forceinline__ void split_b(const uint8_t* panel, uint8_t* plane, int half) {
  const float4* src = reinterpret_cast<const float4*>(panel);
  uint4* dst = reinterpret_cast<uint4*>(plane);
#pragma unroll
  for (int i = 0; i < kPanel / 16 / 256; ++i) {
    const int idx = half * (kPanel / 32) + threadIdx.x % 128 + 128 * i;
    const float4 v = src[idx];
    uint4 out;
    uint32_t big;
    split_tf32(v.x, big, out.x);
    split_tf32(v.y, big, out.y);
    split_tf32(v.z, big, out.z);
    split_tf32(v.w, big, out.w);
    dst[idx] = out;
  }
}

// this thread's A fragments of one stage, split: [8-row step][a0..a3]
struct AFrag {
  uint32_t big[kBK / 8][4];
  uint32_t small[kBK / 8][4];
};

// rows m0 and m0 + 8 (m0 % 8 == g) of the first panel, K columns 8 kk + t
// and 8 kk + t + 4; in the 128-byte swizzle, the 16-byte chunk c of row m
// sits at chunk c ^ (m % 8)
__device__ __forceinline__ void load_a(const uint8_t* panel, int m0, int t, AFrag& f) {
  const int g = m0 % 8;
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = *reinterpret_cast<const float*>(
            panel + (m0 + 8 * r) * 128 + (((2 * kk + h) ^ g) * 16) + t * 4);
        split_tf32(v, f.big[kk][2 * h + r], f.small[kk][2 * h + r]);
      }
}

__device__ __forceinline__ void fence_frag(AFrag& f) {
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      asm volatile("" : "+r"(f.big[kk][i])::"memory");
      asm volatile("" : "+r"(f.small[kk][i])::"memory");
    }
}

struct Consumer {
  uint8_t* ring;
  uint8_t* planes;
  Barriers* bar;
  float* s;
  int nk, total, n_pad, cw, warp, lane, m0, t;
  float sum[64], part[64];

  // stage g lives in ring slot g % kStages (parity (g / kStages) & 1) and
  // the small parts of its second panel in plane g % 2. The products of
  // stage g run on `cur` while this warpgroup loads and splits stage g + 1
  // into `nxt`.
  __device__ __forceinline__ void step(int g, AFrag& cur, AFrag& nxt) {
    const int slot = g % kStages;
    const int ks = g % nk;
    uint8_t* st = ring + slot * kStageBytes;
    // K-major B: 8-row groups of the panel are 1024 bytes apart, and each
    // 8 K (32 bytes = 2 units) step moves along the 128-byte line
    const uint64_t b_big = sw128_desc(st + kPanel, 16, 1024);
    const uint64_t b_small = sw128_desc(planes + (g % 2) * kPanel, 16, 1024);
    fence_regs(part);
    fence_frag(cur);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      wgmma_m64n128k8_tf32_rs(part, cur.small[kk], b_big + 2 * kk, kk);
      wgmma_m64n128k8_tf32_rs(part, cur.big[kk], b_small + 2 * kk, 1);
      wgmma_m64n128k8_tf32_rs(part, cur.big[kk], b_big + 2 * kk, 1);
    }
    wgmma_commit();
    if (g + 1 < total) {
      // stage g + 1's plane was last read by stage g - 1, which both
      // warpgroups finished before the barrier that closed it
      const int next = (g + 1) % kStages;
      mbar_wait(&bar->full[next], ((g + 1) / kStages) & 1);
      const uint8_t* nst = ring + next * kStageBytes;
      load_a(nst, m0, t, nxt);
      split_b(nst + kPanel, planes + ((g + 1) % 2) * kPanel, cw);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_regs(part);
    fence_frag(cur);
    if (lane == 0) mbar_arrive(&bar->empty[slot]);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += part[i];
    if (ks == nk - 1) {
      // epilogue: fragment element 4 j + e sits at row 16 warp + lane / 4
      // (+ 8 for e >= 2), column 8 j + 2 (lane % 4) (+ 1 for odd e)
      int row0, col0;
      sub_tile_origin(blockIdx.x + (g / nk) * gridDim.x, row0, col0);
      const int r = row0 + 64 * cw + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float* dst = s + (size_t)r * n_pad + col0 + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(dst) = make_float2(sum[4 * j], sum[4 * j + 1]);
        *reinterpret_cast<float2*>(dst + 8 * (size_t)n_pad) =
            make_float2(sum[4 * j + 2], sum[4 * j + 3]);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    }
    bar_sync(1, 256);  // both consumer warpgroups
  }
};

__global__ void __launch_bounds__(kThreads, 1)
syrk_lower_kernel(const __grid_constant__ CUtensorMap y_map, float* __restrict__ s, int k_rows,
                  int n_pad, int n_sub) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem;
  uint8_t* planes = smem + kStages * kStageBytes;  // small parts, two stages
  Barriers& bar = *reinterpret_cast<Barriers*>(planes + 2 * kPanel);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bar.full[st], 1);
      mbar_init(&bar.empty[st], kConsumerWarps);
    }
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
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_sub; t += gridDim.x) {
      int row0, col0;
      sub_tile_origin(t, row0, col0);
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&bar.empty[slot], phase ^ 1);
        uint8_t* st = ring + slot * kStageBytes;
        mbar_expect_tx(&bar.full[slot], kStageBytes);
        tma_load_2d(st, &y_map, &bar.full[slot], ks * kBK, row0);
        tma_load_2d(st + kPanel, &y_map, &bar.full[slot], ks * kBK, col0);
        if (++slot == kStages) { slot = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the sub-tile,
  // takes its A operand from registers and splits half of each stage's
  // second panel
  reg_alloc<232>();
  Consumer c;
  c.ring = ring;
  c.planes = planes;
  c.bar = &bar;
  c.s = s;
  c.nk = nk;
  c.total = ((n_sub - blockIdx.x + gridDim.x - 1) / gridDim.x) * nk;
  c.n_pad = n_pad;
  c.cw = wg - 1;
  c.warp = (threadIdx.x / 32) % 4;
  c.lane = threadIdx.x % 32;
  c.m0 = 64 * c.cw + 16 * c.warp + c.lane / 4;
  c.t = c.lane % 4;
#pragma unroll
  for (int i = 0; i < 64; ++i) c.sum[i] = 0.f;
  AFrag f0, f1;
  if (c.total > 0) {
    mbar_wait(&bar.full[0], 0);
    load_a(ring, c.m0, c.t, f0);
    split_b(ring + kPanel, planes, c.cw);
    fence_proxy_async();
  }
  bar_sync(1, 256);  // both consumer warpgroups
  for (int g = 0; g < c.total; g += 2) {
    c.step(g, f0, f1);
    if (g + 1 < c.total) c.step(g + 1, f1, f0);
  }
}

}  // namespace

extern "C" int syrk_lower_f32(float* s, const float* y, int k_rows, int n, int ld,
                              void* stream) {
  if (n < 0 || k_rows <= 0 || ld < k_rows || ld % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nt = (n + kTile - 1) / kTile;
  const int n_pad = nt * kTile;
  const int n_sub = nt * (nt + 1) / 2 * kSubs;
  if (n_sub == 0) return static_cast<int>(cudaSuccess);
  // Y as the row-major (n, k_rows) array Yᵀ with rows ld floats apart:
  // boxes of 128 columns of Y by 32 rows
  CUtensorMap y_map;
  if (!encode_2d(&y_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, y, n, k_rows, (uint64_t)ld * 4, kBM,
                 kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(syrk_lower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    attr_set = true;
  }
  syrk_lower_kernel<<<persistent_blocks(n_sub), kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(y_map, s, k_rows, n_pad, n_sub);
  return static_cast<int>(cudaGetLastError());
}
