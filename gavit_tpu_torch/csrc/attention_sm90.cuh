// Pieces shared by the Hopper attention kernels: the forwards A, K, I, J
// and L (attention_fwd_sm90.cu) and the backward pair of A', K', I', J' and
// L' (attention_bwd_sm90.cu). Both work on head_dim 64 in 64-row tiles of
// 128-byte swizzled rows (one row: one swizzle row), one consumer
// warpgroup and one producer warp a block, and the wgmma fragment layout
// of sm90.cuh: accumulator 4j+e of a 64 x 64 tile holds (row g + 8*(e>>1),
// column 8j + 2t + (e&1)) of the thread's warp's 16 rows.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                       // head_dim
constexpr int kRowBytes = kD * 2;            // one bf16 row: one 128-byte swizzle row
constexpr int kTileRows = 64;                // query rows of a tile; key rows of a ring tile
constexpr int kTileBytes = kTileRows * kRowBytes;
constexpr int kConsumers = 128;              // one warpgroup
constexpr int kThreads = kConsumers + 32;    // and the producer warp

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the SFU (ex2.approx, within 2 ulp; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a 64 x 64 fp32 accumulator rounded to bf16 into this warp's rows of a
// swizzled staging tile
__device__ __forceinline__ void stage_o(const float (&o)[32], uint8_t* tile, int warp, int g,
                                        int t) {
  uint8_t* r0 = tile + (warp * 16 + g) * kRowBytes + 4 * t;
  uint8_t* r1 = r0 + 8 * kRowBytes;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = (j ^ g) << 4;
    *reinterpret_cast<uint32_t*>(r0 + c) = pack_bf16(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(r1 + c) = pack_bf16(o[4 * j + 2], o[4 * j + 3]);
  }
}

// register A fragments settled before wgmma_fence
template <int N>
__device__ __forceinline__ void settle_p(uint32_t (&pa)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(pa[i]);
}

// one operand through its element strides: (b, h, i, c) at p + b*sb + h*sh + i*sn + c
struct Operand {
  const void* p;
  long long sb, sh, sn;
};

}  // namespace
