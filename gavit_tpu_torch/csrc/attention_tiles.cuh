// Tile helpers shared by the exact long-sequence kernels K/K' (attention_long.cu)
// and the blockwise kernels L/L' (attention_large.cu): head_dim 64, blocks of
// four warps that own 16 rows each, operands staged as [64][72] bf16 arrays
// (a row padded to 72 so that fragment loads hit 8 different bank groups),
// and the mma.sync m16n8k16 fragment layout of common.cuh.
//
// The helpers have internal linkage (an unnamed namespace): each kernel file
// gets its own inlined copy.
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;
constexpr int kWarps = 4;
constexpr int kRows = kWarps * 16;  // rows a block owns (queries, or keys in K' kv)
constexpr int kTile = 64;           // rows of a streamed tile
constexpr int kStride = kD + 8;     // 72 bf16: fragment loads hit 8 different bank groups
constexpr int kThreads = kWarps * 32;

// rows r0 .. r0+63 of one 64-column operand (row i at src + i*row_stride),
// in 16-byte chunks, into s[64][72]; rows at or past n are zeros
__device__ __forceinline__ void stage(bf16* s, const bf16* src, long long row_stride, int r0,
                                      int n) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = threadIdx.x; c < kTile * 8; c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    *reinterpret_cast<uint4*>(s + r * kStride + col) =
        r0 + r < n ? *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + col) : zero;
  }
}

// the A fragments (4 k-steps of 16) of the 16-row tile whose row g, column
// 2t starts at rows
__device__ __forceinline__ void frag_rows(uint32_t (*a)[4], const bf16* rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = ld32(rows + kk * 16);
    a[kk][1] = ld32(rows + 8 * kStride + kk * 16);
    a[kk][2] = ld32(rows + kk * 16 + 8);
    a[kk][3] = ld32(rows + 8 * kStride + kk * 16 + 8);
  }
}

// c = A.B^T for one 16x8 tile: A in fragments, B's 8 rows (keys) at
// tile[j*8 .. j*8+7] of a staged [64][72] array
__device__ __forceinline__ void mma_rows(float* c, const uint32_t (*a)[4], const bf16* tile,
                                         int j, int g, int t) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* p = tile + (j * 8 + g) * kStride + kk * 16 + 2 * t;
    const uint32_t b[2] = {ld32(p), ld32(p + 8)};
    mma_16816(c, a[kk], b);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s * scale for keys < n, -inf past n; key of element e of n8 tile j
__device__ __forceinline__ void scale_mask(float* s, int key0, int t, int n, float scale) {
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = key0 + 2 * t + (e & 1) < n ? s[e] * scale : -INFINITY;
}

// cp.async form of stage(): the copies land after cp_async_wait; rows at or
// past n are zero-filled (their source address clamped to row 0)
__device__ __forceinline__ void stage_async(bf16* s, const bf16* src, long long row_stride,
                                            int r0, int n) {
  for (int c = threadIdx.x; c < kTile * 8; c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    const bool in = r0 + r < n;
    cp_async_16(s + r * kStride + col, src + (in ? r0 + r : 0) * row_stride + col, in ? 16 : 0);
  }
}

}  // namespace
