// The row schedule that kernels M and M' share in both dtypes (moe.cu on
// the tensor cores in bf16, moe_f32.cu on the CUDA cores in fp32): the
// shapes they take, the granules of their fp32 column partials, and the
// reduce that turns those partials into the per-expert bias gradients db1
// and db2 without atomics.
#pragma once

#include "common.cuh"

namespace {

// The row tile of both GEMM mainloops (gemm90::BM, gemm32::BM): a segment
// of a tile starts on a tile's first row or on a group's.
constexpr int kTileRows = 128;

// rows of a unit: the granule of M''s dh1 column partials (a segment of a
// 128-row tile always starts on one)
int unit_rows(int tm) { return tm < kTileRows ? tm : kTileRows; }

// rows of a chunk of M''s dye column sums (the backward's prologue): divides
// tm, so a chunk lies inside one expert's rows; a multiple of the bf16
// prologue's 8 warps, as tm >= 8
int prologue_rows(int tm) { return tm < 64 ? tm : 64; }

bool bad_shape(int cap, int d, int f, int e, int tm) {
  return cap <= 0 || d <= 0 || f <= 0 || e <= 0 || d % 8 || f % 8 || tm < 8 ||
         (tm & (tm - 1)) || cap % tm;
}

// out[e][c] = the sum of the partial rows of expert e's units, in order:
// expert e holds rows [start, start + group_sizes[e]) (start a multiple of
// unit), unit u's partial row is part[u]. With starts_only, only the units
// where a GEMM segment started hold one (a 128-row tile's first row, or
// the group's). Deterministic per-expert bias gradients, no atomics.
__global__ void moe_colsum_reduce(const float* __restrict__ part, float* __restrict__ out,
                                  const int* __restrict__ group_sizes, int unit, int starts_only,
                                  int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int e = blockIdx.y;
  if (c >= n) return;
  int start = 0;
  for (int i = 0; i < e; ++i) start += group_sizes[i];
  const int end = start + group_sizes[e];
  float s = 0.f;
  for (int r = start; r < end; r += unit)
    if (!starts_only || r % kTileRows == 0 || r == start) s += part[(long)(r / unit) * n + c];
  out[(long)e * n + c] = s;
}

cudaError_t colsum(const float* part, float* out, const int* group_sizes, int unit,
                   int starts_only, int n, int e, cudaStream_t s) {
  dim3 grid((n + 255) / 256, e);
  moe_colsum_reduce<<<grid, 256, 0, s>>>(part, out, group_sizes, unit, starts_only, n);
  return cudaGetLastError();
}

}  // namespace
