// The epilogues of gemm_sm90.cuh's mainloop shared by the MLP kernels B and
// D (mlp.cu) and the MoE expert MLP M and M' (moe.cu): the bias of the
// segment's group, the GELU forms and their derivatives, the Philox keep
// bits and the training epilogues (fc1: h1, then g = GELU(h1) * keep *
// scale; fc2: y = (sum + bias) * keep * scale; the backward's dh: dh1 =
// dh * GELU'(h1) * keep * scale and go = g, with dh1's column sums), and
// the backward's dy prologue (dye and db2's partials).
//
// Every GELU step is one IEEE-rounded operation (the _rn intrinsics keep
// nvcc from contracting them into FMAs), so the training forms give the
// plain versions' bits (gavit_tpu_torch/ops/mlp.py, ops/moe_fused.py).
#pragma once

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "philox.cuh"

namespace {

enum Act { ACT_NONE = 0, ACT_GELU_TANH = 1, ACT_GELU_ERF = 2 };

// GELU (tanh or erf) in fp32 of a value already rounded to bf16, as the TPU
// kernel rounds; each step one rounded operation, so nvcc contracts none of
// them into an FMA. The tanh form 0.5 h (1 + tanh(u)), u = sqrt(2/pi) (h +
// 0.044715 h^3), is taken as h / (1 + exp(-2u)), the same function: one
// expf and one reciprocal, no branch (tanhf branches on |u|, which kept the
// epilogue warps from overlapping one value's latency with the next's);
// within a few fp32 ulps of the tanh form, far below the bf16 rounding
// that follows. Large |u| gives h or -0, as the tanh form does.
template <int kAct>
__device__ __forceinline__ float infer_gelu(float h) {
  if (kAct == ACT_GELU_TANH) {
    const float cube = __fmul_rn(__fmul_rn(h, h), h);
    const float minus_2u =
        __fmul_rn(-1.5957691216057308f, __fadd_rn(h, __fmul_rn(0.044715f, cube)));
    return __fdividef(h, __fadd_rn(1.f, expf(minus_2u)));
  }
  if (kAct == ACT_GELU_ERF)
    return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, erff(__fmul_rn(h, 0.7071067811865476f))));
  return h;
}

// The training GELU of a rounded h1: the A&S erf form of the TPU kernels'
// _gelu_and_grad_f32 (D, and M by default), or the tanh form (M's
// deterministic bf16 path).
template <int kAct>
__device__ __forceinline__ float train_gelu(float h) {
  if (kAct == ACT_GELU_TANH) return infer_gelu<ACT_GELU_TANH>(h);
  float g, dg;
  gelu_and_grad(h, g, dg);
  return g;
}

// the bias of group e's columns col and col + 1, added to an accumulator
// quad (group e's bias row lies e * bias_stride elements in). The
// epilogues of one bias row pass e = 0, which folds away: the group's index
// costs their consumers registers they do not have to spare.
__device__ __forceinline__ void add_bias(const gemm90::Params& p, int e, int col,
                                         float (&v)[4]) {
  const __nv_bfloat162 b =
      *reinterpret_cast<const __nv_bfloat162*>(p.bias + e * p.bias_stride + col);
  const float b0 = __low2float(b), b1 = __high2float(b);
  v[0] = __fadd_rn(v[0], b0), v[1] = __fadd_rn(v[1], b1);
  v[2] = __fadd_rn(v[2], b0), v[3] = __fadd_rn(v[3], b1);
}

// The keep flags of elements row * n + col .. + 7 of site s, bit i for
// column col + i (all kept when the site is off): two Philox draws, col a
// multiple of 8 and n % 8 == 0, as mlp_bwd_prologue draws them.
__device__ __forceinline__ uint32_t keep_bits8(const DropSite& s, int n, int row, int col) {
  if (!s.on) return 0xFFu;
  const unsigned long long grp = ((unsigned long long)row * n + col) >> 2;
  const uint4 a = site_bits(s, grp), b = site_bits(s, grp + 1);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) bits |= (uint32_t)(w[i] >= s.threshold) << i;
  return bits;
}

// the training epilogues: the epilogue warps draw the keep bits of p.drop
// (nothing at rate 0), global rows: element row * N + col of the [M, N]
// output
struct DrawsKeepBits {
  static constexpr bool kDrawBits = true;
  static constexpr bool kStagedIn = false;
  static __device__ __forceinline__ uint32_t keep8(const gemm90::Params& p, int row, int col) {
    return keep_bits8(p.drop, p.n, row, col);
  }
};

// fc1: the epilogue warps draw the tile's hidden keep bits; the consumers
// add b1 (kGrouped: the segment's group's row) and stage h1 = bf16(x . W1 +
// b1) (stored by TMA: the backward's residual), then read their staged h1
// back a 16-byte chunk at a time and write g = bf16(GELU(h1) * keep_h *
// scale_h), computed in fp32 from the rounded h1, to out2 with one 16-byte
// store a chunk.
template <int kAct, bool kGrouped>
struct TrainFc1Epi : DrawsKeepBits {
  static constexpr bool kFinish = false, kReadBack = true;
  static __device__ __forceinline__ void apply(const gemm90::Params& p, int e, int col, uint32_t,
                                               float (&v)[4]) {
    if (col < p.n) add_bias(p, kGrouped ? e : 0, col, v);
  }
  static __device__ __forceinline__ void read_back(const gemm90::Params& p, int row, int col,
                                                   uint32_t bits, const uint4& h1) {
    if (row >= p.m || col >= p.n) return;  // past M or N: not stored
    const DropSite& s = p.drop;
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&h1);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u[i]);
      float g0 = train_gelu<kAct>(__low2float(h)), g1 = train_gelu<kAct>(__high2float(h));
      if (s.on) {
        g0 = (bits >> (2 * i)) & 1u ? g0 * s.scale : 0.f;
        g1 = (bits >> (2 * i + 1)) & 1u ? g1 * s.scale : 0.f;
      }
      o[i] = pack_bf16(g0, g1);
    }
    *reinterpret_cast<uint4*>(p.out2 + (long long)row * p.n + col) = out;
  }
};

// fc2: the epilogue warps draw the tile's output keep bits; the consumers
// add b2 (kGrouped: the segment's group's row), apply the mask and scale in
// registers, and the mainloop rounds once as it stages.
template <bool kGrouped>
struct TrainFc2Epi : DrawsKeepBits {
  static constexpr bool kFinish = false, kReadBack = false;
  static __device__ __forceinline__ void apply(const gemm90::Params& p, int e, int col,
                                               uint32_t k4, float (&v)[4]) {
    if (col >= p.n) return;  // past N: never stored
    add_bias(p, kGrouped ? e : 0, col, v);
    const DropSite& s = p.drop;
    if (!s.on) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (k4 >> i) & 1u ? v[i] * s.scale : 0.f;
  }
};

// The backward's dh (M' over its groups; one group serves D' the same way):
// the mainloop's sum is dh = dye . W2[e]^T in fp32. The epilogue warps draw
// the tile's hidden keep bits, and epilogue warp 1 brings the forward's h1
// (p.c2) into the staging tiles ahead. The consumers form g and GELU'(h1)
// from the rounded h1 (erf, or tanh: kAct), mask and scale both, write go =
// bf16(g) to out2 for the segment's rows, and leave dh1 = dh * GELU' in
// fp32, which the mainloop rounds once as it stages it over h1 (dh1, stored
// by TMA) and sums by column into p.part (db1's partials). No group index
// is read: h1, the masks and the sums go by global row, and the segments
// the mainloop walks keep each group's rows and partials apart.
template <int kAct>
struct TrainDhEpi : DrawsKeepBits {
  static constexpr bool kFinish = false, kReadBack = false, kStagedIn = true;
  static __device__ __forceinline__ void apply_in(const gemm90::Params& p, int r0, int col,
                                                  uint32_t k4, bool keep0, bool keep1,
                                                  uint32_t h_r0, uint32_t h_r1, float (&v)[4]) {
    if (col >= p.n) return;  // past N: never stored, never summed
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&h_r0);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&h_r1);
    const float h[4] = {__low2float(a), __high2float(a), __low2float(b), __high2float(b)};
    const DropSite& s = p.drop;
    float g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float dg;
      if (kAct == ACT_GELU_TANH)
        gelu_tanh_and_grad(h[i], g[i], dg);
      else
        gelu_and_grad(h[i], g[i], dg);
      if (s.on) {
        const bool keep = (k4 >> i) & 1u;
        g[i] = keep ? __fmul_rn(g[i], s.scale) : 0.f;
        dg = keep ? __fmul_rn(dg, s.scale) : 0.f;
      }
      v[i] = __fmul_rn(v[i], dg);
    }
    const long long at = (long long)r0 * p.n + col;
    if (keep0) *reinterpret_cast<uint32_t*>(p.out2 + at) = pack_bf16(g[0], g[1]);
    if (keep1) *reinterpret_cast<uint32_t*>(p.out2 + at + 8LL * p.n) = pack_bf16(g[2], g[3]);
  }
};

// The backward's prologue (D' and M'): dye = bf16(dy * keep_out * scale)
// (written only when the output mask is on) and the column sums of
// float(dye) over each chunk of `rows` rows, one partial row per chunk
// (db2's; M' keeps a chunk inside one expert). It moves bytes: dy read and
// dye written once, 77 MB at ViT-B b128. A block takes one chunk and 32
// groups of 8 columns (a warp reads 512 contiguous bytes of a row); its 8
// warps each walk rows / 8 consecutive rows of the chunk with one 16-byte
// load a row and thread, then warp 0 adds the other warps' sums in warp
// order: many rows in flight, and every sum in a fixed order (no atomics,
// reruns bit-equal). `rows` is a multiple of kPrologueWarps.
constexpr int kPrologueGroups = 32, kPrologueWarps = 8;

__global__ void __launch_bounds__(kPrologueGroups * kPrologueWarps)
    bwd_prologue(const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dye,
                 float* __restrict__ part, int m, int d, int rows, DropSite s) {
  __shared__ float4 red[kPrologueWarps - 1][kPrologueGroups][2];
  const int x = threadIdx.x, w = threadIdx.y;
  const int c0 = (blockIdx.y * kPrologueGroups + x) * 8;
  const int per = rows / kPrologueWarps;
  const int r0 = blockIdx.x * rows + w * per, r1 = min(r0 + per, m);
  float sum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sum[j] = 0.f;
  if (c0 < d) {
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const long long e = (long long)r * d + c0;
      uint4 in = *reinterpret_cast<const uint4*>(dy + e);
      __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&in);
      if (s.on) {
        const uint4 q0 = site_bits(s, (unsigned long long)e >> 2);
        const uint4 q1 = site_bits(s, ((unsigned long long)e >> 2) + 1);
        const uint32_t bits[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = __float2bfloat16_rn(bits[j] >= s.threshold ? __bfloat162float(v[j]) * s.scale
                                                            : 0.f);
        *reinterpret_cast<uint4*>(dye + e) = in;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sum[j] += __bfloat162float(v[j]);
    }
  }
  if (w > 0) {
    red[w - 1][x][0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
    red[w - 1][x][1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
  }
  __syncthreads();
  if (w > 0 || c0 >= d) return;
  for (int i = 0; i < kPrologueWarps - 1; ++i) {
    const float4 a = red[i][x][0], b = red[i][x][1];
    sum[0] += a.x, sum[1] += a.y, sum[2] += a.z, sum[3] += a.w;
    sum[4] += b.x, sum[5] += b.y, sum[6] += b.z, sum[7] += b.w;
  }
  float4* out = reinterpret_cast<float4*>(part + (long long)blockIdx.x * d + c0);
  out[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
  out[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
}

inline cudaError_t launch_bwd_prologue(const void* dy, void* dye, void* part, int m, int d,
                                       int rows, const DropSite& s, cudaStream_t stream) {
  if (rows <= 0 || rows % kPrologueWarps) return cudaErrorInvalidValue;
  const dim3 grid(gemm90::cdiv(m, rows), gemm90::cdiv(d / 8, kPrologueGroups));
  bwd_prologue<<<grid, dim3(kPrologueGroups, kPrologueWarps), 0, stream>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dye),
      static_cast<float*>(part), m, d, rows, s);
  return cudaGetLastError();
}

}  // namespace
