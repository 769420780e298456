// Kernels M, M', tgmm and N-gmm in fp32: the expert MLP of the dropless
// grouped mixture-of-experts engines on the CUDA cores, for the MoE model
// trained, evaluated or explained in fp32 (training.precision: fp32, the
// Grad-CAM CLI's fp32 model).
//
// Replaces, at fp32 (HIGHEST precision there):
// * M: gavit_tpu/ops/moe_fused.py::_fwd_kernel (launched by _run_fwd);
// * M': gavit_tpu/ops/moe_fused.py::_bwd_kernel (launched by _run_bwd);
// * tgmm: megablox tgmm (JAX-library Pallas), called by
//   moe_fused.py::_fused_bwd for dW1 and dW2 and by the unfused engine's
//   VJP, writing the weights' dtype;
// * N-gmm: megablox gmm (JAX-library Pallas) at preferred_element_type =
//   x.dtype, which gavit_tpu/ops/moe_grouped.py::ragged_matmul launches,
//   in both forms: x . W[e] and, in the VJP, dy . W[e]^T.
// The bf16 kernels are moe.cu's, on the tensor cores; these are the same
// functions and row schedules (moe.cu's comment block, moe_common.cuh) on
// gemm_f32.cuh's CUDA-core mainloop. In fp32 the bf16 kernels' rounding
// points (h1 before the GELU, g before fc2, dh1 before dx) are the identity.
//
// * M: fc1 (x . W1[e]) with b1[e] -> h1 (stored, the backward's residual),
//   g = GELU(h1) (erf, the plain version's A&S form; tanh where the caller
//   asks) with the hidden mask and scale, in the fc1 epilogue; then fc2 (g .
//   W2[e]) with b2[e], the output mask and scale -> y. W1[e] and W2[e] are
//   the MN-major B operand.
// * M': a prologue masks dy -> dye (written only when the output mask is
//   on) and sums its columns per chunk of rows (db2's partials); dh = dye .
//   W2[e]^T (K-major) with the dh epilogue, which forms g and GELU'(h1) from
//   the forward's h1, applies the hidden mask and writes go = g * keep *
//   scale and dh1 = dh * GELU' * keep * scale, with dh1's column partials a
//   segment (db1's); then dx = dh1 . W1[e]^T (K-major), N-gmm's transposed
//   launch. db1 and db2 are reduced from the partials in segment order over
//   group_sizes (moe_common.cuh): deterministic, no atomics.
// * tgmm: C[e] = A[rows of e]^T . B[rows of e], fp32 [E, K, N], on the
//   grouped-K schedule.
// * N-gmm: C[T, N] over the unaligned packed groups, rows past the last
//   group written as zeros.
// Every GELU step is one IEEE-rounded operation (common.cuh), so from the
// same h1 the GELU, its derivative and the masks give the plain version's
// bits; the masks come from Philox (philox.cuh): the hidden mask is element
// row*F + col of [cap, F] at the hidden site, the output mask element
// row*D + col of [cap, D] at the output site.
//
// What bounds it on the H100: the fp32 FMA rate (gemm_f32.cuh): each GEMM
// is 2*T*D*F FLOPs on the T routed rows at 67 TFLOP/s, 3.55 ms at ViT-B
// b128 (T = 50,432); M and M' are two GEMMs each. The epilogues' GELU
// and Philox run between main loops, a few percent of a tile's FMAs.
#include "common.cuh"
#include "gemm_f32.cuh"
#include "moe_common.cuh"
#include "philox.cuh"

namespace {

static_assert(gemm32::BM == kTileRows, "the row tile moe_common.cuh's units count");

using gemm32::Params;

// the keep flags of elements at .. at + 3 of site s (at a multiple of 4:
// one Philox draw), bit i for element at + i; all kept when the site is off
__device__ __forceinline__ uint32_t keep_bits4(const DropSite& s, unsigned long long at) {
  if (!s.on) return 0xFu;
  const uint4 w = site_bits(s, at >> 2);
  return (uint32_t)(w.x >= s.threshold) | (uint32_t)(w.y >= s.threshold) << 1 |
         (uint32_t)(w.z >= s.threshold) << 2 | (uint32_t)(w.w >= s.threshold) << 3;
}

__device__ __forceinline__ void add_bias(const Params& p, int e, int col, float (&v)[4]) {
  const float4 b = *reinterpret_cast<const float4*>(p.bias + (long long)e * p.n + col);
  v[0] = __fadd_rn(v[0], b.x), v[1] = __fadd_rn(v[1], b.y);
  v[2] = __fadd_rn(v[2], b.z), v[3] = __fadd_rn(v[3], b.w);
}

template <bool kTanh>
__device__ __forceinline__ void act_and_grad(float h, float& g, float& dg) {
  if (kTanh)
    gelu_tanh_and_grad(h, g, dg);
  else
    gelu_and_grad(h, g, dg);
}

// fc1: h1 = x . W1[e] + b1[e] to c; g = GELU(h1) * keep * scale to out2
template <bool kTanh>
struct Fc1Epi {
  static constexpr bool kColSums = false;
  static __device__ __forceinline__ void apply(const Params& p, int e, int col, long long at,
                                               float (&v)[4]) {
    add_bias(p, e, col, v);
    gemm32::store4(p.c + at, v);
    const uint32_t keep = keep_bits4(p.drop, at);
    float g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float dg;
      act_and_grad<kTanh>(v[i], g[i], dg);
      if (p.drop.on) g[i] = (keep >> i) & 1u ? __fmul_rn(g[i], p.drop.scale) : 0.f;
    }
    gemm32::store4(p.out2 + at, g);
  }
};

// fc2: y = (g . W2[e] + b2[e]) * keep * scale to c
struct Fc2Epi {
  static constexpr bool kColSums = false;
  static __device__ __forceinline__ void apply(const Params& p, int e, int col, long long at,
                                               float (&v)[4]) {
    add_bias(p, e, col, v);
    if (p.drop.on) {
      const uint32_t keep = keep_bits4(p.drop, at);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = (keep >> i) & 1u ? __fmul_rn(v[i], p.drop.scale) : 0.f;
    }
    gemm32::store4(p.c + at, v);
  }
};

// the backward's dh = dye . W2[e]^T: from the forward's h1 (in2), g and
// GELU'(h1) with the hidden mask and scale; go = g to out2, dh1 = dh *
// GELU' to c, its column sums to part (db1's partials)
template <bool kTanh>
struct DhEpi {
  static constexpr bool kColSums = true;
  static __device__ __forceinline__ void apply(const Params& p, int, int, long long at,
                                               float (&v)[4]) {
    const float4 h4 = *reinterpret_cast<const float4*>(p.in2 + at);
    const float h[4] = {h4.x, h4.y, h4.z, h4.w};
    const uint32_t keep = keep_bits4(p.drop, at);
    float g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float dg;
      act_and_grad<kTanh>(h[i], g[i], dg);
      if (p.drop.on) {
        const bool k = (keep >> i) & 1u;
        g[i] = k ? __fmul_rn(g[i], p.drop.scale) : 0.f;
        dg = k ? __fmul_rn(dg, p.drop.scale) : 0.f;
      }
      v[i] = __fmul_rn(v[i], dg);
    }
    gemm32::store4(p.out2 + at, g);
    gemm32::store4(p.c + at, v);
  }
};

// M''s prologue: dye = dy * keep * scale (written only when the output mask
// is on) and the column sums of dye over each chunk of `rows` rows, one
// partial row a chunk (db2's). A thread owns 4 columns (one Philox draw) and
// walks the chunk's rows in order: coalesced 16-byte loads across the
// threads, every sum in a fixed order.
constexpr int kPrologueThreads = 128;

__global__ void __launch_bounds__(kPrologueThreads)
    bwd_prologue_f32(const float* __restrict__ dy, float* __restrict__ dye,
                     float* __restrict__ part, int m, int d, int rows, DropSite s) {
  const int c = (blockIdx.y * kPrologueThreads + threadIdx.x) * 4;
  if (c >= d) return;
  const int r0 = blockIdx.x * rows, r1 = min(r0 + rows, m);
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = r0; r < r1; ++r) {
    const long long at = (long long)r * d + c;
    const float4 in = *reinterpret_cast<const float4*>(dy + at);
    float v[4] = {in.x, in.y, in.z, in.w};
    if (s.on) {
      const uint32_t keep = keep_bits4(s, at);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = (keep >> i) & 1u ? __fmul_rn(v[i], s.scale) : 0.f;
      gemm32::store4(dye + at, v);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[i] += v[i];
  }
  gemm32::store4(part + (long long)blockIdx.x * d + c, sum);
}

cudaError_t gmm(const void* a, const void* b, const int* group_sizes, void* c, int m, int k,
                int n, int e, bool transpose_rhs, cudaStream_t s) {
  Params p{};
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<float*>(c);
  p.m = m, p.n = n, p.k = k, p.experts = e;
  p.group_sizes = group_sizes;
  return transpose_rhs ? gemm32::launch<gemm32::RowTiles, gemm32::StoreEpi, true>(p, s)
                       : gemm32::launch<gemm32::RowTiles, gemm32::StoreEpi, false>(p, s);
}

}  // namespace

// Kernel M in fp32: gavit_moe_fwd's parameters and contract (moe.cu) on fp32
// tensors: x [cap, d], w1 [e, d, f], b1 [e, f], w2 [e, f, d], b2 [e, d],
// group_sizes [e] int32 on the device; writes h1 [cap, f], g [cap, f]
// (scratch) and y [cap, d]. act: 0 erf GELU, 1 tanh. Two launches: fc1
// writing h1 and g, fc2 writing y.
GAVIT_EXPORT int gavit_moe_fwd_f32(const void* x, const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* group_sizes, void* h1, void* g,
                                   void* y, int cap, int d, int f, int e, int tm, int act,
                                   unsigned k0, unsigned k1, unsigned site_h, unsigned thr_h,
                                   float scale_h, unsigned site_o, unsigned thr_o, float scale_o,
                                   void* stream) {
  if (bad_shape(cap, d, f, e, tm)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{};
  p.a = static_cast<const float*>(x);
  p.b = static_cast<const float*>(w1);
  p.c = static_cast<float*>(h1);
  p.m = cap, p.n = f, p.k = d, p.experts = e;
  p.group_sizes = static_cast<const int*>(group_sizes);
  p.bias = static_cast<const float*>(b1);
  p.drop = make_site(k0, k1, site_h, thr_h, scale_h);
  p.out2 = static_cast<float*>(g);
  cudaError_t err = act ? gemm32::launch<gemm32::RowTiles, Fc1Epi<true>, false>(p, s)
                        : gemm32::launch<gemm32::RowTiles, Fc1Epi<false>, false>(p, s);
  if (err != cudaSuccess) return err;
  p.a = static_cast<const float*>(g);
  p.b = static_cast<const float*>(w2);
  p.c = static_cast<float*>(y);
  p.n = d, p.k = f;
  p.bias = static_cast<const float*>(b2);
  p.drop = make_site(k0, k1, site_o, thr_o, scale_o);
  p.out2 = nullptr;
  return gemm32::launch<gemm32::RowTiles, Fc2Epi, false>(p, s);
}

// Kernel M' in fp32: gavit_moe_bwd's parameters and contract (moe.cu) on
// fp32 tensors, part1 and part2 fp32 scratch of gavit_moe_bwd_partial_rows
// rows. Five launches: the dye prologue, db2's reduce, the dh GEMM with
// its epilogue (W2 K-major), db1's reduce, the dx GEMM (W1 K-major).
GAVIT_EXPORT int gavit_moe_bwd_f32(const void* dy, const void* h1, const void* w1,
                                   const void* w2, const void* group_sizes, void* dye, void* dh1,
                                   void* go, void* dx, void* db1, void* db2, void* part1,
                                   void* part2, int cap, int d, int f, int e, int tm, int act,
                                   unsigned k0, unsigned k1, unsigned site_h, unsigned thr_h,
                                   float scale_h, unsigned site_o, unsigned thr_o, float scale_o,
                                   void* stream) {
  if (bad_shape(cap, d, f, e, tm)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  const DropSite out_site = make_site(k0, k1, site_o, thr_o, scale_o);
  const int prow = prologue_rows(tm);
  const dim3 grid(gemm32::cdiv(cap, prow), gemm32::cdiv(d / 4, kPrologueThreads));
  bwd_prologue_f32<<<grid, kPrologueThreads, 0, s>>>(
      static_cast<const float*>(dy), static_cast<float*>(dye), static_cast<float*>(part2), cap,
      d, prow, out_site);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = colsum(static_cast<const float*>(part2), static_cast<float*>(db2), gs, prow, 0, d, e, s);
  if (err != cudaSuccess) return err;
  Params p{};
  p.a = static_cast<const float*>(out_site.on ? dye : dy);
  p.b = static_cast<const float*>(w2);
  p.c = static_cast<float*>(dh1);
  p.m = cap, p.n = f, p.k = d, p.experts = e;
  p.group_sizes = gs;
  p.drop = make_site(k0, k1, site_h, thr_h, scale_h);
  p.out2 = static_cast<float*>(go);
  p.in2 = static_cast<const float*>(h1);
  p.part = static_cast<float*>(part1);
  p.part_unit = unit_rows(tm);
  err = act ? gemm32::launch<gemm32::RowTiles, DhEpi<true>, true>(p, s)
            : gemm32::launch<gemm32::RowTiles, DhEpi<false>, true>(p, s);
  if (err == cudaSuccess)
    err = colsum(static_cast<const float*>(part1), static_cast<float*>(db1), gs, p.part_unit, 1,
                 f, e, s);
  return err == cudaSuccess ? gmm(dh1, w1, gs, dx, cap, f, d, e, true, s) : err;
}

// Kernel tgmm in fp32: a [rows, kd], b [rows, n] fp32, group_sizes [e]
// int32 on the device (rows in expert order; rows past their sum are read
// by no group); writes c [e, kd, n] in fp32.
GAVIT_EXPORT int gavit_moe_tgmm_f32(const void* a, const void* b, const void* group_sizes,
                                    void* c, int rows, int kd, int n, int e, void* stream) {
  if (rows <= 0 || kd <= 0 || n <= 0 || e <= 0 || kd % 8 || n % 8) return cudaErrorInvalidValue;
  Params p{};
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<float*>(c);
  p.m = kd, p.n = n, p.k = rows, p.experts = e;
  p.group_sizes = static_cast<const int*>(group_sizes);
  return gemm32::launch<gemm32::GroupedK, gemm32::StoreEpi, false>(
      p, static_cast<cudaStream_t>(stream));
}

// Kernel N-gmm in fp32. a [m, k] fp32, group_sizes [e] int32 on the device
// (rows in expert order, past their sum written as zeros); b [e, k, n] (the
// MN-major B operand), or [e, n, k] with transpose_rhs (K-major); writes c
// [m, n] in fp32.
GAVIT_EXPORT int gavit_gmm_f32(const void* a, const void* b, const void* group_sizes, void* c,
                               int m, int k, int n, int e, int transpose_rhs, void* stream) {
  return gmm(a, b, static_cast<const int*>(group_sizes), c, m, k, n, e, transpose_rhs != 0,
             static_cast<cudaStream_t>(stream));
}
