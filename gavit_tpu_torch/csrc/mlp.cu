// Kernels B, D and D': the MLP's fc1 -> GELU -> fc2 on the tensor cores, in
// bf16, for serving (B) and for training (D forward, D' backward).
//
// Replaces:
// * B: gavit_tpu/ops/mlp.py::_mlp_infer_kernel (launched by _mlp_infer_impl,
//   reached through fused_mlp_inference);
// * D: gavit_tpu/ops/mlp.py::_mlp_fwd_kernel (launched by _run_fwd, reached
//   through fused_mlp);
// * D': gavit_tpu/ops/mlp.py::_mlp_bwd_kernel (launched by _run_bwd, the VJP
//   of fused_mlp).
//
// The TPU kernels keep both weight matrices resident in VMEM and stream row
// blocks through fc1 -> GELU -> (dropout) -> fc2. That does not carry over:
// W1 alone is 4.7 MB in bf16 at ViT-B and a block has 227 KB of shared
// memory. So each kernel here is launches of one hand-written tensor-core
// GEMM with a fused epilogue:
// * B: fc1 with bias + round + GELU (tanh or erf) + round -> h, then fc2
//   with bias -> y, on the TMA-fed wgmma mainloop of gemm_sm90.cuh (the
//   hidden h makes one bf16 round trip through device memory: 77 MB at
//   b64, about 46 us of the card's memory rate).
// * D: on the same mainloop, fc1 with bias + round -> h1 (stored: the
//   backward's residual, as on the TPU); the consumers then read their
//   staged h1 back and write the erf-GELU in fp32 of the rounded h1, the
//   hidden mask and scale, round -> g; then fc2 with bias, the output mask
//   and scale in the consumers' registers, and one round -> y. The epilogue
//   warps draw both masks' Philox bits a tile ahead. The TPU kept g in
//   VMEM; here it makes one round trip through device memory (2 x 155 MB at
//   ViT-B b128). fc1's GELUs (about 40 instructions a value, two of them
//   MUFU) outweigh its tensor-core work: they set its pace (PERF.md §6
//   times the placements tried). B's and D's epilogues live in
//   train_epilogues.cuh, which the MoE expert MLP M (moe.cu) shares.
// * D': the shared backward prologue (train_epilogues.cuh) applies the
//   output mask to dy -> dye (needed by the dW2 GEMM) and sums dye's columns
//   per 32-row chunk (db2's partials); then dh = dye . W2 on the same
//   mainloop with M''s dh epilogue TrainDhEpi and one group of every row,
//   W2 read as stored ([D, F], nn.Linear's layout: [K][N], the MN-major B
//   operand, as N-gmm's forward form reads its weights; no transposed
//   copy). Epilogue warp 1 loads each warpgroup's 64 x 192 tile of the
//   forward's h1 by TMA into its staging tile while the mainloop runs and
//   warps 2-3 draw the hidden keep bits a tile ahead; the consumers form
//   GELU and GELU' from one exp (_gelu_and_grad_f32), write go = GELU *
//   mask * scale in bf16, stage dh1 = bf16(dh * GELU' * mask * scale) over
//   h1 for the TMA store and sum the fp32 dh1 by column into one partial
//   row per 128-row tile (db1). One launch then sums both biases' partials
//   in a fixed order, so the bias gradients are deterministic (no atomics).
// The masks come from Philox (philox.cuh): element (row, col) of an [M, N]
// output is element row*N + col of its site, so the backward regenerates
// the forward's masks exactly. dx, dW1 and dW2 stay cuBLAS GEMMs in the
// caller, as the JAX package leaves them to XLA (mlp.py:546-558).
//
// What bounds it on the H100: at M = B*197 rows, D=768, F=3072 each GEMM is
// 2*M*D*F FLOPs against ~(M*D + M*F + D*F)*2 bytes, far above the card's
// ~295 FLOP/byte ridge at b128, so the tensor cores bound it. B, D and D'
// feed them with wgmma (gemm_sm90.cuh); D''s prologue and reductions are
// bound by bytes.
#include "common.cuh"
#include "gemm_sm90.cuh"
#include "philox.cuh"
#include "train_epilogues.cuh"

namespace {

// ---- kernels B and D: epilogues of the wgmma mainloop ----------------------

// B's fc1 (kAct a GELU) and fc2 (ACT_NONE): the consumers add the bias (the
// mainloop rounds the sum to bf16 as it stages it); fc1's epilogue warps
// then take the GELU of each staged value (rounded to bf16 again on store)
template <int kAct>
struct InferEpi {
  static constexpr bool kFinish = kAct != ACT_NONE, kReadBack = false, kDrawBits = false;
  static constexpr bool kStagedIn = false;
  static __device__ __forceinline__ void apply(const gemm90::Params& p, int e, int col, uint32_t,
                                               float (&v)[4]) {
    if (col < p.n) add_bias(p, 0, col, v);  // past N: never stored
  }
  static __device__ __forceinline__ void finish(uint4& q) {
    uint32_t* u = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u[i]);
      u[i] = pack_bf16(infer_gelu<kAct>(__low2float(h)), infer_gelu<kAct>(__high2float(h)));
    }
  }
};

// ---- kernel D': the bias reductions -----------------------------------------

// One set of partial rows part [rows, n] and its sums out [n].
struct ColSums {
  const float* part;
  float* out;
  int rows, n;
};

// out[c] = the sum over r of part[r][c] for db1 (the blocks up to
// split) and db2 (the rest), in a fixed order: thread (x, y) of a block
// sums rows y, y + 16, ... of column c in order, then warp 0 adds the 16
// row slices in order. Deterministic bias gradients, no atomics; 32
// columns a block (a warp reads 128 contiguous bytes of a row).
constexpr int kReduceCols = 32, kReduceSlices = 16;

__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
    colsum_reduce(ColSums first, ColSums second, int split) {
  __shared__ float red[kReduceSlices][kReduceCols];
  const bool one = blockIdx.x < split;  // each field by value: no copy of the params
  const float* part = one ? first.part : second.part;
  const int rows = one ? first.rows : second.rows, n = one ? first.n : second.n;
  const int x = threadIdx.x, y = threadIdx.y;
  const int c = (one ? blockIdx.x : blockIdx.x - split) * kReduceCols + x;
  float s = 0.f;
  if (c < n) {
#pragma unroll 4
    for (int r = y; r < rows; r += kReduceSlices) s += part[(long long)r * n + c];
  }
  red[y][x] = s;
  __syncthreads();
  if (y > 0 || c >= n) return;
  for (int i = 1; i < kReduceSlices; ++i) s += red[i][x];
  (one ? first.out : second.out)[c] = s;
}

// rows of a chunk of D''s dye column sums (bwd_prologue)
constexpr int kPrologueRows = 32;

}  // namespace

// Kernel B. x [m, d], w1 [f, d], b1 [f], w2 [d, f], b2 [d]; h [m, f] is the
// caller's scratch for the bf16 hidden activations; y [m, d]. Two launches
// of the wgmma mainloop, both weights K-major: fc1 with the bias + GELU
// epilogue into h, fc2 with the bias epilogue into y.
GAVIT_EXPORT int gavit_mlp_infer(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* h, void* y, int m,
                                 int d, int f, int approximate, void* stream) {
  if (gemm90::bad_shape(m, f, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gemm90::Params p{};
  p.m = m, p.n = f, p.k = d, p.experts = 1;
  p.bias = static_cast<const __nv_bfloat16*>(b1);
  cudaError_t err = gemm90::row_maps(p, x, h);
  if (err == cudaSuccess) err = gemm90::weight_map(p, w1, false);
  if (err == cudaSuccess)
    err = approximate ? gemm90::launch<InferEpi<ACT_GELU_TANH>, false>(p, s)
                      : gemm90::launch<InferEpi<ACT_GELU_ERF>, false>(p, s);
  if (err != cudaSuccess) return err;
  p.n = d, p.k = f;
  p.bias = static_cast<const __nv_bfloat16*>(b2);
  err = gemm90::row_maps(p, h, y);
  if (err == cudaSuccess) err = gemm90::weight_map(p, w2, false);
  return err == cudaSuccess ? gemm90::launch<InferEpi<ACT_NONE>, false>(p, s) : err;
}

// Kernel D. As B, plus h1 [m, f] (written: the backward's residual) and g
// [m, f] (scratch); the hidden mask is site_h, the output mask site_o (off
// at threshold 0 and scale 1). Two launches of the wgmma mainloop, both
// weights K-major: fc1 writing h1 and g, fc2 with the bias and the output
// mask into y.
GAVIT_EXPORT int gavit_mlp_train_fwd(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* h1, void* g,
                                     void* y, int m, int d, int f, unsigned k0, unsigned k1,
                                     unsigned site_h, unsigned thr_h, float scale_h,
                                     unsigned site_o, unsigned thr_o, float scale_o,
                                     void* stream) {
  if (gemm90::bad_shape(m, f, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gemm90::Params p{};
  p.m = m, p.n = f, p.k = d, p.experts = 1;
  p.bias = static_cast<const __nv_bfloat16*>(b1);
  p.drop = make_site(k0, k1, site_h, thr_h, scale_h);
  p.out2 = static_cast<__nv_bfloat16*>(g);
  cudaError_t err = gemm90::row_maps(p, x, h1);
  if (err == cudaSuccess) err = gemm90::weight_map(p, w1, false);
  if (err == cudaSuccess) err = gemm90::launch<TrainFc1Epi<ACT_GELU_ERF, false>, false>(p, s);
  if (err != cudaSuccess) return err;
  p.n = d, p.k = f;
  p.bias = static_cast<const __nv_bfloat16*>(b2);
  p.drop = make_site(k0, k1, site_o, thr_o, scale_o);
  err = gemm90::row_maps(p, g, y);
  if (err == cudaSuccess) err = gemm90::weight_map(p, w2, false);
  return err == cudaSuccess ? gemm90::launch<TrainFc2Epi<false>, false>(p, s) : err;
}

// Rows of the column-partial scratch buffers of gavit_mlp_train_bwd: which
// 0 db1's (one a 128-row tile of the dh GEMM), 1 db2's (one a prologue
// chunk).
GAVIT_EXPORT int gavit_mlp_bwd_partial_rows(int m, int which) {
  return gemm90::cdiv(m, which == 0 ? gemm90::BM : kPrologueRows);
}

// Kernel D'. dy [m, d], h1 [m, f], w2 [d, f]; writes dye [m, d] (only when
// the output mask is on: otherwise pass dye = dy), dh1 and go [m, f], db1 [f]
// and db2 [d] in fp32; part1 [rows(0), f] and part2 [rows(1), d] are fp32
// scratch. Three launches: the dye prologue, the dh GEMM with TrainDhEpi
// (W2 MN-major, h1 staged by TMA), and both bias reductions.
GAVIT_EXPORT int gavit_mlp_train_bwd(const void* dy, const void* h1, const void* w2, void* dye,
                                     void* dh1, void* go, void* db1, void* db2, void* part1,
                                     void* part2, int m, int d, int f, unsigned k0,
                                     unsigned k1, unsigned site_h, unsigned thr_h,
                                     float scale_h, unsigned site_o, unsigned thr_o,
                                     float scale_o, void* stream) {
  if (gemm90::bad_shape(m, f, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSite out_site = make_site(k0, k1, site_o, thr_o, scale_o);
  cudaError_t err = launch_bwd_prologue(dy, dye, part2, m, d, kPrologueRows, out_site, s);
  if (err != cudaSuccess) return err;
  gemm90::Params p{};
  p.m = m, p.n = f, p.k = d, p.experts = 1;  // one group of every row: no group_sizes
  p.drop = make_site(k0, k1, site_h, thr_h, scale_h);
  p.out2 = static_cast<__nv_bfloat16*>(go);
  p.part = static_cast<float*>(part1);
  p.part_unit = gemm90::BM;  // a tile's partial row: its first row / 128
  err = gemm90::row_maps(p, out_site.on ? dye : dy, dh1);
  if (err == cudaSuccess) err = gemm90::weight_map(p, w2, true);
  if (err == cudaSuccess) err = gemm90::tensor_map(&p.c2, h1, f, m, 1, gemm90::kWgRows);
  if (err == cudaSuccess) err = gemm90::launch<TrainDhEpi<ACT_GELU_ERF>, true>(p, s);
  if (err != cudaSuccess) return err;
  const ColSums sums1{static_cast<const float*>(part1), static_cast<float*>(db1),
                      gavit_mlp_bwd_partial_rows(m, 0), f};
  const ColSums sums2{static_cast<const float*>(part2), static_cast<float*>(db2),
                      gavit_mlp_bwd_partial_rows(m, 1), d};
  const int split = gemm90::cdiv(f, kReduceCols);
  colsum_reduce<<<split + gemm90::cdiv(d, kReduceCols), dim3(kReduceCols, kReduceSlices), 0,
                  s>>>(sums1, sums2, split);
  return cudaGetLastError();
}
