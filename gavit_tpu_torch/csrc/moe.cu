// Kernels M, M', tgmm and N-gmm: the expert MLP of the dropless grouped
// mixture-of-experts engines on the tensor cores, in bf16.
//
// Replaces:
// * M: gavit_tpu/ops/moe_fused.py::_fwd_kernel (launched by _run_fwd, reached
//   through fused_grouped_mlp);
// * M': gavit_tpu/ops/moe_fused.py::_bwd_kernel (launched by _run_bwd, the
//   VJP of fused_grouped_mlp);
// * tgmm: megablox tgmm (JAX-library Pallas), which moe_fused.py::_fused_bwd
//   calls twice for the expert weight gradients dW1 and dW2 (and the unfused
//   engine's VJP once per GEMM);
// * N-gmm: megablox gmm (JAX-library Pallas), which
//   gavit_tpu/ops/moe_grouped.py::ragged_matmul launches for the unfused
//   grouped engine (grouped_moe_mlp with the fused kernels switched off), in
//   both of its forms: x . W[e] and, in the VJP, dy . W[e]^T.
//
// The rows: x_sorted [cap, D] holds the routed (token, choice) pairs grouped
// by expert, each expert's region padded to a multiple of the row tile tm
// and to at least one tile (ops/moe_fused.py::group_by_expert_tiled); M and
// M' take that grouping as group_sizes[E], each expert's padded rows (a
// multiple of tm; the last expert's summing to cap). Pad rows hold finite
// rows of the token buffer and get exactly zero upstream gradient. The weights keep the Flax layout: W1 [E,
// D, F], b1 [E, F], W2 [E, F, D], b2 [E, D]. Nothing here reads a group
// size on the host.
//
// The TPU kernels run one grid step per row tile with the tile's expert
// weights resident in VMEM and keep the GELU output on chip. As for D and D'
// (mlp.cu), the weights of one expert (4.7 MB each at ViT-B) do not fit a
// block's 227 KB of shared memory, so each kernel here is launches of
// hand-written tensor-core GEMMs with fused epilogues:
// * M: fc1 (x . W1[e]) with b1[e] + round -> h1 (stored, the backward's
//   residual), GELU (erf, or tanh on the deterministic bf16 path) on the
//   rounded h1, the hidden mask and scale, round -> g; then fc2 (g . W2[e])
//   with b2[e], the output mask and scale, round -> y. Both are D's
//   training epilogues (train_epilogues.cuh) on the TMA-fed wgmma mainloop
//   of gemm_sm90.cuh with its row schedule over group_sizes, W1[e] and
//   W2[e] the MN-major B operand as N-gmm's forward form reads it: each
//   128-row tile runs the mainloop once per expert segment it holds (one
//   at tm >= 128), the epilogue adds the segment's expert's bias row and
//   keeps the segment's rows, and epilogue warps 2-3 draw the tile's keep
//   bits by global row a tile ahead (nothing at rate 0).
// * M': the backward prologue D' shares (train_epilogues.cuh) masks dy ->
//   dye and sums its columns per row chunk;
//   then dh = dye . W2[e]^T on the same mainloop and row schedule, W2[e]
//   [F, D] the K-major B operand (N-gmm's transposed form), with the
//   training dh epilogue (train_epilogues.cuh's TrainDhEpi): epilogue warps
//   2-3 draw the hidden keep bits a tile ahead, epilogue warp 1 brings each
//   warpgroup's 64 x 192 tile of the forward's h1 into its staging tile by
//   TMA while the mainloop runs, and the consumers form g and GELU'(h1)
//   (erf, or tanh) from it, write go = bf16(g * keep * scale) and stage
//   dh1 = bf16(dh * GELU' * keep * scale) over h1 for the TMA store, and
//   sum dh1 in fp32 by column into one partial row per (128-row tile,
//   group segment); then dx = dh1 . W1[e]^T, N-gmm's transposed launch as
//   gavit_gmm makes it (the TPU kernel also computes dx inside,
//   moe_fused.py:213-216). The per-expert bias gradients db1 [E, F] and db2
//   [E, D] are reduced from the partials in segment order over
//   group_sizes: deterministic, no atomics.
// * tgmm: C[e] = A[rows of e]^T . B[rows of e] for A [R, K], B [R, N]
//   row-major, the groups given by group_sizes [E] on the device, on the
//   TMA-fed wgmma mainloop of gemm_sm90.cuh with its grouped-K schedule:
//   both operands MN-major (A through wgmma's transpose-A bit), each 128 x
//   192 tile of one expert's [K, N] output walking that expert's rows 64 at
//   a time from its first (any row), the rows of the last step past the
//   group zeroed in shared memory, accumulating in fp32 and rounding to bf16
//   once; an empty expert's tiles are stored as zeros. The fused engine
//   passes the cap-padded rows (groups multiples of tm), the unfused one the
//   packed rows (boundaries anywhere).
//
// * N-gmm: C[T, N] = A[T, K] . W[e] (W [E, K, N], the MN-major B operand)
//   or, transposed, A . W[e]^T (W [E, N, K], K-major) over expert-contiguous
//   rows, group_sizes [E] on the device, on the TMA-fed wgmma mainloop of
//   gemm_sm90.cuh with its store epilogue. The groups are not tile-aligned:
//   a block's 128-row tile may straddle several groups, lie in one hot group
//   or in none. Each block walks the groups that overlap its rows and runs
//   the main loop once for each, keeping that group's rows; an empty group
//   is skipped; rows past the last group are written as zeros. Each output
//   element is written once from one fp32 sum: no atomics, reruns give the
//   same bits.
//
// At tm < 128 a 128-row tile of M or M' straddles experts: the row
// schedule runs the main loop once per expert segment of the tile and keeps
// only that segment's rows (and, in M''s dh, that segment's column sums:
// its partial row is its first row / min(tm, 128), a segment always
// starting on a tile or a group boundary); the other rows' sums use the
// wrong weights and are discarded. That costs up to one main loop per group
// boundary, only at the small token counts that pick such a tm.
//
// The masks come from Philox (philox.cuh): the hidden mask is element
// row*F + col of the [cap, F] buffer at the hidden site, the output mask
// element row*D + col of [cap, D] at the output site, so the backward
// regenerates the forward's masks and the plain versions in
// ops/moe_fused.py draw the same bits.
//
// What bounds it on the H100: each GEMM is 2*cap*D*F FLOPs (cap = 52480 rows
// at ViT-B b128) against ~(cap*(D+F) + D*F*E)*2 bytes, far above the card's
// ~295 FLOP/byte ridge, so the tensor cores bound M, M', tgmm and N-gmm,
// all fed with wgmma (gemm_sm90.cuh). M's fc1 and M''s dh also pay their
// GELU (and derivative) a value in the consumers' registers, between
// mainloops, where the tensor cores wait (PERF.md §7).
#include "common.cuh"
#include "gemm_sm90.cuh"
#include "moe_common.cuh"
#include "philox.cuh"
#include "train_epilogues.cuh"

namespace {

static_assert(gemm90::BM == kTileRows, "the row tile moe_common.cuh's units count");

// N-gmm: C[m, n] = A[m, k] . W[e] over the groups' rows (W [e, k, n]
// MN-major, or [e, n, k] K-major with transpose_rhs), past the groups zeros
cudaError_t gmm(const void* a, const void* b, const int* group_sizes, void* c, int m, int k,
                int n, int e, bool transpose_rhs, cudaStream_t s) {
  if (gemm90::bad_shape(m, n, k) || e <= 0) return cudaErrorInvalidValue;
  gemm90::Params p{};
  p.m = m, p.n = n, p.k = k, p.experts = e;
  p.group_sizes = group_sizes;
  cudaError_t err = gemm90::row_maps(p, a, c);
  if (err == cudaSuccess) err = gemm90::weight_map(p, b, !transpose_rhs);
  if (err != cudaSuccess) return err;
  return transpose_rhs ? gemm90::launch<gemm90::StoreEpi, false>(p, s)
                       : gemm90::launch<gemm90::StoreEpi, true>(p, s);
}

}  // namespace

// Kernel M. x [cap, d], w1 [e, d, f], b1 [e, f], w2 [e, f, d], b2 [e, d],
// group_sizes [e] int32 on the device (each expert's cap-padded rows, a
// multiple of tm; summing to cap); writes h1 [cap, f] (the backward's
// residual), g [cap, f] (scratch) and y [cap, d]. act: 0 erf GELU, 1 tanh.
// The hidden mask is site_h, the output mask site_o (off at threshold 0 and
// scale 1). Two launches of the wgmma mainloop with the row schedule over
// the groups, both weights MN-major: fc1 writing h1 and g, fc2 with b2 and
// the output mask into y.
GAVIT_EXPORT int gavit_moe_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* group_sizes, void* h1, void* g,
                               void* y, int cap, int d, int f, int e, int tm, int act,
                               unsigned k0, unsigned k1, unsigned site_h, unsigned thr_h,
                               float scale_h, unsigned site_o, unsigned thr_o, float scale_o,
                               void* stream) {
  if (bad_shape(cap, d, f, e, tm) || gemm90::bad_shape(cap, f, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gemm90::Params p{};
  p.m = cap, p.n = f, p.k = d, p.experts = e;
  p.group_sizes = static_cast<const int*>(group_sizes);
  p.bias = static_cast<const __nv_bfloat16*>(b1);
  p.bias_stride = f;
  p.drop = make_site(k0, k1, site_h, thr_h, scale_h);
  p.out2 = static_cast<__nv_bfloat16*>(g);
  cudaError_t err = gemm90::row_maps(p, x, h1);
  if (err == cudaSuccess) err = gemm90::weight_map(p, w1, true);
  if (err == cudaSuccess)
    err = act ? gemm90::launch<TrainFc1Epi<ACT_GELU_TANH, true>, true>(p, s)
              : gemm90::launch<TrainFc1Epi<ACT_GELU_ERF, true>, true>(p, s);
  if (err != cudaSuccess) return err;
  p.n = d, p.k = f;
  p.bias = static_cast<const __nv_bfloat16*>(b2);
  p.bias_stride = d;
  p.drop = make_site(k0, k1, site_o, thr_o, scale_o);
  p.out2 = nullptr;
  err = gemm90::row_maps(p, g, y);
  if (err == cudaSuccess) err = gemm90::weight_map(p, w2, true);
  return err == cudaSuccess ? gemm90::launch<TrainFc2Epi<true>, true>(p, s) : err;
}

// Rows of M''s fp32 scratch: which 0 the dh1 partials [rows, f], 1 the dye
// partials [rows, d].
GAVIT_EXPORT int gavit_moe_bwd_partial_rows(int cap, int tm, int which) {
  return which == 0 ? cap / unit_rows(tm) : cap / prologue_rows(tm);
}

// Kernel M'. dy [cap, d], h1 [cap, f], w1 [e, d, f], w2 [e, f, d],
// group_sizes [e] int32 on the device (as gavit_moe_fwd's); writes dye
// [cap, d] (only when the output mask is on: otherwise pass dye = dy), dh1
// and go [cap, f], dx [cap, d], and the fp32 per-expert bias gradients db1
// [e, f] and db2 [e, d]; part1 and part2 are fp32 scratch of
// gavit_moe_bwd_partial_rows rows. Five launches: the dye prologue, db2's
// reduce, the dh GEMM with TrainDhEpi (W2 K-major, h1 staged by TMA), db1's
// reduce, the dx GEMM (W1 K-major).
GAVIT_EXPORT int gavit_moe_bwd(const void* dy, const void* h1, const void* w1, const void* w2,
                               const void* group_sizes, void* dye, void* dh1, void* go, void* dx,
                               void* db1, void* db2, void* part1, void* part2, int cap, int d,
                               int f, int e, int tm, int act, unsigned k0, unsigned k1,
                               unsigned site_h, unsigned thr_h, float scale_h, unsigned site_o,
                               unsigned thr_o, float scale_o, void* stream) {
  if (bad_shape(cap, d, f, e, tm) || gemm90::bad_shape(cap, f, d))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  const DropSite out_site = make_site(k0, k1, site_o, thr_o, scale_o);
  const int prow = prologue_rows(tm);
  cudaError_t err = launch_bwd_prologue(dy, dye, part2, cap, d, prow, out_site, s);
  if (err == cudaSuccess)
    err = colsum(static_cast<const float*>(part2), static_cast<float*>(db2), gs, prow, 0, d, e, s);
  if (err != cudaSuccess) return err;
  gemm90::Params p{};
  p.m = cap, p.n = f, p.k = d, p.experts = e;
  p.group_sizes = gs;
  p.drop = make_site(k0, k1, site_h, thr_h, scale_h);
  p.out2 = static_cast<__nv_bfloat16*>(go);
  p.part = static_cast<float*>(part1);
  p.part_unit = unit_rows(tm);
  err = gemm90::row_maps(p, out_site.on ? dye : dy, dh1);
  if (err == cudaSuccess) err = gemm90::weight_map(p, w2, false);
  if (err == cudaSuccess) err = gemm90::tensor_map(&p.c2, h1, f, cap, 1, gemm90::kWgRows);
  if (err == cudaSuccess)
    err = act ? gemm90::launch<TrainDhEpi<ACT_GELU_TANH>, false>(p, s)
              : gemm90::launch<TrainDhEpi<ACT_GELU_ERF>, false>(p, s);
  if (err == cudaSuccess)
    err = colsum(static_cast<const float*>(part1), static_cast<float*>(db1), gs, p.part_unit, 1,
                 f, e, s);
  return err == cudaSuccess ? gmm(dh1, w1, gs, dx, cap, f, d, e, true, s) : err;
}

// Kernel tgmm. a [rows, kd], b [rows, n], group_sizes [e] int32 on the
// device (rows in expert order; rows past their sum are read by no group);
// writes c [e, kd, n] in bf16.
GAVIT_EXPORT int gavit_moe_tgmm(const void* a, const void* b, const void* group_sizes, void* c,
                                int rows, int kd, int n, int e, void* stream) {
  if (rows <= 0 || kd <= 0 || n <= 0 || e <= 0 || kd % 8 || n % 8)
    return cudaErrorInvalidValue;
  gemm90::Params p{};
  p.m = kd, p.n = n, p.k = rows, p.experts = e;
  p.group_sizes = static_cast<const int*>(group_sizes);
  const cudaError_t err = gemm90::grouped_k_maps(p, a, b, c);
  if (err != cudaSuccess) return err;
  return gemm90::launch<gemm90::StoreEpi, true, gemm90::GroupedK>(
      p, static_cast<cudaStream_t>(stream));
}

// Kernel N-gmm. a [m, k], group_sizes [e] int32 on the device (rows in
// expert order, past their sum written as zeros); b [e, k, n] (the MN-major
// B operand), or [e, n, k] with transpose_rhs (K-major); writes c [m, n] in
// bf16.
GAVIT_EXPORT int gavit_gmm(const void* a, const void* b, const void* group_sizes, void* c, int m,
                           int k, int n, int e, int transpose_rhs, void* stream) {
  return gmm(a, b, static_cast<const int*>(group_sizes), c, m, k, n, e, transpose_rhs != 0,
             static_cast<cudaStream_t>(stream));
}
