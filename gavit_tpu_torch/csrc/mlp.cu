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
// * D': a prologue applies the output mask to dy -> dye (needed by the dW2
//   GEMM) and sums dye's columns (db2); the GEMM dh = dye . W2 reads W2 as
//   stored ([D, F], nn.Linear's layout) through ldmatrix.trans, no transposed
//   copy; its epilogue reads the h1 tile, computes GELU and GELU' from one
//   exp (_gelu_and_grad_f32), regenerates the hidden mask and writes
//   dh1 = dh * GELU' * mask * scale and go = GELU * mask * scale in bf16,
//   and sums the fp32 dh1 over its rows into per-block column partials
//   (db1). One pass per bias then sums the partials in a fixed order, so the
//   bias gradients are deterministic (no atomics).
// The masks come from Philox (philox.cuh): element (row, col) of an [M, N]
// output is element row*N + col of its site, so the backward regenerates
// the forward's masks exactly. dx, dW1 and dW2 stay cuBLAS GEMMs in the
// caller, as the JAX package leaves them to XLA (mlp.py:546-558).
//
// What bounds it on the H100: at M = B*197 rows, D=768, F=3072 each GEMM is
// 2*M*D*F FLOPs against ~(M*D + M*F + D*F)*2 bytes, far above the card's
// ~295 FLOP/byte ridge at b128, so the tensor cores bound it. B and D feed
// them with wgmma (gemm_sm90.cuh). D' still feeds them with mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), fragments loaded with ldmatrix from a
// 3-stage cp.async ring; its move to the wgmma mainloop comes later.
//
// D''s GEMM: A = dye [M, D] row-major, B = W2 [D, F] row-major ([K][N]).
// Tiles are 128x128x64 for 8 warps (each 64x32), 3 stages; shared rows of
// 72 (A) or 136 (B) bf16 keep the ldmatrix phases bank-conflict free.
// Ragged M and N are masked; K and N must be multiples of 8 (16-byte rows).
#include "common.cuh"
#include "gemm_sm90.cuh"
#include "philox.cuh"
#include "train_epilogues.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, kStages = 3;
constexpr int LDS = BK + 8;     // 72 bf16 = 36 words: 8 rows of a phase hit 8 bank groups
constexpr int LDS_KN = BN + 8;  // 136 bf16 = 68 words: the same for [K][N] B tiles
constexpr int kThreads = 256;   // 8 warps in 2x4, each owning a 64x32 tile
constexpr int kStageElems = BM * LDS + BK * LDS_KN;
constexpr int kSmemBytes = kStages * kStageElems * (int)sizeof(__nv_bfloat16);

// D''s epilogue
struct EpiArgs {
  __nv_bfloat16* out;         // dh1
  __nv_bfloat16* out2;        // go
  const __nv_bfloat16* h1;    // the forward's h1 [M, N]
  float* colsum;              // column partials [gridDim.y][N]
  DropSite drop;              // the hidden mask
};

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

// ---- kernel D': mma.sync ----------------------------------------------------

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// dh = A . B (A = dye [M, K], B = W2 [K, N]) with the GELU' epilogue: dh1 =
// dh * GELU'(h1) * keep_h * scale_h and go = GELU(h1) * keep_h * scale_h in
// bf16, and the column partials of the fp32 dh1.
__global__ void __launch_bounds__(kThreads)
    dh_gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                   int M, int N, int K, EpiArgs ep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int k0) {
    __nv_bfloat16* sa = smem + stage * kStageElems;
    __nv_bfloat16* sb = sa + BM * LDS;
    // A: 128 rows x 8 chunks of 8 bf16, 4 chunks a thread
    for (int c = tid; c < BM * (BK / 8); c += kThreads) {
      const int r = c >> 3, kc = (c & 7) * 8;
      const int gk = k0 + kc, ga = m0 + r;
      const bool ok = ga < M && gk < K;
      cp_async_16(sa + r * LDS + kc, ok ? A + (long)ga * K + gk : A, ok ? 16 : 0);
    }
    // B [K][N]: 64 k-rows x 16 chunks along n
    for (int c = tid; c < BK * (BN / 8); c += kThreads) {
      const int r = c >> 4, nc = (c & 15) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async_16(sb + r * LDS_KN + nc, ok ? B + (long)gk * N + gn : B, ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // ldmatrix row/column of this lane: A tiles as (rows 0-7 | 8-15) x (k 0-7 |
  // 8-15); [K][N] B as (k 0-7 | 8-15) x (n 0-7), then the same at n 8-15
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3), t_col = (lane >> 4) * 8;

  const int kt_count = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) load_tile(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ...for every thread; stage (kt-1) is free
    const int next = kt + kStages - 1;
    if (next < kt_count) load_tile(next % kStages, next * BK);
    cp_async_commit();
    const __nv_bfloat16* a = smem + (kt % kStages) * kStageElems;
    const __nv_bfloat16* bs = a + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a + (wm * 64 + mi * 16 + a_row) * LDS + ks + a_col);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (ks + t_row) * LDS_KN + wn * 32 + nj * 16 + t_col);
        bf[2 * nj][0] = r[0], bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2], bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  float cs[4][2];  // this thread's column sums of fp32 dh1
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) cs[ni][0] = cs[ni][1] = 0.f;

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + tig * 2;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row >= M) continue;
        const float v0 = acc[mi][ni][half * 2], v1 = acc[mi][ni][half * 2 + 1];
        const long idx = (long)row * N + col;
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(ep.h1 + idx);
        float g0, g1, d0, d1;
        gelu_and_grad(__bfloat162float(hv.x), g0, d0);
        gelu_and_grad(__bfloat162float(hv.y), g1, d1);
        if (ep.drop.on) {
          bool keep0, keep1;
          keep_pair(ep.drop, (unsigned long long)idx, keep0, keep1);
          const float s = ep.drop.scale;
          g0 = keep0 ? g0 * s : 0.f, d0 = keep0 ? d0 * s : 0.f;
          g1 = keep1 ? g1 * s : 0.f, d1 = keep1 ? d1 * s : 0.f;
        }
        const float dh0 = v0 * d0, dh1 = v1 * d1;
        store2(ep.out + idx, dh0, dh1);
        store2(ep.out2 + idx, g0, g1);
        cs[ni][0] += dh0;
        cs[ni][1] += dh1;
      }
    }
  }

  // sum the 8 lanes of a column (same tig), then the two row-warps wm
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) cs[ni][j] += __shfl_xor_sync(0xffffffffu, cs[ni][j], o);
  __syncthreads();  // every warp is past its last read of the ring
  float* red = reinterpret_cast<float*>(smem_raw);  // [BN]
  if (wm == 1 && g == 0) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wn * 32 + ni * 8 + tig * 2;
      red[c] = cs[ni][0], red[c + 1] = cs[ni][1];
    }
  }
  __syncthreads();
  if (wm == 0 && g == 0) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wn * 32 + ni * 8 + tig * 2;
      if (n0 + c < N) {
        float* out = ep.colsum + (long)blockIdx.y * N + n0 + c;
        out[0] = cs[ni][0] + red[c];
        out[1] = cs[ni][1] + red[c + 1];
      }
    }
  }
}

cudaError_t dh_gemm(const void* a, const void* b, int m, int n, int k, const EpiArgs& ep,
                    cudaStream_t stream) {
  cudaError_t err = set_smem(dh_gemm_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  dh_gemm_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), m, n, k, ep);
  return cudaGetLastError();
}

// D' prologue: dye = bf16(dy * keep_out * scale) (only when the output mask
// is on), and per-block column sums of float(dye) over kRows rows. Thread j
// owns columns 8j..8j+7 (one 16-byte vector a row), so blockDim.x = D / 8.
constexpr int kPrologueRows = 128;

__global__ void mlp_bwd_prologue(const __nv_bfloat16* __restrict__ dy,
                                 __nv_bfloat16* __restrict__ dye, float* __restrict__ part,
                                 int M, int D, DropSite s) {
  const int c0 = threadIdx.x * 8;
  const int r0 = blockIdx.x * kPrologueRows;
  const int r1 = min(r0 + kPrologueRows, M);
  float sum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sum[j] = 0.f;
  for (int r = r0; r < r1; ++r) {
    const long e = (long)r * D + c0;
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
#pragma unroll
  for (int j = 0; j < 8; ++j) part[(long)blockIdx.x * D + c0 + j] = sum[j];
}

// out[c] = sum over r of part[r][c], r in order: deterministic bias grads
__global__ void colsum_reduce(const float* __restrict__ part, float* __restrict__ out, int rows,
                              int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(long)r * n + c];
  out[c] = s;
}

bool bad_shape(int m, int d, int f) {
  return m <= 0 || d <= 0 || f <= 0 || d % 8 || f % 8 || m > 65535 * BM;
}

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

// Rows of the column-partial scratch buffers of gavit_mlp_train_bwd.
GAVIT_EXPORT int gavit_mlp_bwd_partial_rows(int m, int which) {
  return which == 0 ? (m + BM - 1) / BM : (m + kPrologueRows - 1) / kPrologueRows;
}

// Kernel D'. dy [m, d], h1 [m, f], w2 [d, f]; writes dye [m, d] (only when
// the output mask is on: otherwise pass dye = dy), dh1 and go [m, f], db1 [f]
// and db2 [d] in fp32; part1 [rows(0), f] and part2 [rows(1), d] are fp32
// scratch.
GAVIT_EXPORT int gavit_mlp_train_bwd(const void* dy, const void* h1, const void* w2, void* dye,
                                     void* dh1, void* go, void* db1, void* db2, void* part1,
                                     void* part2, int m, int d, int f, unsigned k0,
                                     unsigned k1, unsigned site_h, unsigned thr_h,
                                     float scale_h, unsigned site_o, unsigned thr_o,
                                     float scale_o, void* stream) {
  if (bad_shape(m, d, f) || d / 8 > 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSite out_site = make_site(k0, k1, site_o, thr_o, scale_o);
  const int rows2 = gavit_mlp_bwd_partial_rows(m, 1);
  mlp_bwd_prologue<<<rows2, d / 8, 0, s>>>(static_cast<const __nv_bfloat16*>(dy),
                                            static_cast<__nv_bfloat16*>(dye),
                                            static_cast<float*>(part2), m, d, out_site);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_reduce<<<(d + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part2),
                                                static_cast<float*>(db2), rows2, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  EpiArgs ep{};
  ep.out = static_cast<__nv_bfloat16*>(dh1);
  ep.out2 = static_cast<__nv_bfloat16*>(go);
  ep.h1 = static_cast<const __nv_bfloat16*>(h1);
  ep.colsum = static_cast<float*>(part1);
  ep.drop = make_site(k0, k1, site_h, thr_h, scale_h);
  err = dh_gemm(out_site.on ? dye : dy, w2, m, f, d, ep, s);
  if (err != cudaSuccess) return err;
  colsum_reduce<<<(f + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part1),
                                                static_cast<float*>(db1),
                                                gavit_mlp_bwd_partial_rows(m, 0), f);
  return cudaGetLastError();
}
