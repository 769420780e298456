// Kernels M, M' and tgmm: the expert MLP of the dropless grouped
// mixture-of-experts engine on the tensor cores, in bf16.
//
// Replaces:
// * M: gavit_tpu/ops/moe_fused.py::_fwd_kernel (launched by _run_fwd, reached
//   through fused_grouped_mlp);
// * M': gavit_tpu/ops/moe_fused.py::_bwd_kernel (launched by _run_bwd, the
//   VJP of fused_grouped_mlp);
// * tgmm: megablox tgmm (JAX-library Pallas), which moe_fused.py::_fused_bwd
//   calls twice for the expert weight gradients dW1 and dW2.
//
// The rows: x_sorted [cap, D] holds the routed (token, choice) pairs grouped
// by expert, each expert's region padded to a multiple of the row tile tm
// and to at least one tile (ops/moe_fused.py::group_by_expert_tiled), and
// tile_group[cap / tm] names the expert of each tile. Pad rows hold finite
// rows of the token buffer and get exactly zero upstream gradient. The
// weights keep the Flax layout: W1 [E, D, F], b1 [E, F], W2 [E, F, D],
// b2 [E, D]. Nothing here reads a group size on the host.
//
// The TPU kernels run one grid step per row tile with the tile's expert
// weights resident in VMEM and keep the GELU output on chip. As for D and D'
// (mlp.cu), the weights of one expert (4.7 MB each at ViT-B) do not fit a
// block's 227 KB of shared memory, so each kernel here is launches of
// hand-written tensor-core GEMMs with fused epilogues, the same 128x128x64
// mma.sync tiles on a 3-stage cp.async ring as mlp.cu:
// * M: fc1 (x . W1[e], W1 read as [K][N]) with bias + round -> h1 (stored, the
//   backward's residual), GELU (erf, or tanh on the deterministic bf16 path)
//   on the rounded h1, the hidden mask and scale, round -> g; then fc2
//   (g . W2[e]) with bias, the output mask and scale, round -> y.
// * M': a prologue masks dy -> dye and sums its columns per row chunk; the
//   GEMM dh = dye . W2[e]^T (W2[e] [F, D] read as [N][K]) with D''s epilogue
//   (GELU and GELU' from the stored h1, the hidden mask -> dh1 and go, fp32
//   column partials of dh1); then the grouped GEMM dx = dh1 . W1[e]^T, which
//   the TPU kernel also computes inside (moe_fused.py:213-216). The
//   per-expert bias gradients db1 [E, F] and db2 [E, D] are reduced from the
//   partials in a fixed order: deterministic, no atomics.
// * tgmm: C[e] = A[rows of e]^T . B[rows of e] for A [cap, K], B [cap, N]
//   row-major, the groups given by group_sizes [E] on the device. Each block
//   owns one 128x128 tile of one expert's [K, N] output and walks that
//   expert's rows 64 at a time, accumulating in fp32, and rounds to bf16 once.
//
// A block's row tile must belong to one expert to use one expert's weights.
// With tm >= 128 (ViT-B at b64 and b128: tm = 256) it always does. With a
// smaller tm a 128-row tile can span experts: the block then runs the main
// loop once per run of same-expert tiles inside it and keeps only that run's
// rows in the epilogue (the other rows' sums use the wrong weights and are
// discarded). That costs up to 128/tm main loops per block, only at the small
// token counts that pick such a tm.
//
// The masks come from Philox (philox.cuh): the hidden mask is element
// row*F + col of the [cap, F] buffer at the hidden site, the output mask
// element row*D + col of [cap, D] at the output site, so the backward
// regenerates the forward's masks and the plain versions in
// ops/moe_fused.py draw the same bits.
//
// What bounds it on the H100: each GEMM is 2*cap*D*F FLOPs (cap = 52480 rows
// at ViT-B b128) against ~(cap*(D+F) + D*F*E)*2 bytes, far above the card's
// ~295 FLOP/byte ridge, so the tensor cores bound M, M' and tgmm. This
// version feeds them with mma.sync; wgmma, TMA and warp specialisation come
// later.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, kStages = 3;
constexpr int LDS = BK + 8;     // 72 bf16: 8 rows of an ldmatrix phase hit 8 bank groups
constexpr int LDS_KN = BN + 8;  // 136 bf16: the same for [K][N] (and tgmm's [K][M]) tiles
constexpr int kThreads = 256;   // 8 warps in 2x4, each owning a 64x32 tile
static_assert(BM == BN, "tgmm stages its A and B tiles with one row pitch");

template <bool kKN>
__host__ __device__ constexpr int stage_elems() {
  return BM * LDS + (kKN ? BK * LDS_KN : BN * LDS);
}
template <bool kKN>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_elems<kKN>() * (int)sizeof(__nv_bfloat16);
}
constexpr int kTgmmStage = 2 * BK * LDS_KN;
constexpr int kTgmmSmem = kStages * kTgmmStage * (int)sizeof(__nv_bfloat16);

enum Act { ACT_ERF = 0, ACT_TANH = 1 };
// epilogues: M's fc1 and fc2; M''s dh and dx
enum Epi { EPI_FC1 = 0, EPI_FC2 = 1, EPI_DH = 2, EPI_STORE = 3 };

struct Groups {
  const int* tile_group;  // [M / tm] expert of each row tile
  int tm;
};

struct EpiArgs {
  const __nv_bfloat16* bias;  // FC1, FC2: [E, N]
  __nv_bfloat16* out;         // FC1 g; FC2 y; DH dh1; STORE the product
  __nv_bfloat16* out2;        // FC1 h1; DH go
  const __nv_bfloat16* h1;    // DH: the forward's h1 [M, N]
  float* colsum;              // DH: column partials, one row per segment start unit
  DropSite drop;              // FC1 and DH: hidden mask; FC2: output mask
};

// tanh-GELU and its derivative from one tanh (moe_fused.py::_gelu_tanh_and_grad_f32)
__device__ __forceinline__ void gelu_tanh_and_grad(float x, float& g, float& dg) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  const float th = tanhf(c * (x + a * x * x * x));
  g = 0.5f * x * (1.f + th);
  dg = 0.5f * (1.f + th) + 0.5f * x * (1.f - th * th) * c * (1.f + 3.f * a * x * x);
}

template <int kAct>
__device__ __forceinline__ void act_and_grad(float x, float& g, float& dg) {
  if (kAct == ACT_TANH)
    gelu_tanh_and_grad(x, g, dg);
  else
    gelu_and_grad(x, g, dg);
}

template <int kAct>
__device__ __forceinline__ float gelu(float x) {
  float g, dg;
  act_and_grad<kAct>(x, g, dg);
  return g;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// rows of a unit: the granule of the bias-gradient partials (a segment of a
// block's row tile always starts on one)
int unit_rows(int tm) { return tm < BM ? tm : BM; }

// One segment of a block's row tile: rows [lo, hi) of [m0, m0 + BM), all of
// expert e. The main loop runs over every row of the tile (a GEMM row's sum
// needs no other row), the epilogue keeps [lo, hi).
template <bool kKN, int kEpi, int kAct>
__device__ __forceinline__ void gemm_segment(const __nv_bfloat16* __restrict__ A,
                                             const __nv_bfloat16* __restrict__ B, int M, int N,
                                             int K, int e, int lo, int hi, int unit,
                                             const EpiArgs& ep, unsigned char* smem_raw) {
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kStage = stage_elems<kKN>();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16* Be = B + (long)e * K * N;

  auto load_tile = [&](int stage, int k0) {
    __nv_bfloat16* sa = smem + stage * kStage;
    __nv_bfloat16* sb = sa + BM * LDS;
    for (int c = tid; c < BM * (BK / 8); c += kThreads) {
      const int r = c >> 3, kc = (c & 7) * 8;
      const int gk = k0 + kc, ga = m0 + r;
      const bool ok = ga < M && gk < K;
      cp_async_16(sa + r * LDS + kc, ok ? A + (long)ga * K + gk : A, ok ? 16 : 0);
    }
    if (kKN) {  // B_e [K][N]
      for (int c = tid; c < BK * (BN / 8); c += kThreads) {
        const int r = c >> 4, nc = (c & 15) * 8;
        const int gk = k0 + r, gn = n0 + nc;
        const bool ok = gk < K && gn < N;
        cp_async_16(sb + r * LDS_KN + nc, ok ? Be + (long)gk * N + gn : Be, ok ? 16 : 0);
      }
    } else {  // B_e [N][K]
      for (int c = tid; c < BN * (BK / 8); c += kThreads) {
        const int r = c >> 3, kc = (c & 7) * 8;
        const int gk = k0 + kc, gb = n0 + r;
        const bool ok = gb < N && gk < K;
        cp_async_16(sb + r * LDS + kc, ok ? Be + (long)gb * K + gk : Be, ok ? 16 : 0);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  // ldmatrix row/column of this lane (see mlp.cu)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3), t_col = (lane >> 4) * 8;

  const int kt_count = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) load_tile(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < kt_count) load_tile(next % kStages, next * BK);
    cp_async_commit();
    const __nv_bfloat16* a = smem + (kt % kStages) * kStage;
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
        if (kKN)
          ldmatrix_x4_trans(r, bs + (ks + t_row) * LDS_KN + wn * 32 + nj * 16 + t_col);
        else
          ldmatrix_x4(r, bs + (wn * 32 + nj * 16 + b_row) * LDS + ks + b_col);
        bf[2 * nj][0] = r[0], bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2], bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  float cs[4][2];  // EPI_DH: this thread's column sums of fp32 dh1 over the segment
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) cs[ni][0] = cs[ni][1] = 0.f;

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + tig * 2;
      if (col >= N) continue;
      float b0 = 0.f, b1 = 0.f;
      if (kEpi == EPI_FC1 || kEpi == EPI_FC2) {
        b0 = __bfloat162float(ep.bias[(long)e * N + col]);
        b1 = __bfloat162float(ep.bias[(long)e * N + col + 1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row < lo || row >= hi) continue;
        const float v0 = acc[mi][ni][half * 2], v1 = acc[mi][ni][half * 2 + 1];
        const long idx = (long)row * N + col;
        if (kEpi == EPI_FC1) {
          const float h0 = round_to<__nv_bfloat16>(v0 + b0);
          const float h1 = round_to<__nv_bfloat16>(v1 + b1);
          store2(ep.out2 + idx, h0, h1);
          float g0 = gelu<kAct>(h0), g1 = gelu<kAct>(h1);
          if (ep.drop.on) {
            bool keep0, keep1;
            keep_pair(ep.drop, (unsigned long long)idx, keep0, keep1);
            g0 = keep0 ? g0 * ep.drop.scale : 0.f;
            g1 = keep1 ? g1 * ep.drop.scale : 0.f;
          }
          store2(ep.out + idx, g0, g1);
        } else if (kEpi == EPI_FC2) {
          float y0 = v0 + b0, y1 = v1 + b1;
          if (ep.drop.on) {
            bool keep0, keep1;
            keep_pair(ep.drop, (unsigned long long)idx, keep0, keep1);
            y0 = keep0 ? y0 * ep.drop.scale : 0.f;
            y1 = keep1 ? y1 * ep.drop.scale : 0.f;
          }
          store2(ep.out + idx, y0, y1);
        } else if (kEpi == EPI_DH) {
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(ep.h1 + idx);
          float g0, g1, d0, d1;
          act_and_grad<kAct>(__bfloat162float(hv.x), g0, d0);
          act_and_grad<kAct>(__bfloat162float(hv.y), g1, d1);
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
        } else {  // EPI_STORE
          store2(ep.out + idx, v0, v1);
        }
      }
    }
  }

  if (kEpi == EPI_DH) {
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
      float* part = ep.colsum + (long)(lo / unit) * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + tig * 2;
        if (n0 + c < N) {
          part[n0 + c] = cs[ni][0] + red[c];
          part[n0 + c + 1] = cs[ni][1] + red[c + 1];
        }
      }
    }
  }
}

// C[M, N] = A[M, K] . B_e, B_e = B + e*K*N for the expert e of each row's
// tile. kSplit = false (tm >= BM): a block's rows are one expert's, one
// segment. kSplit = true (tm < BM): one segment per run of same-expert tiles.
template <bool kKN, int kEpi, int kAct, bool kSplit>
__global__ void __launch_bounds__(kThreads)
    moe_gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                    int M, int N, int K, Groups grp, EpiArgs ep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tm = grp.tm;
  const int m0 = blockIdx.y * BM;
  const int m_end = min(m0 + BM, M);
  if (!kSplit) {
    gemm_segment<kKN, kEpi, kAct>(A, B, M, N, K, grp.tile_group[m0 / tm], m0, m_end, BM, ep,
                                  smem_raw);
    return;
  }
  for (int lo = m0; lo < m_end;) {
    const int e = grp.tile_group[lo / tm];
    int hi = (lo / tm + 1) * tm;
    while (hi < m_end && grp.tile_group[hi / tm] == e) hi += tm;
    hi = min(hi, m_end);
    __syncthreads();  // the previous segment's readers of shared memory are done
    gemm_segment<kKN, kEpi, kAct>(A, B, M, N, K, e, lo, hi, tm, ep, smem_raw);
    lo = hi;
  }
}

template <bool kKN, int kEpi, int kAct>
cudaError_t moe_gemm(const void* a, const void* b, int m, int n, int k, Groups grp,
                     const EpiArgs& ep, cudaStream_t stream) {
  constexpr int smem = smem_bytes<kKN>();
  const bool split = grp.tm < BM;
  auto kernel = split ? moe_gemm_kernel<kKN, kEpi, kAct, true>
                      : moe_gemm_kernel<kKN, kEpi, kAct, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(a),
                                           static_cast<const __nv_bfloat16*>(b), m, n, k, grp,
                                           ep);
  return cudaGetLastError();
}

// C[e] (bf16 [Kd, N]) = sum over the rows r of group e of A[r, :]^T B[r, :].
__global__ void __launch_bounds__(kThreads)
    moe_tgmm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                    const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ C, int Kd,
                    int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int r_begin = 0;
  for (int i = 0; i < e; ++i) r_begin += group_sizes[i];
  const int r_end = r_begin + group_sizes[e];

  // both tiles are [BK rows][128 columns]: A's columns are C's rows (m)
  auto load_tile = [&](int stage, int r0) {
    __nv_bfloat16* sa = smem + stage * kTgmmStage;
    __nv_bfloat16* sb = sa + BK * LDS_KN;
    for (int c = tid; c < BK * (BM / 8); c += kThreads) {
      const int r = c >> 4, cc = (c & 15) * 8;
      const int gr = r0 + r;
      const bool oka = gr < r_end && m0 + cc < Kd;
      cp_async_16(sa + r * LDS_KN + cc, oka ? A + (long)gr * Kd + m0 + cc : A, oka ? 16 : 0);
      const bool okb = gr < r_end && n0 + cc < N;
      cp_async_16(sb + r * LDS_KN + cc, okb ? B + (long)gr * N + n0 + cc : B, okb ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  // A fragments from the [k][m] tile by ldmatrix.trans: matrix i of lane
  // 8i..8i+7 covers k rows (i/2)*8.. and m columns (i%2)*8.., which hands
  // each thread a0..a3 of the m16n8k16 A operand; B as mlp.cu's [K][N] tiles
  const int at_row = (lane & 7) + ((lane >> 4) << 3), at_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3), t_col = (lane >> 4) * 8;

  const int kt_count = (r_end - r_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) load_tile(s, r_begin + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < kt_count) load_tile(next % kStages, r_begin + next * BK);
    cp_async_commit();
    const __nv_bfloat16* a = smem + (kt % kStages) * kTgmmStage;
    const __nv_bfloat16* bs = a + BK * LDS_KN;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi], a + (ks + at_row) * LDS_KN + wm * 64 + mi * 16 + at_col);
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

  __nv_bfloat16* Ce = C + (long)e * Kd * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + tig * 2;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row < Kd)
          store2(Ce + (long)row * N + col, acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
      }
    }
}

// M' prologue: dye = bf16(dy * keep_out * scale) (only when the output mask
// is on), and the column sums of float(dye) over each chunk of `rows` rows
// (a chunk lies inside one row tile, so inside one expert). Thread j owns
// columns 8j..8j+7, so blockDim.x = D / 8.
__global__ void moe_bwd_prologue(const __nv_bfloat16* __restrict__ dy,
                                 __nv_bfloat16* __restrict__ dye, float* __restrict__ part, int M,
                                 int D, int rows, DropSite s) {
  const int c0 = threadIdx.x * 8;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, M);
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

// out[e][c] = sum over the units u of expert e of part[u][c], u in order:
// deterministic per-expert bias gradients. With starts_only, only the units
// where a GEMM segment started hold a partial (moe_gemm_kernel's EPI_DH).
__global__ void moe_colsum_reduce(const float* __restrict__ part, float* __restrict__ out,
                                  const int* __restrict__ tile_group, int tm, int units,
                                  int unit, int starts_only, int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int e = blockIdx.y;
  if (c >= n) return;
  float s = 0.f;
  for (int u = 0; u < units; ++u) {
    const int r = u * unit;
    if (tile_group[r / tm] != e) continue;
    if (starts_only && r % BM != 0 && tile_group[(r - unit) / tm] == e) continue;
    s += part[(long)u * n + c];
  }
  out[(long)e * n + c] = s;
}

cudaError_t colsum(const float* part, float* out, const int* tile_group, int tm, int units,
                   int unit, int starts_only, int n, int e, cudaStream_t s) {
  dim3 grid((n + 255) / 256, e);
  moe_colsum_reduce<<<grid, 256, 0, s>>>(part, out, tile_group, tm, units, unit, starts_only, n);
  return cudaGetLastError();
}

// a site is off (rate 0) when the caller passes threshold 0 and scale 1
DropSite make_site(unsigned k0, unsigned k1, unsigned site, unsigned threshold, float scale) {
  return DropSite{k0, k1, site, threshold, scale, threshold > 0 || scale != 1.f};
}

// rows of a chunk of M''s dye column sums: divides tm, so one expert's
int prologue_rows(int tm) { return tm < 64 ? tm : 64; }

bool bad_shape(int cap, int d, int f, int e, int tm) {
  return cap <= 0 || d <= 0 || f <= 0 || e <= 0 || d % 8 || f % 8 || tm < 8 ||
         (tm & (tm - 1)) || cap % tm || cap > 65535 * BM;
}

}  // namespace

// Kernel M. x [cap, d], w1 [e, d, f], b1 [e, f], w2 [e, f, d], b2 [e, d],
// tile_group [cap / tm] int32; writes h1 [cap, f] (the backward's residual),
// g [cap, f] (scratch) and y [cap, d]. act: 0 erf GELU, 1 tanh. The hidden
// mask is site_h, the output mask site_o (off at threshold 0 and scale 1).
GAVIT_EXPORT int gavit_moe_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* tile_group, void* h1, void* g,
                               void* y, int cap, int d, int f, int e, int tm, int act,
                               unsigned k0, unsigned k1, unsigned site_h, unsigned thr_h,
                               float scale_h, unsigned site_o, unsigned thr_o, float scale_o,
                               void* stream) {
  if (bad_shape(cap, d, f, e, tm)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Groups grp{static_cast<const int*>(tile_group), tm};
  EpiArgs ep{};
  ep.bias = static_cast<const __nv_bfloat16*>(b1);
  ep.out = static_cast<__nv_bfloat16*>(g);
  ep.out2 = static_cast<__nv_bfloat16*>(h1);
  ep.drop = make_site(k0, k1, site_h, thr_h, scale_h);
  cudaError_t err = act == ACT_TANH
                        ? moe_gemm<true, EPI_FC1, ACT_TANH>(x, w1, cap, f, d, grp, ep, s)
                        : moe_gemm<true, EPI_FC1, ACT_ERF>(x, w1, cap, f, d, grp, ep, s);
  if (err != cudaSuccess) return err;
  ep = EpiArgs{};
  ep.bias = static_cast<const __nv_bfloat16*>(b2);
  ep.out = static_cast<__nv_bfloat16*>(y);
  ep.drop = make_site(k0, k1, site_o, thr_o, scale_o);
  return moe_gemm<true, EPI_FC2, ACT_ERF>(g, w2, cap, d, f, grp, ep, s);
}

// Rows of M''s fp32 scratch: which 0 the dh1 partials [rows, f], 1 the dye
// partials [rows, d].
GAVIT_EXPORT int gavit_moe_bwd_partial_rows(int cap, int tm, int which) {
  return which == 0 ? cap / unit_rows(tm) : cap / prologue_rows(tm);
}

// Kernel M'. dy [cap, d], h1 [cap, f], w1 [e, d, f], w2 [e, f, d],
// tile_group [cap / tm]; writes dye [cap, d] (only when the output mask is
// on: otherwise pass dye = dy), dh1 and go [cap, f], dx [cap, d], and the
// fp32 per-expert bias gradients db1 [e, f] and db2 [e, d]; part1 and part2
// are fp32 scratch of gavit_moe_bwd_partial_rows rows.
GAVIT_EXPORT int gavit_moe_bwd(const void* dy, const void* h1, const void* w1, const void* w2,
                               const void* tile_group, void* dye, void* dh1, void* go, void* dx,
                               void* db1, void* db2, void* part1, void* part2, int cap, int d,
                               int f, int e, int tm, int act, unsigned k0, unsigned k1,
                               unsigned site_h, unsigned thr_h, float scale_h, unsigned site_o,
                               unsigned thr_o, float scale_o, void* stream) {
  if (bad_shape(cap, d, f, e, tm) || d / 8 > 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(tile_group);
  const Groups grp{tg, tm};
  const DropSite out_site = make_site(k0, k1, site_o, thr_o, scale_o);
  const int prow = prologue_rows(tm);
  moe_bwd_prologue<<<cap / prow, d / 8, 0, s>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dye),
      static_cast<float*>(part2), cap, d, prow, out_site);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = colsum(static_cast<const float*>(part2), static_cast<float*>(db2), tg, tm, cap / prow,
               prow, 0, d, e, s);
  if (err != cudaSuccess) return err;
  EpiArgs ep{};
  ep.out = static_cast<__nv_bfloat16*>(dh1);
  ep.out2 = static_cast<__nv_bfloat16*>(go);
  ep.h1 = static_cast<const __nv_bfloat16*>(h1);
  ep.colsum = static_cast<float*>(part1);
  ep.drop = make_site(k0, k1, site_h, thr_h, scale_h);
  const void* dy_eff = out_site.on ? dye : dy;
  err = act == ACT_TANH
            ? moe_gemm<false, EPI_DH, ACT_TANH>(dy_eff, w2, cap, f, d, grp, ep, s)
            : moe_gemm<false, EPI_DH, ACT_ERF>(dy_eff, w2, cap, f, d, grp, ep, s);
  if (err != cudaSuccess) return err;
  err = colsum(static_cast<const float*>(part1), static_cast<float*>(db1), tg, tm,
               cap / unit_rows(tm), unit_rows(tm), 1, f, e, s);
  if (err != cudaSuccess) return err;
  ep = EpiArgs{};
  ep.out = static_cast<__nv_bfloat16*>(dx);
  return moe_gemm<false, EPI_STORE, ACT_ERF>(dh1, w1, cap, d, f, grp, ep, s);
}

// Kernel tgmm. a [rows, kd], b [rows, n], group_sizes [e] int32 on the
// device (summing to rows); writes c [e, kd, n] in bf16.
GAVIT_EXPORT int gavit_moe_tgmm(const void* a, const void* b, const void* group_sizes, void* c,
                                int rows, int kd, int n, int e, void* stream) {
  if (rows <= 0 || kd <= 0 || n <= 0 || e <= 0 || kd % 8 || n % 8 || e > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(moe_tgmm_kernel, kTgmmSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (kd + BM - 1) / BM, e);
  moe_tgmm_kernel<<<grid, kThreads, kTgmmSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(c), kd, n);
  return cudaGetLastError();
}
