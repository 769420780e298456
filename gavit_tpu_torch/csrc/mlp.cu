// Kernel B: the inference MLP, y = GELU(round(x.W1 + b1)).W2 + b2, in bf16.
//
// Replaces: gavit_tpu/ops/mlp.py::_mlp_infer_kernel (launched by
// _mlp_infer_impl, reached through fused_mlp_inference).
//
// The TPU kernel keeps both weight matrices resident in VMEM and streams row
// blocks through fc1 -> GELU -> fc2. That does not carry over: W1 alone is
// 4.7 MB in bf16 at ViT-B and a block has 227 KB of shared memory. So this
// first version is two launches of one hand-written tensor-core GEMM: fc1
// with a fused bias + GELU epilogue that writes the bf16 hidden h, then fc2
// with a fused bias epilogue. Keeping h on chip is a later measurement.
//
// What bounds it on the H100: at M = B*197 rows, D=768, F=3072 the two
// products are 4*M*D*F FLOPs against (2*M*D + M*F + 2*D*F)*2 bytes, far
// above the card's ~295 FLOP/byte ridge at every serving bucket past b1, so
// it is bound by the tensor cores. This version feeds them with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), fragments loaded with
// ldmatrix from a 3-stage cp.async ring of shared-memory tiles; wgmma, TMA
// and warp specialisation come later.
//
// Numerics follow the TPU kernel: h1 = bf16(x.W1 + b1) with fp32
// accumulation, the GELU (tanh form when `approximate`, erf otherwise) runs
// in fp32 on h1 and is rounded to bf16 before fc2, y = bf16(h.W2 + b2).
//
// Layout: x [M, K] row-major, W [N, K] row-major (nn.Linear's [out, in]),
// so both operand tiles are K-contiguous, which is what mma's row.col form
// reads. Tiles are 128x128x64 for 8 warps (each warp 64x32), 3 stages; the
// shared row stride of 72 bf16 (144 bytes) makes the ldmatrix phases
// bank-conflict free.
// Ragged M and N are masked; K and N must be multiples of 8 (16-byte rows).
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, kStages = 3;
constexpr int LDS = BK + 8;  // 72 bf16 = 36 words: 8 rows of a ldmatrix phase hit 8 bank groups
constexpr int kStageElems = (BM + BN) * LDS;
constexpr int kSmemBytes = kStages * kStageElems * (int)sizeof(__nv_bfloat16);
constexpr int kThreads = 256;  // 8 warps in 2x4, each owning a 64x32 tile

enum Act { ACT_NONE = 0, ACT_GELU_TANH = 1, ACT_GELU_ERF = 2 };

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ float epilogue(float acc, float bias, int act) {
  const float h = round_to<__nv_bfloat16>(acc + bias);
  if (act == ACT_GELU_TANH)
    return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  if (act == ACT_GELU_ERF) return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
  return h;
}

__global__ void __launch_bounds__(kThreads)
    gemm_bias_act_kernel(const __nv_bfloat16* __restrict__ A,
                         const __nv_bfloat16* __restrict__ W,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ C, int M, int N, int K, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int k0) {
    // 128 rows x 8 chunks of 8 bf16 for each operand: 4 chunks a thread
    __nv_bfloat16* sa = smem + stage * kStageElems;
    __nv_bfloat16* sb = sa + BM * LDS;
    for (int c = tid; c < BM * (BK / 8); c += kThreads) {
      const int r = c >> 3, kc = (c & 7) * 8;
      const int gk = k0 + kc;
      const int ga = m0 + r, gb = n0 + r;
      const bool oka = ga < M && gk < K, okb = gb < N && gk < K;
      cp_async_16(sa + r * LDS + kc, oka ? A + (long)ga * K + gk : A, oka ? 16 : 0);
      cp_async_16(sb + r * LDS + kc, okb ? W + (long)gb * K + gk : W, okb ? 16 : 0);
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
  // 8-15); B pairs of n8 tiles as (n 0-7: k 0-7 | 8-15) then (n 8-15: ...)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;

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

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + tig * 2;
      if (col >= N) continue;
      const float b0 = __bfloat162float(bias[col]);
      const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row >= M) continue;
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(epilogue(acc[mi][ni][half * 2], b0, act));
        v.y = __float2bfloat16_rn(epilogue(acc[mi][ni][half * 2 + 1], b1, act));
        *reinterpret_cast<__nv_bfloat162*>(C + (long)row * N + col) = v;
      }
    }
  }
}

cudaError_t gemm(const void* a, const void* w, const void* bias, void* c, int m, int n,
                 int k, int act, cudaStream_t stream) {
  cudaError_t err = set_smem(gemm_bias_act_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_bias_act_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(c), m, n, k, act);
  return cudaGetLastError();
}

}  // namespace

// x [m, d], w1 [f, d], b1 [f], w2 [d, f], b2 [d]; h [m, f] is the caller's
// scratch for the bf16 hidden activations; y [m, d].
GAVIT_EXPORT int gavit_mlp_infer(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* h, void* y, int m,
                                 int d, int f, int approximate, void* stream) {
  if (m <= 0 || d <= 0 || f <= 0 || d % 8 || f % 8 || m > 65535 * BM)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = gemm(x, w1, b1, h, m, f, d, approximate ? ACT_GELU_TANH : ACT_GELU_ERF, s);
  if (err != cudaSuccess) return err;
  return gemm(h, w2, b2, y, m, d, f, ACT_NONE, s);
}
