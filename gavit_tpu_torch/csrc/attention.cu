// Kernel A: exact multi-head self-attention forward on the packed qkv rows.
//
// Replaces: gavit_tpu/ops/attention.py::_fwd_kernel_v4 (launched by
// _run_fwd_v4_impl, reached through fused_qkv_attention -> _fused_qkv_flat).
//
// Computes, per image b and head h, o = softmax(q.k^T * scale).v with the
// softmax in fp32, reading q, k and v straight out of the qkv GEMM's raw
// [B, N, 3*H*d] rows through strides (q at column h*d, k at (H+h)*d, v at
// (2H+h)*d). o is [B, H, N, d] at the interface but [B, N, H, d] in memory,
// so the output projection reads it as merged [B, N, H*d] rows with no copy
// (the Python wrapper returns the transposed view). p is rounded to the input
// dtype before p.v, as the TPU kernel does. Ragged N (197 at 224 px) needs no
// host pad: rows and keys past N are masked in the kernel.
//
// Two bodies, chosen by dtype (never by a failure):
// * bf16 with N <= 224 (every ViT at 224 px): the Hopper kernel of
//   attention_fwd_sm90.cu (wgmma on TMA-fed tiles, the whole key row's
//   scores in registers), which also serves K, I and J; its note gives the
//   bound and the design. Longer bf16 rows take kernel K, the same file's
//   streamed instance.
// * fp32 (the parity path) with K and V of a head in shared memory (N <=
//   416): attn_fwd_kernel below, on the CUDA cores, fp32 FMAs only (no TF32).
//   Grid (query-row block of 16, head, image), so B=1 still launches 12
//   heads x 13 blocks. Each block stages K and V of its head into dynamic
//   shared memory with a padded row stride of 65 words, so the 32 lanes of
//   a warp that score 32 different keys hit 32 different banks. Each warp
//   owns two query rows: the lanes score the keys lane, lane+32, ... against
//   q held in registers, reduce max and sum with shuffles, and compute the
//   output columns lane and lane+32 from the probabilities in shared memory.
//   At N = 197 it is bound by shared-memory bandwidth (one operand load per
//   FMA), not by the 4*N*d*4 bytes a head moves.
#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kBlockRows = kWarps * kRowsPerWarp;

constexpr int kKvStride = kHeadDim + 1;  // 65 words: bank = (j + c) % 32
constexpr int kBf16MaxKeys = 224;

inline int pad32(int n) { return (n + 31) & ~31; }

int attn_smem_bytes(int n) {
  return 2 * n * kKvStride * (int)sizeof(float) +
         (kWarps * pad32(n) + kWarps * kHeadDim) * (int)sizeof(float);
}

__global__ void __launch_bounds__(kWarps * 32)
    attn_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n,
                    int heads, float scale) {
  constexpr int S = kKvStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);
  float* sv = sk + n * S;
  const int n_pad = (n + 31) & ~31;
  float* sp = reinterpret_cast<float*>(sv + n * S);  // [warps][n_pad] probs
  float* sq = sp + kWarps * n_pad;                   // [warps][d] query row

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row_stride = 3L * heads * kHeadDim;
  const float* base = qkv + (long)b * n * row_stride;
  const int qoff = h * kHeadDim;
  const int koff = (heads + h) * kHeadDim;
  const int voff = (2 * heads + h) * kHeadDim;

  for (int e = threadIdx.x; e < n * kHeadDim; e += blockDim.x) {
    const int j = e / kHeadDim, c = e % kHeadDim;
    const float* row = base + (long)j * row_stride;
    sk[j * S + c] = row[koff + c];
    sv[j * S + c] = row[voff + c];
  }
  __syncthreads();

  float* wp = sp + warp * n_pad;
  float* wq = sq + warp * kHeadDim;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = blockIdx.x * kBlockRows + warp * kRowsPerWarp + r;
    if (i >= n) break;  // warp-uniform; no block barrier follows
    const float* qrow = base + (long)i * row_stride + qoff;
    wq[lane] = qrow[lane];
    wq[lane + 32] = qrow[lane + 32];
    __syncwarp();
    float q[kHeadDim];
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) q[c] = wq[c];

    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = sk + j * S;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) s = fmaf(q[c], kr[c], s);
      s *= scale;
      wp[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(wp[j] - m);
      wp[j] = p;
      l += p;
    }
    const float inv = 1.f / warp_sum(l);
    for (int j = lane; j < n; j += 32) wp[j] *= inv;
    __syncwarp();

    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < n; ++j) {
      const float p = wp[j];
      o0 = fmaf(p, sv[j * S + lane], o0);
      o1 = fmaf(p, sv[j * S + lane + 32], o1);
    }
    float* orow = out + (((long)b * n + i) * heads + h) * kHeadDim;
    orow[lane] = o0;
    orow[lane + 32] = o1;
    __syncwarp();  // wq and wp are rewritten by the next row
  }
}

int launch_attn_f32(const void* qkv, void* out, int batch, int n, int heads, float scale,
                    cudaStream_t stream) {
  const int smem = attn_smem_bytes(n);
  cudaError_t err = set_smem(attn_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBlockRows - 1) / kBlockRows, heads, batch);
  attn_fwd_kernel<<<grid, kWarps * 32, smem, stream>>>(static_cast<const float*>(qkv),
                                                      static_cast<float*>(out), n, heads, scale);
  return cudaGetLastError();
}

}  // namespace

GAVIT_EXPORT const char* gavit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// This library links its own CUDA runtime, whose current device is separate
// from PyTorch's: the wrappers select the tensors' device before a launch.
GAVIT_EXPORT int gavit_set_device(int device) { return cudaSetDevice(device); }

// 1 if kernel A takes this N: bf16 up to 224 keys (the Python route's
// A_MAX_N; past them it takes kernel K), fp32 while K and V of one head fit
// a block's shared memory (N <= 416). The Python wrapper raises on 0.
GAVIT_EXPORT int gavit_attention_fits(int n, int dtype) {
  if (dtype == GAVIT_BF16) return n <= kBf16MaxKeys ? 1 : 0;
  return dtype == GAVIT_F32 && attn_smem_bytes(n) <= kMaxSmemBytes ? 1 : 0;
}

GAVIT_EXPORT int gavit_attention_fwd(const void* qkv, void* out, int batch,
                                     int n, int heads, int head_dim,
                                     float scale, int dtype, void* stream) {
  if (head_dim != kHeadDim || batch <= 0 || batch > 65535 || n <= 0 ||
      heads <= 0 || heads > 65535 || !gavit_attention_fits(n, dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GAVIT_BF16) return attention_fwd_packed(qkv, out, batch, n, heads, scale, s);
  return launch_attn_f32(qkv, out, batch, n, heads, scale, s);
}
