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
// What bounds it on the H100: at N=197, d=64 the whole K and V of one head
// (50 KB in bf16, 100 KB in fp32) fit in shared memory, so device memory sees
// one read of the qkv rows and one write of o: 4*N*N*d FLOPs against
// ~4*N*d*2 bytes per head is ~100 FLOP/byte, below the ridge, so the bf16
// path is bound by memory and staging, not by the tensor cores.
//
// Two bodies, chosen by dtype (never by a failure):
// * bf16 with N <= 224 (every ViT at 224 px): attn_fwd_mma_kernel, on the
//   tensor cores (mma.sync m16n8k16, fp32 accumulate), grid (query-row
//   block, head, image), described below. Longer bf16 rows take kernel K
//   (attention_long.cu), which streams key tiles.
// * fp32 (the parity path) with K and V of a head in shared memory (N <=
//   416): attn_fwd_kernel on the CUDA cores, fp32 FMAs only (no TF32). Grid
//   (query-row block of 16, head, image), so B=1 still launches 12 heads x
//   13 blocks. Each block stages K and V of its head into dynamic shared
//   memory with a padded row stride of 65 words, so the 32 lanes of a warp
//   that score 32 different keys hit 32 different banks. Each warp owns two
//   query rows: the lanes score the keys lane, lane+32, ... against q held
//   in registers, reduce max and sum with shuffles, and compute the output
//   columns lane and lane+32 from the probabilities in shared memory. It is
//   bound by shared-memory bandwidth (one operand load per FMA).
#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kBlockRows = kWarps * kRowsPerWarp;

constexpr int kKvStride = kHeadDim + 1;  // 65 words: bank = (j + c) % 32

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores, N <= kMmaMaxKeys. Grid (query-row block, head,
// image). Every block stages all K and V rows of its head, so the launcher
// splits the query rows only while the (image, head) blocks alone would
// leave SMs idle: until about two blocks per SM exist, in blocks of a
// multiple of 64 rows. At N=197 on 132 SMs, B=1 launches 4 x 12 blocks of 64
// rows, B=8 2 x 96 blocks of 128, and B=64 768 blocks of all rows, where a
// split would only stage K and V more often (measured on an H100 80GB HBM3
// at 700 W: A at B=64 took 0.28 ms split in 64-row blocks against 0.18-0.19
// ms whole). The query blocks of one (image, head) are adjacent in launch
// order, so their K and V come mostly from L2. A block stages its Q rows and
// the head's K and V (rows padded with zeros to a multiple of 16) in shared
// memory with 16-byte loads and a 72-element row stride (36 words: the 8
// rows a fragment load touches land on 8 different 4-bank groups); its 4
// warps take the 16-row query tiles in turn (two or three blocks fit an SM).
// For a tile, S = Q.K^T over all keys stays in registers (mma.sync
// m16n8k16, fp32 accumulate); the softmax runs on those registers with quad
// shuffles; p is rounded to bf16 and re-packed straight into A fragments for
// P.V, whose B fragments come from V with ldmatrix.trans.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaBlockRows = kMmaWarps * 16;  // query rows, one tile a warp
constexpr int kMmaMaxKeys = 224;
constexpr int kMmaTiles = kMmaMaxKeys / 8;  // n8 key tiles held in registers
constexpr int kMmaStride = kHeadDim + 8;

__host__ __device__ inline int keys16(int n) { return (n + 15) & ~15; }

// Q rows a block stages: its q_rows, or fewer when N is shorter
__host__ __device__ inline int q_stage_rows(int n, int q_rows) {
  return q_rows < keys16(n) ? q_rows : keys16(n);
}

int attn_mma_smem_bytes(int n, int q_rows) {
  return (q_stage_rows(n, q_rows) + 2 * keys16(n)) * kMmaStride *
         (int)sizeof(__nv_bfloat16);
}

__global__ void __launch_bounds__(kMmaWarps * 32)
    attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                        __nv_bfloat16* __restrict__ out, int n, int heads, int q_rows,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = keys16(n), qs = q_stage_rows(n, q_rows);
  // sq: [qs][72], then sk and sv: [nk][72] each, contiguous
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + qs * kMmaStride;
  __nv_bfloat16* sv = sk + nk * kMmaStride;

  const int q_begin = blockIdx.x * q_rows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long row_stride = 3L * heads * kHeadDim;
  const __nv_bfloat16* base = qkv + (long)b * n * row_stride;

  // stage Q rows q_begin..q_begin+qs-1, then K and V rows 0..nk-1 of head h,
  // in 16-byte chunks (8 per row); rows past n are zeros
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < (qs + 2 * nk) * 8; c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    int which = 0, row = q_begin + r;  // 0: q, 1: k, 2: v
    if (r >= qs) {
      const int kv = r - qs;
      which = 1 + kv / nk;
      row = kv - (which - 1) * nk;
    }
    __nv_bfloat16* dst = sq + r * kMmaStride + col;
    *reinterpret_cast<uint4*>(dst) =
        row < n ? *reinterpret_cast<const uint4*>(base + row * row_stride +
                                                  (which * heads + h) * kHeadDim + col)
                : zero;
  }
  __syncthreads();

  const long orow = (long)heads * kHeadDim;  // o is [B, N, H, d] in memory
  __nv_bfloat16* ob = out + (long)b * n * orow + h * kHeadDim;
  const int lrow = lane & 15;  // ldmatrix row supplied by this lane (x2)
  const int q_end = min(q_rows, n - q_begin);  // local rows of this block
  for (int q0 = warp * 16; q0 < q_end; q0 += kMmaBlockRows) {
    // S = Q.K^T for rows q0.. and every key tile
    float s[kMmaTiles][4];
#pragma unroll
    for (int j = 0; j < kMmaTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* qw = sq + (q0 + g) * kMmaStride + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kHeadDim; kk += 16) {
      uint32_t a[4] = {ld32(qw + kk), ld32(qw + 8 * kMmaStride + kk), ld32(qw + kk + 8),
                       ld32(qw + 8 * kMmaStride + kk + 8)};
#pragma unroll
      for (int j = 0; j < kMmaTiles; ++j) {
        if (j * 8 < nk) {
          const __nv_bfloat16* kp = sk + (j * 8 + g) * kMmaStride + kk + 2 * t;
          uint32_t bb[2] = {ld32(kp), ld32(kp + 8)};
          mma_16816(s[j], a, bb);
        }
      }
    }

    // softmax over keys < n for rows g and g+8 (a quad shares a row)
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMmaTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        s[j][e] = key < n ? s[j][e] * scale : -INFINITY;
      }
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < kMmaTiles; ++j) {
      s[j][0] = expf(s[j][0] - m0), s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1), s[j][3] = expf(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;

    // O = P.V: P's C fragments of key tiles 2kk, 2kk+1 are the A fragment of
    // key step kk; V's B fragments come transposed out of row-major sV
    float o[kHeadDim / 8][4];
#pragma unroll
    for (int d = 0; d < kHeadDim / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMmaTiles / 2; ++kk) {
      if (kk * 16 < nk) {
        const float* p0 = s[2 * kk];
        const float* p1 = s[2 * kk + 1];
        uint32_t a[4] = {pack_bf16(p0[0] * inv0, p0[1] * inv0),
                         pack_bf16(p0[2] * inv1, p0[3] * inv1),
                         pack_bf16(p1[0] * inv0, p1[1] * inv0),
                         pack_bf16(p1[2] * inv1, p1[3] * inv1)};
#pragma unroll
        for (int d = 0; d < kHeadDim / 8; ++d) {
          uint32_t bb[2];
          ldmatrix_x2_trans(bb, sv + (kk * 16 + lrow) * kMmaStride + d * 8);
          mma_16816(o[d], a, bb);
        }
      }
    }

    const int r0 = q_begin + q0 + g;
#pragma unroll
    for (int d = 0; d < kHeadDim / 8; ++d) {
      const int col = d * 8 + 2 * t;
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(ob + r0 * orow + col) = pack_bf16(o[d][0], o[d][1]);
      if (r0 + 8 < n)
        *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * orow + col) = pack_bf16(o[d][2], o[d][3]);
    }
  }
}

int launch_attn_mma(const void* qkv, void* out, int batch, int n, int heads, float scale,
                    cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // split the query rows into up to ceil(N/64) blocks, until the grid holds
  // about two blocks per SM (see above)
  const long pairs = (long)batch * heads;
  const long fill = (2L * sms + pairs - 1) / pairs;  // >= 1
  const int most = (n + kMmaBlockRows - 1) / kMmaBlockRows;
  const int split = fill < most ? (int)fill : most;
  const int q_rows = ((n + split - 1) / split + kMmaBlockRows - 1) / kMmaBlockRows * kMmaBlockRows;
  const int smem = attn_mma_smem_bytes(n, q_rows);
  err = set_smem(attn_fwd_mma_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + q_rows - 1) / q_rows, heads, batch);
  attn_fwd_mma_kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), n, heads,
      q_rows, scale);
  return cudaGetLastError();
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

// 1 if kernel A takes this N: bf16 up to the tensor-core body's 224 keys
// (past them the wrapper routes to kernel K), fp32 while K and V of one head
// fit a block's shared memory (N <= 416). The Python wrapper raises on 0.
GAVIT_EXPORT int gavit_attention_fits(int n, int dtype) {
  if (dtype == GAVIT_BF16) return n <= kMmaMaxKeys ? 1 : 0;
  return dtype == GAVIT_F32 && attn_smem_bytes(n) <= kMaxSmemBytes ? 1 : 0;
}

GAVIT_EXPORT int gavit_attention_fwd(const void* qkv, void* out, int batch,
                                     int n, int heads, int head_dim,
                                     float scale, int dtype, void* stream) {
  if (head_dim != kHeadDim || batch <= 0 || batch > 65535 || n <= 0 ||
      heads <= 0 || heads > 65535 || !gavit_attention_fits(n, dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GAVIT_BF16) return launch_attn_mma(qkv, out, batch, n, heads, scale, s);
  return launch_attn_f32(qkv, out, batch, n, heads, scale, s);
}
