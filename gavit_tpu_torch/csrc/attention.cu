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
//
// Kernel A' in fp32: the backward of that fp32 body.
//
// Replaces: gavit_tpu/ops/attention.py::_bwd_kernel_v4 at fp32 (launched by
// _run_bwd_v4_impl, at HIGHEST precision there); the bf16 A' is
// attention_bwd_sm90.cu's.
//
// Computes, per image b and head h, from the packed qkv rows and dout
// [B, H, N, d] (read through its strides): p = softmax(q.k^T * scale),
// dp = dout.v^T, delta = rowsum(dp o p), ds = p o (dp - delta) * scale,
// dq = ds.k, dk = ds^T.q, dv = p^T.dout, written into dqkv's rows at the
// columns q, k and v came from. The plain version is
// ops/attention.py::attention_backward_reference.
//
// Bound: at N = 197 the work (10*N^2*d FMA-flops a head: s and dp, dq, dk,
// dv) at 67 TFLOP/s of fp32 outside the tensor cores, not its bytes:
// wgmma takes no fp32 operands and TF32 must stay off, so every product is
// an fp32 FMA on the CUDA cores. The design is the forward's, twice, with
// no float atomics, so a rerun gives the same bits:
// * attn_bwd_dq_kernel, query-major (grid: 16-row query blocks, heads,
//   images): K and V of the head staged in shared memory at the padded
//   stride of 65 words; each warp takes two query rows. Its lanes score
//   the keys lane, lane+32, ... with q in registers (s into the warp's
//   row buffer), then with dout's row in the same registers (dp in
//   registers: at most 13 keys a lane at N = 416), reduce max, sum and
//   delta with shuffles, turn the row buffer into ds, and compute dq's
//   columns lane and lane+32 over every key in order. It writes the row's
//   max, 1/sum and delta to an fp32 [3, B, H, N] scratch.
// * attn_bwd_dkv_kernel, key-major (grid: 16-key blocks, heads, images):
//   Q and dout of the head staged in shared memory; each warp takes two
//   keys, and each lane recomputes p (with k in registers) and then ds
//   (with v in the same registers) of the queries lane, lane+32, ... from
//   the scratch's statistics (the same fmaf order as the query-major pass,
//   so the same s), then broadcasts them with shuffles while every lane
//   accumulates dk's and dv's columns lane and lane+32 in query order.
// One 64-float row in registers at a time keeps each kernel within 128
// registers, so two blocks share an SM where shared memory allows (N up
// to 208): holding both rows took 170-173 registers and one block an SM,
// 8 warps, too few to hide the shared-memory loads' latency.
// The ragged last query and key blocks exit warp-uniformly; lanes past N
// contribute zeros and no row past N is read. Shared memory at N = 416:
// 229,632 and 216,320 bytes of the 232,448 a block may take.
#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kBlockRows = kWarps * kRowsPerWarp;

constexpr int kKvStride = kHeadDim + 1;  // 65 words: bank = (j + c) % 32
constexpr int kBf16MaxKeys = 224;
// the fp32 body's longest rows (K and V of a head in shared memory) and the
// keys a lane of A''s query-major pass scores there
constexpr int kF32MaxKeys = 416;
constexpr int kMaxKeyChunks = (kF32MaxKeys + 31) / 32;

__host__ __device__ inline int pad32(int n) { return (n + 31) & ~31; }

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

// a row of 64 fp32 values (16-byte aligned) into registers, the same in
// every lane
__device__ __forceinline__ void load_row(float (&r)[kHeadDim], const float* __restrict__ src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int c = 0; c < kHeadDim / 4; ++c) {
    const float4 t = __ldg(s4 + c);
    r[4 * c] = t.x;
    r[4 * c + 1] = t.y;
    r[4 * c + 2] = t.z;
    r[4 * c + 3] = t.w;
  }
}

int bwd_dq_smem_bytes(int n) {
  return (2 * n * kKvStride + kWarps * pad32(n)) * (int)sizeof(float);
}

int bwd_dkv_smem_bytes(int n) { return 2 * n * kKvStride * (int)sizeof(float); }

// A''s query-major launch: dq, and the row statistics into stats. q and
// dout's row are held one after the other (two passes over the keys), so
// the kernel fits 128 registers and two blocks share an SM.
__global__ void __launch_bounds__(kWarps * 32, 2)
    attn_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                       float* __restrict__ dqkv, float* __restrict__ stats, int n, int heads,
                       long long do_sb, long long do_sh, long long do_sn, float scale) {
  constexpr int S = kKvStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);
  float* sv = sk + n * S;
  const int n_pad = pad32(n);
  float* sp = sv + n * S;  // [warps][n_pad]: scores, probabilities, then ds

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row_stride = 3L * heads * kHeadDim;
  const float* base = qkv + (long)b * n * row_stride;
  float* dbase = dqkv + (long)b * n * row_stride;
  const int qoff = h * kHeadDim;
  const int koff = (heads + h) * kHeadDim;
  const int voff = (2 * heads + h) * kHeadDim;
  const long plane = (long)gridDim.z * heads * n;  // one statistic's [B, H, N]
  float* st = stats + ((long)b * heads + h) * n;

  for (int e = threadIdx.x; e < n * kHeadDim; e += blockDim.x) {
    const int j = e / kHeadDim, c = e % kHeadDim;
    const float* row = base + (long)j * row_stride;
    sk[j * S + c] = row[koff + c];
    sv[j * S + c] = row[voff + c];
  }
  __syncthreads();

  float* wp = sp + warp * n_pad;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = blockIdx.x * kBlockRows + warp * kRowsPerWarp + r;
    if (i >= n) break;  // warp-uniform; no block barrier follows
    float row[kHeadDim];  // q, then dout's row
    load_row(row, base + (long)i * row_stride + qoff);
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      if (j < n) {
        const float* kr = sk + j * S;
        float sc = 0.f;
#pragma unroll
        for (int c = 0; c < kHeadDim; ++c) sc = fmaf(row[c], kr[c], sc);
        sc *= scale;
        wp[j] = sc;
        m = fmaxf(m, sc);
      }
    }
    load_row(row, dout + b * do_sb + h * do_sh + i * do_sn);
    float dp[kMaxKeyChunks];
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      dp[t] = 0.f;
      if (j < n) {
        const float* vr = sv + j * S;
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < kHeadDim; ++c) d = fmaf(row[c], vr[c], d);
        dp[t] = d;
      }
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      if (j < n) {
        const float p = expf(wp[j] - m);
        wp[j] = p;
        l += p;
      }
    }
    const float inv = 1.f / warp_sum(l);
    float dsum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      if (j < n) {
        const float p = wp[j] * inv;
        wp[j] = p;
        dsum = fmaf(p, dp[t], dsum);
      }
    }
    const float delta = warp_sum(dsum);
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int j = lane + 32 * t;
      if (j < n) wp[j] = wp[j] * (dp[t] - delta) * scale;
    }
    __syncwarp();

    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < n; ++j) {
      const float ds = wp[j];
      a0 = fmaf(ds, sk[j * S + lane], a0);
      a1 = fmaf(ds, sk[j * S + lane + 32], a1);
    }
    float* drow = dbase + (long)i * row_stride + qoff;
    drow[lane] = a0;
    drow[lane + 32] = a1;
    if (lane == 0) {
      st[i] = m;
      st[plane + i] = inv;
      st[2 * plane + i] = delta;
    }
    __syncwarp();  // wp is rewritten by the next row
  }
}

// A''s key-major launch: dk and dv from the query-major launch's statistics.
// k and v are held one after the other (p of every query, then ds), so the
// kernel fits 128 registers and two blocks share an SM.
__global__ void __launch_bounds__(kWarps * 32, 2)
    attn_bwd_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                        float* __restrict__ dqkv, const float* __restrict__ stats, int n,
                        int heads, long long do_sb, long long do_sh, long long do_sn,
                        float scale) {
  constexpr int S = kKvStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sg = sq + n * S;

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row_stride = 3L * heads * kHeadDim;
  const float* base = qkv + (long)b * n * row_stride;
  float* dbase = dqkv + (long)b * n * row_stride;
  const float* gbase = dout + b * do_sb + h * do_sh;
  const int qoff = h * kHeadDim;
  const int koff = (heads + h) * kHeadDim;
  const int voff = (2 * heads + h) * kHeadDim;
  const long plane = (long)gridDim.z * heads * n;
  const float* st = stats + ((long)b * heads + h) * n;

  for (int e = threadIdx.x; e < n * kHeadDim; e += blockDim.x) {
    const int i = e / kHeadDim, c = e % kHeadDim;
    sq[i * S + c] = base[(long)i * row_stride + qoff + c];
    sg[i * S + c] = gbase[i * do_sn + c];
  }
  __syncthreads();

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int j = blockIdx.x * kBlockRows + warp * kRowsPerWarp + r;
    if (j >= n) break;  // warp-uniform; no block barrier follows
    // p and ds of query lane + 32 t (0 past n)
    float p[kMaxKeyChunks], ds[kMaxKeyChunks];
    float row[kHeadDim];  // k, then v
    load_row(row, base + (long)j * row_stride + koff);
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int i = lane + 32 * t;
      p[t] = 0.f;
      if (i < n) {
        const float* qr = sq + i * S;
        float sc = 0.f;
#pragma unroll
        for (int c = 0; c < kHeadDim; ++c) sc = fmaf(qr[c], row[c], sc);
        sc *= scale;
        p[t] = expf(sc - st[i]) * st[plane + i];
      }
    }
    load_row(row, base + (long)j * row_stride + voff);
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int i = lane + 32 * t;
      ds[t] = 0.f;
      if (i < n) {
        const float* gr = sg + i * S;
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < kHeadDim; ++c) d = fmaf(gr[c], row[c], d);
        ds[t] = p[t] * (d - st[2 * plane + i]) * scale;
      }
    }
    float dk0 = 0.f, dk1 = 0.f, dv0 = 0.f, dv1 = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxKeyChunks; ++t) {
      const int i0 = 32 * t;
      if (i0 >= n) break;  // warp-uniform
      const int rows = min(32, n - i0);
      for (int u = 0; u < rows; ++u) {
        const float pu = __shfl_sync(0xffffffffu, p[t], u);
        const float dsu = __shfl_sync(0xffffffffu, ds[t], u);
        const float* qr = sq + (i0 + u) * S;
        const float* gr = sg + (i0 + u) * S;
        dv0 = fmaf(pu, gr[lane], dv0);
        dv1 = fmaf(pu, gr[lane + 32], dv1);
        dk0 = fmaf(dsu, qr[lane], dk0);
        dk1 = fmaf(dsu, qr[lane + 32], dk1);
      }
    }
    float* drow = dbase + (long)j * row_stride;
    drow[koff + lane] = dk0;
    drow[koff + lane + 32] = dk1;
    drow[voff + lane] = dv0;
    drow[voff + lane + 32] = dv1;
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

// Kernel A' in fp32: qkv [batch, n, 3*heads*64] and dqkv alike, dout
// [batch, heads, n, 64] through its element strides (rows 16-byte aligned),
// stats: 3*batch*heads*n floats of scratch; n within the fp32 forward's
// bound (gavit_attention_fits).
GAVIT_EXPORT int gavit_attention_bwd_f32(const void* qkv, const void* dout, void* dqkv,
                                         void* stats, int batch, int n, int heads, int head_dim,
                                         long long do_sb, long long do_sh, long long do_sn,
                                         float scale, void* stream) {
  if (head_dim != kHeadDim || batch <= 0 || batch > 65535 || n <= 0 || n > kF32MaxKeys ||
      heads <= 0 || heads > 65535 || !gavit_attention_fits(n, GAVIT_F32))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(dout);
  float* dq = static_cast<float*>(dqkv);
  float* st = static_cast<float*>(stats);
  const dim3 grid((n + kBlockRows - 1) / kBlockRows, heads, batch);
  int smem = bwd_dq_smem_bytes(n);
  cudaError_t err = set_smem(attn_bwd_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<<<grid, kWarps * 32, smem, s>>>(q, g, dq, st, n, heads, do_sb, do_sh,
                                                     do_sn, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = bwd_dkv_smem_bytes(n);
  err = set_smem(attn_bwd_dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_kernel<<<grid, kWarps * 32, smem, s>>>(q, g, dq, st, n, heads, do_sb, do_sh,
                                                      do_sn, scale);
  return cudaGetLastError();
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
