// Kernel A': exact multi-head self-attention backward on the packed qkv rows.
//
// Replaces: gavit_tpu/ops/attention.py::_bwd_kernel_v4 (launched by
// _run_bwd_v4_impl, the VJP of _fused_qkv_flat).
//
// Computes, per image b and head h, with the softmax recomputed from q and k
// as the forward did (fp32 row max and sum, p = exp(s - m) / l):
//   dv = bf16(p)^T . do,  dp = do . v^T,  delta = rowsum(dp * p),
//   ds = bf16(p * (dp - delta) * scale),  dq = ds . k,  dk = ds^T . q,
// with fp32 accumulation, each written in the input dtype straight into the
// packed [B, N, 3*H*d] layout (dq at column h*d, dk at (H+h)*d, dv at
// (2H+h)*d). delta is rowsum(dp * p), the TPU kernel's formula
// (attention.py:633), not rowsum(do * o).
//
// What bounds it on the H100: per head, ~5 * 2*N*N*d FLOPs against reading
// q, k, v and do and writing dq, dk, dv (7*N*d*2 bytes): ~140 FLOP/byte at
// N=197, under the card's ~295 ridge, so memory and staging bound it, not
// the tensor cores.
//
// Design: one block per (head, image) — 1536 blocks at b128 — of 8 warps.
// The block stages the head's Q, K, V (read through strides from the qkv
// rows) and dO (read through the strides it arrives with) in shared memory,
// rows zero-padded to a multiple of 16 with a 72-element row stride
// (4 x 208 x 72 x 2 B = 117 KB at N=197). Two sweeps, neither of which needs
// a reduction across warps (no atomics: the result is deterministic):
// 1. query-major: a warp takes a 16-row query tile; S = Q.K^T over all keys
//    stays in registers (mma.sync m16n8k16), the fp32 softmax runs on the
//    fragments; dp is recomputed per 8-key tile for delta, then again for
//    ds, and dq = ds.K accumulates in registers (ds re-packed as the A
//    operand, K read with ldmatrix.trans). The row max, 1/l and delta go to
//    shared memory.
// 2. key-major: a warp takes a 16-key tile and walks all query tiles,
//    recomputing the 16x16 tiles of s, p (from the saved statistics: the
//    same operations as sweep 1, so the same bits) and dp; dv += p^T.dO and
//    dk += ds^T.Q accumulate in registers, with p and ds transposed in
//    registers by movmatrix and dO and Q read with ldmatrix.trans.
// Padded query rows contribute nothing: their dO rows are zero, so dp,
// delta and ds vanish there. Keys past N get p = 0.
// bf16 with N <= 224 only; the wrapper refuses anything else.
#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kWarps = 8;
constexpr int kMaxKeys = 224;
constexpr int kTiles = kMaxKeys / 8;  // n8 key tiles held in registers
constexpr int kStride = kD + 8;

__host__ __device__ inline int keys16(int n) { return (n + 15) & ~15; }

int bwd_smem_bytes(int n) {
  return 4 * keys16(n) * kStride * (int)sizeof(__nv_bfloat16) + 3 * keys16(n) * (int)sizeof(float);
}

__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* rows, int kk) {
  // rows = &tile[g][2t]: the A fragment of a 16-row tile at k offset kk
  a[0] = ld32(rows + kk);
  a[1] = ld32(rows + 8 * kStride + kk);
  a[2] = ld32(rows + kk + 8);
  a[3] = ld32(rows + 8 * kStride + kk + 8);
}

__global__ void __launch_bounds__(kWarps * 32)
    attn_bwd_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
                    __nv_bfloat16* __restrict__ dqkv, int n, int heads, long long do_sb,
                    long long do_sh, long long do_sn, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = keys16(n), nt = nk / 16;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + nk * kStride;
  __nv_bfloat16* sv = sk + nk * kStride;
  __nv_bfloat16* sdo = sv + nk * kStride;
  float* s_m = reinterpret_cast<float*>(sdo + nk * kStride);
  float* s_inv = s_m + nk;
  float* s_delta = s_inv + nk;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long row_stride = 3L * heads * kD;
  const __nv_bfloat16* base = qkv + (long)b * n * row_stride;
  const __nv_bfloat16* dbase = dout + b * do_sb + h * do_sh;
  __nv_bfloat16* obase = dqkv + (long)b * n * row_stride;

  // stage Q, K, V, dO rows 0..nk-1 in 16-byte chunks; rows past n are zeros
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = tid; c < 4 * nk * 8; c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int which = r / nk, row = r - which * nk;
    uint4 v = zero;
    if (row < n) {
      const __nv_bfloat16* src =
          which < 3 ? base + row * row_stride + (which * heads + h) * kD + col
                    : dbase + row * do_sn + col;
      v = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>(sq + r * kStride + col) = v;
  }
  __syncthreads();

  const int lrow = lane & 15;  // ldmatrix row supplied by this lane (x2)

  // ---- sweep 1: query tiles -> row statistics and dq ----
  for (int qt = warp; qt < nt; qt += kWarps) {
    const int q0 = qt * 16;
    float s[kTiles][4];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* qw = sq + (q0 + g) * kStride + 2 * t;
    const __nv_bfloat16* dw = sdo + (q0 + g) * kStride + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      uint32_t a[4];
      frag_a(a, qw, kk);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        if (j * 8 < nk) {
          const __nv_bfloat16* kp = sk + (j * 8 + g) * kStride + kk + 2 * t;
          uint32_t bb[2] = {ld32(kp), ld32(kp + 8)};
          mma_16816(s[j], a, bb);
        }
      }
    }
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
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
    for (int j = 0; j < kTiles; ++j) {
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
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      s[j][0] *= inv0, s[j][1] *= inv0;
      s[j][2] *= inv1, s[j][3] *= inv1;
    }

    // dp = dO . V^T for one 8-key tile j
    auto dp_tile = [&](int j, float* dp) {
      dp[0] = dp[1] = dp[2] = dp[3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD; kk += 16) {
        uint32_t a[4];
        frag_a(a, dw, kk);
        const __nv_bfloat16* vp = sv + (j * 8 + g) * kStride + kk + 2 * t;
        uint32_t bb[2] = {ld32(vp), ld32(vp + 8)};
        mma_16816(dp, a, bb);
      }
    };

    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (j * 8 < nk) {
        float dp[4];
        dp_tile(j, dp);
        d0 += s[j][0] * dp[0] + s[j][1] * dp[1];
        d1 += s[j][2] * dp[2] + s[j][3] * dp[3];
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    }
    if (t == 0) {
      s_m[q0 + g] = m0, s_inv[q0 + g] = inv0, s_delta[q0 + g] = d0;
      s_m[q0 + g + 8] = m1, s_inv[q0 + g + 8] = inv1, s_delta[q0 + g + 8] = d1;
    }

    // dq = ds . K over key steps of 16
    float dq[kD / 8][4];
#pragma unroll
    for (int d = 0; d < kD / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTiles / 2; ++kk) {
      if (kk * 16 < nk) {
        uint32_t a[4];
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const int j = 2 * kk + hlf;
          float dp[4];
          dp_tile(j, dp);
          const float* p = s[j];
          a[2 * hlf] = pack_bf16(p[0] * (dp[0] - d0) * scale, p[1] * (dp[1] - d0) * scale);
          a[2 * hlf + 1] = pack_bf16(p[2] * (dp[2] - d1) * scale, p[3] * (dp[3] - d1) * scale);
        }
        // a = {rows g / keys 2t.. of tile 2kk, rows g+8 / tile 2kk, rows g /
        // tile 2kk+1, rows g+8 / tile 2kk+1}: the A fragment of the 16x16 ds
#pragma unroll
        for (int d = 0; d < kD / 8; ++d) {
          uint32_t bb[2];
          ldmatrix_x2_trans(bb, sk + (kk * 16 + lrow) * kStride + d * 8);
          mma_16816(dq[d], a, bb);
        }
      }
    }
    const int r0 = q0 + g;
#pragma unroll
    for (int d = 0; d < kD / 8; ++d) {
      const int col = h * kD + d * 8 + 2 * t;
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(obase + r0 * row_stride + col) = pack_bf16(dq[d][0], dq[d][1]);
      if (r0 + 8 < n)
        *reinterpret_cast<uint32_t*>(obase + (r0 + 8) * row_stride + col) =
            pack_bf16(dq[d][2], dq[d][3]);
    }
  }
  __syncthreads();  // the row statistics of every query tile are in shared memory

  // ---- sweep 2: key tiles -> dk, dv ----
  for (int kt = warp; kt < nt; kt += kWarps) {
    const int k0 = kt * 16;
    float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
    for (int d = 0; d < kD / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

    for (int qt = 0; qt < nt; ++qt) {
      const int q0 = qt * 16;
      const __nv_bfloat16* qw = sq + (q0 + g) * kStride + 2 * t;
      const __nv_bfloat16* dw = sdo + (q0 + g) * kStride + 2 * t;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD; kk += 16) {
        uint32_t a[4], ad[4];
        frag_a(a, qw, kk);
        frag_a(ad, dw, kk);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const __nv_bfloat16* kp = sk + (k0 + j * 8 + g) * kStride + kk + 2 * t;
          const __nv_bfloat16* vp = sv + (k0 + j * 8 + g) * kStride + kk + 2 * t;
          uint32_t bk[2] = {ld32(kp), ld32(kp + 8)};
          uint32_t bv[2] = {ld32(vp), ld32(vp + 8)};
          mma_16816(s[j], a, bk);
          mma_16816(dp[j], ad, bv);
        }
      }
      const float mr[2] = {s_m[q0 + g], s_m[q0 + g + 8]};
      const float ir[2] = {s_inv[q0 + g], s_inv[q0 + g + 8]};
      const float dr[2] = {s_delta[q0 + g], s_delta[q0 + g + 8]};
      uint32_t pc[2][2], dc[2][2];  // [key tile][row half], packed bf16
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t + (e & 1), r = e >> 1;
          const float sv_ = key < n ? s[j][e] * scale : -INFINITY;
          p[e] = expf(sv_ - mr[r]) * ir[r];
          ds[e] = p[e] * (dp[j][e] - dr[r]) * scale;
        }
        pc[j][0] = pack_bf16(p[0], p[1]), pc[j][1] = pack_bf16(p[2], p[3]);
        dc[j][0] = pack_bf16(ds[0], ds[1]), dc[j][1] = pack_bf16(ds[2], ds[3]);
      }
      // A fragments of p^T and ds^T (16 keys x 16 queries): the transposes of
      // the 8x8 blocks (queries 0-7, keys 0-7), (q 0-7, k 8-15),
      // (q 8-15, k 0-7), (q 8-15, k 8-15)
      const uint32_t pa[4] = {movmatrix_trans(pc[0][0]), movmatrix_trans(pc[1][0]),
                              movmatrix_trans(pc[0][1]), movmatrix_trans(pc[1][1])};
      const uint32_t da[4] = {movmatrix_trans(dc[0][0]), movmatrix_trans(dc[1][0]),
                              movmatrix_trans(dc[0][1]), movmatrix_trans(dc[1][1])};
#pragma unroll
      for (int d = 0; d < kD / 8; ++d) {
        uint32_t bo[2], bq[2];
        ldmatrix_x2_trans(bo, sdo + (q0 + lrow) * kStride + d * 8);
        ldmatrix_x2_trans(bq, sq + (q0 + lrow) * kStride + d * 8);
        mma_16816(dv[d], pa, bo);
        mma_16816(dk[d], da, bq);
      }
    }
    const int r0 = k0 + g;
#pragma unroll
    for (int d = 0; d < kD / 8; ++d) {
      const int kc = (heads + h) * kD + d * 8 + 2 * t;
      const int vc = (2 * heads + h) * kD + d * 8 + 2 * t;
      if (r0 < n) {
        *reinterpret_cast<uint32_t*>(obase + r0 * row_stride + kc) = pack_bf16(dk[d][0], dk[d][1]);
        *reinterpret_cast<uint32_t*>(obase + r0 * row_stride + vc) = pack_bf16(dv[d][0], dv[d][1]);
      }
      if (r0 + 8 < n) {
        *reinterpret_cast<uint32_t*>(obase + (r0 + 8) * row_stride + kc) =
            pack_bf16(dk[d][2], dk[d][3]);
        *reinterpret_cast<uint32_t*>(obase + (r0 + 8) * row_stride + vc) =
            pack_bf16(dv[d][2], dv[d][3]);
      }
    }
  }
}

}  // namespace

// 1 if the backward takes this shape (bf16, N <= 224, d = 64)
GAVIT_EXPORT int gavit_attention_bwd_fits(int n, int dtype) {
  return dtype == GAVIT_BF16 && n > 0 && n <= kMaxKeys ? 1 : 0;
}

// qkv [batch, n, 3*heads*64] bf16; dout element (b, h, i, c) at
// dout + b*do_sb + h*do_sh + i*do_sn + c (rows 16-byte aligned); dqkv like qkv.
GAVIT_EXPORT int gavit_attention_bwd(const void* qkv, const void* dout, void* dqkv, int batch,
                                     int n, int heads, int head_dim, long long do_sb,
                                     long long do_sh, long long do_sn, float scale, int dtype,
                                     void* stream) {
  if (head_dim != kD || batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 ||
      !gavit_attention_bwd_fits(n, dtype))
    return cudaErrorInvalidValue;
  const int smem = bwd_smem_bytes(n);
  cudaError_t err = set_smem(attn_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(heads, batch);
  attn_bwd_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dqkv), n, heads, do_sb, do_sh, do_sn, scale);
  return cudaGetLastError();
}
