// Kernel K': exact multi-head self-attention backward at long sequence
// lengths (384 px: N = 577), on the packed qkv rows; the same kernels are
// I' and J' on separate q, k, v [B, H, N, d]. The bf16 forwards K, I and J
// (and A) are attention_fwd_sm90.cu's Hopper kernel, whose note gives their
// bound and design.
//
// Replaces: gavit_tpu/ops/attention.py::_bwd_kernel_v3 (launched by
// _run_bwd_v3_impl), the backward fused_qkv_attention dispatches to when
// the v4 row no longer fits the TPU's VMEM budget and before the blockwise
// v5 kernels take over; and, as I' and J', ::_bwd_kernel (v1, launched by
// _run_bwd_v1_impl under attention_pallas) and ::_bwd_kernel_v2 (launched
// by _run_bwd_v2_impl under fused_attention_v2).
//
// Computes the backward of the forward's function (p = exp(s - m) / l with
// the row's true max m, p rounded to bf16 before p.v) with A''s formulas:
//   dv = bf16(p)^T . do,  dp = do . v^T,  delta = rowsum(dp * p),
//   ds = bf16(p * (dp - delta) * scale),  dq = ds . k,  dk = ds^T . q.
// v1, v2 and v3 compute this one function and differ only in their TPU
// grids: v1 one program per (image, head) over N padded to 128, v2 one per
// image over a chunk of heads sized for VMEM, v3 the packed rows transposed
// first. On the card each reduces to blocks per (image, head, 64 rows), so
// one kernel pair serves all three, and every operand is addressed through
// (batch, head, row) strides (attention_tiles.cuh's Heads): K' reads q, k
// and v straight out of the qkv GEMM's [B, N, 3*H*d] rows and writes dq,
// dk, dv into the packed layout; I' and J' read and write [B, H, N, d]
// tensors. The TPU kernels transpose qkv to [B, 3, H, N, d] first, for
// VMEM's sake; nothing here needs that copy. N runs from 1 up: rows past N
// are staged as zeros, keys past N are -inf, and the padding of v1 has no
// counterpart.
//
// Why not A': it stages Q, K, V and dO of a head at once (295 KB at N =
// 577, over the 227 KB a block may have). Here both kernels stream tiles
// of 64 rows through static shared memory and recompute what they need
// instead of keeping it. K' is two launches, each without a reduction
// across blocks or warps (no atomics: deterministic), as A' has two sweeps:
// * query-major (attn_long_bwd_q_kernel), grid (query block of 64 rows,
//   head, image), 4 warps of 16 query rows, Q and dO held in A fragments:
//   pass a (row_stats) streams K tiles and keeps each row's running max and
//   sum (the sum rescaled when the max moves), which gives the row's true
//   max m and 1/l; pass b streams K and V and sums delta = rowsum(dp * p)
//   in fp32; pass c streams them again and accumulates dq = ds.K in
//   registers (K read with ldmatrix.trans). The row max, 1/l and delta go
//   to a [3, B, H, N] fp32 scratch the wrapper allocates.
// * key-major (attn_long_bwd_kv_kernel), grid (key block of 64, head,
//   image): each warp keeps 16 keys; it streams Q and dO tiles with their
//   rows' statistics, recomputes the 16x16 tiles of s, p (the same
//   operations as the query-major kernel, so the same bits) and dp, and
//   accumulates dv += p^T.dO and dk += ds^T.Q in registers, p and ds
//   transposed by movmatrix (A''s sweep 2).
//
// What bounds it on the H100: the work is 10*N^2*d FLOPs a head against
// ~7*N*d*2 bytes, about 360 FLOP/byte at N = 577, around the card's ridge;
// the bound is about 0.04 ms at b16; at N = 197, b128 (I', J') the bytes
// bound it, 0.081 ms. These kernels spend 2x the FLOPs on recomputation,
// use mma.sync rather than wgmma and load tiles synchronously, so the
// bound is not near (ROADMAP Queue 2 lists their redesign).
#include "attention_tiles.cuh"

namespace {

// Pass a of K' (query-major): stream the K tiles of one head and return
// each of the thread's two rows' max (m0: row g, m1: row g+8) and 1/sum of
// exp(s - m). sk is a [64][72] staging buffer.
__device__ __forceinline__ void row_stats(const uint32_t (*qa)[4], bf16* sk, const bf16* kcol,
                                          long long rs, int n, float scale, int g, int t,
                                          float& m0, float& m1, float& inv0, float& inv1) {
  m0 = m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage(sk, kcol, rs, k0, n);
    __syncthreads();
    float s[8][4];
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mma_rows(s[j], qa, sk, j, g, t);
      scale_mask(s[j], k0 + j * 8, t, n, scale);
      t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
      t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
    }
    // every tile holds a key < n, so the new max is finite; exp(-inf) = 0
    // drops the empty sum of the first tile
    const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
    l0 *= expf(m0 - n0);
    l1 *= expf(m1 - n1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l0 += expf(s[j][0] - n0) + expf(s[j][1] - n0);
      l1 += expf(s[j][2] - n1) + expf(s[j][3] - n1);
    }
    m0 = n0, m1 = n1;
  }
  inv0 = 1.f / quad_sum(l0);
  inv1 = 1.f / quad_sum(l1);
}

// K', query-major: dq into dqkv, and the rows' statistics (max, 1/l, delta)
// into stats [3][B*H][n].
__global__ void __launch_bounds__(kThreads)
    attn_long_bwd_q_kernel(InHeads q, InHeads k, InHeads v, InHeads dout, OutHeads dq_out,
                           float* __restrict__ stats, int n, float scale) {
  __shared__ __align__(16) bf16 sq[kTile * kStride];
  __shared__ __align__(16) bf16 sdo[kTile * kStride];
  __shared__ __align__(16) bf16 sk[kTile * kStride];
  __shared__ __align__(16) bf16 sv[kTile * kStride];
  const int q_begin = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int heads = gridDim.y;
  const bf16* kcol = k.at(b, h);
  const bf16* vcol = v.at(b, h);

  stage(sq, q.at(b, h), q.sn, q_begin, n);
  stage(sdo, dout.at(b, h), dout.sn, q_begin, n);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  frag_rows(qa, sq + (warp * 16 + g) * kStride + 2 * t);
  frag_rows(da, sdo + (warp * 16 + g) * kStride + 2 * t);

  float m0, m1, inv0, inv1;
  row_stats(qa, sk, kcol, k.sn, n, scale, g, t, m0, m1, inv0, inv1);

  // pass b: delta = rowsum(dp * p), p in fp32
  float d0 = 0.f, d1 = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    stage(sk, kcol, k.sn, k0, n);
    stage(sv, vcol, v.sn, k0, n);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s[4], dp[4];
      mma_rows(s, qa, sk, j, g, t);
      scale_mask(s, k0 + j * 8, t, n, scale);
      mma_rows(dp, da, sv, j, g, t);
      d0 += (expf(s[0] - m0) * inv0) * dp[0] + (expf(s[1] - m0) * inv0) * dp[1];
      d1 += (expf(s[2] - m1) * inv1) * dp[2] + (expf(s[3] - m1) * inv1) * dp[3];
    }
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);

  // pass c: dq = ds.K over 16-key steps
  float dq[kD / 8][4];
#pragma unroll
  for (int d = 0; d < kD / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
  const int lrow = lane & 15;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    stage(sk, kcol, k.sn, k0, n);
    stage(sv, vcol, v.sn, k0, n);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int j = 2 * kk + hlf;
        float s[4], dp[4];
        mma_rows(s, qa, sk, j, g, t);
        scale_mask(s, k0 + j * 8, t, n, scale);
        mma_rows(dp, da, sv, j, g, t);
        const float p0 = expf(s[0] - m0) * inv0, p1 = expf(s[1] - m0) * inv0;
        const float p2 = expf(s[2] - m1) * inv1, p3 = expf(s[3] - m1) * inv1;
        a[2 * hlf] = pack_bf16(p0 * (dp[0] - d0) * scale, p1 * (dp[1] - d0) * scale);
        a[2 * hlf + 1] = pack_bf16(p2 * (dp[2] - d1) * scale, p3 * (dp[3] - d1) * scale);
      }
#pragma unroll
      for (int d = 0; d < kD / 8; ++d) {
        uint32_t bb[2];
        ldmatrix_x2_trans(bb, sk + (kk * 16 + lrow) * kStride + d * 8);
        mma_16816(dq[d], a, bb);
      }
    }
  }

  bf16* ob = dq_out.at(b, h);
  const long long rs = dq_out.sn;
  const int r0 = q_begin + warp * 16 + g;
#pragma unroll
  for (int d = 0; d < kD / 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (r0 < n) *reinterpret_cast<uint32_t*>(ob + r0 * rs + col) = pack_bf16(dq[d][0], dq[d][1]);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * rs + col) = pack_bf16(dq[d][2], dq[d][3]);
  }
  if (t == 0) {
    const long long plane = (long long)gridDim.z * heads * n;
    float* st = stats + ((long long)b * heads + h) * n;
    if (r0 < n) st[r0] = m0, st[plane + r0] = inv0, st[2 * plane + r0] = d0;
    if (r0 + 8 < n) st[r0 + 8] = m1, st[plane + r0 + 8] = inv1, st[2 * plane + r0 + 8] = d1;
  }
}

// K', key-major: dk and dv of a block of 64 keys into dqkv.
__global__ void __launch_bounds__(kThreads)
    attn_long_bwd_kv_kernel(InHeads q, InHeads k, InHeads v, InHeads dout, OutHeads dk_out,
                            OutHeads dv_out, const float* __restrict__ stats, int n,
                            float scale) {
  __shared__ __align__(16) bf16 sk[kRows * kStride];
  __shared__ __align__(16) bf16 sv[kRows * kStride];
  __shared__ __align__(16) bf16 sq[kTile * kStride];
  __shared__ __align__(16) bf16 sdo[kTile * kStride];
  __shared__ float s_m[kTile], s_inv[kTile], s_delta[kTile];
  const int k_begin = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int heads = gridDim.y;
  const bf16* qcol = q.at(b, h);
  const bf16* docol = dout.at(b, h);
  const long long plane = (long long)gridDim.z * heads * n;
  const float* st = stats + ((long long)b * heads + h) * n;

  stage(sk, k.at(b, h), k.sn, k_begin, n);
  stage(sv, v.at(b, h), v.sn, k_begin, n);

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int d = 0; d < kD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  const int lrow = lane & 15;
  const int kw = warp * 16;  // this warp's keys within the block
  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // the previous tiles are consumed (and sk, sv staged)
    stage(sq, qcol, q.sn, q0, n);
    stage(sdo, docol, dout.sn, q0, n);
    if (threadIdx.x < kTile) {
      // rows past n: p = exp(0 - 0) * 0 = 0 and ds = 0, so they add nothing
      const int r = q0 + threadIdx.x;
      s_m[threadIdx.x] = r < n ? st[r] : 0.f;
      s_inv[threadIdx.x] = r < n ? st[plane + r] : 0.f;
      s_delta[threadIdx.x] = r < n ? st[2 * plane + r] : 0.f;
    }
    __syncthreads();
    for (int qt = 0; qt < kTile / 16 && q0 + qt * 16 < n; ++qt) {
      const int r = qt * 16;
      uint32_t qa[4][4], da[4][4];
      frag_rows(qa, sq + (r + g) * kStride + 2 * t);
      frag_rows(da, sdo + (r + g) * kStride + 2 * t);
      const float mr[2] = {s_m[r + g], s_m[r + g + 8]};
      const float ir[2] = {s_inv[r + g], s_inv[r + g + 8]};
      const float dr[2] = {s_delta[r + g], s_delta[r + g + 8]};
      uint32_t pc[2][2], dc[2][2];  // [key tile][row half], packed bf16
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s[4], dp[4], p[4], ds[4];
        mma_rows(s, qa, sk + kw * kStride, j, g, t);
        scale_mask(s, k_begin + kw + j * 8, t, n, scale);
        mma_rows(dp, da, sv + kw * kStride, j, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          p[e] = expf(s[e] - mr[hr]) * ir[hr];
          ds[e] = p[e] * (dp[e] - dr[hr]) * scale;
        }
        pc[j][0] = pack_bf16(p[0], p[1]), pc[j][1] = pack_bf16(p[2], p[3]);
        dc[j][0] = pack_bf16(ds[0], ds[1]), dc[j][1] = pack_bf16(ds[2], ds[3]);
      }
      // A fragments of p^T and ds^T (16 keys x 16 queries): the transposes of
      // the 8x8 blocks (queries 0-7, keys 0-7), (q 0-7, k 8-15),
      // (q 8-15, k 0-7), (q 8-15, k 8-15)
      const uint32_t pa[4] = {movmatrix_trans(pc[0][0]), movmatrix_trans(pc[1][0]),
                              movmatrix_trans(pc[0][1]), movmatrix_trans(pc[1][1])};
      const uint32_t dsa[4] = {movmatrix_trans(dc[0][0]), movmatrix_trans(dc[1][0]),
                               movmatrix_trans(dc[0][1]), movmatrix_trans(dc[1][1])};
#pragma unroll
      for (int d = 0; d < kD / 8; ++d) {
        uint32_t bo[2], bq[2];
        ldmatrix_x2_trans(bo, sdo + (r + lrow) * kStride + d * 8);
        ldmatrix_x2_trans(bq, sq + (r + lrow) * kStride + d * 8);
        mma_16816(dv[d], pa, bo);
        mma_16816(dk[d], dsa, bq);
      }
    }
  }

  bf16* kb = dk_out.at(b, h);
  bf16* vb = dv_out.at(b, h);
  const int r0 = k_begin + kw + g;
#pragma unroll
  for (int d = 0; d < kD / 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(kb + r0 * dk_out.sn + col) = pack_bf16(dk[d][0], dk[d][1]);
      *reinterpret_cast<uint32_t*>(vb + r0 * dv_out.sn + col) = pack_bf16(dv[d][0], dv[d][1]);
    }
    if (r0 + 8 < n) {
      *reinterpret_cast<uint32_t*>(kb + (r0 + 8) * dk_out.sn + col) = pack_bf16(dk[d][2], dk[d][3]);
      *reinterpret_cast<uint32_t*>(vb + (r0 + 8) * dv_out.sn + col) = pack_bf16(dv[d][2], dv[d][3]);
    }
  }
}

bool shape_ok(int batch, int n, int heads, int head_dim) {
  return head_dim == kD && batch > 0 && batch <= 65535 && heads > 0 && heads <= 65535 && n > 0;
}

int launch_bwd(InHeads q, InHeads k, InHeads v, InHeads dout, OutHeads dq, OutHeads dk,
               OutHeads dv, float* stats, int batch, int n, int heads, float scale,
               cudaStream_t s) {
  dim3 grid((n + kRows - 1) / kRows, heads, batch);
  attn_long_bwd_q_kernel<<<grid, kThreads, 0, s>>>(q, k, v, dout, dq, stats, n, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_long_bwd_kv_kernel<<<grid, kThreads, 0, s>>>(q, k, v, dout, dk, dv, stats, n, scale);
  return cudaGetLastError();
}

// the q, k or v columns (which = 0, 1, 2) of packed [batch, n, 3*heads*64] rows
template <typename T>
Heads<T> packed(T* qkv, int which, int n, int heads) {
  const long long rs = 3LL * heads * kD;
  return Heads<T>{qkv + (long long)which * heads * kD, n * rs, kD, rs};
}

// strides[3*i .. 3*i+2] = (sb, sh, sn) of operand i
template <typename T>
Heads<T> strided(T* p, const long long* strides, int i) {
  return Heads<T>{p, strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace

// K': qkv [batch, n, 3*heads*64] bf16; dout element (b, h, i, c) at
// dout + b*do_sb + h*do_sh + i*do_sn + c (rows 16-byte aligned); dqkv like
// qkv; stats: 3*batch*heads*n floats of scratch.
GAVIT_EXPORT int gavit_attention_long_bwd(const void* qkv, const void* dout, void* dqkv,
                                          void* stats, int batch, int n, int heads, int head_dim,
                                          long long do_sb, long long do_sh, long long do_sn,
                                          float scale, void* stream) {
  if (!shape_ok(batch, n, heads, head_dim)) return cudaErrorInvalidValue;
  const bf16* rows = static_cast<const bf16*>(qkv);
  bf16* drows = static_cast<bf16*>(dqkv);
  return launch_bwd(packed(rows, 0, n, heads), packed(rows, 1, n, heads),
                    packed(rows, 2, n, heads),
                    InHeads{static_cast<const bf16*>(dout), do_sb, do_sh, do_sn},
                    packed(drows, 0, n, heads), packed(drows, 1, n, heads),
                    packed(drows, 2, n, heads), static_cast<float*>(stats), batch, n, heads,
                    scale, static_cast<cudaStream_t>(stream));
}

// I' and J': q, k, v, dout -> dq, dk, dv, all [batch, heads, n, 64] bf16 through strides
// (sb, sh, sn) in strides[0..20] in that order; stats: 3*batch*heads*n floats of scratch.
GAVIT_EXPORT int gavit_attention_bhnd_bwd(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          void* stats, const long long* strides, int batch,
                                          int n, int heads, int head_dim, float scale,
                                          void* stream) {
  if (!shape_ok(batch, n, heads, head_dim)) return cudaErrorInvalidValue;
  return launch_bwd(strided(static_cast<const bf16*>(q), strides, 0),
                    strided(static_cast<const bf16*>(k), strides, 1),
                    strided(static_cast<const bf16*>(v), strides, 2),
                    strided(static_cast<const bf16*>(dout), strides, 3),
                    strided(static_cast<bf16*>(dq), strides, 4),
                    strided(static_cast<bf16*>(dk), strides, 5),
                    strided(static_cast<bf16*>(dv), strides, 6), static_cast<float*>(stats),
                    batch, n, heads, scale, static_cast<cudaStream_t>(stream));
}
