// Kernels K and K': exact multi-head self-attention forward and backward at
// long sequence lengths (384 px: N = 577), on the packed qkv rows.
//
// Replaces: gavit_tpu/ops/attention.py::_fwd_kernel_v3 (launched by
// _run_fwd_v3_impl) and ::_bwd_kernel_v3 (launched by _run_bwd_v3_impl), the
// pair fused_qkv_attention dispatches to when the v4 row no longer fits the
// TPU's VMEM budget and before the blockwise v5 kernels take over.
//
// Computes what kernels A and A' compute, with the same fp32 softmax over
// the whole key row (p = exp(s - m) / l with the row's true max m, p rounded
// to bf16 before p.v) and the same backward formulas:
//   dv = bf16(p)^T . do,  dp = do . v^T,  delta = rowsum(dp * p),
//   ds = bf16(p * (dp - delta) * scale),  dq = ds . k,  dk = ds^T . q.
// q, k and v are read straight out of the qkv GEMM's [B, N, 3*H*d] rows
// through strides; o is written as [B, N, H, d] (the Python wrapper returns
// the [B, H, N, d] view, as for A) and dq, dk, dv into the packed layout.
// The TPU kernels transpose qkv to [B, 3, H, N, d] first, for VMEM's sake;
// nothing here needs that copy.
//
// Why not A and A': they keep a 16-row tile's scores for every key in mma
// fragments (224 keys at most), and A' stages Q, K, V and dO of a head at
// once (295 KB at N = 577, over the 227 KB a block may have). Here every
// kernel streams tiles of 64 rows through 36 KB of static shared memory and
// recomputes what it needs instead of keeping it:
//
// * K (attn_long_fwd_kernel): grid (query block of 64 rows, head, image),
//   1920 blocks at b16 (120 at b1), 4 warps of 16 query rows each, Q held in
//   A fragments. Pass 1 streams K tiles and keeps each row's running max and
//   sum (the sum rescaled when the max moves), which gives the row's true
//   max m and 1/l. Pass 2 streams K and V tiles, recomputes S, forms
//   p = exp(s - m) * (1/l), rounds it to bf16 straight into A fragments and
//   accumulates o = p.v in registers. Ragged N: keys past N are -inf, query
//   rows past N are zero rows that are never written.
// * K' is two launches, each without a reduction across blocks or warps (no
//   atomics: deterministic), as A' has two sweeps:
//   - query-major (attn_long_bwd_q_kernel), grid as K's: pass a is K's pass
//     1; pass b streams K and V and sums delta = rowsum(dp * p) in fp32;
//     pass c streams them again and accumulates dq = ds.K in registers
//     (K read with ldmatrix.trans). The row max, 1/l and delta go to a
//     [3, B, H, N] fp32 scratch the wrapper allocates.
//   - key-major (attn_long_bwd_kv_kernel), grid (key block of 64, head,
//     image): each warp keeps 16 keys; it streams Q and dO tiles with their
//     rows' statistics, recomputes the 16x16 tiles of s, p (the same
//     operations as the query-major kernel, so the same bits) and dp, and
//     accumulates dv += p^T.dO and dk += ds^T.Q in registers, p and ds
//     transposed by movmatrix (A''s sweep 2).
//
// What bounds it on the H100: the work is 4*N^2*d FLOPs a head forward and
// 10*N^2*d backward against ~4*N*d*2 and ~7*N*d*2 bytes, 150-360 FLOP/byte at
// N = 577, around the card's ridge; the bound is about 0.02 ms (K) and
// 0.04 ms (K') at b16. This first version spends 1.5x (K) and 2x (K') the
// FLOPs on recomputation, uses mma.sync rather than wgmma and loads tiles
// synchronously, so neither bound is near.
#include "attention_tiles.cuh"

namespace {

// Pass 1 of K and pass a of K' (query-major): stream the K tiles of one
// head and return each of the thread's two rows' max (m0: row g, m1: row
// g+8) and 1/sum of exp(s - m). sk is a [64][72] staging buffer.
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

__global__ void __launch_bounds__(kThreads)
    attn_long_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int n, int heads,
                         float scale) {
  __shared__ __align__(16) bf16 sq[kTile * kStride];
  __shared__ __align__(16) bf16 sk[kTile * kStride];
  __shared__ __align__(16) bf16 sv[kTile * kStride];
  const int q_begin = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long rs = 3LL * heads * kD;
  const bf16* base = qkv + (long long)b * n * rs;
  const bf16* kcol = base + (heads + h) * kD;
  const bf16* vcol = base + (2 * heads + h) * kD;

  stage(sq, base + h * kD, rs, q_begin, n);
  __syncthreads();
  uint32_t qa[4][4];
  frag_rows(qa, sq + (warp * 16 + g) * kStride + 2 * t);

  float m0, m1, inv0, inv1;
  row_stats(qa, sk, kcol, rs, n, scale, g, t, m0, m1, inv0, inv1);

  // pass 2: O = P.V, P rebuilt per 16-key step from the row statistics
  float o[kD / 8][4];
#pragma unroll
  for (int d = 0; d < kD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  const int lrow = lane & 15;  // the row this lane addresses for ldmatrix (x2)
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    stage(sk, kcol, rs, k0, n);
    stage(sv, vcol, rs, k0, n);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int j = 2 * kk + hlf;
        float s[4];
        mma_rows(s, qa, sk, j, g, t);
        scale_mask(s, k0 + j * 8, t, n, scale);
        a[2 * hlf] = pack_bf16(expf(s[0] - m0) * inv0, expf(s[1] - m0) * inv0);
        a[2 * hlf + 1] = pack_bf16(expf(s[2] - m1) * inv1, expf(s[3] - m1) * inv1);
      }
      // a = {rows g / keys 2t.. of tile 2kk, rows g+8 / 2kk, rows g / 2kk+1,
      // rows g+8 / 2kk+1}: the A fragment of the 16x16 block of P
#pragma unroll
      for (int d = 0; d < kD / 8; ++d) {
        uint32_t bb[2];
        ldmatrix_x2_trans(bb, sv + (kk * 16 + lrow) * kStride + d * 8);
        mma_16816(o[d], a, bb);
      }
    }
  }

  const long long orow = (long long)heads * kD;  // o is [B, N, H, d] in memory
  bf16* ob = out + (long long)b * n * orow + h * kD;
  const int r0 = q_begin + warp * 16 + g;
#pragma unroll
  for (int d = 0; d < kD / 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (r0 < n) *reinterpret_cast<uint32_t*>(ob + r0 * orow + col) = pack_bf16(o[d][0], o[d][1]);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * orow + col) = pack_bf16(o[d][2], o[d][3]);
  }
}

// K', query-major: dq into dqkv, and the rows' statistics (max, 1/l, delta)
// into stats [3][B*H][n].
__global__ void __launch_bounds__(kThreads)
    attn_long_bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                           bf16* __restrict__ dqkv, float* __restrict__ stats, int n, int heads,
                           long long do_sb, long long do_sh, long long do_sn, float scale) {
  __shared__ __align__(16) bf16 sq[kTile * kStride];
  __shared__ __align__(16) bf16 sdo[kTile * kStride];
  __shared__ __align__(16) bf16 sk[kTile * kStride];
  __shared__ __align__(16) bf16 sv[kTile * kStride];
  const int q_begin = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long rs = 3LL * heads * kD;
  const bf16* base = qkv + (long long)b * n * rs;
  const bf16* kcol = base + (heads + h) * kD;
  const bf16* vcol = base + (2 * heads + h) * kD;

  stage(sq, base + h * kD, rs, q_begin, n);
  stage(sdo, dout + b * do_sb + h * do_sh, do_sn, q_begin, n);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  frag_rows(qa, sq + (warp * 16 + g) * kStride + 2 * t);
  frag_rows(da, sdo + (warp * 16 + g) * kStride + 2 * t);

  float m0, m1, inv0, inv1;
  row_stats(qa, sk, kcol, rs, n, scale, g, t, m0, m1, inv0, inv1);

  // pass b: delta = rowsum(dp * p), p in fp32
  float d0 = 0.f, d1 = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    stage(sk, kcol, rs, k0, n);
    stage(sv, vcol, rs, k0, n);
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
    stage(sk, kcol, rs, k0, n);
    stage(sv, vcol, rs, k0, n);
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

  bf16* ob = dqkv + (long long)b * n * rs + h * kD;
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
    attn_long_bwd_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                            bf16* __restrict__ dqkv, const float* __restrict__ stats, int n,
                            int heads, long long do_sb, long long do_sh, long long do_sn,
                            float scale) {
  __shared__ __align__(16) bf16 sk[kRows * kStride];
  __shared__ __align__(16) bf16 sv[kRows * kStride];
  __shared__ __align__(16) bf16 sq[kTile * kStride];
  __shared__ __align__(16) bf16 sdo[kTile * kStride];
  __shared__ float s_m[kTile], s_inv[kTile], s_delta[kTile];
  const int k_begin = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long rs = 3LL * heads * kD;
  const bf16* base = qkv + (long long)b * n * rs;
  const bf16* qcol = base + h * kD;
  const bf16* docol = dout + b * do_sb + h * do_sh;
  const long long plane = (long long)gridDim.z * heads * n;
  const float* st = stats + ((long long)b * heads + h) * n;

  stage(sk, base + (heads + h) * kD, rs, k_begin, n);
  stage(sv, base + (2 * heads + h) * kD, rs, k_begin, n);

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int d = 0; d < kD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  const int lrow = lane & 15;
  const int kw = warp * 16;  // this warp's keys within the block
  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // the previous tiles are consumed (and sk, sv staged)
    stage(sq, qcol, rs, q0, n);
    stage(sdo, docol, do_sn, q0, n);
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

  bf16* ob = dqkv + (long long)b * n * rs;
  const int r0 = k_begin + kw + g;
#pragma unroll
  for (int d = 0; d < kD / 8; ++d) {
    const int kc = (heads + h) * kD + d * 8 + 2 * t;
    const int vc = (2 * heads + h) * kD + d * 8 + 2 * t;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(ob + r0 * rs + kc) = pack_bf16(dk[d][0], dk[d][1]);
      *reinterpret_cast<uint32_t*>(ob + r0 * rs + vc) = pack_bf16(dv[d][0], dv[d][1]);
    }
    if (r0 + 8 < n) {
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * rs + kc) = pack_bf16(dk[d][2], dk[d][3]);
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * rs + vc) = pack_bf16(dv[d][2], dv[d][3]);
    }
  }
}

bool shape_ok(int batch, int n, int heads, int head_dim) {
  return head_dim == kD && batch > 0 && batch <= 65535 && heads > 0 && heads <= 65535 && n > 0;
}

}  // namespace

// qkv [batch, n, 3*heads*64] bf16 -> out [batch, n, heads, 64] bf16
GAVIT_EXPORT int gavit_attention_long_fwd(const void* qkv, void* out, int batch, int n, int heads,
                                          int head_dim, float scale, void* stream) {
  if (!shape_ok(batch, n, heads, head_dim)) return cudaErrorInvalidValue;
  dim3 grid((n + kRows - 1) / kRows, heads, batch);
  attn_long_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), n, heads, scale);
  return cudaGetLastError();
}

// qkv [batch, n, 3*heads*64] bf16; dout element (b, h, i, c) at
// dout + b*do_sb + h*do_sh + i*do_sn + c (rows 16-byte aligned); dqkv like
// qkv; stats: 3*batch*heads*n floats of scratch.
GAVIT_EXPORT int gavit_attention_long_bwd(const void* qkv, const void* dout, void* dqkv,
                                          void* stats, int batch, int n, int heads, int head_dim,
                                          long long do_sb, long long do_sh, long long do_sn,
                                          float scale, void* stream) {
  if (!shape_ok(batch, n, heads, head_dim)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n + kRows - 1) / kRows, heads, batch);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* st = static_cast<float*>(stats);
  attn_long_bwd_q_kernel<<<grid, kThreads, 0, s>>>(q, d, dq, st, n, heads, do_sb, do_sh, do_sn,
                                                   scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_long_bwd_kv_kernel<<<grid, kThreads, 0, s>>>(q, d, dq, st, n, heads, do_sb, do_sh, do_sn,
                                                    scale);
  return cudaGetLastError();
}
