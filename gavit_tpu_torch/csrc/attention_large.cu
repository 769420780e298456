// Kernels L and L': blockwise multi-head self-attention forward and backward
// for sequences past the exact kernels' range (512 px: N = 1025, 1024 px:
// N = 4097), on the packed qkv rows.
//
// Replaces: gavit_tpu/ops/attention.py::_fwd_kernel_v5 (launched by
// _run_fwd_v5_impl), ::_dq_kernel_v5 and ::_dkv_kernel_v5 (launched by
// _run_bwd_v5_impl): flash_attention_large, which fused_qkv_attention takes
// once the exact v3 kernels no longer fit the TPU's VMEM (N > 749 in bf16 at
// head_dim 64; attention_route 'L' in the port).
//
// What they compute, with v5's rounding points:
//   forward   s = q.k^T * scale (fp32), online softmax over 64-key tiles:
//             p = exp(s - m) with m the running row max, rounded to bf16
//             before p.v; o = (sum p.v) / l, lse = m + log l (fp32);
//   backward  delta = rowsum(do * o) (fp32), p = exp(s - lse),
//             dv = bf16(p)^T . do, dp = do . v^T,
//             ds = bf16(p * (dp - delta) * scale), dq = ds . k, dk = ds^T . q.
// q, k and v are read straight out of the qkv GEMM's [B, N, 3*H*d] rows
// through strides, with no host transpose or pad (the TPU kernels transpose
// to [3, B*H, N_pad, d] first); o is written as [B, N, H, d] (the Python
// wrapper returns the [B, H, N, d] view, as for A and K), lse as [B, H, N],
// and dq, dk, dv into the packed layout. The ragged tail is masked in the
// kernels: keys at or past N score -inf, query rows past N are zero rows
// that are never written, and their lse is never read.
//
// * L (attn_large_fwd_kernel): grid (query block of 64 rows, head, image),
//   6528 blocks at 512 px b32, 780 at 1024 px b1; 4 warps of 16 query rows,
//   Q held in A fragments. One pass over the key tiles: K and V tiles are
//   double-buffered in shared memory with cp.async (the next tile's copy in
//   flight while this one is multiplied), the row max and sum kept in fp32
//   and o rescaled in registers when the max moves (K makes two passes,
//   because it needs the true max before it rounds p).
// * L' is two launches without atomics (deterministic), as v5's two kernels:
//   - query-major (attn_large_bwd_q_kernel), grid as L's: delta of the
//     block's rows from o and do (fp32, written to a [B, H, N] scratch for the
//     second launch), then one pass over double-buffered K and V tiles that
//     accumulates dq = ds.K in registers (K read with ldmatrix.trans).
//   - key-major (attn_large_bwd_kv_kernel), grid (key block of 64, head,
//     image): each warp keeps 16 keys; Q and dO tiles stream through a
//     double-buffered ring with their rows' lse and delta; s, p and dp are
//     recomputed per 16x16 tile, p and ds transposed by movmatrix, and
//     dv += p^T.dO, dk += ds^T.Q accumulate in registers.
//
// What bounds it on the H100: 4*N^2*d FLOPs a head forward and 10*N^2*d
// backward (recomputing s and dp in both launches: 14*N^2*d done) against
// ~4*N*d*2 and ~8*N*d*2 bytes: 500-2000 FLOP/byte at N = 1025-4097, far
// above the card's ridge (~295), so the bound is the tensor cores: about
// 0.10 ms (L) and 0.26 ms (L') at 512 px b32. This first version issues
// mma.sync, not wgmma, and 4 warps a block, so it will not reach it.
#include "attention_tiles.cuh"

namespace {

// the fp32 rowsum(do * o) of one row's 64 columns, split over the two
// threads 2r and 2r+1 (32 columns each, in order, then the pair's sum)
__device__ __forceinline__ float row_dot(const bf16* a, const bf16* b) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 32; c += 8) {
    const uint4 ua = *reinterpret_cast<const uint4*>(a + c);
    const uint4 ub = *reinterpret_cast<const uint4*>(b + c);
    const bf16* pa = reinterpret_cast<const bf16*>(&ua);
    const bf16* pb = reinterpret_cast<const bf16*>(&ub);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += __bfloat162float(pa[e]) * __bfloat162float(pb[e]);
  }
  return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

__global__ void __launch_bounds__(kThreads)
    attn_large_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                          float* __restrict__ lse, int n, int heads, float scale) {
  __shared__ __align__(16) bf16 sq[kTile * kStride];
  __shared__ __align__(16) bf16 sk[2][kTile * kStride];
  __shared__ __align__(16) bf16 sv[2][kTile * kStride];
  const int q_begin = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long rs = 3LL * heads * kD;
  const bf16* base = qkv + (long long)b * n * rs;
  const bf16* kcol = base + (heads + h) * kD;
  const bf16* vcol = base + (2 * heads + h) * kD;
  const int tiles = (n + kTile - 1) / kTile;

  stage_async(sq, base + h * kD, rs, q_begin, n);
  stage_async(sk[0], kcol, rs, 0, n);
  stage_async(sv[0], vcol, rs, 0, n);
  cp_async_commit();

  uint32_t qa[4][4];
  float o[kD / 8][4];
#pragma unroll
  for (int d = 0; d < kD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int lrow = lane & 15;  // the row this lane addresses for ldmatrix (x2)
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    __syncthreads();  // the tile in slot cur ^ 1 is consumed
    if (it + 1 < tiles) {
      stage_async(sk[cur ^ 1], kcol, rs, (it + 1) * kTile, n);
      stage_async(sv[cur ^ 1], vcol, rs, (it + 1) * kTile, n);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just committed: tile it (and Q)
    __syncthreads();
    if (it == 0) frag_rows(qa, sq + (warp * 16 + g) * kStride + 2 * t);
    const int k0 = it * kTile;
    float s[8][4];
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mma_rows(s[j], qa, sk[cur], j, g, t);
      scale_mask(s[j], k0 + j * 8, t, n, scale);
      t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
      t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
    }
    // every tile holds a key < n, so the new max is finite; on the first
    // tile exp(-inf - max) = 0 clears the empty sums
    const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
    const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);
    m0 = n0, m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int d = 0; d < kD / 8; ++d) {
      o[d][0] *= a0, o[d][1] *= a0;
      o[d][2] *= a1, o[d][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const float* sj = s[2 * kk + hlf];
        const float p0 = expf(sj[0] - m0), p1 = expf(sj[1] - m0);
        const float p2 = expf(sj[2] - m1), p3 = expf(sj[3] - m1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        a[2 * hlf] = pack_bf16(p0, p1);
        a[2 * hlf + 1] = pack_bf16(p2, p3);
      }
      // a: the A fragment of the 16x16 block of p (rows g, g+8; keys of
      // n8 tiles 2kk and 2kk+1)
#pragma unroll
      for (int d = 0; d < kD / 8; ++d) {
        uint32_t bb[2];
        ldmatrix_x2_trans(bb, sv[cur] + (kk * 16 + lrow) * kStride + d * 8);
        mma_16816(o[d], a, bb);
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  const long long orow = (long long)heads * kD;  // o is [B, N, H, d] in memory
  bf16* ob = out + (long long)b * n * orow + h * kD;
  const int r0 = q_begin + warp * 16 + g;
#pragma unroll
  for (int d = 0; d < kD / 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(ob + r0 * orow + col) =
          pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * orow + col) =
          pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
  }
  if (t == 0) {
    float* lb = lse + ((long long)b * heads + h) * n;
    if (r0 < n) lb[r0] = m0 + logf(l0);
    if (r0 + 8 < n) lb[r0 + 8] = m1 + logf(l1);
  }
}

// L', query-major: delta of the block's rows into delta [B, H, n], dq into
// dqkv. o and dout are read through their strides (element (b, h, i, c) at
// ptr + b*sb + h*sh + i*sn + c).
__global__ void __launch_bounds__(kThreads)
    attn_large_bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ o,
                            const float* __restrict__ lse, const bf16* __restrict__ dout,
                            bf16* __restrict__ dqkv, float* __restrict__ delta, int n, int heads,
                            long long o_sb, long long o_sh, long long o_sn, long long do_sb,
                            long long do_sh, long long do_sn, float scale) {
  // [0], [1]: Q and dO of the block, then the second K / V slot; [2], [3]:
  // the first K / V slot
  __shared__ __align__(16) bf16 buf[4][kTile * kStride];
  __shared__ float s_lse[kRows], s_delta[kRows];
  const int q_begin = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long rs = 3LL * heads * kD;
  const bf16* base = qkv + (long long)b * n * rs;
  const bf16* kcol = base + (heads + h) * kD;
  const bf16* vcol = base + (2 * heads + h) * kD;
  const bf16* docol = dout + b * do_sb + h * do_sh;
  const long long bh = (long long)b * heads + h;
  const int tiles = (n + kTile - 1) / kTile;

  stage_async(buf[0], base + h * kD, rs, q_begin, n);
  stage_async(buf[1], docol, do_sn, q_begin, n);
  stage_async(buf[2], kcol, rs, 0, n);
  stage_async(buf[3], vcol, rs, 0, n);
  cp_async_commit();
  {
    // delta = rowsum(do * o) in fp32 while the copies fly; rows past n get
    // lse = delta = 0, so their (never written) rows stay finite
    const int r = threadIdx.x >> 1, half = (threadIdx.x & 1) * 32;
    const int row = q_begin + r;
    const bool in = row < n;
    const int rr = in ? row : 0;
    const float acc = row_dot(o + b * o_sb + h * o_sh + rr * o_sn + half,
                              docol + rr * do_sn + half);
    if (half == 0) {
      s_delta[r] = in ? acc : 0.f;
      s_lse[r] = in ? lse[bh * n + row] : 0.f;
      if (in) delta[bh * n + row] = acc;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  frag_rows(qa, buf[0] + (warp * 16 + g) * kStride + 2 * t);
  frag_rows(da, buf[1] + (warp * 16 + g) * kStride + 2 * t);
  const float lse0 = s_lse[warp * 16 + g], lse1 = s_lse[warp * 16 + g + 8];
  const float d0 = s_delta[warp * 16 + g], d1 = s_delta[warp * 16 + g + 8];

  float dq[kD / 8][4];
#pragma unroll
  for (int d = 0; d < kD / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
  const int lrow = lane & 15;
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1;
    __syncthreads();  // slot cur ^ 1 is consumed (on the first tile: Q and dO)
    if (it + 1 < tiles) {  // slot s holds K in buf[2 - 2s], V in buf[3 - 2s]
      stage_async(buf[2 * cur], kcol, rs, (it + 1) * kTile, n);
      stage_async(buf[2 * cur + 1], vcol, rs, (it + 1) * kTile, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sk = buf[2 - 2 * cur];
    const bf16* sv = buf[3 - 2 * cur];
    const int k0 = it * kTile;
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
        const float p0 = expf(s[0] - lse0), p1 = expf(s[1] - lse0);
        const float p2 = expf(s[2] - lse1), p3 = expf(s[3] - lse1);
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
}

// dynamic shared memory of the key-major launch: the block's K and V, two
// slots of Q and dO tiles, two slots of their rows' lse and delta
constexpr int kKvTileBytes = kTile * kStride * 2;
constexpr int kKvSmemBytes = 6 * kKvTileBytes + 4 * kTile * 4;

// L', key-major: dk and dv of a block of 64 keys into dqkv.
__global__ void __launch_bounds__(kThreads)
    attn_large_bwd_kv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ lse,
                             const bf16* __restrict__ dout, const float* __restrict__ delta,
                             bf16* __restrict__ dqkv, int n, int heads, long long do_sb,
                             long long do_sh, long long do_sn, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int T = kTile * kStride;
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + T;
  float* stat = reinterpret_cast<float*>(smem + 6 * kKvTileBytes);
  // slot c: Q at sk + (2 + c) T, dO at sk + (4 + c) T, the rows' lse at
  // stat + c kTile, their delta at stat + (2 + c) kTile
  const int k_begin = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long rs = 3LL * heads * kD;
  const bf16* base = qkv + (long long)b * n * rs;
  const bf16* qcol = base + h * kD;
  const bf16* docol = dout + b * do_sb + h * do_sh;
  const long long bh = (long long)b * heads + h;
  const int tiles = (n + kTile - 1) / kTile;

  // the lse and delta of query tile q0's rows into slot `slot`; rows past n
  // get lse = +inf, so p = exp(s - inf) = 0 there and they add nothing
  auto stats = [&](int slot, int q0) {
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      stat[slot * kTile + threadIdx.x] = r < n ? lse[bh * n + r] : INFINITY;
      stat[(2 + slot) * kTile + threadIdx.x] = r < n ? delta[bh * n + r] : 0.f;
    }
  };
  stage_async(sk, base + (heads + h) * kD, rs, k_begin, n);
  stage_async(sv, base + (2 * heads + h) * kD, rs, k_begin, n);
  stage_async(sk + 2 * T, qcol, rs, 0, n);
  stage_async(sk + 4 * T, docol, do_sn, 0, n);
  cp_async_commit();
  stats(0, 0);

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int d = 0; d < kD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  const int lrow = lane & 15;
  const int kw = warp * 16;  // this warp's keys within the block
  for (int it = 0; it < tiles; ++it) {
    const int cur = it & 1, q0 = it * kTile;
    __syncthreads();  // slot cur ^ 1 is consumed
    if (it + 1 < tiles) {
      stage_async(sk + (3 - cur) * T, qcol, rs, q0 + kTile, n);
      stage_async(sk + (5 - cur) * T, docol, do_sn, q0 + kTile, n);
      stats(cur ^ 1, q0 + kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sq = sk + (2 + cur) * T;
    const bf16* sdo = sk + (4 + cur) * T;
    const float* s_lse = stat + cur * kTile;
    const float* s_delta = stat + (2 + cur) * kTile;
    for (int qt = 0; qt < kTile / 16 && q0 + qt * 16 < n; ++qt) {
      const int r = qt * 16;
      uint32_t qa[4][4], da[4][4];
      frag_rows(qa, sq + (r + g) * kStride + 2 * t);
      frag_rows(da, sdo + (r + g) * kStride + 2 * t);
      const float lr[2] = {s_lse[r + g], s_lse[r + g + 8]};
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
          p[e] = expf(s[e] - lr[hr]);
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

// qkv [batch, n, 3*heads*64] bf16 -> out [batch, n, heads, 64] bf16 and
// lse [batch, heads, n] fp32
GAVIT_EXPORT int gavit_attention_large_fwd(const void* qkv, void* out, void* lse, int batch,
                                           int n, int heads, int head_dim, float scale,
                                           void* stream) {
  if (!shape_ok(batch, n, heads, head_dim)) return cudaErrorInvalidValue;
  dim3 grid((n + kRows - 1) / kRows, heads, batch);
  attn_large_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), static_cast<float*>(lse), n,
      heads, scale);
  return cudaGetLastError();
}

// qkv [batch, n, 3*heads*64] bf16; o and dout: element (b, h, i, c) at
// ptr + b*sb + h*sh + i*sn + c (rows 16-byte aligned); lse [batch, heads, n]
// fp32 from the forward; dqkv like qkv; delta: batch*heads*n floats of
// scratch.
GAVIT_EXPORT int gavit_attention_large_bwd(const void* qkv, const void* o, const void* lse,
                                           const void* dout, void* dqkv, void* delta, int batch,
                                           int n, int heads, int head_dim, long long o_sb,
                                           long long o_sh, long long o_sn, long long do_sb,
                                           long long do_sh, long long do_sn, float scale,
                                           void* stream) {
  if (!shape_ok(batch, n, heads, head_dim)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(attn_large_bwd_kv_kernel, kKvSmemBytes);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n + kRows - 1) / kRows, heads, batch);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* d = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* dl = static_cast<float*>(delta);
  attn_large_bwd_q_kernel<<<grid, kThreads, 0, s>>>(q, static_cast<const bf16*>(o), l, d, dq, dl,
                                                    n, heads, o_sb, o_sh, o_sn, do_sb, do_sh,
                                                    do_sn, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_large_bwd_kv_kernel<<<grid, kThreads, kKvSmemBytes, s>>>(q, l, d, dl, dq, n, heads, do_sb,
                                                                do_sh, do_sn, scale);
  return cudaGetLastError();
}
