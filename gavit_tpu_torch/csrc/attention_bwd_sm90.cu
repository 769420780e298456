// Kernels K', I' and J': the exact bf16 multi-head self-attention backward
// for Hopper, wgmma on TMA-fed tiles. K' runs on the packed qkv rows (384
// px: N = 577, and every N from 225 up to K_MAX_N = 749 on the model's
// path); I' and J' on separate q, k, v [B, H, N, d] tensors through their
// strides (N from 1 up: I' to 640, J' at any N). The forwards K, I, J are
// attention_fwd_sm90.cu's.
//
// Replaces: gavit_tpu/ops/attention.py::_bwd_kernel_v3 (K', launched by
// _run_bwd_v3_impl), the backward fused_qkv_attention dispatches to when
// the v4 row no longer fits the TPU's VMEM budget and before the blockwise
// v5 kernels take over; and ::_bwd_kernel (I', v1, launched by
// _run_bwd_v1_impl under attention_pallas) and ::_bwd_kernel_v2 (J',
// launched by _run_bwd_v2_impl under fused_attention_v2). The three compute
// one function and differ only in their TPU grids (v1 one program per
// (image, head) over N padded to 128, v2 one per image over a chunk of
// heads sized for VMEM, v3 the packed rows transposed first); on the card
// one kernel pair serves all three through rank-4 tensor maps over (64, N,
// H, B) with each operand's (row, head, image) strides, as the forward's.
// Nothing transposes qkv: the TMA boxes read the packed rows in place.
//
// The function, as the TPU kernels compute it: s = q.k^T * scale in fp32,
// the row's true max m, p = exp(s - m) * (1/l) with l the row's sum, and
//   dv = bf16(p)^T . do,  dp = do . v^T,  delta = rowsum(dp * p) in fp32,
//   ds = bf16(p * (dp - delta) * scale),  dq = ds . k,  dk = ds^T . q,
// fp32 sums, each output rounded to bf16 once. No atomics, every sum in a
// fixed order: reruns give the same bits.
//
// What bounds it on the H100: 10*N^2*64 tensor FLOPs a head against
// 7*N*64*2 bytes (q, k, v, do read once; dq, dk, dv written once), about
// N/1.4 FLOP/byte: at N = 197 (b128, I' and J') the bytes bound it (0.081
// ms), at N = 577 (b16, K') both are near (0.041 ms). Past that, the
// exponentials (one a score on the SFUs, in each sweep that forms p) and
// the rounding of p and ds into register fragments.
//
// Design: two launches over a [3, B, H, N] fp32 scratch of row statistics
// (max in base-2 units, 1/l, delta), each block one consumer warpgroup and
// one producer warp whose lane 0 issues every TMA load into 128-byte
// swizzled tiles behind full/empty mbarriers. No reduction across blocks.
// * Query-major (dq and the statistics): a block owns a 64-row query tile,
//   its Q and dO loaded once; 64-key K and V tiles stream through 3-stage
//   rings. S = Q.K^T and dP = dO.V^T are wgmma m64n64k16 with both operands
//   K-major in shared memory. Sweep 1 keeps each row's running max and sum
//   (the sum rescaled when the max moves): the true max and 1/l. Sweep 2
//   forms p and sums delta. Sweep 3 forms ds, rounds it straight into the
//   register A fragments of dq += ds.K (K the MN-major B operand). The keys
//   past N are masked on the last key tile only, behind a uniform branch
//   (a select on every tile made kernel L 1.27x slower). dq is staged in
//   the Q tile and stored by TMA, which drops rows past N.
// * Key-major (dk, dv): a block owns a 64-key tile of K and V; Q and dO
//   tiles stream through one 3-stage ring with their rows' statistics
//   (copied in by the producer warp's 32 lanes, which all arrive on the
//   stage's barrier). It computes the transposed products S^T = K.Q^T and
//   dP^T = V.dO^T, so p^T and ds^T sit in the accumulators' rows of keys
//   and go straight into the register A fragments of dv += p^T.dO and dk +=
//   ds^T.Q (dO and Q the MN-major B operands): no transpose of p or ds.
//   The query rows past N arrive as zeros with zero statistics, so their p
//   is 0 and they add nothing; the key rows past N are never stored.
// * p in the key-major kernel is the query-major one's function (base-2
//   exponent, one FFMA and ex2.approx a score), not its bits.
// * Two blocks an SM (five warps each: ptxas may give 168 registers a
//   thread), so one block's exponentials overlap the other's wgmmas.
#include "attention_sm90.cuh"

namespace {

constexpr int kStages = 3;         // the streamed rings
constexpr int kBlocksPerSm = 2;

struct BwdMaps {
  CUtensorMap q, k, v, dout, dq, dk, dv;
};

struct BwdParams {
  BwdMaps maps;
  float* stats;      // [3, B, H, N]: row max (base-2 units), 1/l, delta
  int n;
  float scale;
  float scale_log2;  // scale * log2(e): the scores in base-2 units
};

// D[64x64] = A.B^T over head_dim 64: both operands' 64 rows K-major in
// shared memory (S = Q.K^T, dP = dO.V^T and their transposes)
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss(d, kmajor_desc(a_addr + 32 * kk), kmajor_desc(b_addr + 32 * kk), kk > 0);
}

// D[64x64] += A.B over 64 rows of B: A in register fragments (four k16
// steps), B's rows MN-major in shared memory (dq += ds.K, dv += p^T.dO,
// dk += ds^T.Q)
__device__ __forceinline__ void issue_rs(float (&d)[32], const uint32_t (&a)[4][4],
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_mnmajor(d, a[kk], mnmajor_desc(b_addr + 2048 * kk), 1);
}

// one accumulator element's value x (element i of 32) into the bf16 A
// fragments of its k16 step: a[i / 8][(i / 2) % 4] holds elements 2k, 2k+1
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// the scores of keys at or past n set to -inf, on the tile whose first key is
// key0 (a uniform branch: only the last key tile can hold such keys)
__device__ __forceinline__ void mask_keys(float (&s)[32], int key0, int t, int n) {
  if (key0 + kTileRows > n) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (key0 + (i >> 2) * 8 + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
  }
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

struct QBarriers {
  uint64_t q_full, k_full[kStages], k_empty[kStages], v_full[kStages], v_empty[kStages];
};

// shared memory from a 1024-byte aligned base: the K ring, the V ring, the
// Q tile (dq's staging tile once the last S is done), the dO tile, the
// barriers
struct QLayout {
  static constexpr int kV = kStages * kTileBytes;
  static constexpr int kQ = 2 * kV;
  static constexpr int kDo = kQ + kTileBytes;
  static constexpr int kBars = kDo + kTileBytes;
  static constexpr int kBytes = kBars + (int)sizeof(QBarriers) + 1024;
};

// query-major: dq of the block's 64 query rows, and their statistics
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    attn_bwd_q_sm90_kernel(const __grid_constant__ BwdParams p) {
  using L = QLayout;
  constexpr int S = kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = smem;
  uint8_t* sv = smem + L::kV;
  uint8_t* sq = smem + L::kQ;
  uint8_t* sdo = smem + L::kDo;
  QBarriers& bar = *reinterpret_cast<QBarriers*>(smem + L::kBars);

  const int n = p.n, tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int key_tiles = (n + kTileRows - 1) / kTileRows;

  if (threadIdx.x == 0) {
    mbar_init(&bar.q_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&bar.k_full[i], 1), mbar_init(&bar.k_empty[i], kConsumers);
      mbar_init(&bar.v_full[i], 1), mbar_init(&bar.v_empty[i], kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: one lane issues every TMA load ----
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&bar.q_full, 2 * kTileBytes);
      tma_load_4d(sq, &p.maps.q, &bar.q_full, 0, tile * kTileRows, h, b);
      tma_load_4d(sdo, &p.maps.dout, &bar.q_full, 0, tile * kTileRows, h, b);
      // sweep 1: K tiles; sweeps 2 and 3: K and V tiles
      int ki = 0, vi = 0;
      for (int sweep = 0; sweep < 3; ++sweep) {
        for (int j = 0; j < key_tiles; ++j) {
          const int ks = ki % S;
          mbar_wait(&bar.k_empty[ks], ((ki / S) & 1) ^ 1);
          mbar_expect_tx(&bar.k_full[ks], kTileBytes);
          tma_load_4d(sk + ks * kTileBytes, &p.maps.k, &bar.k_full[ks], 0, j * kTileRows, h, b);
          ++ki;
          if (sweep > 0) {
            const int vs = vi % S;
            mbar_wait(&bar.v_empty[vs], ((vi / S) & 1) ^ 1);
            mbar_expect_tx(&bar.v_full[vs], kTileBytes);
            tma_load_4d(sv + vs * kTileBytes, &p.maps.v, &bar.v_full[vs], 0, j * kTileRows, h, b);
            ++vi;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: the warpgroup's 64 query rows ----
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = p.scale_log2, scale = p.scale;
  const uint32_t q_addr = smem_u32(sq), do_addr = smem_u32(sdo);
  const uint32_t k_base = smem_u32(sk), v_base = smem_u32(sv);
  float s[32], dp[32];
  int ki = 0, vi = 0;
  mbar_wait(&bar.q_full, 0);

  // sweep 1: each row's max (base-2 units) and sum; every key tile holds a
  // key < n, so the new max is finite, and ex2(-inf) = 0 clears the first
  // tile's empty sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < key_tiles; ++j, ++ki) {
    const int ks = ki % S;
    mbar_wait(&bar.k_full[ks], (ki / S) & 1);
    wgmma_fence();
    issue_ss(s, q_addr, k_base + ks * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&bar.k_empty[ks]);
    mask_keys(s, j * kTileRows, t, n);
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      t0 = fmaxf(t0, fmaxf(s[i], s[i + 1]));
      t1 = fmaxf(t1, fmaxf(s[i + 2], s[i + 3]));
    }
    const float n0 = fmaxf(m0, quad_max(t0) * c), n1 = fmaxf(m1, quad_max(t1) * c);
    float e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      e0 += ex2(fmaf(s[i], c, -n0)) + ex2(fmaf(s[i + 1], c, -n0));
      e1 += ex2(fmaf(s[i + 2], c, -n1)) + ex2(fmaf(s[i + 3], c, -n1));
    }
    l0 = fmaf(l0, ex2(m0 - n0), e0), l1 = fmaf(l1, ex2(m1 - n1), e1);
    m0 = n0, m1 = n1;
  }
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

  // sweep 2: delta = rowsum(dp * p), p in fp32
  float d0 = 0.f, d1 = 0.f;
  for (int j = 0; j < key_tiles; ++j, ++ki, ++vi) {
    const int ks = ki % S, vs = vi % S;
    mbar_wait(&bar.k_full[ks], (ki / S) & 1);
    mbar_wait(&bar.v_full[vs], (vi / S) & 1);
    wgmma_fence();
    issue_ss(s, q_addr, k_base + ks * kTileBytes);
    issue_ss(dp, do_addr, v_base + vs * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    mbar_arrive(&bar.k_empty[ks]);
    mbar_arrive(&bar.v_empty[vs]);
    mask_keys(s, j * kTileRows, t, n);
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      d0 += ex2(fmaf(s[i], c, -m0)) * inv0 * dp[i] + ex2(fmaf(s[i + 1], c, -m0)) * inv0 * dp[i + 1];
      d1 += ex2(fmaf(s[i + 2], c, -m1)) * inv1 * dp[i + 2] +
            ex2(fmaf(s[i + 3], c, -m1)) * inv1 * dp[i + 3];
    }
  }
  d0 = quad_sum(d0), d1 = quad_sum(d1);

  // sweep 3: ds = bf16(p * (dp - delta) * scale) as the A fragments of
  // dq += ds.K
  float dq[32];
  zero(dq);
  for (int j = 0; j < key_tiles; ++j, ++ki, ++vi) {
    const int ks = ki % S, vs = vi % S;
    const uint32_t k_addr = k_base + ks * kTileBytes;
    mbar_wait(&bar.k_full[ks], (ki / S) & 1);
    mbar_wait(&bar.v_full[vs], (vi / S) & 1);
    fence_regs(dq);
    wgmma_fence();
    issue_ss(s, q_addr, k_addr);
    issue_ss(dp, do_addr, v_base + vs * kTileBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    mbar_arrive(&bar.v_empty[vs]);
    mask_keys(s, j * kTileRows, t, n);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool r1 = i & 2;
      const float pi = ex2(fmaf(s[i], c, r1 ? -m1 : -m0)) * (r1 ? inv1 : inv0);
      s[i] = pi * (dp[i] - (r1 ? d1 : d0)) * scale;
    }
    uint32_t da[4][4];
    pack_frags(da, s);
    settle_p(da);
    wgmma_fence();
    issue_rs(dq, da, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    settle_p(da);
    mbar_arrive(&bar.k_empty[ks]);
  }

  // the rows' statistics, for the rows < n
  const int r0 = tile * kTileRows + warp * 16 + g;
  if (t == 0) {
    const long long plane = (long long)gridDim.z * gridDim.y * n;
    float* st = p.stats + ((long long)b * gridDim.y + h) * n;
    if (r0 < n) st[r0] = m0, st[plane + r0] = inv0, st[2 * plane + r0] = d0;
    if (r0 + 8 < n) st[r0 + 8] = m1, st[plane + r0 + 8] = inv1, st[2 * plane + r0 + 8] = d1;
  }
  // the S wgmmas are done with the Q tile: stage dq there, then one TMA
  // store, which drops rows past n
  named_sync(1, kConsumers);
  stage_o(dq, sq, warp, g, t);
  fence_proxy_async();
  named_sync(1, kConsumers);
  if (threadIdx.x == 0) {
    tma_store_4d(&p.maps.dq, sq, 0, tile * kTileRows, h, b);
    bulk_commit();
    bulk_wait<0>();
  }
}

struct KvBarriers {
  uint64_t kv_full, full[kStages], empty[kStages];
};

// a ring stage's row statistics: max, 1/l and delta of its 64 query rows
constexpr int kStatsBytes = 3 * kTileRows * 4;

// shared memory from a 1024-byte aligned base: the K tile (dk's staging
// tile at the end), the V tile (dv's), the Q ring, the dO ring, the
// statistics ring, the barriers
struct KvLayout {
  static constexpr int kV = kTileBytes;
  static constexpr int kQ = 2 * kTileBytes;
  static constexpr int kDo = kQ + kStages * kTileBytes;
  static constexpr int kStats = kDo + kStages * kTileBytes;
  static constexpr int kBars = kStats + kStages * kStatsBytes;
  static constexpr int kBytes = kBars + (int)sizeof(KvBarriers) + 1024;
};

// key-major: dk and dv of the block's 64 keys
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    attn_bwd_kv_sm90_kernel(const __grid_constant__ BwdParams p) {
  using L = KvLayout;
  constexpr int S = kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = smem;
  uint8_t* sv = smem + L::kV;
  uint8_t* sq = smem + L::kQ;
  uint8_t* sdo = smem + L::kDo;
  float* sst = reinterpret_cast<float*>(smem + L::kStats);
  KvBarriers& bar = *reinterpret_cast<KvBarriers*>(smem + L::kBars);

  const int n = p.n, tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q_tiles = (n + kTileRows - 1) / kTileRows;

  if (threadIdx.x == 0) {
    mbar_init(&bar.kv_full, 1);
    for (int i = 0; i < S; ++i) mbar_init(&bar.full[i], 32), mbar_init(&bar.empty[i], kConsumers);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: lane 0 issues the TMA loads, all 32 lanes copy
    // each query tile's statistics and arrive on its stage ----
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0) {
      mbar_expect_tx(&bar.kv_full, 2 * kTileBytes);
      tma_load_4d(sk, &p.maps.k, &bar.kv_full, 0, tile * kTileRows, h, b);
      tma_load_4d(sv, &p.maps.v, &bar.kv_full, 0, tile * kTileRows, h, b);
    }
    const long long plane = (long long)gridDim.z * gridDim.y * n;
    const float* st = p.stats + ((long long)b * gridDim.y + h) * n;
    for (int i = 0; i < q_tiles; ++i) {
      const int s = i % S;
      mbar_wait(&bar.empty[s], ((i / S) & 1) ^ 1);
      // rows past n: max 0, 1/l 0, delta 0, so p = 0 and ds = 0
      float* dst = sst + s * (3 * kTileRows);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = lane + 32 * k, row = i * kTileRows + r;
        const bool in = row < n;
        dst[r] = in ? st[row] : 0.f;
        dst[kTileRows + r] = in ? st[plane + row] : 0.f;
        dst[2 * kTileRows + r] = in ? st[2 * plane + row] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&bar.full[s], 2 * kTileBytes);
        tma_load_4d(sq + s * kTileBytes, &p.maps.q, &bar.full[s], 0, i * kTileRows, h, b);
        tma_load_4d(sdo + s * kTileBytes, &p.maps.dout, &bar.full[s], 0, i * kTileRows, h, b);
      } else {
        mbar_arrive(&bar.full[s]);
      }
    }
    return;
  }

  // ---- consumers: the warpgroup's 64 keys ----
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = p.scale_log2, scale = p.scale;
  const uint32_t k_addr = smem_u32(sk), v_addr = smem_u32(sv);
  const uint32_t q_base = smem_u32(sq), do_base = smem_u32(sdo);
  float st[32], dpt[32], dk[32], dv[32];
  zero(dk);
  zero(dv);
  mbar_wait(&bar.kv_full, 0);
  for (int i = 0; i < q_tiles; ++i) {
    const int s = i % S;
    const uint32_t q_addr = q_base + s * kTileBytes, do_addr = do_base + s * kTileBytes;
    mbar_wait(&bar.full[s], (i / S) & 1);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
    issue_ss(st, k_addr, q_addr);    // S^T = K.Q^T: rows keys, columns queries
    issue_ss(dpt, v_addr, do_addr);  // dP^T = V.dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    // column 8j + 2t + e of the tile is query row 8j + 2t + e: p^T and ds^T
    const float* row_m = sst + s * (3 * kTileRows);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * j + 2 * t + e;
        const float m = row_m[q], inv = row_m[kTileRows + q], delta = row_m[2 * kTileRows + q];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i2 = 4 * j + 2 * r + e;
          const float pt = ex2(fmaf(st[i2], c, -m)) * inv;
          st[i2] = pt;
          dpt[i2] = pt * (dpt[i2] - delta) * scale;
        }
      }
    }
    uint32_t pa[4][4], da[4][4];
    pack_frags(pa, st);
    pack_frags(da, dpt);
    settle_p(pa);
    settle_p(da);
    wgmma_fence();
    issue_rs(dv, pa, do_addr);  // dv += p^T.dO
    issue_rs(dk, da, q_addr);   // dk += ds^T.Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    settle_p(pa);
    settle_p(da);
    mbar_arrive(&bar.empty[s]);
  }

  // K and V are done with: stage dk and dv there, then two TMA stores,
  // which drop rows past n
  named_sync(1, kConsumers);
  stage_o(dk, sk, warp, g, t);
  stage_o(dv, sv, warp, g, t);
  fence_proxy_async();
  named_sync(1, kConsumers);
  if (threadIdx.x == 0) {
    tma_store_4d(&p.maps.dk, sk, 0, tile * kTileRows, h, b);
    tma_store_4d(&p.maps.dv, sv, 0, tile * kTileRows, h, b);
    bulk_commit();
    bulk_wait<0>();
  }
}

// once a process: the SM's shared memory carved out in full for both
// kernels, and their dynamic shared memory
cudaError_t prepare() {
  static const cudaError_t state = [] {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_q_sm90_kernel,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) err = set_smem(attn_bwd_q_sm90_kernel, QLayout::kBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_kv_sm90_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) err = set_smem(attn_bwd_kv_sm90_kernel, KvLayout::kBytes);
    return err;
  }();
  return state;
}

// ops[0..6] = q, k, v, dout, dq, dk, dv
int launch_bwd(const Operand (&ops)[7], float* stats, int batch, int n, int heads, int head_dim,
               float scale, cudaStream_t stream) {
  if (head_dim != kD || batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || n <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare();
  BwdParams p;
  p.stats = stats;
  p.n = n;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  CUtensorMap* maps[7] = {&p.maps.q,  &p.maps.k,  &p.maps.v, &p.maps.dout,
                          &p.maps.dq, &p.maps.dk, &p.maps.dv};
  for (int i = 0; i < 7 && err == cudaSuccess; ++i)
    err = encode_rows_map(maps[i], ops[i].p, n, heads, batch, ops[i].sn, ops[i].sh, ops[i].sb,
                          kTileRows);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTileRows - 1) / kTileRows, heads, batch);
  attn_bwd_q_sm90_kernel<<<grid, kThreads, QLayout::kBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_kv_sm90_kernel<<<grid, kThreads, KvLayout::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K': qkv [batch, n, 3*heads*64] bf16; dout element (b, h, i, c) at
// dout + b*do_sb + h*do_sh + i*do_sn + c (rows 16-byte aligned); dqkv like
// qkv; stats: 3*batch*heads*n floats of scratch.
GAVIT_EXPORT int gavit_attention_long_bwd(const void* qkv, const void* dout, void* dqkv,
                                          void* stats, int batch, int n, int heads, int head_dim,
                                          long long do_sb, long long do_sh, long long do_sn,
                                          float scale, void* stream) {
  const long long rs = 3LL * heads * kD, hs = (long long)heads * kD;
  const bf16* rows = static_cast<const bf16*>(qkv);
  bf16* drows = static_cast<bf16*>(dqkv);
  // q, k, v at columns h*64, (H+h)*64, (2H+h)*64 of each packed row
  const Operand ops[7] = {{rows, n * rs, kD, rs},      {rows + hs, n * rs, kD, rs},
                          {rows + 2 * hs, n * rs, kD, rs}, {dout, do_sb, do_sh, do_sn},
                          {drows, n * rs, kD, rs},     {drows + hs, n * rs, kD, rs},
                          {drows + 2 * hs, n * rs, kD, rs}};
  return launch_bwd(ops, static_cast<float*>(stats), batch, n, heads, head_dim, scale,
                    static_cast<cudaStream_t>(stream));
}

// I' and J': q, k, v, dout -> dq, dk, dv, all [batch, heads, n, 64] bf16 through strides
// (sb, sh, sn) in strides[0..20] in that order (rows 16-byte aligned); stats:
// 3*batch*heads*n floats of scratch.
GAVIT_EXPORT int gavit_attention_bhnd_bwd(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          void* stats, const long long* strides, int batch,
                                          int n, int heads, int head_dim, float scale,
                                          void* stream) {
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  Operand ops[7];
  for (int i = 0; i < 7; ++i)
    ops[i] = Operand{ptrs[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return launch_bwd(ops, static_cast<float*>(stats), batch, n, heads, head_dim, scale,
                    static_cast<cudaStream_t>(stream));
}
