// Kernels A', K', I', J' and L': the bf16 multi-head self-attention
// backwards for Hopper, one pair of wgmma kernels on TMA-fed tiles. A' runs
// on the packed qkv rows up to 224 tokens (224 px: N = 197), K' on them past
// 224 up to K_MAX_N = 749 (384 px: N = 577), L' past that (512 px: N =
// 1025, 1024 px: N = 4097); I' and J' on separate q, k, v [B, H, N, d]
// tensors through their strides (N from 1 up: I' to 640, J' at any N). The
// forwards A, K, I, J and L are attention_fwd_sm90.cu's.
//
// Replaces: gavit_tpu/ops/attention.py::_bwd_kernel_v4 (A', launched by
// _run_bwd_v4_impl, the VJP of _fused_qkv_flat), ::_bwd_kernel_v3 (K',
// launched by _run_bwd_v3_impl), ::_bwd_kernel (I', v1, launched by
// _run_bwd_v1_impl under attention_pallas), ::_bwd_kernel_v2 (J', launched
// by _run_bwd_v2_impl under fused_attention_v2), and ::_dq_kernel_v5 with
// ::_dkv_kernel_v5 (L', launched by _run_bwd_v5_impl: the backward of
// flash_attention_large). v1-v4 compute one function and differ only in
// their TPU grids (v1 one program per (image, head) over N padded to 128,
// v2 one per image over a chunk of heads sized for VMEM, v3 the packed rows
// transposed first, v4 a whole row of 224 keys in VMEM); v5 reads the
// forward's saved lse instead of the row statistics. On the card one pair
// of kernel bodies serves all five through rank-4 tensor maps over (64, N,
// H, B) with each operand's (row, head, image) strides. Nothing transposes
// qkv: the TMA boxes read the packed rows in place.
//
// The functions, as the TPU kernels compute them: s = q.k^T * scale in fp32,
//   A', K', I', J': the row's true max m, p = exp(s - m) * (1/l) with l the
//     row's sum, delta = rowsum(dp * p) in fp32;
//   L': p = exp(s - lse) from kernel L's fp32 lse, delta = rowsum(do * o)
//     in fp32 from L's o;
// then dv = bf16(p)^T . do, dp = do . v^T, ds = bf16(p * (dp - delta) *
// scale), dq = ds . k, dk = ds^T . q, fp32 sums, each output rounded to bf16
// once. No atomics, every sum in a fixed order: reruns give the same bits.
//
// What bounds it on the H100: 10*N^2*64 tensor FLOPs a head against
// 7*N*64*2 bytes (q, k, v, do read once; dq, dk, dv written once; L' also
// reads o and lse), about N/1.4 FLOP/byte: at N = 197 (b128, A', I' and J')
// the bytes bound it (0.081 ms), at N = 577 (b16, K') both are near (0.041
// ms), at N = 1025 (b32, L') the tensor cores (0.261 ms). Past that, the
// exponentials (one a score on the SFUs in each sweep that forms p) and the
// rounding of p and ds into register fragments.
//
// Design: two launches over a [3, B, H, N] fp32 scratch of row statistics
// (max in base-2 units, the multiplier 1/l, delta), each block one consumer
// warpgroup and one producer warp whose lane 0 issues every TMA load into
// 128-byte swizzled tiles behind full/empty mbarriers. No reduction across
// blocks.
// * Query-major (dq and the statistics): a block owns a 64-row query tile,
//   its Q and dO loaded once; 64-key K and V tiles stream through 3-stage
//   rings. S = Q.K^T and dP = dO.V^T are wgmma m64n64k16 with both operands
//   K-major in shared memory. The exact mode (K', I', J') runs three
//   sweeps. Sweep 1 keeps each row's running max and sum (the sum rescaled
//   when the max moves): the true max and 1/l. Sweep 2 forms p and sums
//   delta. Sweep 3 forms p while dP is still on the tensor cores, then ds,
//   rounded straight into the register A fragments of dq += ds.K (K the
//   MN-major B operand). The lse mode (L') needs only sweep 3: its prologue
//   loads the O tile by TMA beside Q and dO, sums delta = rowsum(do * o)
//   from the two swizzled tiles (two threads a row, each 32 columns in
//   order, then the pair's sum), and takes the max slot as lse * log2(e)
//   with the multiplier 1: 3 products and one exponential a score instead
//   of 6 and 3. A' has a query-major launch of its own for rows of up to
//   224 keys (below). The keys past N are masked on the last key tile
//   only, behind a uniform branch (a select on every tile made kernel L
//   1.27x slower). dq is staged in shared memory and stored by TMA, which
//   drops rows past N; the statistics of the rows < N go to the scratch.
// * Key-major (dk, dv): a block owns a 64-key tile of K and V; Q and dO
//   tiles stream through one 3-stage ring with their rows' statistics
//   (copied in by the producer warp's 32 lanes, which all arrive on the
//   stage's barrier). It computes the transposed products S^T = K.Q^T and
//   dP^T = V.dO^T, so p^T and ds^T sit in the accumulators' rows of keys
//   and go straight into the register A fragments of dv += p^T.dO and dk +=
//   ds^T.Q (dO and Q the MN-major B operands): no transpose of p or ds.
//   p^T forms while dP^T is on the tensor cores. The query rows past N
//   arrive as zeros (TMA fills past the map's extent whatever lies in
//   memory there) with zero statistics, the multiplier included, so their
//   p is 0 and they add nothing; the key rows past N are never stored.
//   K', I', J' and L' run this body; A' has a key-major launch of its own
//   on the same tile step (below). A' takes the last query tile of its
//   short row at the width W (16, 32 or 64) that holds its rows < N (N =
//   197: 16 of 64), and its query-major launch the last key tile likewise.
// * p in the key-major kernel is the query-major one's function (base-2
//   exponent, one FFMA and ex2.approx a score), not its bits.
// * Two blocks an SM (five warps each: ptxas may give 168 registers a
//   thread), so one block's exponentials overlap the other's wgmmas.
// * Each entry has kernel names of its own (attn_bwd_* for K', I', J';
//   attn_short_bwd_*<W> for A'; attn_large_bwd_* for L'), so that a
//   profile tells them apart.
#include "attention_sm90.cuh"

namespace {

constexpr int kStages = 3;         // the streamed rings
constexpr int kBlocksPerSm = 2;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdMaps {
  CUtensorMap q, k, v, dout, dq, dk, dv;
  CUtensorMap o;                             // L' only
  CUtensorMap k_row, v_row, q_row, dout_row;  // A' only: 256-row boxes
};

struct BwdParams {
  BwdMaps maps;
  float* stats;       // [3, B, H, N]: row max (base-2 units), multiplier, delta
  const float* lse;   // L': kernel L's [B, H, N] log-sum-exp; else unused
  int n;
  int tiles;          // A': the 64-row tiles a block takes
  float scale;
  float scale_log2;  // scale * log2(e): the scores in base-2 units
};

// D[64xW] = A.B^T over head_dim 64 (W = 16, 32 or 64 rows of B): both
// operands' rows K-major in shared memory (S = Q.K^T, dP = dO.V^T and their
// transposes)
template <int W = kTileRows>
__device__ __forceinline__ void issue_ss(float (&d)[W / 2], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t a = kmajor_desc(a_addr + 32 * kk), b = kmajor_desc(b_addr + 32 * kk);
    if constexpr (W == 64)
      wgmma_m64n64k16_ss(d, a, b, kk > 0);
    else if constexpr (W == 32)
      wgmma_m64n32k16_ss(d, a, b, kk > 0);
    else
      wgmma_m64n16k16_ss(d, a, b, kk > 0);
  }
}

// D[64x64] += A.B over W rows of B: A in register fragments (W / 16 k16
// steps), B's rows MN-major in shared memory (dq += ds.K, dv += p^T.dO,
// dk += ds^T.Q)
template <int W = kTileRows>
__device__ __forceinline__ void issue_rs(float (&d)[32], const uint32_t (&a)[W / 16][4],
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_m64n64k16_mnmajor(d, a[kk], mnmajor_desc(b_addr + 2048 * kk), 1);
}

// one accumulator element's value x (element i of W / 2) into the bf16 A
// fragments of its k16 step: a[i / 8][(i / 2) % 4] holds elements 2k, 2k+1
template <int W = kTileRows>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[W / 16][4], const float (&x)[W / 2]) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// the scores of keys at or past n set to -inf, on the W-key tile whose
// first key is key0 (a uniform branch: only the last key tile can hold
// such keys)
template <int W = kTileRows>
__device__ __forceinline__ void mask_keys(float (&s)[W / 2], int key0, int t, int n) {
  if (key0 + W > n) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i)
      if (key0 + (i >> 2) * 8 + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
  }
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// fp32 sum of a[r][c] * b[r][c] over half `half` of row r's 64 columns (32,
// in order) of two 128-byte swizzled tiles
__device__ __forceinline__ float half_row_dot(const uint8_t* a, const uint8_t* b, int r,
                                              int half) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int off = r * kRowBytes + (((4 * half + j) ^ (r & 7)) << 4);
    const uint4 ua = *reinterpret_cast<const uint4*>(a + off);
    const uint4 ub = *reinterpret_cast<const uint4*>(b + off);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&ua);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&ub);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(pa[e]), fb = __bfloat1622float2(pb[e]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
  return acc;
}

// one W-key slice of dq += ds.K from key key0 on (W: 64, or the width that
// holds a short row's last keys < n): S and dP formed, p while dP is on the
// tensor cores, ds = bf16(p * (dp - delta) * scale) rounded straight into
// the A fragments
template <int W = kTileRows>
__device__ __forceinline__ void dq_slice(float (&dq)[32], uint32_t q_addr, uint32_t do_addr,
                                         uint32_t k_addr, uint32_t v_addr, int key0, int t, int n,
                                         float c, float scale, float m0, float m1, float inv0,
                                         float inv1, float d0, float d1) {
  float sj[W / 2], dpj[W / 2];
  fence_regs(dq);
  wgmma_fence();
  issue_ss<W>(sj, q_addr, k_addr);
  wgmma_commit();
  issue_ss<W>(dpj, do_addr, v_addr);
  wgmma_commit();
  wgmma_wait<1>();  // S
  fence_regs(sj);
  mask_keys<W>(sj, key0, t, n);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const bool r1 = i & 2;
    sj[i] = ex2(fmaf(sj[i], c, r1 ? -m1 : -m0)) * (r1 ? inv1 : inv0);
  }
  wgmma_wait<0>();
  fence_regs(dpj);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) sj[i] = sj[i] * (dpj[i] - (i & 2 ? d1 : d0)) * scale;
  uint32_t da[W / 16][4];
  pack_frags<W>(da, sj);
  settle_p(da);
  wgmma_fence();
  issue_rs<W>(dq, da, k_addr);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  settle_p(da);
}

struct QBarriers {
  uint64_t q_full, k_full[kStages], k_empty[kStages], v_full[kStages], v_empty[kStages];
};

// shared memory from a 1024-byte aligned base: the K ring, the V ring, the
// Q tile (dq's staging tile once the last S is done), the dO tile, the O
// tile (lse mode only), the barriers
template <bool kLse>
struct QLayout {
  static constexpr int kV = kStages * kTileBytes;
  static constexpr int kQ = 2 * kV;
  static constexpr int kDo = kQ + kTileBytes;
  static constexpr int kO = kDo + kTileBytes;
  static constexpr int kBars = kO + (kLse ? kTileBytes : 0);
  static constexpr int kBytes = kBars + (int)sizeof(QBarriers) + 1024;
};

// query-major: dq of the block's 64 query rows, and their statistics;
// kLse: from kernel L's lse and o (L'), else from the scores (three sweeps)
template <bool kLse>
__device__ __forceinline__ void bwd_q(const BwdParams& p) {
  using L = QLayout<kLse>;
  constexpr int S = kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = smem;
  uint8_t* sv = smem + L::kV;
  uint8_t* sq = smem + L::kQ;
  uint8_t* sdo = smem + L::kDo;
  uint8_t* so = smem + L::kO;
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
      mbar_expect_tx(&bar.q_full, (kLse ? 3 : 2) * kTileBytes);
      tma_load_4d(sq, &p.maps.q, &bar.q_full, 0, tile * kTileRows, h, b);
      tma_load_4d(sdo, &p.maps.dout, &bar.q_full, 0, tile * kTileRows, h, b);
      if constexpr (kLse) tma_load_4d(so, &p.maps.o, &bar.q_full, 0, tile * kTileRows, h, b);
      // sweep 1: K tiles; sweeps 2 and 3: K and V tiles (the lse mode runs
      // sweep 3 only)
      int ki = 0, vi = 0;
      for (int sweep = kLse ? 2 : 0; sweep < 3; ++sweep) {
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
  const int r0 = tile * kTileRows + warp * 16 + g;  // this thread's rows r0, r0 + 8
  int ki = 0, vi = 0;
  // each row's max (base-2 units), multiplier and delta: rows g (0) and g+8 (1)
  float m0, m1, inv0, inv1, d0, d1;
  mbar_wait(&bar.q_full, 0);

  if constexpr (kLse) {
    // delta = rowsum(do * o): thread (g, t) sums half t & 1 of row g +
    // 8 (t >> 1) of its warp's 16; the quad's lanes 0 and 2 then hold rows
    // g and g + 8. Rows past n are TMA's zeros: delta 0.
    const float part = half_row_dot(so, sdo, warp * 16 + g + 8 * (t >> 1), t & 1);
    const float row = part + __shfl_xor_sync(0xffffffffu, part, 1);
    d0 = __shfl_sync(0xffffffffu, row, 4 * g);
    d1 = __shfl_sync(0xffffffffu, row, 4 * g + 2);
    const float* lse = p.lse + ((long long)b * gridDim.y + h) * n;
    m0 = r0 < n ? lse[r0] * kLog2e : 0.f;
    m1 = r0 + 8 < n ? lse[r0 + 8] * kLog2e : 0.f;
    inv0 = inv1 = 1.f;
  } else {
    // sweep 1: each row's max (base-2 units) and sum; every key tile holds
    // a key < n, so the new max is finite, and ex2(-inf) = 0 clears the
    // first tile's empty sum
    float s[32], dp[32];
    m0 = -INFINITY, m1 = -INFINITY;
    float l0 = 0.f, l1 = 0.f;
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
    inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

    // sweep 2: delta = rowsum(dp * p), p in fp32
    d0 = 0.f, d1 = 0.f;
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
        d0 += ex2(fmaf(s[i], c, -m0)) * inv0 * dp[i] +
              ex2(fmaf(s[i + 1], c, -m0)) * inv0 * dp[i + 1];
        d1 += ex2(fmaf(s[i + 2], c, -m1)) * inv1 * dp[i + 2] +
              ex2(fmaf(s[i + 3], c, -m1)) * inv1 * dp[i + 3];
      }
    }
    d0 = quad_sum(d0), d1 = quad_sum(d1);
  }

  // sweep 3: ds = bf16(p * (dp - delta) * scale) as the A fragments of
  // dq += ds.K
  float dq[32];
  zero(dq);
  for (int j = 0; j < key_tiles; ++j, ++ki, ++vi) {
    const int ks = ki % S, vs = vi % S;
    mbar_wait(&bar.k_full[ks], (ki / S) & 1);
    mbar_wait(&bar.v_full[vs], (vi / S) & 1);
    dq_slice(dq, q_addr, do_addr, k_base + ks * kTileBytes, v_base + vs * kTileBytes,
             j * kTileRows, t, n, c, scale, m0, m1, inv0, inv1, d0, d1);
    mbar_arrive(&bar.v_empty[vs]);
    mbar_arrive(&bar.k_empty[ks]);
  }

  // the rows' statistics, for the rows < n
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

// a ring stage's row statistics: max, multiplier and delta of its 64 query
// rows
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

// one query tile of the key-major launch: its first W rows (all 64, or the
// rows < n of a short row's last tile) into dk and dv. Column 8j + 2t + e
// of the transposed products is query row 8j + 2t + e of the tile, whose
// statistics are row_m[q], row_m[64 + q], row_m[128 + q].
template <int W = kTileRows>
__device__ __forceinline__ void kv_tile(float (&dk)[32], float (&dv)[32], uint32_t k_addr,
                                        uint32_t v_addr, uint32_t q_addr, uint32_t do_addr,
                                        const float* row_m, int t, float c, float scale) {
  float st[W / 2], dpt[W / 2];
  fence_regs(dk);
  fence_regs(dv);
  wgmma_fence();
  issue_ss<W>(st, k_addr, q_addr);    // S^T = K.Q^T: rows keys, columns queries
  wgmma_commit();
  issue_ss<W>(dpt, v_addr, do_addr);  // dP^T = V.dO^T
  wgmma_commit();
  wgmma_wait<1>();  // S^T: p^T forms while dP^T is on the tensor cores
  fence_regs(st);
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 8 * j + 2 * t + e;
      const float m = row_m[q], inv = row_m[kTileRows + q];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i2 = 4 * j + 2 * r + e;
        st[i2] = ex2(fmaf(st[i2], c, -m)) * inv;
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(dpt);
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float delta = row_m[2 * kTileRows + 8 * j + 2 * t + e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i2 = 4 * j + 2 * r + e;
        dpt[i2] = st[i2] * (dpt[i2] - delta) * scale;
      }
    }
  }
  uint32_t pa[W / 16][4], da[W / 16][4];
  pack_frags<W>(pa, st);
  pack_frags<W>(da, dpt);
  settle_p(pa);
  settle_p(da);
  wgmma_fence();
  issue_rs<W>(dv, pa, do_addr);  // dv += p^T.dO
  issue_rs<W>(dk, da, q_addr);   // dk += ds^T.Q
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  settle_p(pa);
  settle_p(da);
}

// key-major: dk and dv of the block's 64 keys (K', I', J', L')
__device__ __forceinline__ void bwd_kv(const BwdParams& p) {
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
      // rows past n: max 0, multiplier 0, delta 0, so p = 0 and ds = 0
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
  float dk[32], dv[32];
  zero(dk);
  zero(dv);
  mbar_wait(&bar.kv_full, 0);
  for (int i = 0; i < q_tiles; ++i) {
    const int s = i % S;
    mbar_wait(&bar.full[s], (i / S) & 1);
    kv_tile(dk, dv, k_addr, v_addr, q_base + s * kTileBytes, do_base + s * kTileBytes,
            sst + s * (3 * kTileRows), t, c, scale);
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

// ---- A' on short rows (n <= 224): its own query-major launch ----
//
// The whole key row of up to 224 keys is one wgmma N extent (m64n224k16,
// as kernel A's single pass), so S is formed once and the true max and sum
// come from the registers (112 fp32 a thread); p stays there in fp32 while
// dP streams in 32-key chunks (16 fp32 a thread) for delta. Then S and dP
// are formed again tile by tile for ds and dq += ds.K, as sweep 3, the
// last key tile at the width W that holds the keys < n (p, dP, dq and the
// A fragments do not fit 168 registers beside the 112 of the row). At N =
// 197 a query row's products span 1072 key columns (224 + 224 + 3 x 208)
// against the generic sweeps' 1536 (6 x 256), its exponentials 432 against
// 768. K and V arrive once a block as 256-row boxes (TMA's zeros
// past n), and the block takes a run of query tiles of one (image, head)
// through a ring of two Q and dO tiles; dq leaves through its own staging
// tile. Tried: dP in 64-key slices beside the row (32 fp32 a thread)
// spilled 256 bytes and serialised the wgmmas, 0.408 ms a call at b128
// against the generic pair's 0.384 (PERF.md §6, an H100 at 700 W).

constexpr int kShortKeys = 224;             // S's key row: one wgmma N extent
constexpr int kShortRows = 256;             // K, V, Q, dO boxes: four 64-row tiles
constexpr int kShortTiles = kShortRows / kTileRows;

struct ShortBarriers {
  uint64_t kv_full, q_full[2], q_empty[2];
};

// shared memory from a 1024-byte aligned base: K, V (256 rows each), the Q
// ring, the dO ring, dq's staging tile, the barriers
struct ShortLayout {
  static constexpr int kV = kShortRows * kRowBytes;
  static constexpr int kQ = 2 * kV;
  static constexpr int kDo = kQ + 2 * kTileBytes;
  static constexpr int kDq = kDo + 2 * kTileBytes;
  static constexpr int kBars = kDq + kTileBytes;
  static constexpr int kBytes = kBars + (int)sizeof(ShortBarriers) + 1024;
};

template <int W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    attn_short_bwd_q_sm90_kernel(const __grid_constant__ BwdParams p) {
  using L = ShortLayout;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = smem;
  uint8_t* sv = smem + L::kV;
  uint8_t* sq = smem + L::kQ;
  uint8_t* sdo = smem + L::kDo;
  uint8_t* sdq = smem + L::kDq;
  ShortBarriers& bar = *reinterpret_cast<ShortBarriers*>(smem + L::kBars);

  const int n = p.n, h = blockIdx.y, b = blockIdx.z;
  const int nt = (n + kTileRows - 1) / kTileRows;
  const int t_begin = blockIdx.x * p.tiles;
  const int t_end = min(t_begin + p.tiles, nt);

  if (threadIdx.x == 0) {
    mbar_init(&bar.kv_full, 1);
    for (int i = 0; i < 2; ++i) mbar_init(&bar.q_full[i], 1), mbar_init(&bar.q_empty[i], kConsumers);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: one lane issues every TMA load ----
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&bar.kv_full, 2 * L::kV);
      tma_load_4d(sk, &p.maps.k_row, &bar.kv_full, 0, 0, h, b);
      tma_load_4d(sv, &p.maps.v_row, &bar.kv_full, 0, 0, h, b);
      for (int tile = t_begin, qi = 0; tile < t_end; ++tile, ++qi) {
        const int qs = qi & 1;
        mbar_wait(&bar.q_empty[qs], ((qi >> 1) & 1) ^ 1);
        mbar_expect_tx(&bar.q_full[qs], 2 * kTileBytes);
        tma_load_4d(sq + qs * kTileBytes, &p.maps.q, &bar.q_full[qs], 0, tile * kTileRows, h, b);
        tma_load_4d(sdo + qs * kTileBytes, &p.maps.dout, &bar.q_full[qs], 0, tile * kTileRows, h,
                    b);
      }
    }
    return;
  }

  // ---- consumers: one 64-row query tile at a time ----
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = p.scale_log2, scale = p.scale;
  const uint32_t k_base = smem_u32(sk), v_base = smem_u32(sv);
  mbar_wait(&bar.kv_full, 0);
  for (int tile = t_begin, qi = 0; tile < t_end; ++tile, ++qi) {
    const int qs = qi & 1;
    const uint32_t q_addr = smem_u32(sq + qs * kTileBytes);
    const uint32_t do_addr = smem_u32(sdo + qs * kTileBytes);
    mbar_wait(&bar.q_full[qs], (qi >> 1) & 1);

    // S over the key row: accumulator 4j + e holds key 8j + 2t + (e & 1)
    // of row g + 8 (e >> 1); keys at or past n to -inf (a uniform branch a
    // 32-key chunk), then each row's max (base-2 units), p = ex2(s c - m)
    // in place, and 1/l
    float s[kShortKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n224k16_ss(s, kmajor_desc(q_addr + 32 * kk), kmajor_desc(k_base + 32 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int ch = 0; ch < kShortKeys / 32; ++ch) {
      if (32 * ch + 32 > n) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (32 * ch + (i >> 2) * 8 + 2 * t + (i & 1) >= n) s[16 * ch + i] = -INFINITY;
      }
    }
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < kShortKeys / 2; i += 4) {
      t0 = fmaxf(t0, fmaxf(s[i], s[i + 1]));
      t1 = fmaxf(t1, fmaxf(s[i + 2], s[i + 3]));
    }
    const float m0 = quad_max(t0) * c, m1 = quad_max(t1) * c;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int i = 0; i < kShortKeys / 2; i += 4) {
      s[i] = ex2(fmaf(s[i], c, -m0)), s[i + 1] = ex2(fmaf(s[i + 1], c, -m0));
      s[i + 2] = ex2(fmaf(s[i + 2], c, -m1)), s[i + 3] = ex2(fmaf(s[i + 3], c, -m1));
      l0 += s[i] + s[i + 1];
      l1 += s[i + 2] + s[i + 3];
    }
    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

    // delta = rowsum(dp * p), dP = dO.V^T in 32-key chunks (16 fp32 a
    // thread beside the row's 112): element i of chunk ch is key 32 ch +
    // 8 (i >> 2) + 2t + (i & 1), element 16 ch + i of the row
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int ch = 0; ch < kShortKeys / 32; ++ch) {
      float dp[16];
      wgmma_fence();
      issue_ss<32>(dp, do_addr, v_base + ch * 32 * kRowBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 16; i += 4) {
        const int k = 16 * ch + i;
        d0 += s[k] * inv0 * dp[i] + s[k + 1] * inv0 * dp[i + 1];
        d1 += s[k + 2] * inv1 * dp[i + 2] + s[k + 3] * inv1 * dp[i + 3];
      }
    }
    d0 = quad_sum(d0), d1 = quad_sum(d1);

    // ds = bf16(p * (dp - delta) * scale) slice by slice, S and dP formed
    // again, as the A fragments of dq += ds.K: the keys' 64-key tiles, the
    // last at width W (keys past n masked: p = 0)
    float dq[32];
    zero(dq);
#pragma unroll 1
    for (int sl = 0; sl < nt - 1; ++sl)
      dq_slice(dq, q_addr, do_addr, k_base + sl * kTileBytes, v_base + sl * kTileBytes,
               sl * kTileRows, t, n, c, scale, m0, m1, inv0, inv1, d0, d1);
    // the last key tile, its index opaque here so that nothing of it is
    // hoisted out of the tile loop to live through the row's phases
    int last = nt - 1;
    asm volatile("" : "+r"(last));
    dq_slice<W>(dq, q_addr, do_addr, k_base + last * kTileBytes, v_base + last * kTileBytes,
                last * kTileRows, t, n, c, scale, m0, m1, inv0, inv1, d0, d1);
    mbar_arrive(&bar.q_empty[qs]);  // every wgmma reading Q and dO is done

    // the rows' statistics, for the rows < n
    const int r0 = tile * kTileRows + warp * 16 + g;
    if (t == 0) {
      const long long plane = (long long)gridDim.z * gridDim.y * n;
      float* stats = p.stats + ((long long)b * gridDim.y + h) * n;
      if (r0 < n) stats[r0] = m0, stats[plane + r0] = inv0, stats[2 * plane + r0] = d0;
      if (r0 + 8 < n)
        stats[r0 + 8] = m1, stats[plane + r0 + 8] = inv1, stats[2 * plane + r0 + 8] = d1;
    }
    // dq: the staging tile is free once the previous tile's store has read
    // it; one TMA store, which drops rows past n
    if (threadIdx.x == 0) bulk_wait_read<0>();
    named_sync(1, kConsumers);
    stage_o(dq, sdq, warp, g, t);
    fence_proxy_async();
    named_sync(1, kConsumers);
    if (threadIdx.x == 0) {
      tma_store_4d(&p.maps.dq, sdq, 0, tile * kTileRows, h, b);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait<0>();
}

// ---- A' on short rows: its key-major launch ----
//
// A block takes a run of the 64-key tiles of one (image, head) and keeps
// the head's Q and dO (256-row boxes, TMA's zeros past n) and the rows'
// statistics resident; K and V tiles arrive through a ring of two, and dk
// and dv leave through the K and V tiles they were computed from, which go
// back to the producer once their stores have read them (checked as the
// next key tile starts). Each key tile walks the query tiles
// with the pair's key-major step (kv_tile), the last at width W. Against
// the pair's launch, one block a key tile with Q and dO streamed: the
// head's Q, dO and statistics arrive once a block instead of once a key
// tile, and a key tile's loads and stores overlap its neighbours' work.

struct ShortKvBarriers {
  uint64_t q_full, kv_full[2], kv_empty[2];
};

// shared memory from a 1024-byte aligned base: Q and dO (256 rows each),
// the K ring, the V ring, the statistics ([query tile][max, multiplier,
// delta][64]), the barriers
struct ShortKvLayout {
  static constexpr int kDo = kShortRows * kRowBytes;
  static constexpr int kK = 2 * kDo;
  static constexpr int kV = kK + 2 * kTileBytes;
  static constexpr int kStats = kV + 2 * kTileBytes;
  static constexpr int kBars = kStats + kShortTiles * kStatsBytes;
  static constexpr int kBytes = kBars + (int)sizeof(ShortKvBarriers) + 1024;
};

template <int W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    attn_short_bwd_kv_sm90_kernel(const __grid_constant__ BwdParams p) {
  using L = ShortKvLayout;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;
  uint8_t* sdo = smem + L::kDo;
  uint8_t* sk = smem + L::kK;
  uint8_t* sv = smem + L::kV;
  float* sst = reinterpret_cast<float*>(smem + L::kStats);
  ShortKvBarriers& bar = *reinterpret_cast<ShortKvBarriers*>(smem + L::kBars);

  const int n = p.n, h = blockIdx.y, b = blockIdx.z;
  const int nt = (n + kTileRows - 1) / kTileRows;
  const int t_begin = blockIdx.x * p.tiles;
  const int t_end = min(t_begin + p.tiles, nt);

  if (threadIdx.x == 0) {
    mbar_init(&bar.q_full, 32);
    for (int i = 0; i < 2; ++i) mbar_init(&bar.kv_full[i], 1), mbar_init(&bar.kv_empty[i], 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: all 32 lanes copy the rows' statistics (rows past
    // n: max 0, multiplier 0, delta 0, so p = 0 and ds = 0) and arrive on
    // q_full; lane 0 issues every TMA load ----
    const int lane = threadIdx.x - kConsumers;
    const long long plane = (long long)gridDim.z * gridDim.y * n;
    const float* st = p.stats + ((long long)b * gridDim.y + h) * n;
    for (int r = lane; r < kShortRows; r += 32) {
      const bool in = r < n;
      float* dst = sst + (r / kTileRows) * (3 * kTileRows) + r % kTileRows;
      dst[0] = in ? st[r] : 0.f;
      dst[kTileRows] = in ? st[plane + r] : 0.f;
      dst[2 * kTileRows] = in ? st[2 * plane + r] : 0.f;
    }
    if (lane == 0) {
      mbar_expect_tx(&bar.q_full, 2 * L::kDo);
      tma_load_4d(sq, &p.maps.q_row, &bar.q_full, 0, 0, h, b);
      tma_load_4d(sdo, &p.maps.dout_row, &bar.q_full, 0, 0, h, b);
      for (int tile = t_begin, j = 0; tile < t_end; ++tile, ++j) {
        const int s = j & 1;
        mbar_wait(&bar.kv_empty[s], ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(&bar.kv_full[s], 2 * kTileBytes);
        tma_load_4d(sk + s * kTileBytes, &p.maps.k, &bar.kv_full[s], 0, tile * kTileRows, h, b);
        tma_load_4d(sv + s * kTileBytes, &p.maps.v, &bar.kv_full[s], 0, tile * kTileRows, h, b);
      }
    } else {
      mbar_arrive(&bar.q_full);
    }
    return;
  }

  // ---- consumers: one 64-key tile at a time ----
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = p.scale_log2, scale = p.scale;
  const uint32_t q_base = smem_u32(sq), do_base = smem_u32(sdo);
  mbar_wait(&bar.q_full, 0);
  for (int tile = t_begin, j = 0; tile < t_end; ++tile, ++j) {
    const int s = j & 1;
    const uint32_t k_addr = smem_u32(sk + s * kTileBytes), v_addr = smem_u32(sv + s * kTileBytes);
    // the other stage goes back to the producer once the previous key
    // tile's stores have read it
    if (j > 0 && threadIdx.x == 0) {
      bulk_wait_read<0>();
      mbar_arrive(&bar.kv_empty[s ^ 1]);
    }
    mbar_wait(&bar.kv_full[s], (j >> 1) & 1);
    float dk[32], dv[32];
    zero(dk);
    zero(dv);
    // the query tiles, the last at width W (its index opaque, so that
    // nothing of it is hoisted out of the key-tile loop)
    int full = W == kTileRows ? nt : nt - 1;
    asm volatile("" : "+r"(full));
#pragma unroll 1
    for (int i = 0; i < full; ++i)
      kv_tile(dk, dv, k_addr, v_addr, q_base + i * kTileBytes, do_base + i * kTileBytes,
              sst + i * (3 * kTileRows), t, c, scale);
    if constexpr (W < kTileRows)
      kv_tile<W>(dk, dv, k_addr, v_addr, q_base + full * kTileBytes, do_base + full * kTileBytes,
                 sst + full * (3 * kTileRows), t, c, scale);

    // every product on this K and V tile is done: stage dk and dv there,
    // then two TMA stores, which drop rows past n
    named_sync(1, kConsumers);
    stage_o(dk, sk + s * kTileBytes, warp, g, t);
    stage_o(dv, sv + s * kTileBytes, warp, g, t);
    fence_proxy_async();
    named_sync(1, kConsumers);
    if (threadIdx.x == 0) {
      tma_store_4d(&p.maps.dk, sk + s * kTileBytes, 0, tile * kTileRows, h, b);
      tma_store_4d(&p.maps.dv, sv + s * kTileBytes, 0, tile * kTileRows, h, b);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait<0>();
}

// the pair under the names of K', I', J' and of L' (A''s are above)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    attn_bwd_q_sm90_kernel(const __grid_constant__ BwdParams p) {
  bwd_q<false>(p);
}
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    attn_bwd_kv_sm90_kernel(const __grid_constant__ BwdParams p) {
  bwd_kv(p);
}
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    attn_large_bwd_q_sm90_kernel(const __grid_constant__ BwdParams p) {
  bwd_q<true>(p);
}
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    attn_large_bwd_kv_sm90_kernel(const __grid_constant__ BwdParams p) {
  bwd_kv(p);
}

enum Entry { kPairEntry, kShortEntry, kLargeEntry };

using BwdKernel = void (*)(BwdParams);

struct Pair {
  BwdKernel q, kv;
  int q_bytes, kv_bytes;
};

template <int W>
Pair short_pair() {
  return {attn_short_bwd_q_sm90_kernel<W>, attn_short_bwd_kv_sm90_kernel<W>, ShortLayout::kBytes,
          ShortKvLayout::kBytes};
}

// the kernels of an entry; w: the width of a short row's last tile (A')
Pair pair_of(int entry, int w) {
  if (entry == kPairEntry)
    return {attn_bwd_q_sm90_kernel, attn_bwd_kv_sm90_kernel, QLayout<false>::kBytes,
            KvLayout::kBytes};
  if (entry == kLargeEntry)
    return {attn_large_bwd_q_sm90_kernel, attn_large_bwd_kv_sm90_kernel, QLayout<true>::kBytes,
            KvLayout::kBytes};
  return w == 16 ? short_pair<16>() : w == 32 ? short_pair<32>() : short_pair<64>();
}

// once a process: the SM's shared memory carved out in full for every
// kernel, and their dynamic shared memory
cudaError_t prepare() {
  static const cudaError_t state = [] {
    const Pair pairs[5] = {pair_of(kPairEntry, 64), pair_of(kLargeEntry, 64),
                           pair_of(kShortEntry, 16), pair_of(kShortEntry, 32),
                           pair_of(kShortEntry, 64)};
    cudaError_t err = cudaSuccess;
    for (const Pair& pr : pairs) {
      const BwdKernel kernels[2] = {pr.q, pr.kv};
      const int bytes[2] = {pr.q_bytes, pr.kv_bytes};
      for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
        err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
        if (err == cudaSuccess) err = set_smem(kernels[i], bytes[i]);
      }
    }
    return err;
  }();
  return state;
}

// ops[0..7] = q, k, v, dout, dq, dk, dv, o (o read by L' only); lse: L's,
// for L' only
int launch_bwd(int entry, const Operand (&ops)[8], float* stats, const float* lse, int batch,
               int n, int heads, int head_dim, float scale, cudaStream_t stream) {
  if (head_dim != kD || batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || n <= 0 ||
      (entry == kShortEntry && n > kShortKeys))
    return cudaErrorInvalidValue;
  cudaError_t err = prepare();
  BwdParams p{};
  p.stats = stats;
  p.lse = lse;
  p.n = n;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  CUtensorMap* maps[8] = {&p.maps.q,  &p.maps.k,  &p.maps.v,  &p.maps.dout,
                          &p.maps.dq, &p.maps.dk, &p.maps.dv, &p.maps.o};
  for (int i = 0; i < (entry == kLargeEntry ? 8 : 7) && err == cudaSuccess; ++i)
    err = encode_rows_map(maps[i], ops[i].p, n, heads, batch, ops[i].sn, ops[i].sh, ops[i].sb,
                          kTileRows);
  const int nt = (n + kTileRows - 1) / kTileRows;
  const int last = n - (nt - 1) * kTileRows;  // rows of the last tile
  p.tiles = 1;
  dim3 q_grid(nt, heads, batch);
  if (entry == kShortEntry && err == cudaSuccess) {
    CUtensorMap* rows[4] = {&p.maps.q_row, &p.maps.k_row, &p.maps.v_row, &p.maps.dout_row};
    for (int i = 0; i < 4 && err == cudaSuccess; ++i)
      err = encode_rows_map(rows[i], ops[i].p, n, heads, batch, ops[i].sn, ops[i].sh, ops[i].sb,
                            kShortRows);
    // split a head's tiles over blocks only while the (image, head) blocks
    // alone would leave the card short of two blocks per SM
    int dev = 0, sms = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long pairs = (long long)batch * heads, want = (long long)kBlocksPerSm * sms;
    const long long fill = (want + pairs - 1) / pairs;
    const int split = fill < nt ? (int)fill : nt;
    p.tiles = (nt + split - 1) / split;
    q_grid.x = (nt + p.tiles - 1) / p.tiles;
  }
  if (err != cudaSuccess) return err;
  const Pair pr = pair_of(entry, last <= 16 ? 16 : last <= 32 ? 32 : 64);
  pr.q<<<q_grid, kThreads, pr.q_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // A''s key-major launch takes the same runs of tiles as its query-major
  const dim3 kv_grid = entry == kShortEntry ? q_grid : dim3(nt, heads, batch);
  pr.kv<<<kv_grid, kThreads, pr.kv_bytes, stream>>>(p);
  return cudaGetLastError();
}

// the operands of the packed rows qkv [batch, n, 3*heads*64] and dqkv like
// it (q, k, v at columns h*64, (H+h)*64, (2H+h)*64 of each row), dout
// through its strides, o (L' only) through its strides
void packed_ops(Operand (&ops)[8], const void* qkv, void* dqkv, const Operand& dout,
                const Operand& o, int n, int heads) {
  const long long rs = 3LL * heads * kD, hs = (long long)heads * kD;
  const bf16* rows = static_cast<const bf16*>(qkv);
  const bf16* drows = static_cast<const bf16*>(dqkv);
  for (int i = 0; i < 3; ++i) {
    ops[i] = Operand{rows + i * hs, n * rs, kD, rs};
    ops[4 + i] = Operand{drows + i * hs, n * rs, kD, rs};
  }
  ops[3] = dout;
  ops[7] = o;
}

}  // namespace

// A': qkv [batch, n, 3*heads*64] bf16 with n <= 224; dout element (b, h,
// i, c) at dout + b*do_sb + h*do_sh + i*do_sn + c (rows 16-byte aligned);
// dqkv like qkv; stats: 3*batch*heads*n floats of scratch.
GAVIT_EXPORT int gavit_attention_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                                     int batch, int n, int heads, int head_dim, long long do_sb,
                                     long long do_sh, long long do_sn, float scale,
                                     void* stream) {
  Operand ops[8];
  packed_ops(ops, qkv, dqkv, Operand{dout, do_sb, do_sh, do_sn}, Operand{}, n, heads);
  return launch_bwd(kShortEntry, ops, static_cast<float*>(stats), nullptr, batch, n, heads,
                    head_dim, scale, static_cast<cudaStream_t>(stream));
}

// K': the arguments as A''s, any n (the wrapper keeps it to 225..749).
GAVIT_EXPORT int gavit_attention_long_bwd(const void* qkv, const void* dout, void* dqkv,
                                          void* stats, int batch, int n, int heads, int head_dim,
                                          long long do_sb, long long do_sh, long long do_sn,
                                          float scale, void* stream) {
  Operand ops[8];
  packed_ops(ops, qkv, dqkv, Operand{dout, do_sb, do_sh, do_sn}, Operand{}, n, heads);
  return launch_bwd(kPairEntry, ops, static_cast<float*>(stats), nullptr, batch, n, heads,
                    head_dim, scale, static_cast<cudaStream_t>(stream));
}

// L': qkv and dqkv as A''s, any n; o (kernel L's output, [batch, n, heads,
// 64] memory) and dout through their strides (rows 16-byte aligned); lse
// [batch, heads, n] fp32 from kernel L; stats: 3*batch*heads*n floats of
// scratch.
GAVIT_EXPORT int gavit_attention_large_bwd(const void* qkv, const void* o, const void* lse,
                                           const void* dout, void* dqkv, void* stats, int batch,
                                           int n, int heads, int head_dim, long long o_sb,
                                           long long o_sh, long long o_sn, long long do_sb,
                                           long long do_sh, long long do_sn, float scale,
                                           void* stream) {
  Operand ops[8];
  packed_ops(ops, qkv, dqkv, Operand{dout, do_sb, do_sh, do_sn}, Operand{o, o_sb, o_sh, o_sn}, n,
             heads);
  return launch_bwd(kLargeEntry, ops, static_cast<float*>(stats), static_cast<const float*>(lse),
                    batch, n, heads, head_dim, scale, static_cast<cudaStream_t>(stream));
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
  Operand ops[8] = {};
  for (int i = 0; i < 7; ++i)
    ops[i] = Operand{ptrs[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return launch_bwd(kPairEntry, ops, static_cast<float*>(stats), nullptr, batch, n, heads,
                    head_dim, scale, static_cast<cudaStream_t>(stream));
}
