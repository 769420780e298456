// Kernels K, K', L and L' in fp32: exact attention at any length on the CUDA
// cores, its key and value tiles (or query and dO tiles) streamed through
// shared memory.
//
// Replaces, at fp32 (HIGHEST precision there), in gavit_tpu/ops/attention.py:
// * K:  _fwd_kernel_v3 (launched by _run_fwd_v3_impl :533), attention.py:453;
// * K': _bwd_kernel_v3 (launched by _run_bwd_v3_impl :561), :475;
// * L:  _fwd_kernel_v5 (launched by _run_fwd_v5_impl :954), :803, with the
//       fp32 log-sum-exp it saves;
// * L': _dq_kernel_v5 and _dkv_kernel_v5 (launched by _run_bwd_v5_impl
//       :1012), :852 and :889, from that log-sum-exp;
// and, reading [B, H, N, 64] q, k, v and dO through their strides, kernels
// I/I' (_fwd_kernel :102, _bwd_kernel :125) and J/J' (_fwd_kernel_v2 :301,
// _bwd_kernel_v2 :321) in fp32. The bf16 bodies are attention_fwd_sm90.cu's
// and attention_bwd_sm90.cu's; A and A' in fp32 up to 416 tokens are
// attention.cu's, which stage a whole head's K and V (2*N*65*4 bytes: 300 KB
// at N = 577, past a block's 227 KB). Here shared memory does not depend on N.
//
// Computes, per image b and head h: the forward o = softmax(q.k^T * scale).v
// (and for L lse = m + log l, m the row's max, l its sum of exp(s - m)); the
// backward dv = p^T.dO, dp = dO.v^T, ds = p o (dp - delta) * scale, dq =
// ds.k, dk = ds^T.q with delta = rowsum(dp o p) (K', as _bwd_kernel_v3)
// or rowsum(dO o o) (L', from L's o, as _run_bwd_v5_impl). The plain
// versions are ops/attention.py's attention_reference /
// attention_backward_reference (K, K') and blockwise_attention_reference /
// blockwise_attention_backward_reference (L, L'); at fp32 both pairs
// compute the same function.
//
// Bound: the work, not the bytes: 4*N^2*d FMA-flops a head forward (s and
// p.v), 10*N^2*d backward (s and dp, dq, dk, dv), at 67 TFLOP/s of fp32
// outside the tensor cores. wgmma takes no fp32 operands and TF32 must stay
// off, so every product is an fp32 FMA; no float atomics, so reruns give the
// same bits.
//
// The design is attention.cu's fp32 layout with tiles:
// * a block owns 16 query rows (or keys) of one head, 8 warps of two rows
//   each; the rows' own q and dO (or k and v) are staged once in shared
//   memory, and 64-row tiles of the other side stream through it at the
//   padded stride of 65 words (bank (j + c) % 32: the 32 lanes that score 32
//   different rows hit 32 banks);
// * each lane scores the tile's rows lane and lane + 32 against one row held
//   in registers (64 fmaf steps in column order), the warp reduces with
//   shuffles, and the p.v (dq, dk, dv) pass broadcasts each row's value by a
//   shuffle while each lane accumulates the output columns lane and lane +
//   32; that pass serves the warp's two rows at once, so each value loaded
//   from shared memory feeds two FMAs;
// * the forward keeps an online softmax over the tiles: the running max m,
//   the sum l (a part in each lane) and the accumulators rescale by
//   exp(m_old - m_new);
// * the backward is A''s pair of launches: a query-major one writes dq and
//   the [3, B, H, N] row statistics (m, 1/l, delta), a key-major one
//   recomputes p and ds of each query from them and writes dk and dv. In L''s
//   mode the statistics are (lse, 1, rowsum(dO o o)) from L's lse and o; in
//   K''s mode (K saves only the rows) the query-major launch first takes a
//   pass over the key tiles for m, l and the sum of exp(s - m) * dp,
//   rescaled as l is, so delta = rowsum(dp o p). Both launches form s, p,
//   dp and ds with the same rounded steps in the same order (fmaf is
//   symmetric in its factors), so p and ds are the same bits in both, and
//   where the softmax is exact (one key) ds is exactly 0.
// The ragged last tile and rows past N exit warp-uniformly; lanes past N
// add zeros; no row past N is read. Each block's shared memory is static,
// 37-42 KB, so the launchers set no attribute: they allocate, copy and
// synchronise nothing, and CUDA-graph capture stays open.
#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 2;                     // query rows (or keys) a warp owns
constexpr int kBlockRows = kWarps * kRows;   // 16 a block
constexpr int kTile = 64;                    // streamed rows a tile
constexpr int kS = kD + 1;                   // padded tile stride, 65 words

// a [B, H, N, 64] operand: element (b, h, i, c) at p + b*sb + h*sh + i*sn + c
struct In {
  const float* p;
  long long sb, sh, sn;
};
struct Out {
  float* p;
  long long sb, sh, sn;
};

__device__ __forceinline__ const float* row_of(const In& t, int b, int h, int i) {
  return t.p + b * t.sb + h * t.sh + i * t.sn;
}
__device__ __forceinline__ float* row_of(const Out& t, int b, int h, int i) {
  return t.p + b * t.sb + h * t.sh + i * t.sn;
}

// rows [i0, i0 + rows) of (b, h) into dst at `stride` words a row, coalesced
// (consecutive threads read consecutive columns); no row past them is read
__device__ __forceinline__ void stage(float* dst, int stride, const In& t, int b, int h, int i0,
                                      int rows) {
  for (int e = threadIdx.x; e < rows * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    dst[r * stride + c] = row_of(t, b, h, i0 + r)[c];
  }
}

// one staged 64-float row (16-byte aligned, the same in every lane: a
// broadcast) into registers
__device__ __forceinline__ void load_row(float (&x)[kD], const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int c = 0; c < kD / 4; ++c) {
    const float4 t = s4[c];
    x[4 * c] = t.x;
    x[4 * c + 1] = t.y;
    x[4 * c + 2] = t.z;
    x[4 * c + 3] = t.w;
  }
}

// <x, row> in 64 fmaf steps in column order: a score or a dp takes the
// same bits wherever it is formed (fmaf(a, b, c) == fmaf(b, a, c))
__device__ __forceinline__ float dot(const float (&x)[kD], const float* row) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kD; ++c) s = fmaf(x[c], row[c], s);
  return s;
}

__device__ __forceinline__ float prob(float dotv, float scale, float m, float inv) {
  return __fmul_rn(expf(__fsub_rn(__fmul_rn(dotv, scale), m)), inv);
}

__device__ __forceinline__ float dscore(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// this warp's rows that lie before n (0, 1 or 2), first row r0
__device__ __forceinline__ int rows_before(int r0, int n) {
  return max(0, min(kRows, n - r0));
}

// One key tile of t keys (staged in sk, sv) into the online softmax of the
// warp's `rows` query rows (staged in sq_w): the running max m, this lane's
// part of the sum l, and the output columns lane and lane + 32 (a0, a1).
__device__ __forceinline__ void softmax_tile(const float* sq_w, const float* sk, const float* sv,
                                             int t, int rows, float scale, float (&m)[kRows],
                                             float (&l)[kRows], float (&a0)[kRows],
                                             float (&a1)[kRows]) {
  const int lane = threadIdx.x & 31;
  float p0[kRows], p1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    p0[r] = p1[r] = 0.f;
    if (r < rows) {  // warp-uniform
      float x[kD];
      load_row(x, sq_w + r * kD);
      const float s0 = lane < t ? __fmul_rn(dot(x, sk + lane * kS), scale) : -INFINITY;
      const float s1 = lane + 32 < t ? __fmul_rn(dot(x, sk + (lane + 32) * kS), scale) : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(__fsub_rn(m[r], mn));
      p0[r] = expf(__fsub_rn(s0, mn));
      p1[r] = expf(__fsub_rn(s1, mn));
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha), __fadd_rn(p0[r], p1[r]));
      a0[r] = __fmul_rn(a0[r], alpha);
      a1[r] = __fmul_rn(a1[r], alpha);
      m[r] = mn;
    }
  }
  const int t0 = min(t, 32);
  for (int u = 0; u < t0; ++u) {
    const float v0 = sv[u * kS + lane], v1 = sv[u * kS + lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float pu = __shfl_sync(0xffffffffu, p0[r], u);
      a0[r] = fmaf(pu, v0, a0[r]);
      a1[r] = fmaf(pu, v1, a1[r]);
    }
  }
  for (int u = 32; u < t; ++u) {
    const float v0 = sv[u * kS + lane], v1 = sv[u * kS + lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float pu = __shfl_sync(0xffffffffu, p1[r], u - 32);
      a0[r] = fmaf(pu, v0, a0[r]);
      a1[r] = fmaf(pu, v1, a1[r]);
    }
  }
}

// The online softmax of the warp's rows over every key tile of (b, h): on
// return m, l (summed over the warp), a0 and a1 (unnormalised).
__device__ __forceinline__ void softmax_rows(const In& k, const In& v, float* sk, float* sv,
                                             const float* sq_w, int b, int h, int n, int rows,
                                             float scale, float (&m)[kRows], float (&l)[kRows],
                                             float (&a0)[kRows], float (&a1)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = a0[r] = a1[r] = 0.f;
  }
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int t = min(kTile, n - j0);
    __syncthreads();  // the tile before is consumed (and the block's rows staged)
    stage(sk, kS, k, b, h, j0, t);
    stage(sv, kS, v, b, h, j0, t);
    __syncthreads();
    if (rows > 0) softmax_tile(sq_w, sk, sv, t, rows, scale, m, l, a0, a1);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) l[r] = warp_sum(l[r]);
}

// K''s statistics of the warp's rows in one pass over every key tile of (b,
// h): the running max m, the sum l of exp(s - m) and the sum dd of
// exp(s - m) * dp, both rescaled as the max moves, each summed over the warp
// on return (delta = dd / l = rowsum(dp o p)).
__device__ __forceinline__ void delta_rows(const In& k, const In& v, float* sk, float* sv,
                                           const float* sq_w, const float* sg_w, int b, int h,
                                           int n, int rows, float scale, float (&m)[kRows],
                                           float (&l)[kRows], float (&dd)[kRows]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = dd[r] = 0.f;
  }
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int t = min(kTile, n - j0);
    __syncthreads();  // the tile before is consumed (and the block's rows staged)
    stage(sk, kS, k, b, h, j0, t);
    stage(sv, kS, v, b, h, j0, t);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {  // warp-uniform
        const bool in0 = lane < t, in1 = lane + 32 < t;
        float x[kD];
        load_row(x, sq_w + r * kD);
        const float s0 = in0 ? __fmul_rn(dot(x, sk + lane * kS), scale) : -INFINITY;
        const float s1 = in1 ? __fmul_rn(dot(x, sk + (lane + 32) * kS), scale) : -INFINITY;
        load_row(x, sg_w + r * kD);
        const float dp0 = in0 ? dot(x, sv + lane * kS) : 0.f;
        const float dp1 = in1 ? dot(x, sv + (lane + 32) * kS) : 0.f;
        const float mn = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
        const float alpha = expf(__fsub_rn(m[r], mn));
        const float p0 = expf(__fsub_rn(s0, mn)), p1 = expf(__fsub_rn(s1, mn));
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha), __fadd_rn(p0, p1));
        dd[r] = __fadd_rn(__fmul_rn(dd[r], alpha),
                          __fadd_rn(__fmul_rn(p0, dp0), __fmul_rn(p1, dp1)));
        m[r] = mn;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    l[r] = warp_sum(l[r]);
    dd[r] = warp_sum(dd[r]);
  }
}

// K and L (lse != nullptr): grid (query blocks of 16, heads, images).
__global__ void __launch_bounds__(kThreads, 2)
    attn_f32_fwd_kernel(In q, In k, In v, Out o, float* __restrict__ lse, int n, int heads,
                        float scale) {
  __shared__ __align__(16) float sk[kTile * kS];
  __shared__ __align__(16) float sv[kTile * kS];
  __shared__ __align__(16) float sq[kBlockRows * kD];
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = i0 + warp * kRows;
  const int rows = rows_before(r0, n);
  stage(sq, kD, q, b, h, i0, min(kBlockRows, n - i0));
  float m[kRows], l[kRows], a0[kRows], a1[kRows];
  softmax_rows(k, v, sk, sv, sq + warp * kRows * kD, b, h, n, rows, scale, m, l, a0, a1);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      float* orow = row_of(o, b, h, r0 + r);
      orow[lane] = __fdiv_rn(a0[r], l[r]);
      orow[lane + 32] = __fdiv_rn(a1[r], l[r]);
      if (lse != nullptr && lane == 0)
        lse[((long long)b * heads + h) * n + r0 + r] = __fadd_rn(m[r], logf(l[r]));
    }
  }
}

// K''s and L''s query-major launch: dq, and the row statistics (m, 1/l,
// delta) into stats [3, B, H, N]. lse != nullptr: L''s mode (m = lse, 1/l =
// 1, delta = rowsum(dO o o) from L's o); else K''s (delta_rows first).
__global__ void __launch_bounds__(kThreads, 2)
    attn_f32_bwd_dq_kernel(In q, In k, In v, In o, In g, Out dq, const float* __restrict__ lse,
                           float* __restrict__ stats, int n, int heads, float scale) {
  __shared__ __align__(16) float sk[kTile * kS];
  __shared__ __align__(16) float sv[kTile * kS];
  __shared__ __align__(16) float sq[kBlockRows * kD];
  __shared__ __align__(16) float sg[kBlockRows * kD];
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = i0 + warp * kRows;
  const int rows = rows_before(r0, n);
  const int block_rows = min(kBlockRows, n - i0);
  stage(sq, kD, q, b, h, i0, block_rows);
  stage(sg, kD, g, b, h, i0, block_rows);
  const float* sq_w = sq + warp * kRows * kD;
  const float* sg_w = sg + warp * kRows * kD;
  const long long bh = ((long long)b * heads + h) * n;
  const long long plane = (long long)gridDim.z * heads * n;

  float m[kRows], inv[kRows], delta[kRows];
  if (lse != nullptr) {
    __syncthreads();  // sg staged
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = inv[r] = delta[r] = 0.f;
      if (r < rows) {
        const float* orow = row_of(o, b, h, r0 + r);
        const float* grow = sg_w + r * kD;
        m[r] = lse[bh + r0 + r];
        inv[r] = 1.f;
        delta[r] = warp_sum(__fadd_rn(__fmul_rn(grow[lane], orow[lane]),
                                      __fmul_rn(grow[lane + 32], orow[lane + 32])));
      }
    }
  } else {
    float l[kRows], dd[kRows];
    delta_rows(k, v, sk, sv, sq_w, sg_w, b, h, n, rows, scale, m, l, dd);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      inv[r] = delta[r] = 0.f;
      if (r < rows) {
        inv[r] = __fdiv_rn(1.f, l[r]);
        delta[r] = __fdiv_rn(dd[r], l[r]);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        stats[bh + r0 + r] = m[r];
        stats[plane + bh + r0 + r] = inv[r];
        stats[2 * plane + bh + r0 + r] = delta[r];
      }
    }
  }

  float d0[kRows], d1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) d0[r] = d1[r] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int t = min(kTile, n - j0);
    __syncthreads();
    stage(sk, kS, k, b, h, j0, t);
    stage(sv, kS, v, b, h, j0, t);
    __syncthreads();
    if (rows == 0) continue;  // warp-uniform; the next barrier is still met
    float ds0[kRows], ds1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ds0[r] = ds1[r] = 0.f;
      if (r < rows) {
        float x[kD];
        load_row(x, sq_w + r * kD);
        const bool in0 = lane < t, in1 = lane + 32 < t;
        const float p0 = in0 ? prob(dot(x, sk + lane * kS), scale, m[r], inv[r]) : 0.f;
        const float p1 = in1 ? prob(dot(x, sk + (lane + 32) * kS), scale, m[r], inv[r]) : 0.f;
        load_row(x, sg_w + r * kD);
        ds0[r] = in0 ? dscore(p0, dot(x, sv + lane * kS), delta[r], scale) : 0.f;
        ds1[r] = in1 ? dscore(p1, dot(x, sv + (lane + 32) * kS), delta[r], scale) : 0.f;
      }
    }
    const int t0 = min(t, 32);
    for (int u = 0; u < t0; ++u) {
      const float k0 = sk[u * kS + lane], k1 = sk[u * kS + lane + 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float du = __shfl_sync(0xffffffffu, ds0[r], u);
        d0[r] = fmaf(du, k0, d0[r]);
        d1[r] = fmaf(du, k1, d1[r]);
      }
    }
    for (int u = 32; u < t; ++u) {
      const float k0 = sk[u * kS + lane], k1 = sk[u * kS + lane + 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float du = __shfl_sync(0xffffffffu, ds1[r], u - 32);
        d0[r] = fmaf(du, k0, d0[r]);
        d1[r] = fmaf(du, k1, d1[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      float* drow = row_of(dq, b, h, r0 + r);
      drow[lane] = d0[r];
      drow[lane + 32] = d1[r];
    }
  }
}

// The key-major launch of both modes: dk and dv from the statistics (grid:
// key blocks of 16, heads, images; a warp owns two keys).
__global__ void __launch_bounds__(kThreads, 2)
    attn_f32_bwd_dkv_kernel(In q, In k, In v, In g, Out dk, Out dv,
                            const float* __restrict__ stats, int n, int heads, float scale) {
  __shared__ __align__(16) float sq[kTile * kS];
  __shared__ __align__(16) float sg[kTile * kS];
  __shared__ __align__(16) float sst[3 * kTile];
  __shared__ __align__(16) float skb[kBlockRows * kD];
  __shared__ __align__(16) float svb[kBlockRows * kD];
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = j0 + warp * kRows;
  const int rows = rows_before(r0, n);
  const int block_rows = min(kBlockRows, n - j0);
  stage(skb, kD, k, b, h, j0, block_rows);
  stage(svb, kD, v, b, h, j0, block_rows);
  const float* sk_w = skb + warp * kRows * kD;
  const float* sv_w = svb + warp * kRows * kD;
  const long long bh = ((long long)b * heads + h) * n;
  const long long plane = (long long)gridDim.z * heads * n;

  float dk0[kRows], dk1[kRows], dv0[kRows], dv1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dk0[r] = dk1[r] = dv0[r] = dv1[r] = 0.f;
  for (int i0 = 0; i0 < n; i0 += kTile) {
    const int t = min(kTile, n - i0);
    __syncthreads();
    stage(sq, kS, q, b, h, i0, t);
    stage(sg, kS, g, b, h, i0, t);
    for (int e = threadIdx.x; e < t; e += kThreads) {
      sst[e] = stats[bh + i0 + e];
      sst[kTile + e] = stats[plane + bh + i0 + e];
      sst[2 * kTile + e] = stats[2 * plane + bh + i0 + e];
    }
    __syncthreads();
    if (rows == 0) continue;  // warp-uniform; the next barrier is still met
    float p0[kRows], p1[kRows], ds0[kRows], ds1[kRows];
    const bool in0 = lane < t, in1 = lane + 32 < t;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      p0[r] = p1[r] = ds0[r] = ds1[r] = 0.f;
      if (r < rows) {
        float x[kD];
        load_row(x, sk_w + r * kD);
        if (in0) p0[r] = prob(dot(x, sq + lane * kS), scale, sst[lane], sst[kTile + lane]);
        if (in1)
          p1[r] = prob(dot(x, sq + (lane + 32) * kS), scale, sst[lane + 32],
                       sst[kTile + lane + 32]);
        load_row(x, sv_w + r * kD);
        if (in0) ds0[r] = dscore(p0[r], dot(x, sg + lane * kS), sst[2 * kTile + lane], scale);
        if (in1)
          ds1[r] = dscore(p1[r], dot(x, sg + (lane + 32) * kS), sst[2 * kTile + lane + 32],
                          scale);
      }
    }
    const int t0 = min(t, 32);
    for (int u = 0; u < t0; ++u) {
      const float q0 = sq[u * kS + lane], q1 = sq[u * kS + lane + 32];
      const float g0 = sg[u * kS + lane], g1 = sg[u * kS + lane + 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pu = __shfl_sync(0xffffffffu, p0[r], u);
        const float du = __shfl_sync(0xffffffffu, ds0[r], u);
        dv0[r] = fmaf(pu, g0, dv0[r]);
        dv1[r] = fmaf(pu, g1, dv1[r]);
        dk0[r] = fmaf(du, q0, dk0[r]);
        dk1[r] = fmaf(du, q1, dk1[r]);
      }
    }
    for (int u = 32; u < t; ++u) {
      const float q0 = sq[u * kS + lane], q1 = sq[u * kS + lane + 32];
      const float g0 = sg[u * kS + lane], g1 = sg[u * kS + lane + 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pu = __shfl_sync(0xffffffffu, p1[r], u - 32);
        const float du = __shfl_sync(0xffffffffu, ds1[r], u - 32);
        dv0[r] = fmaf(pu, g0, dv0[r]);
        dv1[r] = fmaf(pu, g1, dv1[r]);
        dk0[r] = fmaf(du, q0, dk0[r]);
        dk1[r] = fmaf(du, q1, dk1[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      float* krow = row_of(dk, b, h, r0 + r);
      float* vrow = row_of(dv, b, h, r0 + r);
      krow[lane] = dk0[r];
      krow[lane + 32] = dk1[r];
      vrow[lane] = dv0[r];
      vrow[lane + 32] = dv1[r];
    }
  }
}

bool takes(int batch, int n, int heads, int head_dim) {
  return head_dim == kD && batch > 0 && batch <= 65535 && n > 0 && heads > 0 && heads <= 65535;
}

In in_op(const void* p, const long long* s) { return In{static_cast<const float*>(p), s[0], s[1], s[2]}; }
Out out_op(void* p, const long long* s) { return Out{static_cast<float*>(p), s[0], s[1], s[2]}; }

}  // namespace

// K and L (and I, J) in fp32: q, k, v -> o, all [batch, heads, n, 64] fp32
// through strides (sb, sh, sn) in strides[0..11] in the order q, k, v, o
// (the last dim contiguous); lse: [batch, heads, n] fp32 (L), or null (K).
GAVIT_EXPORT int gavit_attention_f32_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, const long long* strides, int batch, int n,
                                         int heads, int head_dim, float scale, void* stream) {
  if (!takes(batch, n, heads, head_dim)) return cudaErrorInvalidValue;
  const dim3 grid((n + kBlockRows - 1) / kBlockRows, heads, batch);
  attn_f32_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in_op(q, strides), in_op(k, strides + 3), in_op(v, strides + 6), out_op(o, strides + 9),
      static_cast<float*>(lse), n, heads, scale);
  return cudaGetLastError();
}

// K' and L' (and I', J') in fp32: q, k, v, o, dout -> dq, dk, dv, all
// [batch, heads, n, 64] fp32 through strides (sb, sh, sn) in strides[0..23]
// in that order. lse: kernel L's [batch, heads, n] fp32 beside its o (L''s
// mode), or null (K''s mode: o is not read); stats: 3*batch*heads*n floats
// of scratch.
GAVIT_EXPORT int gavit_attention_f32_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, void* stats,
                                         const long long* strides, int batch, int n, int heads,
                                         int head_dim, float scale, void* stream) {
  if (!takes(batch, n, heads, head_dim)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBlockRows - 1) / kBlockRows, heads, batch);
  const In qi = in_op(q, strides), ki = in_op(k, strides + 3), vi = in_op(v, strides + 6),
           oi = in_op(o, strides + 9), gi = in_op(dout, strides + 12);
  float* st = static_cast<float*>(stats);
  attn_f32_bwd_dq_kernel<<<grid, kThreads, 0, s>>>(qi, ki, vi, oi, gi, out_op(dq, strides + 15),
                                                   static_cast<const float*>(lse), st, n, heads,
                                                   scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_f32_bwd_dkv_kernel<<<grid, kThreads, 0, s>>>(qi, ki, vi, gi, out_op(dk, strides + 18),
                                                    out_op(dv, strides + 21), st, n, heads, scale);
  return cudaGetLastError();
}
