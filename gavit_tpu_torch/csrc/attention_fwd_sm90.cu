// The bf16 attention forwards for Hopper, wgmma on TMA-fed tiles: A, K, I
// and J with the TPU kernels' exact softmax, and the blockwise L with its
// online softmax (at the end of the file).
//
// Replaces: gavit_tpu/ops/attention.py::_fwd_kernel_v4 (A, on the packed
// qkv rows up to 224 tokens), ::_fwd_kernel_v3 (K, packed rows past 224),
// ::_fwd_kernel (I, v1 under attention_pallas) and ::_fwd_kernel_v2 (J,
// fused_attention_v2), the last two on [B, H, N, d] tensors. The four
// compute one function, and one kernel serves them all through rank-4
// tensor maps over (64, N, H, B) with each operand's (row, head, image)
// strides: the packed rows (q at column h*64, k at (H+h)*64, v at
// (2H+h)*64 of [B, N, 3*H*64]) and strided [B, H, N, 64] views alike. A
// and K write o as [B, N, H, 64] memory (the Python wrappers return the
// [B, H, N, d] view); I and J write o through its strides. Kernel A's fp32
// body stays in attention.cu; the backward kernels A', K', I', J' and L'
// are attention_bwd_sm90.cu's.
//
// The function, as the TPU kernels compute it: s = (q.k^T) * scale in fp32,
// the row's true max m, p = exp(s - m) * (1/l) with l the row's sum, p
// rounded to bf16 before p.v, fp32 accumulation, o rounded to bf16. No
// online rescaling of a rounded p, no atomics, every sum in a fixed order:
// reruns give the same bits.
//
// What bounds it on the H100: per (image, head) 4*N^2*64 FLOPs against
// 4*N*64*2 bytes (q, k, v read once, o written once): N/2 FLOP/byte, 98 at
// N = 197 and 288 at N = 577, under the card's ridge of ~295, so the bytes
// bound both (b128 at 197: 0.046 ms; b16 at 577: 0.017 ms). Past the
// bytes, the work that costs is the softmax's per-score arithmetic on the
// CUDA cores (about 8 instructions a score, exp included), which the
// design keeps in registers and overlaps with other blocks' loads and
// tensor-core work.
//
// Design (one block = one consumer warpgroup + one producer warp):
// * The producer warp's lane 0 issues every load by TMA into 128-byte
//   swizzled shared memory and signals mbarriers: the 64-row query tiles
//   through a ring of 2, and the keys and values.
// * The consumer warpgroup owns a 64-row query tile. S = Q.K^T is wgmma
//   with both operands K-major in shared memory, one instruction per 16 of
//   the 64 columns (m64n224k16 in the single pass, m64n64k16 streamed).
//   The softmax runs on the accumulator registers (a row spreads over a
//   quad: quad shuffles for max and sum; exp on the SFU as ex2.approx);
//   p is rounded to bf16 and packed straight into the register A
//   fragments of O = P.V, wgmma m64n64k16 per 16 keys with V as the
//   MN-major (transposed) B operand. O goes through a swizzled staging
//   tile to a TMA store, which drops rows past N.
// * N <= 224, single pass (A at every N it takes; K, I, J up to 224): the
//   whole key row is one 224-row tile (TMA zero-fills rows past N; keys
//   past N are set to -inf in S). Its scores stay in registers (112 fp32
//   a thread; 145 registers in all, no spills), so there is no recompute,
//   and K and V are read once per block. The block takes a run of query
//   tiles of one (image, head); the launcher splits a head's tiles over
//   blocks until about two blocks per SM exist (b1: 12 heads x 4 tiles =
//   48 blocks; b128: 1536 blocks of 4 tiles). Two blocks fit an SM: each
//   SM sub-partition holds 3 of their 10 warps, so ptxas allows 168
//   registers.
// * N > 224, streamed (K at 577, I up to 640, J at any N): one query tile a
//   block, key tiles of 64 rows through TMA rings (K: 3 stages, V: 2). Pass
//   1 streams K and keeps each row's running max and sum (the sum rescaled
//   when the max moves), which gives the true max m and 1/l; pass 2
//   streams K and V, recomputes S, forms p = exp(s - m) * (1/l) and
//   accumulates P.V. That is 1.5x the tensor-core FLOPs of one pass, which
//   at wgmma rates costs ~0.008 ms at b16, N = 577; keeping the fp32 scores
//   in shared memory instead would take 64*N*4 bytes (160 KB at N = 640)
//   and could not run J at 1025. 93 registers; three blocks fit an SM.
// * No setmaxnreg: with a producer warpgroup giving its registers to the
//   consumers (24 / 232 at two blocks an SM), ptxas still allocated every
//   region within the launch's 128 registers, and the spills and
//   serialised wgmma made A at b128 0.35 ms against 0.09 here (an H100
//   80GB HBM3 at 700 W). A lone producer warp cannot give registers to all
//   four consumer warps either: each SM sub-partition has its own file.
// * Every register a wgmma touches asynchronously is pinned (fence_regs)
//   before wgmma_fence and after wgmma_wait. A branch around the softmax
//   (skipping warps whose rows all lie past N) doubled the code and made
//   ptxas spill and serialise the wgmmas; every warp runs it.
#include "attention_sm90.cuh"

namespace {

constexpr int kChunk = 32;                   // keys in 16 accumulators a thread
constexpr int kChunkBytes = kChunk * kRowBytes;
constexpr int kSingleKeys = 224;             // the single pass's key row
constexpr int kSingleChunks = kSingleKeys / kChunk;
constexpr int kStreamChunks = kTileRows / kChunk;
constexpr int kKStages = 3, kVStages = 2;    // streamed rings

template <bool kSingle>
struct Shape {
  static constexpr int kBlocksPerSm = kSingle ? 2 : 3;
  static constexpr int kKeyRows = kSingle ? kSingleKeys : kTileRows;  // a K or V box
};

struct Maps {
  CUtensorMap q, k, v, o;
};

struct Params {
  Maps maps;
  int n;
  int tiles;  // query tiles a block takes
  float scale;
};

struct Barriers {
  uint64_t q_full[2], q_empty[2];
  uint64_t k_full[kKStages], k_empty[kKStages];
  uint64_t v_full[kVStages], v_empty[kVStages];
};

// shared memory from a 1024-byte aligned base: K, V, the Q ring, the O
// staging tile, the barriers
template <bool kSingle>
struct Layout {
  static constexpr int kK = kSingle ? kSingleKeys * kRowBytes : kKStages * kTileBytes;
  static constexpr int kV = kSingle ? kSingleKeys * kRowBytes : kVStages * kTileBytes;
  static constexpr int kQ = kK + kV;
  static constexpr int kO = kQ + 2 * kTileBytes;
  static constexpr int kBars = kO + kTileBytes;
  // what the launch asks for: the layout, the barriers, the alignment slack
  static constexpr int kBytes = kBars + (int)sizeof(Barriers) + 1024;
};

// exp(x) as 2^(x log2 e) on the SFU (ex2.approx: within 2 ulp; results
// under 2^-126 flush to 0, far below what p's bf16 rounding keeps)
__device__ __forceinline__ float exp_f32(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// issue S = Q.K^T for a 64-row Q tile and the key rows at k_addr, both
// swizzled in shared memory: one wgmma per 16 of the 64 columns, as wide
// as the keys (C chunks of 32 in s, one accumulator array to the wgmma)
template <int C>
__device__ __forceinline__ void issue_s(float (&s)[C][16], uint32_t q_addr, uint32_t k_addr) {
  float(&d)[C * 16] = *reinterpret_cast<float(*)[C * 16]>(&s[0][0]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t a = kmajor_desc(q_addr + 32 * kk), b = kmajor_desc(k_addr + 32 * kk);
    if constexpr (C == kSingleChunks)
      wgmma_m64n224k16_ss(d, a, b, kk > 0);
    else
      wgmma_m64n64k16_ss(d, a, b, kk > 0);
  }
}

// s * scale, and -inf for keys at or past n, over one chunk whose first key is key0
__device__ __forceinline__ void scale_mask(float (&s)[16], int key0, int t, int n, float scale) {
  const bool edge = key0 + kChunk > n;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float x = s[i] * scale;
    s[i] = edge && key0 + (i >> 2) * 8 + 2 * t + (i & 1) >= n ? -INFINITY : x;
  }
}

__device__ __forceinline__ void chunk_max(const float (&s)[16], float& m0, float& m1) {
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
    m0 = fmaxf(m0, fmaxf(s[i], s[i + 1]));
    m1 = fmaxf(m1, fmaxf(s[i + 2], s[i + 3]));
  }
}

// s = exp(s - m) over one chunk (elements 4j, 4j+1 are row g's, 4j+2,
// 4j+3 row g+8's)
__device__ __forceinline__ void chunk_exp(float (&s)[16], float m0, float m1) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = exp_f32(s[i] - (i & 2 ? m1 : m0));
}

__device__ __forceinline__ void chunk_sum(const float (&e)[16], float& l0, float& l1) {
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
    l0 += e[i] + e[i + 1];
    l1 += e[i + 2] + e[i + 3];
  }
}

// p = e * inv of one chunk's exponentials, rounded to bf16, as the A
// fragments of its two 16-key steps of P.V
__device__ __forceinline__ void chunk_p(uint32_t (*pa)[4], const float (&e)[16], float inv0,
                                        float inv1) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* x = e + 8 * h;  // n8 blocks 2h (keys +0..7) and 2h+1 (keys +8..15)
    pa[h][0] = pack_bf16(x[0] * inv0, x[1] * inv0);
    pa[h][1] = pack_bf16(x[2] * inv1, x[3] * inv1);
    pa[h][2] = pack_bf16(x[4] * inv0, x[5] * inv0);
    pa[h][3] = pack_bf16(x[6] * inv1, x[7] * inv1);
  }
}

// issue O (+)= P.V over the 16-key steps of one chunk, V's swizzled rows
// from v_addr; `first`: the chunk starts the sum
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (*pa)[4], uint32_t v_addr,
                                         bool first) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    wgmma_m64n64k16_mnmajor(o, pa[h], mnmajor_desc(v_addr + 2048 * h), !first || h > 0);
}

template <bool kSingle>
__global__ void __launch_bounds__(kThreads, Shape<kSingle>::kBlocksPerSm)
    attn_fwd_sm90_kernel(const __grid_constant__ Params p) {
  using L = Layout<kSingle>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = smem;
  uint8_t* sv = smem + L::kK;
  uint8_t* sq = smem + L::kQ;
  uint8_t* so = smem + L::kO;
  Barriers& bar = *reinterpret_cast<Barriers*>(smem + L::kBars);

  const int n = p.n, h = blockIdx.y, b = blockIdx.z;
  const int nt = (n + kTileRows - 1) / kTileRows;
  const int t_begin = blockIdx.x * p.tiles;
  const int t_end = min(t_begin + p.tiles, nt);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(&bar.q_full[i], 1), mbar_init(&bar.q_empty[i], kConsumers);
    for (int i = 0; i < kKStages; ++i)
      mbar_init(&bar.k_full[i], 1), mbar_init(&bar.k_empty[i], kConsumers);
    for (int i = 0; i < kVStages; ++i)
      mbar_init(&bar.v_full[i], 1), mbar_init(&bar.v_empty[i], kConsumers);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: one lane issues every TMA load ----
    if (threadIdx.x == kConsumers) {
      int ki = 0, vi = 0;
      for (int tile = t_begin, qi = 0; tile < t_end; ++tile, ++qi) {
        const int qs = qi & 1;
        mbar_wait(&bar.q_empty[qs], ((qi >> 1) & 1) ^ 1);
        mbar_expect_tx(&bar.q_full[qs], kTileBytes);
        tma_load_4d(sq + qs * kTileBytes, &p.maps.q, &bar.q_full[qs], 0, tile * kTileRows, h, b);
        if constexpr (kSingle) {
          if (tile == t_begin) {  // the whole key row, once a block
            mbar_expect_tx(&bar.k_full[0], L::kK);
            tma_load_4d(sk, &p.maps.k, &bar.k_full[0], 0, 0, h, b);
            mbar_expect_tx(&bar.v_full[0], L::kV);
            tma_load_4d(sv, &p.maps.v, &bar.v_full[0], 0, 0, h, b);
          }
        } else {
          // pass 1: K tiles; pass 2: K and V tiles
          for (int pass = 0; pass < 2; ++pass) {
            for (int k0 = 0; k0 < n; k0 += kTileRows) {
              const int ks = ki % kKStages;
              mbar_wait(&bar.k_empty[ks], ((ki / kKStages) & 1) ^ 1);
              mbar_expect_tx(&bar.k_full[ks], kTileBytes);
              tma_load_4d(sk + ks * kTileBytes, &p.maps.k, &bar.k_full[ks], 0, k0, h, b);
              ++ki;
              if (pass == 1) {
                const int vs = vi % kVStages;
                mbar_wait(&bar.v_empty[vs], ((vi / kVStages) & 1) ^ 1);
                mbar_expect_tx(&bar.v_full[vs], kTileBytes);
                tma_load_4d(sv + vs * kTileBytes, &p.maps.v, &bar.v_full[vs], 0, k0, h, b);
                ++vi;
              }
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: the warpgroup computes one 64-row query tile at a time ----
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale = p.scale;
  const uint32_t k_base = smem_u32(sk), v_base = smem_u32(sv);
  int ki = 0, vi = 0;
  for (int tile = t_begin, qi = 0; tile < t_end; ++tile, ++qi) {
    const int qs = qi & 1;
    const uint32_t q_addr = smem_u32(sq + qs * kTileBytes);
    mbar_wait(&bar.q_full[qs], (qi >> 1) & 1);

    float o[32];
    if constexpr (kSingle) {
      if (tile == t_begin) mbar_wait(&bar.k_full[0], 0);
      float s[kSingleChunks][16];
      wgmma_fence();
      issue_s(s, q_addr, k_base);
      wgmma_commit();
      wgmma_wait<0>();
      mbar_arrive(&bar.q_empty[qs]);
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int c = 0; c < kSingleChunks; ++c) {
        fence_regs(s[c]);
        scale_mask(s[c], c * kChunk, t, n, scale);
        chunk_max(s[c], m0, m1);
      }
      m0 = quad_max(m0), m1 = quad_max(m1);
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int c = 0; c < kSingleChunks; ++c) {
        chunk_exp(s[c], m0, m1);
        chunk_sum(s[c], l0, l1);
      }
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
      uint32_t pa[2 * kSingleChunks][4];
#pragma unroll
      for (int c = 0; c < kSingleChunks; ++c) chunk_p(pa + 2 * c, s[c], inv0, inv1);
      settle_p(pa);
      if (tile == t_begin) mbar_wait(&bar.v_full[0], 0);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kSingleChunks; ++c)
        issue_pv(o, pa + 2 * c, v_base + c * kChunkBytes, c == 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    } else {
      float s[kStreamChunks][16];
      // pass 1: the row's max and 1/sum
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      for (int k0 = 0; k0 < n; k0 += kTileRows, ++ki) {
        const int ks = ki % kKStages;
        mbar_wait(&bar.k_full[ks], (ki / kKStages) & 1);
        wgmma_fence();
        issue_s(s, q_addr, k_base + ks * kTileBytes);
        wgmma_commit();
        wgmma_wait<0>();
        mbar_arrive(&bar.k_empty[ks]);
        float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
        for (int c = 0; c < kStreamChunks; ++c) {
          fence_regs(s[c]);
          scale_mask(s[c], k0 + c * kChunk, t, n, scale);
          chunk_max(s[c], t0, t1);
        }
        // every tile holds a key < n, so the new max is finite; exp(-inf)
        // = 0 drops the empty sum of the first tile
        const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
        l0 *= exp_f32(m0 - n0);
        l1 *= exp_f32(m1 - n1);
#pragma unroll
        for (int c = 0; c < kStreamChunks; ++c) {
          chunk_exp(s[c], n0, n1);
          chunk_sum(s[c], l0, l1);
        }
        m0 = n0, m1 = n1;
      }
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
      // pass 2: O = P.V, S recomputed tile by tile
      for (int k0 = 0; k0 < n; k0 += kTileRows, ++ki, ++vi) {
        const int ks = ki % kKStages, vs = vi % kVStages;
        mbar_wait(&bar.k_full[ks], (ki / kKStages) & 1);
        wgmma_fence();
        issue_s(s, q_addr, k_base + ks * kTileBytes);
        wgmma_commit();
        wgmma_wait<0>();
        mbar_arrive(&bar.k_empty[ks]);
        uint32_t pa[2 * kStreamChunks][4];
#pragma unroll
        for (int c = 0; c < kStreamChunks; ++c) {
          fence_regs(s[c]);
          scale_mask(s[c], k0 + c * kChunk, t, n, scale);
          chunk_exp(s[c], m0, m1);
          chunk_p(pa + 2 * c, s[c], inv0, inv1);
        }
        settle_p(pa);
        mbar_wait(&bar.v_full[vs], (vi / kVStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < kStreamChunks; ++c)
          issue_pv(o, pa + 2 * c, v_base + vs * kTileBytes + c * kChunkBytes, k0 == 0 && c == 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&bar.v_empty[vs]);
      }
      mbar_arrive(&bar.q_empty[qs]);
    }

    // epilogue: the staging tile is free once the previous tile's store
    // has read it; then o -> bf16 -> staging -> one TMA store
    if (threadIdx.x == 0) bulk_wait_read<0>();
    named_sync(1, kConsumers);
    stage_o(o, so, warp, g, t);
    fence_proxy_async();
    named_sync(1, kConsumers);
    if (threadIdx.x == 0) {
      tma_store_4d(&p.maps.o, so, 0, tile * kTileRows, h, b);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait<0>();
}

// Once a process: the SM's shared memory carved out in full, so that two
// (single pass) or three (streamed) blocks share it.
template <bool kSingle>
cudaError_t prepare() {
  static const cudaError_t state = [] {
    cudaError_t err = cudaFuncSetAttribute(attn_fwd_sm90_kernel<kSingle>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) err = set_smem(attn_fwd_sm90_kernel<kSingle>, Layout<kSingle>::kBytes);
    return err;
  }();
  return state;
}

template <bool kSingle>
int launch(const Operand& q, const Operand& k, const Operand& v, const Operand& o, int batch,
           int n, int heads, float scale, cudaStream_t stream) {
  Params p;
  p.n = n;
  p.scale = scale;
  const int nt = (n + kTileRows - 1) / kTileRows;
  cudaError_t err = prepare<kSingle>();
  const Operand* ops[4] = {&q, &k, &v, &o};
  CUtensorMap* maps[4] = {&p.maps.q, &p.maps.k, &p.maps.v, &p.maps.o};
  const int rows[4] = {kTileRows, Shape<kSingle>::kKeyRows, Shape<kSingle>::kKeyRows, kTileRows};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = encode_rows_map(maps[i], ops[i]->p, n, heads, batch, ops[i]->sn, ops[i]->sh,
                          ops[i]->sb, rows[i]);
  if (err != cudaSuccess) return err;
  p.tiles = 1;
  if (kSingle) {
    // split a head's query tiles over blocks only while the (image, head)
    // blocks alone would leave the card short of two blocks per SM
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long pairs = (long long)batch * heads;
    const long long want = Shape<kSingle>::kBlocksPerSm * (long long)sms;
    const long long fill = (want + pairs - 1) / pairs;
    const int split = fill < nt ? (int)fill : nt;
    p.tiles = (nt + split - 1) / split;
  }
  dim3 grid((nt + p.tiles - 1) / p.tiles, heads, batch);
  attn_fwd_sm90_kernel<kSingle><<<grid, kThreads, Layout<kSingle>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

int launch_fwd(const Operand& q, const Operand& k, const Operand& v, const Operand& o, int batch,
               int n, int heads, float scale, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || n <= 0)
    return cudaErrorInvalidValue;
  return n <= kSingleKeys ? launch<true>(q, k, v, o, batch, n, heads, scale, stream)
                          : launch<false>(q, k, v, o, batch, n, heads, scale, stream);
}

// ---- kernel L: one pass, online softmax ------------------------------------
//
// Replaces: gavit_tpu/ops/attention.py::_fwd_kernel_v5 (launched by
// _run_fwd_v5_impl): the forward of flash_attention_large, which
// fused_qkv_attention takes past the exact kernels' range (N > 749 in bf16
// at head_dim 64; attention_route 'L' in the port: 512 px, N = 1025, and
// 1024 px, N = 4097). Its backward L' (attention_bwd_sm90.cu) reads the o
// and lse written here.
//
// The function, with v5's rounding points: s = q.k^T * scale in fp32, keys
// at or past N at -inf; over the key tiles in order, each row keeps a
// running max m and sum l; when m moves, l and o are rescaled by
// exp(m_old - m_new); p = exp(s - m) against the running max is rounded to
// bf16 before p.v, l sums the unrounded fp32 p; o = acc / l rounded to bf16
// ([B, N, H, 64] memory: the wrapper returns the [B, H, N, d] view) and
// lse = m + log l in fp32 [B, H, N] (logf, the accurate form: L' recomputes
// p from it). q, k, v come from the packed [B, N, 3*H*64] rows through
// rank-4 tensor maps, as A's. No atomics, every sum in a fixed order:
// reruns give the same bits.
//
// What bounds it on the H100: 4*N^2*64 tensor FLOPs a head (0.104 ms at
// 512 px b32) and one exponential a score on the SFUs (16 ex2 a clock an
// SM: about 0.1 ms for the 4.0e8 scores at 512 px b32), each about the
// other's size at head_dim 64, with ~4 more CUDA-core instructions a score
// (the max, the scaled subtraction as one FFMA in base 2, the sum, half a
// pack). The bytes (q, k, v read once, o written once) are far below.
//
// Design (one block = one consumer warpgroup + one producer warp, one
// 64-row query tile a block, three blocks an SM):
// * The producer warp's lane 0 loads the Q tile and streams 64-key K and V
//   tiles by TMA through 3-stage rings with full/empty mbarriers, 128-byte
//   swizzled.
// * One pass over the key tiles, FlashAttention-3's intra-warpgroup
//   overlap: at tile j the warpgroup issues S_j = Q.K_j^T (wgmma
//   m64n64k16, both operands K-major in shared memory) and O += P_{j-1} .
//   V_{j-1} (register A fragments, V the MN-major B operand) back to back,
//   waits for S_j only, runs the online softmax of S_j in registers while
//   P_{j-1}.V_{j-1} is on the tensor cores (a second set of P fragments),
//   then waits for it and rescales O by the step's exp(m_old - m_new). The
//   softmax works in base 2: x = s * scale * log2(e) and p = ex2(x - m) as
//   one FFMA and one ex2.approx; the keys past N are masked on the last
//   key tile only, behind a uniform branch (a select on every tile made
//   the kernel 1.27x slower at 512 px b32). Three blocks an SM (106
//   registers, no spills) keep three warpgroups' softmax and tensor work
//   interleaved.
// * O goes through the Q tile's shared memory (the last S is done with it)
//   to one TMA store, which drops rows past N; lse is written for rows < N.
// * The first key tile always holds a key < N, so the first running max is
//   finite and exp(-inf - m) = 0 clears the empty sums; the ragged last
//   query tile's rows past N multiply TMA's zeros and are never stored.
// * Tried and measured (PERF.md §6, PR 11): two or three warpgroups a block
//   sharing the K/V tiles (a third of the K/V traffic, slower: the
//   warpgroups' softmax and wgmmas line up instead of interleaving),
//   FlashAttention-3's ping-pong between two warpgroups, S_{j+1} issued
//   before the softmax of S_j (two S tiles), a persistent item loop with a
//   double-buffered Q, 128-key tiles (best at N = 4097 by 8%, 6% behind at
//   1025).

// L's block: one consumer warpgroup owning a 64-row query tile, and the
// producer warp; 64-key tiles through 3-stage K and V rings
constexpr int kLargeStages = 3;
constexpr int kLargeBlocksPerSm = 3;

struct LargeBarriers {
  uint64_t q_full, k_full[kLargeStages], k_empty[kLargeStages], v_full[kLargeStages],
      v_empty[kLargeStages];
};

// shared memory from a 1024-byte aligned base: the K ring, the V ring, the
// Q tile (the O staging tile once the last S is done), the barriers
struct LargeLayout {
  static constexpr int kV = kLargeStages * kTileBytes;
  static constexpr int kQ = 2 * kV;
  static constexpr int kBars = kQ + kTileBytes;
  static constexpr int kBytes = kBars + (int)sizeof(LargeBarriers) + 1024;
};

struct LargeParams {
  Maps maps;
  float* lse;
  int n;
  float scale_log2;  // scale * log2(e): the scores in base-2 units
};

// The running softmax over one key tile of raw scores s whose first key is
// key0 (keys at or past n set to -inf): the row maxima m (base-2 units of
// the scaled scores) move to cover the tile, a returns exp(m_old - m_new)
// for each row, l (this thread's share of the row sums) is rescaled and
// takes the tile's p = exp(s * scale - m) in fp32, and p leaves rounded to
// bf16 as the A fragments of the tile's P.V. Every key tile holds a key <
// n, so the new maxima are finite; on the first tile (m = -inf) a = 0.
template <int C>
__device__ __forceinline__ void online_softmax(float (&s)[C][16], uint32_t (&pa)[2 * C][4],
                                               int key0, int t, int n, float c, float& m0,
                                               float& m1, float& l0, float& l1, float& a0,
                                               float& a1) {
  if (key0 + C * kChunk > n) {  // the last key tile only: a uniform branch
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (key0 + ch * kChunk + (i >> 2) * 8 + 2 * t + (i & 1) >= n) s[ch][i] = -INFINITY;
  }
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) chunk_max(s[ch], t0, t1);
  const float n0 = fmaxf(m0, quad_max(t0) * c), n1 = fmaxf(m1, quad_max(t1) * c);
  a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
  m0 = n0, m1 = n1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
#pragma unroll
    for (int i = 0; i < 16; ++i) s[ch][i] = ex2(fmaf(s[ch][i], c, i & 2 ? -n1 : -n0));
    chunk_sum(s[ch], s0, s1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* x = s[ch] + 8 * h;
      uint32_t* f = pa[2 * ch + h];
      f[0] = pack_bf16(x[0], x[1]), f[1] = pack_bf16(x[2], x[3]);
      f[2] = pack_bf16(x[4], x[5]), f[3] = pack_bf16(x[6], x[7]);
    }
  }
  l0 = fmaf(l0, a0, s0), l1 = fmaf(l1, a1, s1);
}

// issue O += P.V over one key tile (its 16-key steps), V's swizzled rows
// from v_addr
template <int C>
__device__ __forceinline__ void issue_pv_tile(float (&o)[32], const uint32_t (&pa)[2 * C][4],
                                              uint32_t v_addr) {
#pragma unroll
  for (int k = 0; k < 2 * C; ++k)
    wgmma_m64n64k16_mnmajor(o, pa[k], mnmajor_desc(v_addr + 2048 * k), 1);
}

__global__ void __launch_bounds__(kThreads, kLargeBlocksPerSm)
    attn_large_sm90_kernel(const __grid_constant__ LargeParams p) {
  using L = LargeLayout;
  constexpr int C = kStreamChunks, S = kLargeStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = smem;
  uint8_t* sv = smem + L::kV;
  uint8_t* sq = smem + L::kQ;
  LargeBarriers& bar = *reinterpret_cast<LargeBarriers*>(smem + L::kBars);

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
      mbar_expect_tx(&bar.q_full, kTileBytes);
      tma_load_4d(sq, &p.maps.q, &bar.q_full, 0, tile * kTileRows, h, b);
      for (int j = 0; j < key_tiles; ++j) {
        const int s = j % S;
        const unsigned ph = ((j / S) & 1) ^ 1;
        mbar_wait(&bar.k_empty[s], ph);
        mbar_expect_tx(&bar.k_full[s], kTileBytes);
        tma_load_4d(sk + s * kTileBytes, &p.maps.k, &bar.k_full[s], 0, j * kTileRows, h, b);
        mbar_wait(&bar.v_empty[s], ph);
        mbar_expect_tx(&bar.v_full[s], kTileBytes);
        tma_load_4d(sv + s * kTileBytes, &p.maps.v, &bar.v_full[s], 0, j * kTileRows, h, b);
      }
    }
    return;
  }

  // ---- consumers: the warpgroup computes the block's query tile ----
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float c = p.scale_log2;
  const uint32_t q_addr = smem_u32(sq), k_base = smem_u32(sk), v_base = smem_u32(sv);
  float s[C][16], o[32];
  uint32_t pa[2 * C][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  mbar_wait(&bar.q_full, 0);

  uint32_t pn[2 * C][4];
  // key tile 0: S, then its softmax
  mbar_wait(&bar.k_full[0], 0);
  wgmma_fence();
  issue_s(s, q_addr, k_base);
  wgmma_commit();
  wgmma_wait<0>();
  mbar_arrive(&bar.k_empty[0]);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) fence_regs(s[ch]);
  online_softmax(s, pa, 0, t, n, c, m0, m1, l0, l1, a0, a1);
  // key tile j: issue S_j and O += P_{j-1}.V_{j-1}; the softmax of S_j
  // runs while P_{j-1}.V_{j-1} is on the tensor cores; then O is
  // rescaled to the new maxima
  for (int j = 1; j < key_tiles; ++j) {
    const int sj = j % S, sp = (j - 1) % S;
    mbar_wait(&bar.k_full[sj], (j / S) & 1);
    mbar_wait(&bar.v_full[sp], ((j - 1) / S) & 1);
    settle_p(pa);
    fence_regs(o);
    wgmma_fence();
    issue_s(s, q_addr, k_base + sj * kTileBytes);
    wgmma_commit();
    issue_pv_tile<C>(o, pa, v_base + sp * kTileBytes);
    wgmma_commit();
    wgmma_wait<1>();
    mbar_arrive(&bar.k_empty[sj]);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) fence_regs(s[ch]);
    online_softmax(s, pn, j * kTileRows, t, n, c, m0, m1, l0, l1, a0, a1);
    wgmma_wait<0>();
    fence_regs(o);
    settle_p(pa);
    mbar_arrive(&bar.v_empty[sp]);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= i & 2 ? a1 : a0;
#pragma unroll
    for (int k = 0; k < 2 * C; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[k][r] = pn[k][r];
  }
  const int sp = (key_tiles - 1) % S;
  mbar_wait(&bar.v_full[sp], ((key_tiles - 1) / S) & 1);
  settle_p(pa);
  fence_regs(o);
  wgmma_fence();
  issue_pv_tile<C>(o, pa, v_base + sp * kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  mbar_arrive(&bar.v_empty[sp]);

  // o / l and lse = m + log l (m back in natural units), for the rows < n
  l0 = quad_sum(l0), l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= i & 2 ? inv1 : inv0;
  const int r0 = tile * kTileRows + warp * 16 + g;
  if (t == 0) {
    float* lse = p.lse + ((long long)b * gridDim.y + h) * n;
    if (r0 < n) lse[r0] = m0 * 0.6931471805599453f + logf(l0);
    if (r0 + 8 < n) lse[r0 + 8] = m1 * 0.6931471805599453f + logf(l1);
  }
  // the S wgmmas are done with the Q tile: stage O there, then one TMA
  // store, which drops rows past n
  named_sync(1, kConsumers);
  stage_o(o, sq, warp, g, t);
  fence_proxy_async();
  named_sync(1, kConsumers);
  if (threadIdx.x == 0) {
    tma_store_4d(&p.maps.o, sq, 0, tile * kTileRows, h, b);
    bulk_commit();
    bulk_wait<0>();
  }
}

// L: qkv [batch, n, 3*heads*64] bf16 -> out [batch, n, heads, 64] bf16 and
// lse [batch, heads, n] fp32
int large_fwd(const void* qkv, void* out, float* lse, int batch, int n, int heads,
              float scale, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || n <= 0)
    return cudaErrorInvalidValue;
  // once a process: the SM's shared memory carved out in full, so that
  // three blocks share it
  static const cudaError_t prepared = [] {
    cudaError_t err = cudaFuncSetAttribute(attn_large_sm90_kernel,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    return err == cudaSuccess ? set_smem(attn_large_sm90_kernel, LargeLayout::kBytes) : err;
  }();
  if (prepared != cudaSuccess) return prepared;
  const bf16* rows = static_cast<const bf16*>(qkv);
  const long long rs = 3LL * heads * kD, orow = (long long)heads * kD;
  LargeParams p;
  p.lse = lse;
  p.n = n;
  p.scale_log2 = scale * 1.4426950408889634f;
  const void* bases[4] = {rows, rows + heads * kD, rows + 2 * heads * kD, out};
  CUtensorMap* maps[4] = {&p.maps.q, &p.maps.k, &p.maps.v, &p.maps.o};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    const long long sn = i < 3 ? rs : orow;
    err = encode_rows_map(maps[i], bases[i], n, heads, batch, sn, kD, n * sn, kTileRows);
  }
  if (err != cudaSuccess) return err;
  dim3 grid((n + kTileRows - 1) / kTileRows, heads, batch);
  attn_large_sm90_kernel<<<grid, kThreads, LargeLayout::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// A and K: qkv [batch, n, 3*heads*64] bf16 -> out [batch, n, heads, 64] bf16
int attention_fwd_packed(const void* qkv, void* out, int batch, int n, int heads, float scale,
                         cudaStream_t stream) {
  const bf16* rows = static_cast<const bf16*>(qkv);
  const long long rs = 3LL * heads * kD, orow = (long long)heads * kD;
  const Operand q{rows, n * rs, kD, rs}, k{rows + heads * kD, n * rs, kD, rs},
      v{rows + 2 * heads * kD, n * rs, kD, rs}, o{out, n * orow, kD, orow};
  return launch_fwd(q, k, v, o, batch, n, heads, scale, stream);
}

// K: the packed rows at any n (past 224 on the model's path)
GAVIT_EXPORT int gavit_attention_long_fwd(const void* qkv, void* out, int batch, int n, int heads,
                                          int head_dim, float scale, void* stream) {
  if (head_dim != kD) return cudaErrorInvalidValue;
  return attention_fwd_packed(qkv, out, batch, n, heads, scale,
                              static_cast<cudaStream_t>(stream));
}

// I and J: q, k, v [batch, heads, n, 64] bf16 -> o [batch, heads, n, 64] bf16, each through
// strides (sb, sh, sn) in strides[0..11] in the order q, k, v, o (rows 16-byte aligned)
GAVIT_EXPORT int gavit_attention_bhnd_fwd(const void* q, const void* k, const void* v, void* o,
                                          const long long* strides, int batch, int n, int heads,
                                          int head_dim, float scale, void* stream) {
  if (head_dim != kD) return cudaErrorInvalidValue;
  const Operand ops[4] = {{q, strides[0], strides[1], strides[2]},
                          {k, strides[3], strides[4], strides[5]},
                          {v, strides[6], strides[7], strides[8]},
                          {o, strides[9], strides[10], strides[11]}};
  return launch_fwd(ops[0], ops[1], ops[2], ops[3], batch, n, heads, scale,
                    static_cast<cudaStream_t>(stream));
}

// L: qkv [batch, n, 3*heads*64] bf16 -> out [batch, n, heads, 64] bf16 and
// lse [batch, heads, n] fp32
GAVIT_EXPORT int gavit_attention_large_fwd(const void* qkv, void* out, void* lse, int batch,
                                           int n, int heads, int head_dim, float scale,
                                           void* stream) {
  if (head_dim != kD) return cudaErrorInvalidValue;
  return large_fwd(qkv, out, static_cast<float*>(lse), batch, n, heads, scale,
                   static_cast<cudaStream_t>(stream));
}
