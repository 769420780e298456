// Kernel C: fused graph aggregate forward: cosine similarity -> kNN /
// threshold / dense mask -> row softmax of sim/temperature -> A.V.
//
// Replaces: gavit_tpu/ops/graph_ops.py::_graph_kernel (launched by
// _run_fused_impl, reached through fused_graph_aggregate -> _fused_small).
//
// Semantics, row by row as in the TPU kernel: tokens are normalised in fp32
// with rsqrt(sum t^2 + 1e-6) and rounded back to the input dtype; sim is their
// product with fp32 accumulation; kNN takes k = min(k, N-1) passes of
// leftmost-max over the non-self entries (ties go to the lower index, as
// jax.lax.top_k does); threshold keeps sim > threshold off the diagonal and
// falls back to the self edge for a row with no edge; dense keeps every
// non-self entry. The selected logits sim/temperature are row-softmaxed, the
// adjacency is rounded to the values' dtype and multiplied by V with fp32
// accumulation. The fp32 adjacency is written only when the caller passes a
// pointer for it (the training backward will need it).
//
// What bounds it on the H100: per image the work is 2*N*N*D FMAs (sim and
// A.V) on [N, D] inputs that are read once from device memory and
// otherwise come from L2; at b128, N=196, D=768 that is 15.1 GFLOP against
// 135 MB (tokens, values and out in bf16, the 19.7 MB fp32 adjacency), so
// the bytes bound it (0.015 ms of tensor work against 0.040 ms of memory).
// Past the bytes, the kNN selection's k passes over every score of a row
// run on the CUDA cores with the tensor cores idle.
//
// Two bodies, chosen by dtype and N (never by a failure): bf16 with N <= 256
// runs on the tensor cores (graph_fwd_sm90_kernel, TMA + wgmma, described
// with it below); fp32, and bf16 past 256 keys, run graph_fwd_kernel on the
// CUDA cores (neither is on a shipped bf16 path).
//
// CUDA-core design per block (256 threads):
//  1. inverse norms of all N rows of the image (a warp per row);
//  2. sim[16, N] accumulated in registers over 32-wide chunks of D: each
//     thread owns 4 rows x N/64 columns, so one shared load feeds 2-4 FMAs;
//     the key chunk is stored with a 33-word row stride (conflict free);
//  3. selection, softmax and the optional adjacency write, a warp per row;
//  4. out[16, D] = A.V with V streamed from memory once per block and the
//     rounded adjacency read as float4 broadcasts from a transposed copy.
#include <cfloat>

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "sm90.cuh"

namespace {

constexpr int R = 16;  // query rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int DC = 32;  // D chunk of the similarity product
constexpr int KS = DC + 1;
constexpr float kEps = 1e-6f;

enum Mode { MODE_DENSE = 0, MODE_KNN = 1, MODE_THRESHOLD = 2 };

inline int pad64(int n) { return (n + 63) & ~63; }

inline int graph_smem_bytes(int n) {
  const int np = pad64(n);
  return (np + R * np + np * R + R * KS + np * KS) * (int)sizeof(float) + R * np;
}

template <typename T, int UMAX>
__global__ void __launch_bounds__(kThreads)
    graph_fwd_kernel(const T* __restrict__ tokens, const T* __restrict__ values,
                     T* __restrict__ out, float* __restrict__ adj, int n, int dim, int mode,
                     int k, float threshold, float temperature) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = (n + 63) & ~63;
  float* rinv = reinterpret_cast<float*>(smem_raw);  // [np]
  float* sim = rinv + np;                            // [R][np]
  float* pt = sim + R * np;                          // [np][R] rounded adjacency
  float* sq = pt + np * R;                           // [R][KS]
  float* sk = sq + R * KS;                           // [np][KS]
  unsigned char* sel = reinterpret_cast<unsigned char*>(sk + np * KS);  // [R][np]

  const int b = blockIdx.y, row0 = blockIdx.x * R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* t = tokens + (long)b * n * dim;
  const T* v = values + (long)b * n * dim;

  // 1. inverse norms
  for (int j = warp; j < n; j += kWarps) {
    float s = 0.f;
    for (int c = lane; c < dim; c += 32) {
      const float x = to_f32(t[(long)j * dim + c]);
      s = fmaf(x, x, s);
    }
    s = warp_sum(s);
    if (lane == 0) rinv[j] = 1.f / sqrtf(s + kEps);
  }
  __syncthreads();

  // 2. similarity slice, 4 rows x UMAX columns of 64 per thread
  const int tr = tid >> 6, tc = tid & 63;
  const int u_count = np / 64;
  float acc[4][UMAX];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < UMAX; ++u) acc[a][u] = 0.f;

  for (int d0 = 0; d0 < dim; d0 += DC) {
    for (int e = tid; e < R * DC; e += kThreads) {
      const int r = e / DC, c = e % DC, i = row0 + r, d = d0 + c;
      sq[r * KS + c] =
          (i < n && d < dim) ? round_to<T>(to_f32(t[(long)i * dim + d]) * rinv[i]) : 0.f;
    }
    for (int e = tid; e < np * DC; e += kThreads) {
      const int j = e / DC, c = e % DC, d = d0 + c;
      sk[j * KS + c] =
          (j < n && d < dim) ? round_to<T>(to_f32(t[(long)j * dim + d]) * rinv[j]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < DC; ++c) {
      float qv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = sq[(tr * 4 + a) * KS + c];
#pragma unroll
      for (int u = 0; u < UMAX; ++u) {
        if (u < u_count) {
          const float kv = sk[(tc + 64 * u) * KS + c];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][u] = fmaf(qv[a], kv, acc[a][u]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < UMAX; ++u)
      if (u < u_count) sim[(tr * 4 + a) * np + tc + 64 * u] = acc[a][u];
  __syncthreads();

  // 3. selection + softmax, a warp per row
  for (int r = warp; r < R; r += kWarps) {
    const int i = row0 + r;
    float* srow = sim + r * np;
    unsigned char* sl = sel + r * np;
    if (i >= n) {
      for (int j = lane; j < np; j += 32) pt[j * R + r] = 0.f;
      continue;
    }
    if (mode == MODE_DENSE) {
      for (int j = lane; j < n; j += 32) sl[j] = j != i;
    } else if (mode == MODE_THRESHOLD) {
      bool any = false;
      for (int j = lane; j < n; j += 32) {
        const bool e = j != i && srow[j] > threshold;
        sl[j] = e;
        any |= e;
      }
      if (!__any_sync(0xffffffffu, any))
        for (int j = lane; j < n; j += 32) sl[j] = j == i;
    } else {
      for (int j = lane; j < n; j += 32) sl[j] = 0;
      __syncwarp();
      const int kk = min(k, n - 1);
      for (int pass = 0; pass < kk; ++pass) {
        float best = -INFINITY;
        int bidx = n;
        for (int j = lane; j < n; j += 32) {  // ascending: leftmost wins in-lane
          if (j != i && !sl[j] && srow[j] > best) {
            best = srow[j];
            bidx = j;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
          if (ob > best || (ob == best && oi < bidx)) {
            best = ob;
            bidx = oi;
          }
        }
        if (lane == 0 && bidx < n) sl[bidx] = 1;
        __syncwarp();
      }
    }
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < n; j += 32)
      if (sl[j]) m = fmaxf(m, srow[j] / temperature);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < n; j += 32)
      if (sl[j]) s += expf(srow[j] / temperature - m);
    const float inv = 1.f / warp_sum(s);
    float* arow = adj ? adj + ((long)b * n + i) * n : nullptr;
    for (int j = lane; j < np; j += 32) {
      const float p = (j < n && sl[j]) ? expf(srow[j] / temperature - m) * inv : 0.f;
      if (arow && j < n) arow[j] = p;
      pt[j * R + r] = round_to<T>(p);
    }
  }
  __syncthreads();

  // 4. out = A.V for the block's rows
  for (int c = tid; c < dim; c += kThreads) {
    float o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float vj = to_f32(v[(long)j * dim + c]);
      const float4* p4 = reinterpret_cast<const float4*>(pt + j * R);
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 p = p4[q];
        o[4 * q + 0] = fmaf(p.x, vj, o[4 * q + 0]);
        o[4 * q + 1] = fmaf(p.y, vj, o[4 * q + 1]);
        o[4 * q + 2] = fmaf(p.z, vj, o[4 * q + 2]);
        o[4 * q + 3] = fmaf(p.w, vj, o[4 * q + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + r;
      if (i < n) out[((long)b * n + i) * dim + c] = from_f32<T>(o[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores, N <= kMmaMaxKeys, in two launches:
//  1. graph_normalize_kernel writes the normalised tokens, rounded to bf16,
//     once per image into a scratch [B, N, D] (a warp per row, 16-byte
//     loads), instead of every row block normalising every key again;
//  2. graph_fwd_sm90_kernel<NS>: one block takes 128 query rows of one
//     image (blockIdx.x the row tile, fastest, so that an image's tiles run
//     together and its keys and values come from L2), with two warpgroups
//     of 64 rows each.
//     * Thread 0 feeds one 4-stage ring of 128-byte swizzled tiles by TMA
//       (C90Ring): first, for each 64-dim chunk of D, the block's 128
//       query rows and the image's key rows (S's operands), then, for each
//       64-dim chunk of D (an even count), the image's value rows (P.V's).
//       Rows past N and dims past D arrive as zeros. Each stage is refilled
//       once both warpgroups' wgmmas that read it are done.
//     * S = Q.K^T: wgmma with both operands K-major in shared memory, NS =
//       N rounded up to a multiple of 8 keys wide, issued as m64n64k16
//       pieces and one each of n32, n16, n8 as NS's bits ask (one
//       instantiation per NS, chosen by N); the warpgroup's 64 x NS scores
//       stay in registers (NS / 2 fp32 a thread).
//     * Selection (k passes of quad-wide leftmost-max, a 64-bit mask per
//       row), the softmax of sim / temperature over the selected keys and
//       the optional fp32 adjacency write run on those registers; keys past
//       N are never selected.
//     * out = A.V: the adjacency rounded to bf16 is packed straight into
//       the register A fragments of wgmma m64n64k16 (16 keys a step, keys
//       past NS zero), V's 64-dim chunk the MN-major B operand, two chunks
//       in flight; each 64 x 64 result goes to bf16 through one of two
//       swizzled staging tiles to a TMA store, which drops rows past N,
//       while the next chunk's wgmmas run.
// ---------------------------------------------------------------------------

constexpr int kMmaMaxKeys = 256;
constexpr int kC90Groups = 2;                      // warpgroups
constexpr int kC90WgRows = 64;                     // query rows of a warpgroup
constexpr int kC90Rows = kC90Groups * kC90WgRows;  // query rows of a block
constexpr int kC90Threads = 128 * kC90Groups;      // no producer warp: thread 0 loads
constexpr int kC90Chunk = 64;                      // dims of a ring stage: one swizzle row
constexpr int kC90Stages = 4;
constexpr int kC90QBytes = kC90Rows * 128;         // a stage's query rows, 16 KB
constexpr int kC90OBytes = kC90WgRows * 128;       // a staging tile, 8 KB

struct C90Barriers {
  uint64_t full[kC90Stages], empty[kC90Stages];
};

// shared memory from a 1024-byte aligned base: the ring (each stage the
// query rows, then the key or value rows), two staging tiles a warpgroup,
// the barriers
template <int NS>
struct C90Layout {
  static constexpr int kKeys = (NS + 15) & ~15;  // key rows of a box: whole k16 steps of P.V
  static constexpr int kKBytes = kKeys * 128;
  static constexpr int kStageBytes = kC90QBytes + kKBytes;
  static constexpr int kOut = kC90Stages * kStageBytes;
  static constexpr int kBars = kOut + kC90Groups * 2 * kC90OBytes;
  static constexpr int kBytes = kBars + (int)sizeof(C90Barriers) + 1024;
  static_assert(kBytes <= kMaxSmemBytes, "kernel C's shared memory exceeds a block's");
};

struct C90Params {
  CUtensorMap mq, mk, mv, mo;  // normalised tokens (query and key boxes), values, out
  float* adj;
  int n, dim, mode, k;
  float threshold, temperature;
};

// issue S (+)= Q.K^T over one 64-dim chunk: a warpgroup's 64 query rows at
// q, the key rows at k, both swizzled K-major; NS columns in pieces of 64,
// then 32, 16 and 8 as NS's bits ask (each piece a multiple of 8 keys, so
// accumulator 4j + e holds key 8j + 2t + (e & 1) across the pieces)
template <int NS>
__device__ __forceinline__ void issue_s(float (&s)[NS / 2], uint32_t q, uint32_t k, bool acc) {
  constexpr int t32 = NS & ~63, t16 = t32 + (NS & 32), t8 = t16 + (NS & 16);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t a = kmajor_desc(q + 32 * kk);
    const int on = acc || kk > 0;
#pragma unroll
    for (int c0 = 0; c0 < t32; c0 += 64)
      wgmma_m64n64k16_ss(*reinterpret_cast<float(*)[32]>(&s[c0 / 2]), a,
                         kmajor_desc(k + c0 * 128 + 32 * kk), on);
    if constexpr ((NS & 32) != 0)
      wgmma_m64n32k16_ss(*reinterpret_cast<float(*)[16]>(&s[t32 / 2]), a,
                         kmajor_desc(k + t32 * 128 + 32 * kk), on);
    if constexpr ((NS & 16) != 0)
      wgmma_m64n16k16_ss(*reinterpret_cast<float(*)[8]>(&s[t16 / 2]), a,
                         kmajor_desc(k + t16 * 128 + 32 * kk), on);
    if constexpr ((NS & 8) != 0)
      wgmma_m64n8k16_ss(*reinterpret_cast<float(*)[4]>(&s[t8 / 2]), a,
                        kmajor_desc(k + t8 * 128 + 32 * kk), on);
  }
}

// The ring's uses in order: S's chunks (the block's query rows and the
// image's key rows), then P.V's (the image's value rows; an even count).
// Thread 0 loads use u once every consumer has released the stage's
// previous use (no producer warp: 8 warps a block leave the consumers up to
// 255 registers, where a ninth warp on one SM sub-partition capped them at
// 168 and the scores of N > 200 spilled).
struct C90Ring {
  uint8_t* smem;
  int stage_bytes, k_bytes, chunks, i0, b;
  __device__ __forceinline__ void fill(const C90Params& p, C90Barriers& bar, int u) const {
    if (u >= chunks + chunks + (chunks & 1)) return;
    const int s = u % kC90Stages;
    mbar_wait(&bar.empty[s], ((u / kC90Stages) & 1) ^ 1);
    uint8_t* st = smem + s * stage_bytes;
    if (u < chunks) {
      mbar_expect_tx(&bar.full[s], kC90QBytes + k_bytes);
      tma_load_3d(st, &p.mq, &bar.full[s], u * kC90Chunk, i0, b);
      tma_load_3d(st + kC90QBytes, &p.mk, &bar.full[s], u * kC90Chunk, 0, b);
    } else {
      mbar_expect_tx(&bar.full[s], k_bytes);
      tma_load_3d(st + kC90QBytes, &p.mv, &bar.full[s], (u - chunks) * kC90Chunk, 0, b);
    }
  }
  // release use u of the ring (every consumer), and load use u + kC90Stages
  __device__ __forceinline__ void release(const C90Params& p, C90Barriers& bar, int u) const {
    mbar_arrive(&bar.empty[u % kC90Stages]);
    if (threadIdx.x == 0) fill(p, bar, u + kC90Stages);
  }
};

// P.V: issue o = P . V over the k16 steps of the V chunk at ring use `it`
// (V's rows at v0 in stage 0, stages `stage_bytes` apart), once it has
// landed
template <int kSteps>
__device__ __forceinline__ void pv_issue(float (&o)[32], const uint32_t (&pa)[kSteps][4],
                                         C90Barriers& bar, uint32_t v0, int stage_bytes, int it) {
  const int st = it % kC90Stages;
  mbar_wait(&bar.full[st], (it / kC90Stages) & 1);
  const uint32_t v = v0 + st * stage_bytes;
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < kSteps; ++h)
    wgmma_m64n64k16_mnmajor(o, pa[h], mnmajor_desc(v + 2048 * h), h > 0);
  wgmma_commit();
}

// P.V, once chunk c's wgmmas are done: free its ring stage, round o to bf16
// into the warpgroup's staging tile (free once the store from it two
// chunks ago has read it) and store rows m0.. of it by TMA (`store`: this
// thread stores, and the chunk lies below D)
__device__ __forceinline__ void pv_store(float (&o)[32], const C90Ring& ring, C90Barriers& bar,
                                         int it, uint8_t* tile, const C90Params& p, int c, int m0,
                                         bool store) {
  fence_regs(o);
  ring.release(p, bar, it);
  const int b = ring.b;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if (store) bulk_wait_read<1>();
  named_sync(1 + wg, 128);
  uint8_t* r0 = tile + (warp * 16 + g) * 128 + 4 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int x = (j ^ g) << 4;
    *reinterpret_cast<uint32_t*>(r0 + x) = pack_bf16(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(r0 + 8 * 128 + x) = pack_bf16(o[4 * j + 2], o[4 * j + 3]);
  }
  fence_proxy_async();  // the staged tile, visible to the TMA store
  named_sync(1 + wg, 128);
  if (store && c * kC90Chunk < p.dim) {
    tma_store_3d(&p.mo, tile, c * kC90Chunk, m0, b);
    bulk_commit();
  }
}

template <int NS>
__global__ void __launch_bounds__(kC90Threads, 1)
    graph_fwd_sm90_kernel(const __grid_constant__ C90Params p) {
  using L = C90Layout<NS>;
  constexpr int kTiles = NS / 8;         // n8 key blocks of S
  constexpr int kSteps = L::kKeys / 16;  // k16 steps of P.V
  extern __shared__ __align__(1024) uint8_t graph_smem[];
  uint8_t* smem = graph_smem + ((1024 - (smem_u32(graph_smem) & 1023)) & 1023);
  C90Barriers& bar = *reinterpret_cast<C90Barriers*>(smem + L::kBars);
  const int b = blockIdx.y, i0 = blockIdx.x * kC90Rows, n = p.n;
  const int chunks = (p.dim + kC90Chunk - 1) / kC90Chunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kC90Stages; ++s)
      mbar_init(&bar.full[s], 1), mbar_init(&bar.empty[s], kC90Threads);
    fence_mbar_init();
  }
  __syncthreads();

  const C90Ring ring{smem, L::kStageBytes, L::kKBytes, chunks, i0, b};
  if (threadIdx.x == 0)
    for (int u = 0; u < kC90Stages; ++u) ring.fill(p, bar, u);

  // ---- warpgroup wg owns query rows i0 + 64 wg .. + 63 ----
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {i0 + wg * kC90WgRows + warp * 16 + g,
                       i0 + wg * kC90WgRows + warp * 16 + g + 8};
  const uint32_t base0 = smem_u32(smem);

  // S for the warpgroup's rows and all keys, in registers
  float s[NS / 2];
  int it = 0;
  for (int c = 0; c < chunks; ++c, ++it) {
    const int st = it % kC90Stages;
    mbar_wait(&bar.full[st], (it / kC90Stages) & 1);
    const uint32_t base = base0 + st * L::kStageBytes;
    wgmma_fence();
    issue_s<NS>(s, base + wg * kC90WgRows * 128, base + kC90QBytes, c > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's wgmmas are done: free its stage
    if (c > 0) ring.release(p, bar, it - 1);
  }
  wgmma_wait<0>();
  fence_regs(s);
  ring.release(p, bar, it - 1);

  // selection: bit 2j+e of sel[h] is key 8j + 2t + e of row rows[h]
  uint64_t sel[2] = {0, 0};
  if (p.mode == MODE_KNN) {
    // keys past N never win (-inf), the self key only once every other key
    // has (-FLT_MAX, below any cosine): k <= N - 1 passes never reach it.
    // A selected key keeps its score for the softmax.
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 8 * j + 2 * t + (i & 1);
        if (key >= n) s[4 * j + i] = -INFINITY;
        else if (key == rows[i >> 1]) s[4 * j + i] = -FLT_MAX;
      }
    const int kk = min(p.k, n - 1);
    for (int pass = 0; pass < kk; ++pass) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float best = -INFINITY;
        int bidx = n;
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // ascending keys: leftmost wins in-thread
            if (!((sel[h] >> (2 * j + e)) & 1) && s[4 * j + 2 * h + e] > best) {
              best = s[4 * j + 2 * h + e];
              bidx = 8 * j + 2 * t + e;
            }
          }
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
          if (ob > best || (ob == best && oi < bidx)) {
            best = ob;
            bidx = oi;
          }
        }
        if (bidx < n && ((bidx & 7) >> 1) == t)
          sel[h] |= 1ull << (2 * (bidx >> 3) + (bidx & 1));
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * t + e;
          const bool on = key < n && key != rows[h] &&
                          (p.mode == MODE_DENSE || s[4 * j + 2 * h + e] > p.threshold);
          if (on) sel[h] |= 1ull << (2 * j + e);
        }
      if (p.mode == MODE_THRESHOLD) {  // a row with no edge keeps its self edge
        int any = sel[h] != 0;
        any |= __shfl_xor_sync(0xffffffffu, any, 1);
        any |= __shfl_xor_sync(0xffffffffu, any, 2);
        const int self = rows[h];
        if (!any && self < n && ((self & 7) >> 1) == t)
          sel[h] |= 1ull << (2 * (self >> 3) + (self & 1));
      }
    }
  }

  // softmax of sim/temperature over the selected keys of rows[0], rows[1]
  // (exp on the SFU: within 2 ulp, far below the bf16 rounding of P)
  const float inv_t = 1.f / p.temperature;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = -INFINITY, l = 0.f;
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if ((sel[h] >> (2 * j + e)) & 1) m = fmaxf(m, s[4 * j + 2 * h + e] * inv_t);
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool on = (sel[h] >> (2 * j + e)) & 1;
        const float x = on ? __expf(s[4 * j + 2 * h + e] * inv_t - m) : 0.f;
        s[4 * j + 2 * h + e] = x;
        l += x;
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    // a row past N may have no edge (threshold): its zeros stay zeros
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      s[4 * j + 2 * h] *= inv;
      s[4 * j + 2 * h + 1] *= inv;
    }
    if (p.adj != nullptr && rows[h] < n) {
      float* arow = p.adj + ((long long)b * n + rows[h]) * n;
      if (n % 2 == 0) {  // key 8j + 2t even: both of a thread's keys in one 8-byte store
#pragma unroll
        for (int j = 0; j < kTiles; ++j)
          if (8 * j + 2 * t < n)
            *reinterpret_cast<float2*>(arow + 8 * j + 2 * t) =
                make_float2(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
      } else {
#pragma unroll
        for (int j = 0; j < kTiles; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 8 * j + 2 * t + e;
            if (key < n) arow[key] = s[4 * j + 2 * h + e];
          }
      }
    }
  }

  // the adjacency rounded to bf16, as the A fragments of P.V's k16 steps
  // (the n8 block past NS, where kKeys > NS, is zero)
  uint32_t pa[kSteps][4];
#pragma unroll
  for (int h = 0; h < kSteps; ++h) {
    const float* lo = s + 8 * h;  // n8 block 2h: keys 16h..16h+7
    pa[h][0] = pack_bf16(lo[0], lo[1]);
    pa[h][1] = pack_bf16(lo[2], lo[3]);
    if (2 * h + 1 < kTiles) {  // n8 block 2h + 1: keys 16h+8..16h+15
      pa[h][2] = pack_bf16(lo[4], lo[5]);
      pa[h][3] = pack_bf16(lo[6], lo[7]);
    } else {
      pa[h][2] = pa[h][3] = 0u;
    }
  }
#pragma unroll
  for (int h = 0; h < kSteps; ++h) fence_regs(pa[h]);

  // out = A.V, 64 dims a chunk, in pairs of chunks: chunk c + 1's wgmmas
  // run while chunk c goes through its staging tile (c % 2) to its store.
  // The ring holds an even count of V chunks (a chunk past D arrives as
  // zeros and is not stored), so no wgmma sits behind a branch.
  const int pv_chunks = chunks + (chunks & 1);
  const bool store = (threadIdx.x & 127) == 0 &&     // the warpgroup's leader, when
                     i0 + wg * kC90WgRows < n;       // a row of its tile lies below N
  const int m0 = i0 + wg * kC90WgRows;
  const uint32_t v0 = base0 + kC90QBytes;  // V's rows in ring stage 0
  uint8_t* staging = smem + L::kOut + wg * 2 * kC90OBytes;
  float o0[32], o1[32];
  pv_issue(o0, pa, bar, v0, L::kStageBytes, it);
  int c = 0;
  for (; c + 2 < pv_chunks; c += 2, it += 2) {
    pv_issue(o1, pa, bar, v0, L::kStageBytes, it + 1);
    wgmma_wait<1>();
    pv_store(o0, ring, bar, it, staging, p, c, m0, store);
    pv_issue(o0, pa, bar, v0, L::kStageBytes, it + 2);
    wgmma_wait<1>();
    pv_store(o1, ring, bar, it + 1, staging + kC90OBytes, p, c + 1, m0, store);
  }
  pv_issue(o1, pa, bar, v0, L::kStageBytes, it + 1);
  wgmma_wait<1>();
  pv_store(o0, ring, bar, it, staging, p, c, m0, store);
  wgmma_wait<0>();
  pv_store(o1, ring, bar, it + 1, staging + kC90OBytes, p, c + 1, m0, store);
  if (store) bulk_wait<0>();
}

// normalised tokens in fp32, rounded to bf16: a warp per row, 8 values a
// lane and load (dim % 8 == 0)
__global__ void __launch_bounds__(kThreads)
    graph_normalize_kernel(const __nv_bfloat16* __restrict__ t,
                           __nv_bfloat16* __restrict__ tn, int rows, int dim) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat16* src = t + (long long)row * dim;
  float s = 0.f;
  for (int c = lane * 8; c < dim; c += 256) {
    const uint4 q = *reinterpret_cast<const uint4*>(src + c);
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = __bfloat162float(v[j]);
      s = fmaf(x, x, s);
    }
  }
  const float r = 1.f / sqrtf(warp_sum(s) + kEps);
  for (int c = lane * 8; c < dim; c += 256) {
    uint4 q = *reinterpret_cast<const uint4*>(src + c);
    __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&q);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16_rn(__bfloat162float(v[j]) * r);
    *reinterpret_cast<uint4*>(tn + (long long)row * dim + c) = q;
  }
}

// Kernel C's tensor-core body at S's width NS = N rounded up to a multiple
// of 8 (the instantiation chosen by N, from NS = 8 up)
template <int NS>
int launch_graph_sm90(const void* tn, const void* values, void* out, float* adj, int batch, int n,
                      int dim, int mode, int k, float threshold, float temperature,
                      cudaStream_t stream) {
  if constexpr (NS > kMmaMaxKeys) {
    return cudaErrorInvalidValue;
  } else {
    if ((n + 7) / 8 * 8 != NS)
      return launch_graph_sm90<NS + 8>(tn, values, out, adj, batch, n, dim, mode, k, threshold,
                                       temperature, stream);
    using L = C90Layout<NS>;
    static const cudaError_t prepared = set_smem(graph_fwd_sm90_kernel<NS>, L::kBytes);
    if (prepared != cudaSuccess) return prepared;
    C90Params p;
    p.adj = adj, p.n = n, p.dim = dim, p.mode = mode, p.k = k;
    p.threshold = threshold, p.temperature = temperature;
    cudaError_t err = gemm90::tensor_map(&p.mq, tn, dim, n, batch, kC90Rows);
    if (err == cudaSuccess) err = gemm90::tensor_map(&p.mk, tn, dim, n, batch, L::kKeys);
    if (err == cudaSuccess) err = gemm90::tensor_map(&p.mv, values, dim, n, batch, L::kKeys);
    if (err == cudaSuccess) err = gemm90::tensor_map(&p.mo, out, dim, n, batch, kC90WgRows);
    if (err != cudaSuccess) return err;
    const dim3 grid((n + kC90Rows - 1) / kC90Rows, batch);
    graph_fwd_sm90_kernel<NS><<<grid, kC90Threads, L::kBytes, stream>>>(p);
    return cudaGetLastError();
  }
}

int launch_graph_tensor_cores(const void* tokens, const void* values, void* out, float* adj,
                              void* scratch, int batch, int n, int dim, int mode, int k,
                              float threshold, float temperature, cudaStream_t stream) {
  if (scratch == nullptr || dim % 8) return cudaErrorInvalidValue;
  const int rows = batch * n;
  graph_normalize_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(tokens), static_cast<__nv_bfloat16*>(scratch), rows,
      dim);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_graph_sm90<8>(scratch, values, out, adj, batch, n, dim, mode, k, threshold,
                              temperature, stream);
}

template <typename T, int UMAX>
int launch_graph(const void* tokens, const void* values, void* out, float* adj, int batch,
                 int n, int dim, int mode, int k, float threshold, float temperature,
                 cudaStream_t stream) {
  const int smem = graph_smem_bytes(n);
  cudaError_t err = set_smem(graph_fwd_kernel<T, UMAX>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + R - 1) / R, batch);
  graph_fwd_kernel<T, UMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(tokens), static_cast<const T*>(values), static_cast<T*>(out), adj,
      n, dim, mode, k, threshold, temperature);
  return cudaGetLastError();
}

template <typename T>
int dispatch_graph(const void* tokens, const void* values, void* out, float* adj, int batch,
                   int n, int dim, int mode, int k, float threshold, float temperature,
                   cudaStream_t s) {
  const int u = pad64(n) / 64;
  if (u <= 4)
    return launch_graph<T, 4>(tokens, values, out, adj, batch, n, dim, mode, k, threshold,
                              temperature, s);
  if (u <= 8)
    return launch_graph<T, 8>(tokens, values, out, adj, batch, n, dim, mode, k, threshold,
                              temperature, s);
  return launch_graph<T, 16>(tokens, values, out, adj, batch, n, dim, mode, k, threshold,
                             temperature, s);
}

}  // namespace

// 1 if a block's working set at this N fits in shared memory.
GAVIT_EXPORT int gavit_graph_fits(int n) {
  return pad64(n) <= 1024 && graph_smem_bytes(n) <= kMaxSmemBytes ? 1 : 0;
}

// tokens, values, out [batch, n, dim]; adj [batch, n, n] fp32 or null;
// scratch [batch, n, dim] in the tokens' dtype (the bf16 tensor-core body
// keeps the normalised tokens there; the other body ignores it).
GAVIT_EXPORT int gavit_graph_fwd(const void* tokens, const void* values, void* out, void* adj,
                                 void* scratch, int batch, int n, int dim, int mode, int k,
                                 float threshold, float temperature, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || n < 2 || dim <= 0 || !gavit_graph_fits(n) ||
      mode < MODE_DENSE || mode > MODE_THRESHOLD || (mode == MODE_KNN && k < 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(adj);
  if (dtype == GAVIT_BF16 && n <= kMmaMaxKeys && dim % 8 == 0)
    return launch_graph_tensor_cores(tokens, values, out, a, scratch, batch, n, dim, mode, k,
                                     threshold, temperature, s);
  if (dtype == GAVIT_BF16)
    return dispatch_graph<__nv_bfloat16>(tokens, values, out, a, batch, n, dim, mode, k,
                                         threshold, temperature, s);
  if (dtype == GAVIT_F32)
    return dispatch_graph<float>(tokens, values, out, a, batch, n, dim, mode, k, threshold,
                                 temperature, s);
  return cudaErrorInvalidValue;
}
