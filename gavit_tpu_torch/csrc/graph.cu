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
// A.V) on [N, D] inputs that are read once from device memory per row block
// and otherwise come from L2, so at N=196, D=768 it is bound by on-chip
// operand bandwidth, not HBM. Rows are independent, so the grid runs over
// (16-row query block, image) and B=1 still launches 13 blocks per image.
//
// Two bodies, chosen by dtype and N (never by a failure): bf16 with N <= 256
// runs on the tensor cores (graph_fwd_mma_kernel, described with it below);
// fp32, and bf16 past 256 keys, run graph_fwd_kernel on the CUDA cores.
//
// CUDA-core design per block (256 threads):
//  1. inverse norms of all N rows of the image (a warp per row);
//  2. sim[16, N] accumulated in registers over 32-wide chunks of D: each
//     thread owns 4 rows x N/64 columns, so one shared load feeds 2-4 FMAs;
//     the key chunk is stored with a 33-word row stride (conflict free);
//  3. selection, softmax and the optional adjacency write, a warp per row;
//  4. out[16, D] = A.V with V streamed from memory once per block and the
//     rounded adjacency read as float4 broadcasts from a transposed copy.
#include "common.cuh"

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
//     once per image into a scratch [B, N, D] (a warp per row), instead of
//     every row block normalising every key again;
//  2. graph_fwd_mma_kernel: a block owns 64 query rows of one image, 16 per
//     warp. sim for the warp's rows and all keys stays in registers
//     (mma.sync m16n8k16, fp32 accumulate) over 64-wide chunks of D staged
//     in shared memory; selection (k passes of quad-wide leftmost-max, a
//     64-bit mask per row), softmax and the optional adjacency write run on
//     those registers; the rounded adjacency is re-packed into A fragments
//     and multiplied by V chunks read with ldmatrix.trans.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;
constexpr int kMmaMaxKeys = 256;
constexpr int kMmaTiles = kMmaMaxKeys / 8;  // n8 key tiles held in registers
constexpr int kChunk = 64;                   // D columns staged at a time
constexpr int kStride = kChunk + 8;          // 36 words: conflict-free fragments

__host__ __device__ inline int keys16(int n) { return (n + 15) & ~15; }

int graph_mma_smem_bytes(int n) {
  return (kMmaRows + keys16(n)) * kStride * (int)sizeof(__nv_bfloat16);
}

__global__ void __launch_bounds__(kThreads)
    graph_normalize_kernel(const __nv_bfloat16* __restrict__ t,
                           __nv_bfloat16* __restrict__ tn, int rows, int dim) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat16* src = t + (long)row * dim;
  float s = 0.f;
  for (int c = lane; c < dim; c += 32) {
    const float x = __bfloat162float(src[c]);
    s = fmaf(x, x, s);
  }
  const float r = 1.f / sqrtf(warp_sum(s) + kEps);
  for (int c = lane; c < dim; c += 32)
    tn[(long)row * dim + c] = __float2bfloat16_rn(__bfloat162float(src[c]) * r);
}

// stage rows [0, count) of a [n, dim] bf16 matrix, columns d0..d0+63, into a
// [count][kStride] shared array in 16-byte chunks; rows >= n and columns >=
// dim read as zero
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            int row0, int count, int n, int dim, int d0) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = threadIdx.x; c < count * (kChunk / 8); c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int row = row0 + r, d = d0 + col;
    *reinterpret_cast<uint4*>(dst + r * kStride + col) =
        row < n && d < dim ? *reinterpret_cast<const uint4*>(src + (long)row * dim + d) : zero;
  }
}

__global__ void __launch_bounds__(kMmaWarps * 32)
    graph_fwd_mma_kernel(const __nv_bfloat16* __restrict__ tn,
                         const __nv_bfloat16* __restrict__ values,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ adj, int n,
                         int dim, int mode, int k, float threshold, float temperature) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = keys16(n);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][72]
  __nv_bfloat16* skv = sq + kMmaRows * kStride;                     // [nk][72]

  const int b = blockIdx.y, i0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* tb = tn + (long)b * n * dim;
  const __nv_bfloat16* vb = values + (long)b * n * dim;
  const int r0 = i0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows

  // sim[16 rows, nk keys] of this warp
  float s[kMmaTiles][4];
#pragma unroll
  for (int j = 0; j < kMmaTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const __nv_bfloat16* qw = sq + (warp * 16 + g) * kStride + 2 * t;
  for (int d0 = 0; d0 < dim; d0 += kChunk) {
    stage_chunk(sq, tb, i0, kMmaRows, n, dim, d0);
    stage_chunk(skv, tb, 0, nk, n, dim, d0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      uint32_t a[4] = {ld32(qw + kk), ld32(qw + 8 * kStride + kk), ld32(qw + kk + 8),
                       ld32(qw + 8 * kStride + kk + 8)};
#pragma unroll
      for (int j = 0; j < kMmaTiles; ++j) {
        if (j * 8 < nk) {
          const __nv_bfloat16* kp = skv + (j * 8 + g) * kStride + kk + 2 * t;
          uint32_t bb[2] = {ld32(kp), ld32(kp + 8)};
          mma_16816(s[j], a, bb);
        }
      }
    }
    __syncthreads();
  }

  // selection: bit 2j+e of sel[h] is key j*8 + 2t + e of row r0 (h=0) or r1
  uint64_t sel[2] = {0, 0};
  const int rows[2] = {r0, r1};
  if (mode == MODE_KNN) {
    const int kk = min(k, n - 1);
    for (int pass = 0; pass < kk; ++pass) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float best = -INFINITY;
        int bidx = n;
#pragma unroll
        for (int j = 0; j < kMmaTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // ascending keys: leftmost wins in-thread
            const int key = j * 8 + 2 * t + e;
            if (key < n && key != rows[h] && !((sel[h] >> (2 * j + e)) & 1) &&
                s[j][2 * h + e] > best) {
              best = s[j][2 * h + e];
              bidx = key;
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
      for (int j = 0; j < kMmaTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j * 8 + 2 * t + e;
          const bool on = key < n && key != rows[h] &&
                          (mode == MODE_DENSE || s[j][2 * h + e] > threshold);
          if (on) sel[h] |= 1ull << (2 * j + e);
        }
      if (mode == MODE_THRESHOLD) {  // a row with no edge keeps its self edge
        int any = sel[h] != 0;
        any |= __shfl_xor_sync(0xffffffffu, any, 1);
        any |= __shfl_xor_sync(0xffffffffu, any, 2);
        const int self = rows[h];
        if (!any && self < n && ((self & 7) >> 1) == t)
          sel[h] |= 1ull << (2 * (self >> 3) + (self & 1));
      }
    }
  }

  // softmax of sim/temperature over the selected keys, rows r0 and r1
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < kMmaTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if ((sel[h] >> (2 * j + e)) & 1) m[h] = fmaxf(m[h], s[j][2 * h + e] / temperature);
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], o));
#pragma unroll
    for (int j = 0; j < kMmaTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool on = (sel[h] >> (2 * j + e)) & 1;
        const float p = on ? expf(s[j][2 * h + e] / temperature - m[h]) : 0.f;
        s[j][2 * h + e] = p;
        l[h] += p;
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
    const float inv = 1.f / l[h];
#pragma unroll
    for (int j = 0; j < kMmaTiles; ++j) {
      s[j][2 * h] *= inv;
      s[j][2 * h + 1] *= inv;
    }
    if (adj != nullptr && rows[h] < n) {
      float* arow = adj + ((long)b * n + rows[h]) * n;
#pragma unroll
      for (int j = 0; j < kMmaTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j * 8 + 2 * t + e;
          if (key < n) arow[key] = s[j][2 * h + e];
        }
    }
  }

  // out = A.V, A rounded to bf16 and packed as the A fragments of key steps
  uint32_t pa[kMmaTiles / 2][4];
#pragma unroll
  for (int kk = 0; kk < kMmaTiles / 2; ++kk) {
    pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
  const int lrow = lane & 15;
  for (int d0 = 0; d0 < dim; d0 += kChunk) {
    stage_chunk(skv, vb, 0, nk, n, dim, d0);
    __syncthreads();
    float o[kChunk / 8][4];
#pragma unroll
    for (int d = 0; d < kChunk / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMmaTiles / 2; ++kk) {
      if (kk * 16 < nk) {
#pragma unroll
        for (int d = 0; d < kChunk / 8; ++d) {
          uint32_t bb[2];
          ldmatrix_x2_trans(bb, skv + (kk * 16 + lrow) * kStride + d * 8);
          mma_16816(o[d], pa[kk], bb);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < kChunk / 8; ++d) {
      const int col = d0 + d * 8 + 2 * t;
      if (col >= dim) continue;
      __nv_bfloat16* ob = out + ((long)b * n) * dim + col;
      if (r0 < n) *reinterpret_cast<uint32_t*>(ob + (long)r0 * dim) = pack_bf16(o[d][0], o[d][1]);
      if (r1 < n) *reinterpret_cast<uint32_t*>(ob + (long)r1 * dim) = pack_bf16(o[d][2], o[d][3]);
    }
    __syncthreads();  // the next chunk overwrites skv
  }
}

int launch_graph_mma(const void* tokens, const void* values, void* out, float* adj,
                     void* scratch, int batch, int n, int dim, int mode, int k,
                     float threshold, float temperature, cudaStream_t stream) {
  if (scratch == nullptr || dim % 8) return cudaErrorInvalidValue;
  const int rows = batch * n;
  graph_normalize_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(tokens), static_cast<__nv_bfloat16*>(scratch), rows,
      dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = graph_mma_smem_bytes(n);
  err = set_smem(graph_fwd_mma_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kMmaRows - 1) / kMmaRows, batch);
  graph_fwd_mma_kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(scratch), static_cast<const __nv_bfloat16*>(values),
      static_cast<__nv_bfloat16*>(out), adj, n, dim, mode, k, threshold, temperature);
  return cudaGetLastError();
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
    return launch_graph_mma(tokens, values, out, a, scratch, batch, n, dim, mode, k, threshold,
                            temperature, s);
  if (dtype == GAVIT_BF16)
    return dispatch_graph<__nv_bfloat16>(tokens, values, out, a, batch, n, dim, mode, k,
                                         threshold, temperature, s);
  if (dtype == GAVIT_F32)
    return dispatch_graph<float>(tokens, values, out, a, batch, n, dim, mode, k, threshold,
                                 temperature, s);
  return cudaErrorInvalidValue;
}
