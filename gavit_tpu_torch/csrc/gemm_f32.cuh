// One fp32 GEMM mainloop on the CUDA cores, shared by kernels M, M', tgmm
// and N-gmm in fp32 (moe_f32.cu): the expert GEMMs of the MoE engines when
// the model trains, evaluates or explains in fp32. gemm_sm90.cuh is their
// bf16 mainloop; Hopper's wgmma takes no fp32 operands, and TF32 stays off
// (it keeps 10 bits of mantissa), so every product here is an fp32 FMA.
//
// The same two schedules and operand layouts as gemm_sm90.cuh:
// * RowTiles (M, M', N-gmm): C[M, N] = A[M, K] . B_e for the rows of each
//   group e of group_sizes, A row-major (K-major), B_e MN-major ([K, N]
//   rows: the forward's W[e]) or K-major ([N, K] rows: the transposed
//   forms, dye . W2[e]^T, dh1 . W1[e]^T, N-gmm with transpose_rhs). Each
//   block's 128-row tile walks the groups that overlap its rows and runs the
//   main loop once for each, keeping that group's rows (a GEMM row needs no
//   other row, so the whole tile is multiplied by group e's weights and the
//   other rows' sums are discarded); an empty group is skipped; rows past
//   the last group are written as zeros. At the small token counts that
//   pick tm < 128 a tile straddles experts and pays one main loop per group
//   boundary.
// * GroupedK (tgmm): C[e] = A[rows of e]^T . B[rows of e] for A [R, M], B
//   [R, N] row-major and C [E, M, N]: both operands MN-major, the K loop
//   over the rows of one group from its first (any row); the last step's
//   rows past the group are zeroed as they are staged, in A and in B, so
//   they add exactly nothing (Inf and NaN included); an empty group's tiles
//   are stored as zeros.
// No group size is read on the host, so CUDA-graph capture and
// torch.export stay open.
//
// What bounds it on the H100: at the MoE example's b128 shapes (T = 50,432
// routed pairs, D = 768, F = 3072) a GEMM does 2*T*D*F = 2.4e11 FLOPs
// against ~(T*(D+F) + E*D*F)*4 = 0.9 GB, 260 FLOP/byte, far above the
// fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20): the CUDA cores' FMA rate
// bounds it.
//
// Design: a register-blocked SGEMM, simple and right first.
// * A block of 256 threads owns a 128 x 128 output tile; each thread holds
//   an 8 x 8 fp32 accumulator: rows ty*4 + i and 64 + ty*4 + i, columns
//   tx*4 + j and 64 + tx*4 + j (tx = thread % 16, ty = thread / 16), so
//   each k step reads two float4 of A and two of B from shared memory (the
//   A reads broadcast within a warp) for 64 FMAs.
// * K advances in slabs of 8: the next slab is loaded from device memory
//   into registers (one float4 of A and one of B a thread, coalesced along
//   the operand's contiguous dimension) while the current one is multiplied,
//   then stored into the other of two shared-memory buffers; one barrier a
//   slab. A K-major operand is transposed as it is stored (k rows of 128
//   values, padded to 132 words: the four scalar stores of a warp hit 32
//   banks), an MN-major one is stored as it is.
// * Each output element is one fp32 sum in k order, fmaf by fmaf: no
//   atomics, reruns give the same bits. No -use_fast_math.
// * Static shared memory, 16.5 KB a block: the launchers set no attribute
//   and allocate nothing. __launch_bounds__(256, 2): at most 128 registers
//   a thread, two blocks an SM.
// * The epilogue maps each quad (one row, four consecutive columns) of the
//   accumulator in registers and stores it as one float4; with kColSums it
//   also sums the mapped values by column over the segment's rows in a
//   fixed order (a thread's rows, then the 16 row groups through shared
//   memory) into one row of p.part per segment: row lo / p.part_unit for
//   the segment's first row lo.
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace {
namespace gemm32 {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int kThreads = 256;
constexpr int kLd = BM + 4;  // a staged k row of 128 values, padded

struct Params {
  const float* a;          // RowTiles: [m, k]; GroupedK: [k rows, m]
  const float* b;          // RowTiles: [experts, k, n] or (K-major) [experts, n, k]; GroupedK: [k rows, n]
  float* c;                // RowTiles: [m, n]; GroupedK: [experts, m, n]
  int m, n, k;
  const int* group_sizes;  // [experts] on the device
  int experts;
  // for the epilogues that take them (moe_f32.cu)
  const float* bias;       // [experts, n], a row a group
  DropSite drop;           // the mask of the [m, n] output's elements
  float* out2;             // a second output [m, n]
  const float* in2;        // a second input [m, n]
  float* part;             // kColSums: [segments, n], a row per segment
  int part_unit;           // kColSums: a segment's row is its first row / part_unit
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// rows m0.., columns n0.. of slice e of C
struct Tile {
  int m0, n0, e;
};

struct RowTiles {
  static constexpr bool kGroupedK = false;
  static long long count(const Params& p) { return (long long)cdiv(p.m, BM) * cdiv(p.n, BN); }
  static __device__ __forceinline__ Tile at(const Params& p, int t) {
    const int nt = cdiv(p.n, BN);
    return Tile{t / nt * BM, t % nt * BN, 0};
  }
};

struct GroupedK {
  static constexpr bool kGroupedK = true;
  static long long count(const Params& p) {
    return (long long)p.experts * cdiv(p.m, BM) * cdiv(p.n, BN);
  }
  static __device__ __forceinline__ Tile at(const Params& p, int t) {
    const int nt = cdiv(p.n, BN), per = cdiv(p.m, BM) * nt;
    const int r = t % per;
    return Tile{r / nt * BM, r % nt * BN, t / per};
  }
};

struct Smem {
  float a[2][BK][kLd];
  float b[2][BK][kLd];
};
static_assert(16 * BN <= 2 * BK * kLd, "the column sums' buffer fits in A's slabs");

// An operand's rows as the tile reads them: K-major, rows i0.. of [limit,
// ld] (K along a row); MN-major, columns i0.. of [K rows, ld] with `limit`
// columns. Past the limit a tile reads zeros.
struct Operand {
  const float* p;
  long long ld;
  int i0, limit;
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// this thread's float4 of the slab at k (K-major: row r = thread / 2,
// columns k + (thread % 2) * 4; MN-major: row k + thread / 32, columns
// (thread % 32) * 4), zero past the operand's rows or columns and, for
// MN-major, past k_end (K-major operands take K % 8 == 0 and no K tail)
template <bool kKMajor>
__device__ __forceinline__ float4 fetch(const Operand& o, int k, int k_end) {
  const int t = threadIdx.x;
  if (kKMajor) {
    const int r = o.i0 + (t >> 1);
    if (r >= o.limit) return zero4();
    return *reinterpret_cast<const float4*>(o.p + r * o.ld + k + (t & 1) * 4);
  }
  const int kr = k + (t >> 5), c = o.i0 + (t & 31) * 4;
  if (kr >= k_end || c >= o.limit) return zero4();
  return *reinterpret_cast<const float4*>(o.p + kr * o.ld + c);
}

// the fetched float4 into a slab buffer [BK][kLd] (k rows of tile values)
template <bool kKMajor>
__device__ __forceinline__ void stage(float (*s)[kLd], const float4& v) {
  const int t = threadIdx.x;
  if (kKMajor) {
    const int r = t >> 1, c = (t & 1) * 4;
    s[c][r] = v.x, s[c + 1][r] = v.y, s[c + 2][r] = v.z, s[c + 3][r] = v.w;
  } else {
    *reinterpret_cast<float4*>(&s[t >> 5][(t & 31) * 4]) = v;
  }
}

// acc = A[tile rows, k0:k1] . B[k0:k1, tile columns]; k0 and k1 the same in
// every thread of the block (a segment of no k leaves acc zero). Returns
// with shared memory free.
template <bool kAKMajor, bool kBKMajor>
__device__ __forceinline__ void mainloop(const Operand& A, const Operand& B, int k0, int k1,
                                         float (&acc)[8][8], Smem& sm) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (k0 >= k1) return;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float4 ra = fetch<kAKMajor>(A, k0, k1), rb = fetch<kBKMajor>(B, k0, k1);
  stage<kAKMajor>(sm.a[0], ra);
  stage<kBKMajor>(sm.b[0], rb);
  __syncthreads();
  int buf = 0;
  for (int k = k0; k < k1; k += BK) {
    const bool more = k + BK < k1;
    if (more) {
      ra = fetch<kAKMajor>(A, k + BK, k1);
      rb = fetch<kBKMajor>(B, k + BK, k1);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      stage<kAKMajor>(sm.a[buf ^ 1], ra);
      stage<kBKMajor>(sm.b[buf ^ 1], rb);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// the tile row of this thread's accumulator row i
__device__ __forceinline__ int row_of(int i) {
  return (i < 4 ? 0 : 60) + (threadIdx.x >> 4) * 4 + i;
}

// The segment's rows [lo, hi) of the tile through Epi: apply(p, e, col,
// at, v) gets the quad's four values at element `at` of the output (row *
// n + col, past slice e's start for GroupedK) and maps them in place;
// with Epi::kColSums the mapped values are summed by column into p.part.
template <class Epi>
__device__ __forceinline__ void epilogue(const Params& p, const Tile& t, int e, long long base,
                                         int lo, int hi, float (&acc)[8][8], Smem& sm) {
  const int tx = threadIdx.x & 15;
  float cs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cs[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = t.m0 + row_of(i);
    if (row < lo || row >= hi) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = t.n0 + h * 64 + tx * 4;
      if (col >= p.n) continue;
      float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      Epi::apply(p, e, col, base + (long long)row * p.n + col, v);
      if (Epi::kColSums)
#pragma unroll
        for (int j = 0; j < 4; ++j) cs[4 * h + j] += v[j];
    }
  }
  if constexpr (Epi::kColSums) {
    float* red = &sm.a[0][0][0];  // [16][BN]: a row of sums per ty
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[ty * BN + h * 64 + tx * 4 + j] = cs[4 * h + j];
    __syncthreads();
    const int c = threadIdx.x;
    if (c < BN && t.n0 + c < p.n) {
      float s = 0.f;
      for (int y = 0; y < 16; ++y) s += red[y * BN + c];
      p.part[(long long)(lo / p.part_unit) * p.n + t.n0 + c] = s;
    }
    __syncthreads();  // the buffer is free for the next segment's slabs
  }
}

__device__ __forceinline__ void store4(float* at, const float (&v)[4]) {
  *reinterpret_cast<float4*>(at) = make_float4(v[0], v[1], v[2], v[3]);
}

// the plain store (N-gmm, tgmm, M''s dx)
struct StoreEpi {
  static constexpr bool kColSums = false;
  static __device__ __forceinline__ void apply(const Params& p, int, int, long long at,
                                               float (&v)[4]) {
    store4(p.c + at, v);
  }
};

template <class Sched, class Epi, bool kBKMajor>
__global__ void __launch_bounds__(kThreads, 2) gemm_f32_kernel(const Params p) {
  __shared__ __align__(16) Smem sm;
  const Tile t = Sched::at(p, blockIdx.x);
  float acc[8][8];
  if constexpr (Sched::kGroupedK) {
    int r_begin = 0;
    for (int e = 0; e < t.e; ++e) r_begin += p.group_sizes[e];
    const Operand A{p.a, p.m, t.m0, p.m}, B{p.b, p.n, t.n0, p.n};
    mainloop<false, false>(A, B, r_begin, r_begin + p.group_sizes[t.e], acc, sm);
    epilogue<Epi>(p, t, t.e, (long long)t.e * p.m * p.n, t.m0, min(t.m0 + BM, p.m), acc, sm);
  } else {
    const int m_end = min(t.m0 + BM, p.m);
    const Operand A{p.a, p.k, t.m0, p.m};
    int start = 0;
    for (int e = 0; e < p.experts && start < m_end; ++e) {
      const int end = start + p.group_sizes[e];
      const int lo = max(start, t.m0), hi = min(end, m_end);
      if (lo < hi) {
        const float* be = p.b + (long long)e * p.k * p.n;
        const Operand B = kBKMajor ? Operand{be, p.k, t.n0, p.n} : Operand{be, p.n, t.n0, p.n};
        mainloop<true, kBKMajor>(A, B, 0, p.k, acc, sm);
        epilogue<Epi>(p, t, e, 0, lo, hi, acc, sm);
      }
      start = end;
    }
    // rows past every group: zeros
    const int tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = t.m0 + row_of(i);
      if (row < start || row >= m_end) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = t.n0 + h * 64 + tx * 4;
        if (col < p.n)
          *reinterpret_cast<float4*>(p.c + (long long)row * p.n + col) = zero4();
      }
    }
  }
}

// One launch: a block a tile, N fastest (GroupedK: then M, then the
// group). Shapes: every width a multiple of 8 (16-byte rows, no K tail).
template <class Sched, class Epi, bool kBKMajor>
cudaError_t launch(const Params& p, cudaStream_t s) {
  if (p.m <= 0 || p.n <= 0 || p.n % 8 || p.experts <= 0 ||
      (Sched::kGroupedK ? p.k < 0 || p.m % 8 : p.k <= 0 || p.k % 8))
    return cudaErrorInvalidValue;
  const long long tiles = Sched::count(p);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  gemm_f32_kernel<Sched, Epi, kBKMajor><<<(unsigned)tiles, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace gemm32
}  // namespace
