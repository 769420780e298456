// One bf16 GEMM mainloop for Hopper, shared by kernels B, D and D' (mlp.cu:
// the serving and the training MLP's fc1 and fc2, the backward's dh), M
// and M' (moe.cu: the MoE expert MLP's fc1 and fc2, the backward's dh),
// N-gmm (moe.cu: megablox gmm in both forms) and tgmm (moe.cu: megablox
// tgmm, the grouped weight gradient): TMA-fed, warp-specialised wgmma with
// two tile schedules and pluggable epilogues (train_epilogues.cuh holds
// the training ones).
//
// * RowTiles (B, D, D', M, M', N-gmm): C[M, N] = A[M, K] . B_e for the rows
//   of each group e of group_sizes, with A row-major (K-major) and B_e either
//   K-major ([N, K] rows: nn.Linear's weights, gmm's transposed form) or
//   MN-major ([K, N] rows: gmm's forward W[e], D''s W2). A dense GEMM is
//   one group of every row (group_sizes null: no group size is read).
// * GroupedK (tgmm): C[e] = A[rows of e]^T . B[rows of e] for A [R, M], B
//   [R, N] row-major and C [E, M, N]: both operands MN-major, and the K loop
//   runs over the rows of one group.
//
// What bounds it on the H100: at the main shapes (B: M = 12608, D: M =
// 25216, K, N = 768, 3072; N-gmm and tgmm: T = 50432) a GEMM does 2*M*K*N
// FLOPs against (M*K + K*N*E + M*N)*2 bytes, far above the card's ~295
// FLOP/byte ridge: the tensor cores bound it, fed from L2.
//
// Design (one persistent block an SM, 384 threads):
// * Tiles of 128 x 192 output elements, walked by the blocks in turn (tile
//   t by block t mod grid), N fastest (GroupedK: then M, then the group).
//   192 divides 768 and 3072, and the tile counts at the main shapes fill
//   whole waves of 132 SMs (B's fc1 1584 = 12 waves, fc2 396 = 3); a
//   persistent loop also lifts gridDim.y's limit on M.
// * Warpgroup 0 is the producer: one thread issues every TMA load into a
//   4-stage ring of 128-byte swizzled tiles (A 128 x 64, B 192 x 64: 40 KB a
//   stage) and signals full barriers; the consumers free a stage through its
//   empty barrier once the wgmmas that read it are done (256 arrivals). Its
//   warps 1-3 are the epilogue warps (below).
// * Warpgroups 1 and 2 are the consumers: each owns 64 rows of the tile,
//   issues wgmma m64n192k16 with both operands in shared memory (4 per
//   64-wide K step, one group kept in flight) and holds a 64 x 192 fp32
//   accumulator (96 registers a thread). No setmaxnreg: at 168 registers a
//   thread the accumulator and the loop fit without spills (ptxas sizes
//   every region by the launch bound whatever setmaxnreg asks, as the
//   attention forward found).
// * Epilogue, in two parts. The consumers map each accumulator quad (two
//   columns of rows r0 and r0 + 8) in registers (a bias; D's output mask)
//   and round it to bf16 into a 128-byte swizzled staging tile per
//   warpgroup (64 x 192: three 64-column atoms), then hand the tile over
//   through an mbarrier. The epilogue warps apply the epilogue's finish to
//   the staged values in shared memory (B's GELU) and store the tile by
//   TMA, which drops rows past M and columns past N; once the store has
//   read it, the tile goes back to its consumers. The finish and the store
//   of one tile overlap the next tile's mainloop: run by the consumers
//   themselves, B's fc1 GELU (about 35 instructions a value, tanhf among
//   them) took nearly as long as its mainloop, with the tensor cores idle.
// * D's and M's training epilogues: epilogue warps 2-3 draw each tile's
//   Philox keep bits (one bit an element, 3 KB a tile, double-buffered;
//   nothing at rate 0) ahead of the consumers, which apply them in
//   registers (fc2) or when they read their staged h1 back and write g =
//   GELU(h1) * keep * scale themselves (fc1); warp 1 stores. Run on the
//   three epilogue warps, the exact-erf GELU and Philox held fc1 to 3.5
//   times its bare GEMM's time (PERF.md §6). M's add the bias row of the
//   segment's group (apply gets the group's index).
// * M''s and D''s dh epilogue (kStagedIn): epilogue warp 1 loads each
//   warpgroup's 64 x 192 tile of a second input (p.c2: the forward's h1)
//   by TMA into the warpgroup's staging tile as soon as the previous
//   tile's store has read it, so the load overlaps the mainloop; the
//   consumers read each accumulator quad's inputs back from where they
//   will stage its result, map both (apply_in), and overwrite them in
//   place. They then sum each segment's mapped fp32 values by column in a
//   fixed order (the 8 rows of a quad's lanes by shuffles, then the 8
//   consumer warps through shared memory) into one row of p.part per
//   segment: row lo / p.part_unit for the segment's first row lo, which
//   the caller's grouping makes a multiple of part_unit. No atomics.
// * RowTiles' groups (M, N-gmm): each block walks the groups that overlap its
//   128-row tile and runs the mainloop once for each (a GEMM row needs no
//   other row, so the whole tile is multiplied by group e's weights and
//   only e's rows are kept). The segments of one tile write disjoint rows
//   of the same staging tile, rows past the last group are staged as
//   zeros, and the tile leaves in one store: every element is written once,
//   from one fp32 sum, with no atomics, so reruns give the same bits.
//   Straddling tiles cost one extra mainloop per group boundary (at most E
//   - 1 a column of tiles). Nothing reads a group size on the host.
// * GroupedK (tgmm): a tile of C[e] walks e's rows [r_begin, r_end) in
//   64-row steps from r_begin (TMA box coordinates need no alignment). A
//   consumer warpgroup's A operand is one 64 x 64 atom A[r.., m0 + 64 wg
//   ..]^T, read with wgmma's transpose-A bit. The last step's rows at or
//   past r_end belong to the next group or lie past R: both consumer
//   warpgroups zero them in shared memory, in A and in B, before any wgmma
//   reads the stage, so they add exactly nothing (Inf and NaN included).
//   An empty group's tile takes no ring step and stages zeros. Each element
//   is one fp32 sum rounded once: reruns give the same bits.
// * Edges: rows past M and the K tail arrive as zeros through TMA's
//   out-of-bounds fill; an atom wholly past M or N is not loaded (the rows
//   or columns it would feed are never stored).
// * Tensor maps: rank 3 ([depth, rows, inner]), encoded on the host and
//   cached by (address, extents, box): weights hit the cache on every call
//   after the first, and activations too once PyTorch's allocator hands out
//   the same blocks again, so a served call pays no encode in steady state.
#pragma once

#include <mutex>

#include "common.cuh"
#include "philox.cuh"
#include "sm90.cuh"

namespace {
namespace gemm90 {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 192, BK = 64, kStages = 4;
constexpr int kAtom = 64;                       // elements in one 128-byte swizzle row
constexpr int kAtoms = BN / kAtom;              // MN-major B atoms of a tile
constexpr int kAtomBytes = 64 * 128;            // one atom of 64 rows
constexpr int kABytes = BM * BK * 2;            // 16 KB
constexpr int kBBytes = BN * BK * 2;            // 24 KB
constexpr int kStageBytes = kABytes + kBBytes;  // 40 KB
constexpr int kWgRows = 64;                     // rows of a consumer warpgroup
constexpr int kOutBytes = kWgRows * BN * 2;     // a warpgroup's staging tile, 24 KB
constexpr int kMaskBytes = BM * BN / 8;        // a tile's keep bits, a byte per 8 columns
constexpr int kRedBytes = 8 * BN * 4;           // kStagedIn: a column sum row per consumer warp
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
static_assert(kWgRows * 128 == kAtomBytes, "a warpgroup's K-major A rows are one atom");

struct Barriers {
  uint64_t full[kStages], empty[kStages];  // the ring
  uint64_t out_full[2], out_empty[2];      // the consumers' staging tiles
  uint64_t mask_full[2], mask_empty[2];    // the keep bits of two tiles
  uint64_t in_full[2];                     // kStagedIn: a staging tile holds its input
};

// shared memory from a 1024-byte aligned base: the ring, the two staging
// tiles, the keep bits of two tiles, the column sums' buffer, the barriers
struct Layout {
  static constexpr int kOut = kStages * kStageBytes;
  static constexpr int kMask = kOut + 2 * kOutBytes;
  static constexpr int kRed = kMask + 2 * kMaskBytes;
  static constexpr int kBars = kRed + kRedBytes;
  static constexpr int kBytes = kBars + (int)sizeof(Barriers) + 1024;
};
static_assert(Layout::kBytes <= kMaxSmemBytes, "the GEMM's shared memory exceeds a block's");

struct Params {
  CUtensorMap a, b, c;
  CUtensorMap c2;          // kStagedIn: the input tile [M, N] read in C's boxes
  int m, n, k;
  const int* group_sizes;  // [experts] on the device; null: one group of all rows
  int experts;
  const bf16* bias;        // for the epilogues that take one: [N], or a row a group
  int bias_stride;         // elements from one group's bias row to the next's (0: one row)
  DropSite drop;           // for the epilogues that mask (D, M)
  bf16* out2;              // a second output [M, N], for the epilogues that write one (g)
  float* part;             // kStagedIn: [segments, N] column sums, a row per segment
  int part_unit;           // kStagedIn: a segment's partial row is its first row / part_unit
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// An output tile: rows m0.., columns n0.. of slice `depth` of C.
struct Tile {
  int m0, n0, depth;
};

// Rows [lo, hi) of a tile keep the product over K indices [k0, k1) with
// group e's operands; `end` is the first row past group e (RowTiles) or past
// the tile (GroupedK). A schedule's next() steps a segment, starting from
// kNoSegment, to the tile's next one and returns false past the last, with
// `end` then the first row of the tile past every group. The walk is a plain
// loop in the kernel, no callback, so that the mainloop's accumulator never
// has its address taken and stays in registers.
struct Segment {
  int e, k0, k1, lo, hi, end;
};
constexpr Segment kNoSegment{-1, 0, 0, 0, 0, 0};

// The row schedule: C [M, N], N fastest; a tile's segments are the groups
// that hold its rows, in order, each over the whole of K.
struct RowTiles {
  static constexpr bool kTransA = false;
  static __host__ __device__ long long count(const Params& p) {
    return (long long)cdiv(p.m, BM) * cdiv(p.n, BN);
  }
  static __device__ __forceinline__ Tile at(const Params& p, int t) {
    const int nt = cdiv(p.n, BN);
    return Tile{t / nt * BM, t % nt * BN, 0};
  }
  static __device__ __forceinline__ bool next(const Params& p, const Tile& t, Segment& sg) {
    const int m_end = min(t.m0 + BM, p.m);
    if (p.group_sizes == nullptr) {
      if (sg.e >= 0) return false;
      sg = Segment{0, 0, p.k, t.m0, m_end, m_end};
      return true;
    }
    for (int e = sg.e + 1; e < p.experts && sg.end < m_end; ++e) {
      const int start = sg.end, end = start + p.group_sizes[e];
      sg.e = e, sg.end = end;
      const int lo = max(start, t.m0), hi = min(end, m_end);
      if (lo < hi) {
        sg.k0 = 0, sg.k1 = p.k, sg.lo = lo, sg.hi = hi;
        return true;
      }
    }
    return false;
  }
};

// The grouped-K schedule: C [E, M, N], N fastest, then M, then the group;
// one segment a tile, K over its group's rows of A [R, M] and B [R, N].
struct GroupedK {
  static constexpr bool kTransA = true;
  static __host__ __device__ long long count(const Params& p) {
    return (long long)p.experts * cdiv(p.m, BM) * cdiv(p.n, BN);
  }
  static __device__ __forceinline__ Tile at(const Params& p, int t) {
    const int nt = cdiv(p.n, BN), per = cdiv(p.m, BM) * nt;
    const int r = t % per;
    return Tile{r / nt * BM, r % nt * BN, t / per};
  }
  static __device__ __forceinline__ bool next(const Params& p, const Tile& t, Segment& sg) {
    if (sg.e >= 0) return false;
    int r_begin = 0;
    for (int e = 0; e < t.depth; ++e) r_begin += p.group_sizes[e];
    sg = Segment{t.depth, r_begin, r_begin + p.group_sizes[t.depth], t.m0, t.m0 + BM,
                 t.m0 + BM};
    return true;
  }
};

// An epilogue: `apply` maps an accumulator quad (columns col and col + 1 of
// two rows, r0 and r0 + 8, of group e's segment) in the consumers'
// registers before the values are rounded to bf16 and staged. With
// kFinish, the epilogue warps then map each 16-byte chunk of 8 staged
// values (row, columns col..col + 7) with finish(), in shared memory, while
// the consumers run the next tile's mainloop. With kReadBack, the
// consumers themselves map each chunk of their staged tile with
// read_back(), which writes a second output (D's and M's g) and leaves the
// staged values as they are. With kDrawBits, the epilogue
// warps draw each tile's keep bits with keep8() (bit i: column col + i of
// a row) ahead of its consumers, Philox's arithmetic off the tensor cores'
// path; apply() gets its quad's 4 bits (columns col, col + 1 of row r0,
// then of r0 + 8), read_back() the 8 of its chunk. With kStagedIn,
// apply_in() takes the place of apply() and also gets the quad's two
// staged input pairs and whether each of its rows is the segment's, and
// the mapped values of the segment's rows are summed by column into
// p.part.
// The epilogue that stores the sums as they are:
struct StoreEpi {
  static constexpr bool kFinish = false, kReadBack = false, kDrawBits = false;
  static constexpr bool kStagedIn = false;
  static __device__ __forceinline__ void apply(const Params&, int, int, uint32_t, float (&)[4]) {}
};

// The row and the first column of the 8 values in 16-byte chunk c of a
// staging tile whose rows start at m0 and columns at n0: atom c / 512, row
// (c / 8) % 64, logical chunk (c % 8) ^ (row % 8) of the 128-byte swizzle.
__device__ __forceinline__ int chunk_row(int m0, int c) { return m0 + ((c >> 3) & 63); }
__device__ __forceinline__ int chunk_col(int n0, int c) {
  return n0 + (c >> 9) * kAtom + (((c & 7) ^ ((c >> 3) & 7)) << 3);
}

// GroupedK's last step of a group: rows [valid, BK) of the stage hold the
// next group's rows or TMA's zeros past R. Warpgroup wg zeros them in its
// own A atom, the two consumer warpgroups together in B's atoms; both then
// wait for each other, so that no wgmma reads the stage before every zero
// is visible to the async proxy. Whole 128-byte rows: the swizzle does not
// matter.
__device__ __forceinline__ void zero_tail(uint8_t* stage, int wg, int valid) {
  const int ct = threadIdx.x - 128;     // 0..255 over both consumer warpgroups
  const int chunks = (BK - valid) * 8;  // 16-byte chunks of an atom's rows past valid
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  uint8_t* a = stage + wg * kAtomBytes + valid * 128;
  for (int c = ct & 127; c < chunks; c += 128) *reinterpret_cast<uint4*>(a + 16 * c) = z;
  uint8_t* b = stage + kABytes + valid * 128;
  for (int c = ct; c < kAtoms * chunks; c += kConsumers)
    *reinterpret_cast<uint4*>(b + (c / chunks) * kAtomBytes + 16 * (c % chunks)) = z;
  fence_proxy_async();
  named_sync(2, kConsumers);
}

// acc = (this warpgroup's 64 rows of A) . B over the segment's K indices;
// `it` counts the ring's uses in the block's order (the producer's). A
// segment of no K index (GroupedK's empty group) takes no step and leaves
// acc as it was.
template <bool kMnB, bool kTransA>
__device__ __forceinline__ void mainloop(float (&acc)[96], uint8_t* smem, int wg,
                                         const Segment& sg, uint32_t& it, Barriers& bar) {
  const uint32_t ring = smem_u32(smem);
  const int steps = cdiv(sg.k1 - sg.k0, BK);
  for (int ks = 0; ks < steps; ++ks, ++it) {
    const int s = it % kStages;
    mbar_wait(&bar.full[s], (it / kStages) & 1);
    if (kTransA) {
      const int valid = sg.k1 - sg.k0 - ks * BK;
      if (valid < BK) zero_tail(smem + s * kStageBytes, wg, valid);
    }
    const uint32_t a = ring + s * kStageBytes + wg * kAtomBytes;
    const uint32_t b = ring + s * kStageBytes + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = kTransA ? mnmajor_desc(a + 2048 * kk) : kmajor_desc(a + 32 * kk);
      const uint64_t db =
          kMnB ? mnmajor_wide_desc(b + 2048 * kk, kAtomBytes) : kmajor_desc(b + 32 * kk);
      wgmma_m64n192k16_ss<kTransA ? 1 : 0, kMnB ? 1 : 0>(acc, da, db, ks > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's wgmmas are done: free its stage
    if (ks > 0) mbar_arrive(&bar.empty[(it - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (steps > 0) mbar_arrive(&bar.empty[(it - 1) % kStages]);
}

// kStagedIn: load staging tile w's input, the 64 x 192 box of p.c2 at the
// tile's rows m0 + 64 w and columns n0 (the atoms past N, and every atom
// when the rows lie past M, are not loaded: those values are never stored)
__device__ __forceinline__ void load_input(const Params& p, const Tile& t, int w, uint8_t* out,
                                           uint64_t* full) {
  const int m0 = t.m0 + w * kWgRows;
  const int atoms = m0 < p.m ? min(kAtoms, cdiv(p.n - t.n0, kAtom)) : 0;
  mbar_expect_tx(full, atoms * kAtomBytes);
  for (int j = 0; j < atoms; ++j)
    tma_load_3d(out + j * kAtomBytes, &p.c2, full, t.n0 + j * kAtom, m0, 0);
}

// kStagedIn, as each accumulator quad is mapped: the sums s0, s1 of its two
// columns over the quad's two rows, summed over the warp's 8 row lanes by
// shuffles into the warp's column-sum row (at the quad's first column), so
// that no mapped value stays live for the sums
__device__ __forceinline__ void quad_col_sums(float* at, int g, float s0, float s1) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if (g == 0) at[0] = s0, at[1] = s1;
}

// kStagedIn, after a segment's quads: the 8 consumer warps' column-sum rows
// summed in order into row sg.lo / p.part_unit of p.part. Both consumer
// warpgroups call it for the same segment.
__device__ __forceinline__ void col_sums(const Params& p, float* red, const Tile& t,
                                         const Segment& sg) {
  named_sync(5, kConsumers);
  const int c = threadIdx.x - 128;
  if (c < BN && t.n0 + c < p.n) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w * BN + c];
    p.part[(long long)(sg.lo / p.part_unit) * p.n + t.n0 + c] = s;
  }
  named_sync(5, kConsumers);  // the buffer is free for the next segment
}

// a consumer warpgroup's wait for its staging tile at tile ti: until the
// previous tile's store has read it; kStagedIn: until this tile's input
// (loaded once that store has read it) has landed
template <class Epi>
__device__ __forceinline__ void wait_staging(Barriers& bar, int wg, int ti) {
  if constexpr (Epi::kStagedIn)
    mbar_wait(&bar.in_full[wg], ti & 1);
  else
    mbar_wait(&bar.out_empty[wg], (ti & 1) ^ 1);
}

template <class Epi, bool kMnB, class Sched>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t gemm_smem[];
  uint8_t* smem = gemm_smem + ((1024 - (smem_u32(gemm_smem) & 1023)) & 1023);
  Barriers& bar = *reinterpret_cast<Barriers*>(smem + Layout::kBars);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      mbar_init(&bar.full[s], 1), mbar_init(&bar.empty[s], kConsumers);
    for (int w = 0; w < 2; ++w) {
      mbar_init(&bar.out_full[w], kConsumers / 2), mbar_init(&bar.out_empty[w], 1);
      mbar_init(&bar.mask_full[w], 64), mbar_init(&bar.mask_empty[w], kConsumers);
      mbar_init(&bar.in_full[w], 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int tiles = (int)Sched::count(p);

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every TMA load ----
    if (threadIdx.x == 0) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Tile t = Sched::at(p, tile);
        const int a_atoms = Sched::kTransA ? min(BM / kAtom, cdiv(p.m - t.m0, kAtom)) : 0;
        const int b_atoms = kMnB ? min(kAtoms, cdiv(p.n - t.n0, kAtom)) : 0;
        const unsigned bytes = (Sched::kTransA ? a_atoms * kAtomBytes : kABytes) +
                               (kMnB ? b_atoms * kAtomBytes : kBBytes);
        for (Segment sg = kNoSegment; Sched::next(p, t, sg);) {
          const int depth = Sched::kTransA ? 0 : sg.e;  // B's slice: group e's weights
          for (int kx = sg.k0; kx < sg.k1; kx += BK, ++it) {
            const int s = it % kStages;
            mbar_wait(&bar.empty[s], ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(&bar.full[s], bytes);
            uint8_t* st = smem + s * kStageBytes;
            if (Sched::kTransA) {
              for (int j = 0; j < a_atoms; ++j)
                tma_load_3d(st + j * kAtomBytes, &p.a, &bar.full[s], t.m0 + j * kAtom, kx, 0);
            } else {
              tma_load_3d(st, &p.a, &bar.full[s], kx, t.m0, 0);
            }
            if (kMnB) {
              for (int j = 0; j < b_atoms; ++j)
                tma_load_3d(st + kABytes + j * kAtomBytes, &p.b, &bar.full[s], t.n0 + j * kAtom,
                            kx, depth);
            } else {
              tma_load_3d(st + kABytes, &p.b, &bar.full[s], kx, t.n0, depth);
            }
          }
        }
      }
    } else if (threadIdx.x >= 32) {
      // ---- epilogue warps 1-3: finish each staging tile, store it; or,
      // with kDrawBits, warp 1 stores and warps 2-3 draw the keep bits ----
      static_assert(!(Epi::kFinish && Epi::kDrawBits), "the finish pass takes warps 2-3");
      const int etid = threadIdx.x - 32;
      if constexpr (Epi::kDrawBits) {
        if (etid >= 32) {
          int ti = 0;
          for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
            const Tile t = Sched::at(p, tile);
            // buffer ti % 2, once its consumers have read tile ti - 2's bits
            mbar_wait(&bar.mask_empty[ti & 1], ((ti >> 1) & 1) ^ 1);
            uint8_t* mask = smem + Layout::kMask + (ti & 1) * kMaskBytes;
            if (p.drop.on)  // at rate 0 the bits are never read
              for (int i = etid - 32; i < kMaskBytes; i += 64)
                mask[i] = (uint8_t)Epi::keep8(p, t.m0 + i / (BN / 8), t.n0 + 8 * (i % (BN / 8)));
            mbar_arrive(&bar.mask_full[ti & 1]);
          }
          return;
        }
      }
      if (!Epi::kFinish && etid != 0) return;  // storing takes one thread
      if (Epi::kStagedIn && blockIdx.x < tiles)
        for (int w = 0; w < 2; ++w)
          load_input(p, Sched::at(p, blockIdx.x), w, smem + Layout::kOut + w * kOutBytes,
                     &bar.in_full[w]);
      int ti = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
        const Tile t = Sched::at(p, tile);
        for (int w = 0; w < 2; ++w) {
          uint8_t* out = smem + Layout::kOut + w * kOutBytes;
          const int m0 = t.m0 + w * kWgRows;
          mbar_wait(&bar.out_full[w], ti & 1);
          if constexpr (Epi::kFinish) {
            // elementwise, so the swizzle does not matter: 2 x 16 bytes a
            // step, 16 independent values for one warp to overlap
            static_assert(kOutBytes % (2 * 16 * 96) == 0, "the finish pass's steps");
            for (int c = etid; c < kOutBytes / 16; c += 2 * 96) {
              uint4 q[2] = {*reinterpret_cast<const uint4*>(out + 16 * c),
                            *reinterpret_cast<const uint4*>(out + 16 * (c + 96))};
              Epi::finish(q[0]);
              Epi::finish(q[1]);
              *reinterpret_cast<uint4*>(out + 16 * c) = q[0];
              *reinterpret_cast<uint4*>(out + 16 * (c + 96)) = q[1];
            }
            fence_proxy_async();
            named_sync(1, 96);
          }
          if (etid == 0) {
            if (m0 < p.m)
              for (int j = 0; j < kAtoms && t.n0 + j * kAtom < p.n; ++j)
                tma_store_3d(&p.c, out + j * kAtomBytes, t.n0 + j * kAtom, m0, t.depth);
            bulk_commit();
            bulk_wait_read<0>();  // the store has read the tile: the consumers may refill it
            if constexpr (Epi::kStagedIn) {  // with the next tile's input
              if (tile + (int)gridDim.x < tiles)
                load_input(p, Sched::at(p, tile + gridDim.x), w, out, &bar.in_full[w]);
            } else {
              mbar_arrive(&bar.out_empty[w]);
            }
          }
        }
      }
      if (etid == 0) bulk_wait<0>();
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64*wg.. of each tile ----
  const int wg = (threadIdx.x >> 7) - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  uint8_t* out = smem + Layout::kOut + wg * kOutBytes;
  // this thread's two rows of the staging tile (row & 7 == g for both)
  uint8_t* row0 = out + (warp * 16 + g) * 128 + 4 * q4;
  uint8_t* row1 = row0 + 8 * 128;
  float* red = reinterpret_cast<float*>(smem + Layout::kRed);
  float acc[96];
  uint32_t it = 0;
  // the tile recomputed from its count each round, not carried: one
  // register fewer, which M's fc1 (a bias row an expert) needs to spill
  // nothing
  for (int ti = 0;; ++ti) {
    const int tile = blockIdx.x + ti * gridDim.x;
    if (tile >= tiles) break;
    const Tile t = Sched::at(p, tile);
    const int r0 = t.m0 + wg * kWgRows + warp * 16 + g, r1 = r0 + 8;
    const uint8_t* mask = smem + Layout::kMask + (ti & 1) * kMaskBytes;
    bool staged = false;
    Segment sg = kNoSegment;
    while (Sched::next(p, t, sg)) {
      // no branch around the wgmmas (one cost the attention forward its
      // registers): an empty group (GroupedK) runs no step, and its C[e]
      // is staged as zeros
      mainloop<kMnB, Sched::kTransA>(acc, smem, wg, sg, it, bar);
      const bool empty = Sched::kTransA && sg.k1 == sg.k0;
      if (!staged) {
        // the previous tile's store has read the staging tile (kStagedIn:
        // and this tile's input has landed in it), and this tile's keep
        // bits are drawn
        wait_staging<Epi>(bar, wg, ti);
        if (Epi::kDrawBits) mbar_wait(&bar.mask_full[ti & 1], (ti >> 1) & 1);
        staged = true;
      }
      const bool keep0 = r0 >= sg.lo && r0 < sg.hi, keep1 = r1 >= sg.lo && r1 < sg.hi;
      const uint8_t* bits0 = mask + (r0 - t.m0) * (BN / 8);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
        if (empty) v[0] = v[1] = v[2] = v[3] = 0.f;
        uint32_t k4 = 0xFu;
        if (Epi::kDrawBits)
          k4 = (bits0[j] >> (2 * q4) & 3u) | (bits0[8 * (BN / 8) + j] >> (2 * q4) & 3u) << 2;
        const int off = (j >> 3) * kAtomBytes + (((j & 7) ^ g) << 4);
        if constexpr (Epi::kStagedIn)
          Epi::apply_in(p, r0, t.n0 + 8 * j + 2 * q4, k4, keep0, keep1,
                        *reinterpret_cast<const uint32_t*>(row0 + off),
                        *reinterpret_cast<const uint32_t*>(row1 + off), v);
        else
          Epi::apply(p, sg.e, t.n0 + 8 * j + 2 * q4, k4, v);
        if (keep0) *reinterpret_cast<uint32_t*>(row0 + off) = pack_bf16(v[0], v[1]);
        if (keep1) *reinterpret_cast<uint32_t*>(row1 + off) = pack_bf16(v[2], v[3]);
        if constexpr (Epi::kStagedIn)  // the column sums of the segment's rows
          quad_col_sums(red + (wg * 4 + warp) * BN + 8 * j + 2 * q4, g,
                        (keep0 ? v[0] : 0.f) + (keep1 ? v[2] : 0.f),
                        (keep0 ? v[1] : 0.f) + (keep1 ? v[3] : 0.f));
      }
      if constexpr (Epi::kStagedIn) col_sums(p, red, t, sg);
    }
    if (!staged) wait_staging<Epi>(bar, wg, ti);
    const int z0 = max(sg.end, t.m0);
    if (r0 >= z0 || r1 >= z0) {  // rows past the last group: zeros
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int off = (j >> 3) * kAtomBytes + (((j & 7) ^ g) << 4);
        if (r0 >= z0) *reinterpret_cast<uint32_t*>(row0 + off) = 0u;
        if (r1 >= z0) *reinterpret_cast<uint32_t*>(row1 + off) = 0u;
      }
    }
    if constexpr (Epi::kReadBack) {
      // the warpgroup's staged tile is whole: map it chunk by chunk (16
      // bytes a thread, a row's 8 chunks from 8 neighbouring threads)
      named_sync(3 + wg, 128);
      const int ct = threadIdx.x & 127, m0 = t.m0 + wg * kWgRows;
      static_assert(kOutBytes / 16 % (2 * 128) == 0, "the read-back's steps");
#pragma unroll 2
      for (int c = ct; c < kOutBytes / 16; c += 128) {
        const int row = chunk_row(m0, c), col = chunk_col(t.n0, c);
        const uint32_t bits = Epi::kDrawBits ? mask[(row - t.m0) * (BN / 8) + ((col - t.n0) >> 3)]
                                             : 0xFFu;
        Epi::read_back(p, row, col, bits, *reinterpret_cast<const uint4*>(out + 16 * c));
      }
    }
    if (Epi::kDrawBits) mbar_arrive(&bar.mask_empty[ti & 1]);
    fence_proxy_async();  // the staged tile, visible to the TMA store
    mbar_arrive(&bar.out_full[wg]);
  }
}

// ---- host ----------------------------------------------------------------

// What a tensor map is a function of: a contiguous bf16 tensor [depth, rows,
// inner] read or written in boxes of (64, box_rows, 1).
struct MapKey {
  const void* base;
  unsigned long long inner, rows, depth;
  unsigned box_rows;
  bool operator==(const MapKey& o) const {
    return base == o.base && inner == o.inner && rows == o.rows && depth == o.depth &&
           box_rows == o.box_rows;
  }
};

inline cudaError_t encode_map(CUtensorMap* map, const MapKey& key) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {key.inner, key.rows, key.depth};
  const cuuint64_t strides[2] = {key.inner * 2, key.inner * key.rows * 2};
  const cuuint32_t box[3] = {kAtom, key.box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(key.base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of `key`, from a cache of the last kCached distinct keys (the
// server's threads call concurrently, hence the lock).
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, long long inner,
                              long long rows, long long depth, int box_rows) {
  constexpr int kCached = 256;
  struct Entry {
    CUtensorMap map;
    MapKey key;
    bool used;
  };
  static Entry cache[kCached];
  static int next = 0;
  static std::mutex mu;
  const MapKey key{base, (unsigned long long)inner, (unsigned long long)rows,
                   (unsigned long long)depth, (unsigned)box_rows};
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.used && e.key == key) {
      *map = e.map;
      return cudaSuccess;
    }
  Entry& e = cache[next];
  const cudaError_t err = encode_map(&e.map, key);
  if (err != cudaSuccess) return err;
  e.key = key, e.used = true;
  next = (next + 1) % kCached;
  *map = e.map;
  return cudaSuccess;
}

// The maps of A [m, k] (read in 128-row boxes) and C [m, n] (written in
// 64-row boxes), for Params whose B map the caller sets.
inline cudaError_t row_maps(Params& p, const void* a, const void* c) {
  cudaError_t err = tensor_map(&p.a, a, p.k, p.m, 1, BM);
  if (err == cudaSuccess) err = tensor_map(&p.c, c, p.n, p.m, 1, kWgRows);
  return err;
}

// B's map: K-major B [e, n, k] in 192-row boxes, MN-major B [e, k, n] in
// 64-row boxes of 64 columns.
inline cudaError_t weight_map(Params& p, const void* b, bool mn_major) {
  return mn_major ? tensor_map(&p.b, b, p.n, p.k, p.experts, BK)
                  : tensor_map(&p.b, b, p.k, p.n, p.experts, BN);
}

// GroupedK's maps: A [k, m] and B [k, n] (k = R rows) read in 64-row boxes
// of 64 columns, C [experts, m, n] written in 64-row boxes.
inline cudaError_t grouped_k_maps(Params& p, const void* a, const void* b, const void* c) {
  cudaError_t err = tensor_map(&p.a, a, p.m, p.k, 1, BK);
  if (err == cudaSuccess) err = tensor_map(&p.b, b, p.n, p.k, 1, BK);
  if (err == cudaSuccess) err = tensor_map(&p.c, c, p.n, p.m, p.experts, kWgRows);
  return err;
}

inline bool bad_shape(int m, int n, int k) {
  return m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 8;
}

template <class Epi, bool kMnB, class Sched = RowTiles>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // once a process: the dynamic shared memory the ring asks for, and the SMs
  static const cudaError_t prepared = [] {
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<Epi, kMnB, Sched>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    return err == cudaSuccess ? set_smem(gemm_kernel<Epi, kMnB, Sched>, Layout::kBytes) : err;
  }();
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return n;
  }();
  if (prepared != cudaSuccess) return prepared;
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long long tiles = Sched::count(p);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = tiles < sms ? (int)tiles : sms;
  gemm_kernel<Epi, kMnB, Sched><<<grid, kThreads, Layout::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace gemm90
}  // namespace
