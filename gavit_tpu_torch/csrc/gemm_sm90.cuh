// One bf16 GEMM mainloop for Hopper, shared by kernel B (mlp.cu: the serving
// MLP's fc1 and fc2) and kernel N-gmm (moe.cu: megablox gmm in both forms):
// TMA-fed, warp-specialised wgmma with pluggable epilogues.
//
//   C[M, N] = A[M, K] . B_e    for the rows of each group e of group_sizes,
//
// with A row-major (K-major) and B_e either K-major ([N, K] rows: nn.Linear's
// weights, gmm's transposed form) or MN-major ([K, N] rows: gmm's forward
// W[e]). A dense GEMM is one group of every row (group_sizes null).
//
// What bounds it on the H100: at the main shapes (B: M = 12608, K, N = 768,
// 3072; N-gmm: T = 50432) a GEMM does 2*M*K*N FLOPs against (M*K + K*N*E +
// M*N)*2 bytes, far above the card's ~295 FLOP/byte ridge: the tensor cores
// bound it, fed from L2 (every operand fits the 50 MB cache).
//
// Design (one persistent block an SM, 384 threads):
// * Tiles of 128 x 192 output elements, walked by the blocks in turn (tile
//   t by block t mod grid), N fastest. 192 divides 768 and 3072, and the
//   tile counts at the main shapes fill whole waves of 132 SMs (fc1 1584 =
//   12 waves, fc2 396 = 3); a persistent loop also lifts gridDim.y's limit
//   on M.
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
//   columns, rows g and g+8) in registers (a bias) and round it to bf16
//   into a 128-byte swizzled staging tile per warpgroup (64 x 192: three
//   64-column atoms), then hand the tile over through an mbarrier. The
//   epilogue warps apply the epilogue's elementwise finish to the staged
//   values in shared memory (B's GELU) and store the tile by TMA, which
//   drops rows past M and columns past N; once the store has read it, the
//   tile goes back to its consumers. The finish and the store of one tile
//   overlap the next tile's mainloop: run by the consumers themselves, fc1's
//   GELU (about 35 instructions a value, tanhf among them) took nearly as
//   long as its mainloop, with the tensor cores idle.
// * Groups (N-gmm): each block walks the groups that overlap its 128-row
//   tile and runs the mainloop once for each (a GEMM row needs no other row,
//   so the whole tile is multiplied by group e's weights and only e's rows
//   are kept). The segments of one tile write disjoint rows of the same
//   staging tile, rows past the last group are staged as zeros, and the
//   tile leaves in one store: every element is written once, from one fp32
//   sum, with no atomics, so reruns give the same bits. Straddling tiles
//   cost one extra mainloop per group boundary (at most E - 1 a column of
//   tiles). Nothing reads a group size on the host.
// * Edges: rows past M and the K tail arrive as zeros through TMA's
//   out-of-bounds fill; a B atom wholly past N is not loaded (the columns it
//   would feed are never stored).
// * Tensor maps: A [K, M], C [N, M] and B [K or N, N or K, E], rank 3, are
//   encoded on the host and cached by (address, extents, box): weights hit
//   the cache on every call after the first, and activations too once
//   PyTorch's allocator hands out the same blocks again, so a served call
//   pays no encode in steady state.
#pragma once

#include <mutex>

#include "common.cuh"
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
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;

struct Barriers {
  uint64_t full[kStages], empty[kStages];  // the ring
  uint64_t out_full[2], out_empty[2];      // the consumers' staging tiles
};

// shared memory from a 1024-byte aligned base: the ring, the two staging
// tiles, the barriers
struct Layout {
  static constexpr int kOut = kStages * kStageBytes;
  static constexpr int kBars = kOut + 2 * kOutBytes;
  static constexpr int kBytes = kBars + (int)sizeof(Barriers) + 1024;
};
static_assert(Layout::kBytes <= kMaxSmemBytes, "the GEMM's shared memory exceeds a block's");

struct Params {
  CUtensorMap a, b, c;
  int m, n, k;
  const int* group_sizes;  // [experts] on the device; null: one group of all rows
  int experts;
  const bf16* bias;        // for the epilogues that take one ([N])
};

// An epilogue: `apply` maps an accumulator quad (columns col and col + 1 of
// rows g and g + 8) in the consumers' registers before the values are
// rounded to bf16 and staged; with kFinish, the epilogue warps then map
// every staged value x to finish(x), rounded to bf16 again, in shared
// memory, while the consumers run the next tile's mainloop.
// The epilogue that stores the sums as they are:
struct StoreEpi {
  static constexpr bool kFinish = false;
  static __device__ __forceinline__ void apply(const Params&, int, float (&)[4]) {}
};

// Calls f(e, lo, hi) for each group e that holds rows [lo, hi) of the tile
// at m0, in order; returns the first row of the tile past the last group.
template <class F>
__device__ __forceinline__ int walk_groups(const Params& p, int m0, F&& f) {
  const int m_end = min(m0 + BM, p.m);
  if (p.group_sizes == nullptr) {
    f(0, m0, m_end);
    return m_end;
  }
  int start = 0;
  for (int e = 0; e < p.experts && start < m_end; ++e) {
    const int end = start + p.group_sizes[e];
    const int lo = max(start, m0), hi = min(end, m_end);
    if (lo < hi) f(e, lo, hi);
    start = end;
  }
  return max(start, m0);
}

// acc = (this warpgroup's 64 rows of A) . B over every K step; `it` counts
// the ring's uses in the block's order (the producer's).
template <bool kMnB>
__device__ __forceinline__ void mainloop(float (&acc)[96], uint32_t ring, int wg, int k_steps,
                                         uint32_t& it, Barriers& bar) {
  for (int ks = 0; ks < k_steps; ++ks, ++it) {
    const int s = it % kStages;
    mbar_wait(&bar.full[s], (it / kStages) & 1);
    const uint32_t a = ring + s * kStageBytes + wg * kWgRows * 128;
    const uint32_t b = ring + s * kStageBytes + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = kmajor_desc(a + 32 * kk);
      const uint64_t db =
          kMnB ? mnmajor_wide_desc(b + 2048 * kk, kAtomBytes) : kmajor_desc(b + 32 * kk);
      wgmma_m64n192k16_ss<kMnB ? 1 : 0>(acc, da, db, ks > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's wgmmas are done: free its stage
    if (ks > 0) mbar_arrive(&bar.empty[(it - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive(&bar.empty[(it - 1) % kStages]);
}

template <class Epi, bool kMnB>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t gemm_smem[];
  uint8_t* smem = gemm_smem + ((1024 - (smem_u32(gemm_smem) & 1023)) & 1023);
  Barriers& bar = *reinterpret_cast<Barriers*>(smem + Layout::kBars);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      mbar_init(&bar.full[s], 1), mbar_init(&bar.empty[s], kConsumers);
    for (int w = 0; w < 2; ++w)
      mbar_init(&bar.out_full[w], kConsumers / 2), mbar_init(&bar.out_empty[w], 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int n_tiles = (p.n + BN - 1) / BN;
  const int tiles = (p.m + BM - 1) / BM * n_tiles;
  const int k_steps = (p.k + BK - 1) / BK;

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every TMA load ----
    if (threadIdx.x == 0) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        const int atoms = kMnB ? min(kAtoms, (p.n - n0 + kAtom - 1) / kAtom) : 0;
        const unsigned bytes = kABytes + (kMnB ? atoms * kAtomBytes : kBBytes);
        walk_groups(p, m0, [&](int e, int, int) {
          for (int ks = 0; ks < k_steps; ++ks, ++it) {
            const int s = it % kStages;
            mbar_wait(&bar.empty[s], ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(&bar.full[s], bytes);
            uint8_t* st = smem + s * kStageBytes;
            tma_load_3d(st, &p.a, &bar.full[s], ks * BK, m0, 0);
            if (kMnB) {
              for (int j = 0; j < atoms; ++j)
                tma_load_3d(st + kABytes + j * kAtomBytes, &p.b, &bar.full[s], n0 + j * kAtom,
                            ks * BK, e);
            } else {
              tma_load_3d(st + kABytes, &p.b, &bar.full[s], ks * BK, n0, e);
            }
          }
        });
      }
    } else if (threadIdx.x >= 32) {
      // ---- epilogue warps 1-3: finish each staging tile, store it ----
      const int etid = threadIdx.x - 32;
      if (!Epi::kFinish && etid != 0) return;  // storing takes one thread
      int ti = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        for (int w = 0; w < 2; ++w) {
          uint8_t* out = smem + Layout::kOut + w * kOutBytes;
          mbar_wait(&bar.out_full[w], ti & 1);
          if constexpr (Epi::kFinish) {
            // elementwise, so the swizzle does not matter: 2 x 16 bytes a
            // step, 16 independent values for one warp to overlap
            static_assert(kOutBytes % (2 * 16 * 96) == 0, "the finish pass's steps");
            for (int c = etid; c < kOutBytes / 16; c += 2 * 96) {
              uint4 q[2] = {*reinterpret_cast<const uint4*>(out + 16 * c),
                            *reinterpret_cast<const uint4*>(out + 16 * (c + 96))};
              uint32_t* u = reinterpret_cast<uint32_t*>(q);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u[i]);
                u[i] = pack_bf16(Epi::finish(__low2float(h)), Epi::finish(__high2float(h)));
              }
              *reinterpret_cast<uint4*>(out + 16 * c) = q[0];
              *reinterpret_cast<uint4*>(out + 16 * (c + 96)) = q[1];
            }
            fence_proxy_async();
            named_sync(1, 96);
          }
          if (etid == 0) {
            if (m0 + w * kWgRows < p.m)
              for (int j = 0; j < kAtoms && n0 + j * kAtom < p.n; ++j)
                tma_store_3d(&p.c, out + j * kAtomBytes, n0 + j * kAtom, m0 + w * kWgRows, 0);
            bulk_commit();
            bulk_wait_read<0>();  // the store has read the tile: the consumers may refill it
            mbar_arrive(&bar.out_empty[w]);
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
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ring = smem_u32(smem);
  uint8_t* out = smem + Layout::kOut + wg * kOutBytes;
  // this thread's two rows of the staging tile (row & 7 == g for both)
  uint8_t* row0 = out + (warp * 16 + g) * 128 + 4 * t;
  uint8_t* row1 = row0 + 8 * 128;
  float acc[96];
  uint32_t it = 0;
  int ti = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
    const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
    const int r0 = m0 + wg * kWgRows + warp * 16 + g, r1 = r0 + 8;
    bool staged = false;
    // the previous tile's store has read the staging tile
    auto make_room = [&] {
      mbar_wait(&bar.out_empty[wg], (ti & 1) ^ 1);
      staged = true;
    };
    const int z0 = walk_groups(p, m0, [&](int, int lo, int hi) {
      mainloop<kMnB>(acc, ring, wg, k_steps, it, bar);
      if (!staged) make_room();
      const bool keep0 = r0 >= lo && r0 < hi, keep1 = r1 >= lo && r1 < hi;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
        Epi::apply(p, n0 + 8 * j + 2 * t, v);
        const int off = (j >> 3) * kAtomBytes + (((j & 7) ^ g) << 4);
        if (keep0) *reinterpret_cast<uint32_t*>(row0 + off) = pack_bf16(v[0], v[1]);
        if (keep1) *reinterpret_cast<uint32_t*>(row1 + off) = pack_bf16(v[2], v[3]);
      }
    });
    if (!staged) make_room();
    if (r0 >= z0 || r1 >= z0) {  // rows past the last group: zeros
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int off = (j >> 3) * kAtomBytes + (((j & 7) ^ g) << 4);
        if (r0 >= z0) *reinterpret_cast<uint32_t*>(row0 + off) = 0u;
        if (r1 >= z0) *reinterpret_cast<uint32_t*>(row1 + off) = 0u;
      }
    }
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

inline bool bad_shape(int m, int n, int k) {
  return m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 8;
}

template <class Epi, bool kMnB>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // once a process: the dynamic shared memory the ring asks for, and the SMs
  static const cudaError_t prepared = [] {
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<Epi, kMnB>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    return err == cudaSuccess ? set_smem(gemm_kernel<Epi, kMnB>, Layout::kBytes) : err;
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
  const long long tiles = (long long)((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = tiles < sms ? (int)tiles : sms;
  gemm_kernel<Epi, kMnB><<<grid, kThreads, Layout::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace gemm90
}  // namespace
