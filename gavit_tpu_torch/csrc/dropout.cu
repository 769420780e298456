// Kernel F: memory-free dropout, y = keep ? x * scale : 0, scale rounded to
// x's dtype first, with the mask drawn from Philox (philox.cuh) and never
// stored: the backward is this kernel again on the gradient with the same
// (seed, site).
//
// Replaces: gavit_tpu/ops/dropout.py::_dropout_kernel (launched by
// _run_kernel, reached through fused_dropout), which draws its bits from the
// TPU core's generator seeded per grid program.
//
// Kernels H and H': exact-erf GELU followed by dropout, and its backward.
// H: y = keep ? gelu(x) * scale : 0; H': dx = keep ? (gelu'(x) * g) * scale
// : 0, from the saved x and the mask regenerated from (seed, site); scale =
// 1 / (1 - rate) in fp32 (the TPU kernels multiply in fp32 and round once).
// GELU and GELU' are common.cuh's gelu_and_grad, the A&S erf in IEEE-rounded
// steps, so both agree bit for bit with the plain versions in
// gavit_tpu_torch/ops/dropout.py. At rate 0 the threshold is 0 and the scale
// 1: every element is kept and the kernels are GELU and GELU' alone.
//
// Replace: gavit_tpu/ops/dropout.py::_gelu_dropout_kernel and
// ::_gelu_dropout_bwd_kernel (launched by _run_gelu_dropout_kernel and
// _run_gelu_dropout_bwd_kernel, reached through fused_gelu_dropout, the MLP's
// hidden site when no row block divides M).
//
// Kernel G: out = r + dropout(y), the residual add after dropout in one
// pass: keep ? y * scale : 0 with F's mask and F's scale rounded to y's
// dtype, rounded to that dtype, then added to r and rounded again, so that
// G gives the bits of r + F(y). Its backward is F on the gradient (for y)
// and the gradient itself (for r), as the JAX custom VJP has it.
//
// Replaces: gavit_tpu/ops/dropout.py::_dropout_add_kernel (launched by
// _run_add_kernel, reached through fused_dropout_add).
//
// Kernel E: the keep masks of two sites of one seed written out as 0/1 fp32
// in one launch (the second may be empty), the masks that F, G, H and the MLP
// kernels D/D' draw for element e of a tensor of that site (philox.cuh's
// contract), for on-card self-checks.
//
// Replaces: gavit_tpu/ops/mlp.py::kernel_mask (its inner kern, which writes
// both masks in one call), which writes the TPU MLP kernels' masks from the
// core's generator in their row blocks and f-chunks; here the stream does
// not depend on a block.
//
// What bounds them on the H100 (instructions an element counted in the SASS
// by tools/sass_issue.py; the issue floor is instructions / 32 over 528
// sub-partitions issuing one warp instruction a clock at 1.98 GHz, beside
// the bytes at 3.35 TB/s). F (4 bytes and about 19 instructions a bf16
// element: Philox4x32-10 is 10 rounds of two 32x32->64 multiplies and two
// 3-input XORs for 4 elements), G (6 bytes, about 31) and E (4 bytes
// written, about 26) are bound by bytes, their issue floors a half or less
// of their byte bounds. H is bound by issue: about 50 instructions a bf16
// element (28 fp32 operations, two special-function ones, Philox, the
// select, the bf16 unpack and pack) put its floor at 0.042 ms over
// [16, 577, 3072] above its 0.034-ms byte bound, and its multiplies, the
// Philox ones among them, keep the FMA pipe about as busy as the issue
// slot. H' (6 bytes, about 55) sits near both, 0.047 and 0.051 ms.
//
// Design. A thread takes one 16-byte unit at a time (8 bf16 or 4 fp32
// elements, so 2 or 1 Philox calls), loaded through the read-only path and
// stored with st.global.cs, since nothing is read twice: each warp
// instruction moves 512 contiguous bytes. The element op is a select
// around the result, never a branch, so a unit's 8 GELUs form one basic
// block that the compiler interleaves (a branch around each dropped
// element makes each GELU a block of its own). The Philox round keys come
// as a launch parameter (PhiloxKeys: the LOP3s read them from the constant
// bank), so no register holds them and no add steps them. F, H and H' walk
// a persistent grid (the resident blocks of each SM, asked of the occupancy
// API once): each step loads the next step's units before it computes its
// own, so the loads fly under the arithmetic; H and H' take two units a
// step. G and E take one unit a thread, every load in flight at once: the
// persistent walk measured slower for G (PERF.md §6). A ragged
// tail (n not a multiple of the unit) is done element by element by the
// first thread.
#include <algorithm>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

enum Op { kDropout = 0, kGeluDropout = 1, kGeluDropoutBwd = 2, kDropoutAdd = 3 };

// the ops that read a second tensor g (H''s gradient, G's residual)
__host__ __device__ constexpr bool reads_g(int op) {
  return op == kGeluDropoutBwd || op == kDropoutAdd;
}
__host__ __device__ constexpr bool is_gelu(int op) {
  return op == kGeluDropout || op == kGeluDropoutBwd;
}
// units a thread takes a step of the walk, and whether the op walks a
// persistent grid (else one unit a thread)
__host__ __device__ constexpr int step_units(int op) { return is_gelu(op) ? 2 : 1; }
__host__ __device__ constexpr bool persistent(int op) { return op != kDropoutAdd; }

// loads through the read-only path (ld.global.nc); the L1::no_allocate hint
// measured slower for F and G and no faster for H (PERF.md §6)
__device__ __forceinline__ uint4 load_stream(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// stores marked evict-first (st.global.cs): nothing here reads them again
__device__ __forceinline__ void store_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// the elements of a 16-byte unit widened to fp32 (bf16 widens exactly by
// a shift), and back, rounded to T
template <typename T>
__device__ __forceinline__ void unpack(const uint4& w, float* f) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(u[i]);
    } else {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  if constexpr (sizeof(T) == 4)
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  else
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                      pack_bf16(f[6], f[7]));
}

// One element of op in fp32, before the rounding to T; scale_t is the scale
// rounded to T (F's rule). The dropped value is a select, never a branch.
template <int kOp, typename T>
__device__ __forceinline__ float apply_one(float x, float g, uint32_t bits, const DropSite& s,
                                           float scale_t) {
  const bool drop = bits < s.threshold;
  if (kOp == kDropout) return drop ? 0.f : __fmul_rn(x, scale_t);
  // G: F's output, rounded to T, then the residual add (no contraction into
  // an FMA: r + F(y) rounds twice)
  if (kOp == kDropoutAdd) return __fadd_rn(g, drop ? 0.f : round_to<T>(__fmul_rn(x, scale_t)));
  float gl, dg;
  gelu_and_grad(x, gl, dg);
  const float r = kOp == kGeluDropout ? __fmul_rn(gl, s.scale)
                                      : __fmul_rn(__fmul_rn(dg, g), s.scale);
  return drop ? 0.f : r;
}

// Philox words of elements [e0, e0 + kVec), e0 a multiple of 4
template <int kVec>
__device__ __forceinline__ void draw_bits(unsigned long long e0, uint32_t site,
                                          const PhiloxKeys& keys, uint32_t* bits) {
#pragma unroll
  for (int q = 0; q < kVec / 4; ++q) {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>((e0 >> 2) + q), site, 0u, 0u), keys);
    bits[4 * q] = r.x;
    bits[4 * q + 1] = r.y;
    bits[4 * q + 2] = r.z;
    bits[4 * q + 3] = r.w;
  }
}

template <int kOp, typename T>
__device__ __forceinline__ uint4 apply_unit(const uint4& xw, const uint4& gw, long long unit,
                                            const DropSite& s, const PhiloxKeys& keys,
                                            float scale_t) {
  constexpr int kVec = 16 / sizeof(T);
  uint32_t bits[kVec];
  draw_bits<kVec>((unsigned long long)unit * kVec, s.site, keys, bits);
  float xf[kVec], gf[kVec], out[kVec];
  unpack<T>(xw, xf);
  if (reads_g(kOp)) unpack<T>(gw, gf);
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    out[j] = apply_one<kOp, T>(xf[j], reads_g(kOp) ? gf[j] : 0.f, bits[j], s, scale_t);
  return pack<T>(out);
}

// The walk: unit v, v + stride, ... with U units a step, the next step's
// loaded before this step's are computed; a grid with a thread for every
// unit runs one step. The launch bound asks for one block an SM only, so
// ptxas may give the GELU walk the registers of its two units' interleaved
// chains (90 for H; at ptxas's default target it held 48 and ran slower).
template <int kOp, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    elementwise_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
                       long long n, DropSite s, const PhiloxKeys keys) {
  constexpr int kVec = 16 / sizeof(T), U = step_units(kOp);
  const float scale_t = round_to<T>(s.scale);
  const long long units = n / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  uint4 xc[U], gc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (v + u * stride < units) {
      xc[u] = load_stream(x + (v + u * stride) * kVec);
      if (reads_g(kOp)) gc[u] = load_stream(g + (v + u * stride) * kVec);
    }
  }
  for (; v < units; v += U * stride) {
    const long long next = v + U * stride;
    uint4 xn[U], gn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (next + u * stride < units) {
        xn[u] = load_stream(x + (next + u * stride) * kVec);
        if (reads_g(kOp)) gn[u] = load_stream(g + (next + u * stride) * kVec);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long vu = v + u * stride;
      if (vu < units)
        store_stream(y + vu * kVec, apply_unit<kOp, T>(xc[u], gc[u], vu, s, keys, scale_t));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xc[u] = xn[u];
      gc[u] = gn[u];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && units * kVec < n) {
    const long long e0 = units * kVec;
    uint32_t bits[kVec];
    draw_bits<kVec>((unsigned long long)e0, s.site, keys, bits);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (e0 + j < n) {
        const float ge = reads_g(kOp) ? to_f32(g[e0 + j]) : 0.f;
        y[e0 + j] = from_f32<T>(apply_one<kOp, T>(to_f32(x[e0 + j]), ge, bits[j], s, scale_t));
      }
    }
  }
}

// Kernel E: unit v < units_a writes 4 mask values of site a, the rest of
// site b, one 16-byte store a unit; the grid has a thread for every unit.
__global__ void __launch_bounds__(kThreads)
    keep_mask_kernel(float* __restrict__ out_a, long long n_a, float* __restrict__ out_b,
                     long long n_b, uint32_t site_a, uint32_t thr_a, uint32_t site_b,
                     uint32_t thr_b, const PhiloxKeys keys) {
  const long long units_a = n_a / 4, units = units_a + n_b / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < units; v += stride) {
    const bool a = v < units_a;
    const long long w = a ? v : v - units_a;
    const uint32_t thr = a ? thr_a : thr_b;
    uint32_t bits[4];
    draw_bits<4>((unsigned long long)w * 4, a ? site_a : site_b, keys, bits);
    store_stream((a ? out_a : out_b) + w * 4,
                 make_uint4(__float_as_uint(bits[0] < thr ? 0.f : 1.f),
                            __float_as_uint(bits[1] < thr ? 0.f : 1.f),
                            __float_as_uint(bits[2] < thr ? 0.f : 1.f),
                            __float_as_uint(bits[3] < thr ? 0.f : 1.f)));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long nk = k ? n_b : n_a, e0 = nk / 4 * 4;
      const uint32_t thr = k ? thr_b : thr_a;
      float* out = k ? out_b : out_a;
      if (e0 < nk) {
        uint32_t bits[4];
        draw_bits<4>((unsigned long long)e0, k ? site_b : site_a, keys, bits);
        for (long long e = e0; e < nk; ++e) out[e] = bits[e - e0] < thr ? 0.f : 1.f;
      }
    }
  }
}

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// Blocks of a launch of op over n elements: one thread for every unit (at
// least one block, whose first thread takes a ragged tail), or for a
// persistent grid no more than the SMs hold at once (asked once for this
// kernel).
template <int kOp, typename T>
long long grid_blocks(long long n) {
  constexpr long long kStep = (long long)kThreads * step_units(kOp);
  long long blocks = (n / (16 / (long long)sizeof(T)) + kStep - 1) / kStep;
  if (persistent(kOp)) {
    static const int per_sm = [] {
      int b = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, elementwise_kernel<kOp, T>, kThreads, 0);
      return b > 0 ? b : 1;
    }();
    blocks = std::min(blocks, (long long)sm_count() * per_sm);
  }
  return std::max(blocks, 1LL);
}

template <int kOp, typename T>
int launch(const void* x, const void* g, void* y, long long n, const DropSite& s,
           cudaStream_t stream) {
  elementwise_kernel<kOp, T><<<(unsigned)grid_blocks<kOp, T>(n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(y), n, s,
      philox_keys(s.k0, s.k1));
  return cudaGetLastError();
}

// elements one step of a launch's grid covers
template <int kOp, typename T>
long long step_of(long long n) {
  return grid_blocks<kOp, T>(n) * kThreads * step_units(kOp) * (16 / (long long)sizeof(T));
}

template <typename T>
long long step_elements(int op, long long n) {
  switch (op) {
    case kDropout: return step_of<kDropout, T>(n);
    case kGeluDropout: return step_of<kGeluDropout, T>(n);
    case kGeluDropoutBwd: return step_of<kGeluDropoutBwd, T>(n);
    case kDropoutAdd: return step_of<kDropoutAdd, T>(n);
  }
  return -1;
}

template <int kOp>
int dispatch(const void* x, const void* g, void* y, long long n, unsigned k0, unsigned k1,
             unsigned site, unsigned threshold, float scale, int dtype, void* stream) {
  if (n <= 0 || n >= (1LL << 34)) return cudaErrorInvalidValue;
  const DropSite s{k0, k1, site, threshold, scale, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == GAVIT_BF16) return launch<kOp, __nv_bfloat16>(x, g, y, n, s, st);
  if (dtype == GAVIT_F32) return launch<kOp, float>(x, g, y, n, s, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// y = dropout(x) over n contiguous elements of x (16-byte aligned); the
// caller passes the step seed as (k0, k1), the site, the uint32 threshold
// and 1 / (1 - rate).
GAVIT_EXPORT int gavit_dropout(const void* x, void* y, long long n, unsigned k0, unsigned k1,
                               unsigned site, unsigned threshold, float scale, int dtype,
                               void* stream) {
  return dispatch<kDropout>(x, x, y, n, k0, k1, site, threshold, scale, dtype, stream);
}

// y = dropout(gelu(x)), the arguments as gavit_dropout's (threshold 0 and
// scale 1 at rate 0).
GAVIT_EXPORT int gavit_gelu_dropout(const void* x, void* y, long long n, unsigned k0, unsigned k1,
                                    unsigned site, unsigned threshold, float scale, int dtype,
                                    void* stream) {
  return dispatch<kGeluDropout>(x, x, y, n, k0, k1, site, threshold, scale, dtype, stream);
}

// dx = dropout(gelu'(x) * g) with the forward's mask; x, g and dx alike.
GAVIT_EXPORT int gavit_gelu_dropout_bwd(const void* x, const void* g, void* dx, long long n,
                                        unsigned k0, unsigned k1, unsigned site,
                                        unsigned threshold, float scale, int dtype,
                                        void* stream) {
  return dispatch<kGeluDropoutBwd>(x, g, dx, n, k0, k1, site, threshold, scale, dtype, stream);
}

// out = r + dropout(y) over n contiguous elements of y, r and out (one shape
// and dtype), the arguments as gavit_dropout's.
GAVIT_EXPORT int gavit_dropout_add(const void* y, const void* r, void* out, long long n,
                                   unsigned k0, unsigned k1, unsigned site, unsigned threshold,
                                   float scale, int dtype, void* stream) {
  return dispatch<kDropoutAdd>(y, r, out, n, k0, k1, site, threshold, scale, dtype, stream);
}

// The elements one step of the grid covers in a launch of op (0 F, 1 H, 2
// H', 3 G) over n elements of dtype, or -1: the card tests size the walk's
// ragged tails from it.
GAVIT_EXPORT long long gavit_elementwise_step(int op, int dtype, long long n) {
  if (dtype == GAVIT_BF16) return step_elements<__nv_bfloat16>(op, n);
  if (dtype == GAVIT_F32) return step_elements<float>(op, n);
  return -1;
}

// out_a[e] = 1.f where element e of site_a is kept, else 0.f, over n_a fp32
// elements, and the same for site_b over out_b's n_b (0 for none), in one
// launch; threshold 0 (rate 0) gives all ones.
GAVIT_EXPORT int gavit_keep_masks(void* out_a, long long n_a, void* out_b, long long n_b,
                                  unsigned k0, unsigned k1, unsigned site_a,
                                  unsigned threshold_a, unsigned site_b, unsigned threshold_b,
                                  void* stream) {
  if (n_a < 0 || n_b < 0 || n_a + n_b <= 0 || n_a >= (1LL << 34) || n_b >= (1LL << 34))
    return cudaErrorInvalidValue;
  const long long units = n_a / 4 + n_b / 4;
  const long long blocks = units > 0 ? (units + kThreads - 1) / kThreads : 1;
  keep_mask_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out_a), n_a, static_cast<float*>(out_b), n_b, site_a, threshold_a,
      site_b, threshold_b, philox_keys(k0, k1));
  return cudaGetLastError();
}
