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
// Kernel E: the keep mask of one (seed, site) written out as 0/1 fp32, the
// mask that F, G, H and the MLP kernels D/D' draw for element e of a
// tensor of that site (philox.cuh's contract), for on-card self-checks.
//
// Replaces: gavit_tpu/ops/mlp.py::kernel_mask (its inner kern), which
// writes the TPU MLP kernels' masks from the core's generator in their row
// blocks and f-chunks; here the stream does not depend on a block.
//
// What bounds them on the H100: one read and one write of x for F and H
// (4 bytes a bf16 element), two reads and a write for H', against ~40
// integer multiplies of Philox per 4 elements and, for H and H', ~25 fp32
// operations and one exp per element; G reads two tensors and writes one,
// E writes 4 bytes an element; at 3.35 TB/s the traffic is the bound
// (one [128, 197, 768] bf16 site of F is 38.7 MB, 11.6 us; H at
// [16, 577, 3072] bf16 113 MB, 34 us; G at [128, 197, 768] bf16 116 MB,
// 35 us; E over [25216, 3072 + 768] fp32 387 MB, 116 us). Each thread takes 8 consecutive
// elements (one 16-byte bf16 vector, two for fp32) and two Philox calls; the
// ragged tail is done element by element.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

enum Op { kDropout = 0, kGeluDropout = 1, kGeluDropoutBwd = 2, kDropoutAdd = 3, kMask = 4 };

// the ops that read a second tensor g (H''s gradient, G's residual), and the one that reads none
__host__ __device__ constexpr bool reads_g(int op) {
  return op == kGeluDropoutBwd || op == kDropoutAdd;
}
__host__ __device__ constexpr bool reads_x(int op) { return op != kMask; }

// one element of op; scale_t is the scale rounded to T (F's rule)
template <int kOp, typename T>
__device__ __forceinline__ T apply_one(T x, T g, uint32_t bits, const DropSite& s,
                                       float scale_t) {
  if (kOp == kMask) return from_f32<T>(bits < s.threshold ? 0.f : 1.f);
  if (kOp == kDropoutAdd) {
    // F's output, rounded to T, then the residual add rounded again (no
    // contraction into an FMA: r + F(y) rounds twice)
    const float f = bits < s.threshold ? 0.f : to_f32(from_f32<T>(__fmul_rn(to_f32(x), scale_t)));
    return from_f32<T>(__fadd_rn(to_f32(g), f));
  }
  if (bits < s.threshold) return from_f32<T>(0.f);
  if (kOp == kDropout) return from_f32<T>(to_f32(x) * scale_t);
  float gl, dg;
  gelu_and_grad(to_f32(x), gl, dg);
  if (kOp == kGeluDropout) return from_f32<T>(__fmul_rn(gl, s.scale));
  return from_f32<T>(__fmul_rn(__fmul_rn(dg, to_f32(g)), s.scale));
}

template <int kOp, typename T>
__global__ void __launch_bounds__(kThreads)
    elementwise_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
                       long long n, DropSite s) {
  const float scale_t = to_f32(from_f32<T>(s.scale));  // the scale in x's dtype
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v * 8 < n; v += stride) {
    const long long e0 = v * 8;
    const uint4 r0 = site_bits(s, (unsigned long long)e0 >> 2);
    const uint4 r1 = site_bits(s, ((unsigned long long)e0 >> 2) + 1);
    const uint32_t bits[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    if (e0 + 8 <= n) {
      constexpr int kVec = 16 / sizeof(T);  // elements of one 16-byte vector
#pragma unroll
      for (int h = 0; h < 8 / kVec; ++h) {
        const uint4 in = reads_x(kOp) ? *reinterpret_cast<const uint4*>(x + e0 + h * kVec)
                                      : make_uint4(0, 0, 0, 0);
        const uint4 gin = reads_g(kOp) ? *reinterpret_cast<const uint4*>(g + e0 + h * kVec)
                                       : make_uint4(0, 0, 0, 0);
        uint4 out;
        const T* xi = reinterpret_cast<const T*>(&in);
        const T* gi = reinterpret_cast<const T*>(&gin);
        T* yo = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          yo[j] = apply_one<kOp>(xi[j], gi[j], bits[h * kVec + j], s, scale_t);
        *reinterpret_cast<uint4*>(y + e0 + h * kVec) = out;
      }
    } else {
      for (long long e = e0; e < n; ++e) {
        const T xe = reads_x(kOp) ? x[e] : from_f32<T>(0.f);
        y[e] = apply_one<kOp>(xe, reads_g(kOp) ? g[e] : xe, bits[e - e0], s, scale_t);
      }
    }
  }
}

template <int kOp, typename T>
int launch(const void* x, const void* g, void* y, long long n, DropSite s, cudaStream_t stream) {
  const long long vecs = (n + 7) / 8;
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  const int grid = blocks < 65535LL * 32 ? (int)blocks : 65535 * 32;
  elementwise_kernel<kOp, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(y), n, s);
  return cudaGetLastError();
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

// out[e] = 1.f where element e of the site is kept, else 0.f, over n fp32
// elements (threshold 0 at rate 0: all ones).
GAVIT_EXPORT int gavit_keep_mask(void* out, long long n, unsigned k0, unsigned k1, unsigned site,
                                 unsigned threshold, void* stream) {
  return dispatch<kMask>(nullptr, nullptr, out, n, k0, k1, site, threshold, 1.f, GAVIT_F32,
                         stream);
}
