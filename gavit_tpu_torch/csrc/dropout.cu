// Kernel F: memory-free dropout, y = keep ? x * scale : 0, scale rounded to
// x's dtype first, with the mask drawn from Philox (philox.cuh) and never
// stored: the backward is this kernel again on the gradient with the same
// (seed, site).
//
// Replaces: gavit_tpu/ops/dropout.py::_dropout_kernel (launched by
// _run_kernel, reached through fused_dropout), which draws its bits from the
// TPU core's generator seeded per grid program.
//
// What bounds it on the H100: one read and one write of x, 4 bytes of
// traffic per bf16 element against ~40 integer multiplies of Philox per 4
// elements; at 3.35 TB/s the traffic is the bound (one [128, 197, 768]
// bf16 site is 38.7 MB, 11.6 us). Each thread takes 8 consecutive elements
// (one 16-byte bf16 vector, two for fp32) and two Philox calls; the ragged
// tail is done element by element. y = float(x) * float(T(scale)) rounded
// to T, which is T's own multiply, so bf16 output is bit-equal to the plain
// version.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T drop_one(T x, uint32_t bits, const DropSite& s, float scale) {
  return bits >= s.threshold ? from_f32<T>(to_f32(x) * scale) : from_f32<T>(0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, DropSite s) {
  const float scale = to_f32(from_f32<T>(s.scale));  // the scale in x's dtype
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
        uint4 in = *reinterpret_cast<const uint4*>(x + e0 + h * kVec);
        uint4 out;
        const T* xi = reinterpret_cast<const T*>(&in);
        T* yo = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < kVec; ++j) yo[j] = drop_one(xi[j], bits[h * kVec + j], s, scale);
        *reinterpret_cast<uint4*>(y + e0 + h * kVec) = out;
      }
    } else {
      for (long long e = e0; e < n; ++e) y[e] = drop_one(x[e], bits[e - e0], s, scale);
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, DropSite s, cudaStream_t stream) {
  const long long vecs = (n + 7) / 8;
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  const int grid = blocks < 65535LL * 32 ? (int)blocks : 65535 * 32;
  dropout_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                                   n, s);
  return cudaGetLastError();
}

}  // namespace

// y = dropout(x) over n contiguous elements of x (16-byte aligned); the
// caller passes the step seed as (k0, k1), the site, the uint32 threshold
// and 1 / (1 - rate).
GAVIT_EXPORT int gavit_dropout(const void* x, void* y, long long n, unsigned k0, unsigned k1,
                               unsigned site, unsigned threshold, float scale, int dtype,
                               void* stream) {
  if (n <= 0 || n >= (1LL << 34)) return cudaErrorInvalidValue;
  const DropSite s{k0, k1, site, threshold, scale, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == GAVIT_BF16) return launch<__nv_bfloat16>(x, y, n, s, st);
  if (dtype == GAVIT_F32) return launch<float>(x, y, n, s, st);
  return cudaErrorInvalidValue;
}
