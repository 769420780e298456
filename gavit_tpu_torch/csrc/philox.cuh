// Philox4x32-10: the dropout bits shared by kernels F (dropout.cu) and D/D'
// (mlp.cu), bit for bit equal to the plain version in
// gavit_tpu_torch/ops/philox.py.
//
// Replaces the TPU's per-core hardware generator (pltpu.prng_seed /
// prng_random_bits in gavit_tpu/ops/dropout.py and ops/mlp.py), whose
// stream depends on the launch grid. Here a mask is a pure function of
// (step seed, site, element index): key = the 64-bit seed as (low, high),
// counter = (element index / 4, site, 0, 0), and the four output words serve
// elements 4i..4i+3 in order. keep = bits >= threshold, threshold =
// uint32(int(rate * 0xFFFFFFFF)) as on the TPU.
#pragma once

#include <stdint.h>

struct DropSite {
  uint32_t k0, k1;     // the step seed (low, high)
  uint32_t site;       // counter word 1
  uint32_t threshold;  // keep = bits >= threshold
  float scale;         // 1 / (1 - rate)
  int on;              // rate > 0
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// the four words of element group g (elements 4g..4g+3) of a site
__device__ __forceinline__ uint4 site_bits(const DropSite& s, unsigned long long g) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(g), s.site, 0u, 0u), s.k0, s.k1);
}

// keep flags of elements e and e+1 for an even e (both in one group)
__device__ __forceinline__ void keep_pair(const DropSite& s, unsigned long long e, bool& a,
                                          bool& b) {
  const uint4 r = site_bits(s, e >> 2);
  const bool hi = (e & 3) != 0;
  a = (hi ? r.z : r.x) >= s.threshold;
  b = (hi ? r.w : r.y) >= s.threshold;
}
