// Philox4x32-10 read noise, device side: the Hopper counterpart of the
// reference kernel's noise_source="hw" branch (src/repro/kernels/
// aimc_mvm.py:160-170, the TPU hardware PRNG seeded per grid cell). Hopper
// has no hardware generator, so this is a stateless counter-based one
// (Salmon et al., SC'11; the Random123 algorithm), addressed by the
// LOGICAL element so no launch tiling or batch padding moves a draw. The
// plain PyTorch version is ref.philox_read_noise_array.
//
// Element (k, row, col): key (seed, k), counter (row, col >> 1, 0, 0);
// words 0-1 feed the even column and words 2-3 the odd one through the
// reference's Box-Muller mapping (cprng.cuh box_muller).
#pragma once
#include <stdint.h>

#include "cprng.cuh"

namespace aimc {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The two standard-normal f32 draws of "hw" read noise for elements
// (k, row, 2*pair) and (k, row, 2*pair + 1): one Philox block serves both.
__device__ __forceinline__ void gauss_philox_pair(uint32_t seed, uint32_t k,
                                                  uint32_t row, uint32_t pair,
                                                  float& z_even,
                                                  float& z_odd) {
  const uint4 w = philox4x32_10(make_uint4(row, pair, 0u, 0u), seed, k);
  z_even = box_muller(w.x, w.y);
  z_odd = box_muller(w.z, w.w);
}

}  // namespace aimc
