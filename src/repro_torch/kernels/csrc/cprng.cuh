// Counter-based Gaussian PRNG, device side (port of repro/kernels/cprng.py;
// the plain PyTorch version is repro_torch/kernels/cprng.py).
//
// Every draw is a pure function of (seed, uint32 element counter): a
// lowbias32 hash feeding Box-Muller. The transcendental calls are the
// IEEE-accurate logf/sqrtf/cosf, never the __logf/__cosf intrinsics, and the
// library is built without --use_fast_math and with --fmad=false, so each
// draw equals the plain version's elementwise PyTorch ops.
#pragma once
#include <stdint.h>

namespace aimc {

constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Seed of gate g in a stacked multi-MVM (cprng.stack_seed).
__device__ __forceinline__ uint32_t stack_seed(uint32_t seed, uint32_t g) {
  return mix32(seed ^ ((g + 1u) * kGolden));
}

// Box-Muller on two uint32 words (cprng.box_muller): u1 in (0, 1],
// u2 in [0, 1).
__device__ __forceinline__ float box_muller(uint32_t h1, uint32_t h2) {
  const float u1 = ((float)(h1 >> 8) + 1.0f) * 5.9604644775390625e-08f;
  const float u2 = (float)(h2 >> 8) * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(6.283185307179586f * u2);
}

// One standard-normal f32 draw for counter ctr (cprng.gauss_from_counter).
__device__ __forceinline__ float gauss_from_counter(uint32_t seed,
                                                    uint32_t ctr) {
  const uint32_t h1 = mix32(ctr ^ seed);
  return box_muller(h1, mix32(h1 + kGolden));
}

}  // namespace aimc
