// Counter-based Gaussian PRNG, device side (port of repro/kernels/cprng.py;
// the plain PyTorch version is repro_torch/kernels/cprng.py).
//
// Every draw is a pure function of (seed, uint32 element counter): a
// lowbias32 hash feeding Box-Muller, bit for bit with the reference's
// draw as XLA:CPU computes it. Its log and cos are f32math.cuh's (XLA:CPU's
// f32 log, glibc's cosf), its square root the IEEE-accurate sqrtf (the
// correctly rounded root, as the plain version's f64 sqrt rounded once);
// never the __logf/__cosf intrinsics. The library is built without
// --use_fast_math and with --fmad=false, so each draw equals the plain
// version's elementwise PyTorch ops.
#pragma once
#include <stdint.h>

#include "f32math.cuh"

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

// Box-Muller's two factors from the top 24 bits n of each hash word
// (cprng.radius, cprng.angle_cos): the radius sqrt(-2 log u1) of
// u1 = (n + 1) 2^-24 in (0, 1], the cosine of 2 pi u2, u2 = n 2^-24.
__device__ __forceinline__ float radius(uint32_t n) {
  const float u1 = ((float)n + 1.0f) * 5.9604644775390625e-08f;
  return sqrtf(-2.0f * f32math::log(u1));
}

__device__ __forceinline__ float angle_cos(uint32_t n) {
  const float u2 = (float)n * 5.9604644775390625e-08f;
  return f32math::cos(6.283185307179586f * u2);
}

// Box-Muller on two uint32 words (cprng.box_muller)
__device__ __forceinline__ float box_muller(uint32_t h1, uint32_t h2) {
  return radius(h1 >> 8) * angle_cos(h2 >> 8);
}

// One standard-normal f32 draw for counter ctr (cprng.gauss_from_counter).
__device__ __forceinline__ float gauss_from_counter(uint32_t seed,
                                                    uint32_t ctr) {
  const uint32_t h1 = mix32(ctr ^ seed);
  return box_muller(h1, mix32(h1 + kGolden));
}

}  // namespace aimc
