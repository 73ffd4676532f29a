// The reference's f32 log, log1p and cos on the card, bit for bit with
// their plain version, repro_torch/core/f32math.py: XLA:CPU's f32 log and
// log1p (Cephes' logf and log1pf, as XLA inlines them) and glibc's cosf,
// which the reference's draws go through. That module says how each
// operation sequence was read off; this file repeats its operations one
// for one. fmaf stands exactly where the plain version fuses a
// multiply-add; every other product and sum rounds on its own (the
// library is built with --fmad=false). cos runs in double, as glibc's
// does, with the plain version's reduction and unfused polynomial. Every
// special case is a select, so a caller's draws stay branch-free.
#pragma once
#include <stdint.h>

namespace f32math {

constexpr float kFltMin = 0x1p-126f;

// XLA:CPU flushes subnormals (DAZ/FTZ): zero of the value's sign
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < kFltMin ? x * 0.0f : x;
}

// Cephes' logf on max(x, FLT_MIN): x = m 2^e, m in [sqrt(1/2), sqrt(2)),
// x1 - x1^2 / 2 + x1^3 P(x1) + e (Q2 - Q1), XLA's multiply-adds fused
__device__ __forceinline__ float log_poly(float x) {
  const uint32_t bits = __float_as_uint(fmaxf(x, kFltMin));
  const float e0 = (float)((int)(bits >> 23) - 127) + 1.0f;
  const float m = __uint_as_float((bits & 0x007FFFFFu) | 0x3F000000u);
  const bool low = m < 0x1.6a09e6p-1f;
  const float x1 = (m - 1.0f) + (low ? m : 0.0f);
  const float e = e0 - (low ? 1.0f : 0.0f);
  const float x2 = x1 * x1;
  const float x3 = x2 * x1;
  float y = fmaf(x1, 0x1.204376p-4f, -0x1.d7a37p-4f);
  float y1 = fmaf(x1, -0x1.fcba9ep-4f, 0x1.23d37ep-3f);
  float y2 = fmaf(x1, 0x1.999d58p-3f, -0x1.fffff8p-3f);
  y = fmaf(y, x1, 0x1.de4a34p-4f);
  y1 = fmaf(y1, x1, -0x1.555cap-3f);
  y2 = fmaf(y2, x1, 0x1.555554p-2f);
  y = fmaf(y, x3, y1);
  y = fmaf(y, x3, y2);
  y = fmaf(y, x3, e * -0x1.bd0106p-13f);
  const float r = (x1 - x2 * 0.5f) + y;
  return r + e * 0x1.63p-1f;
}

// XLA:CPU's f32 log: -inf at zero and subnormals, inf at inf, NaN (all
// bits set) below zero and at NaN
__device__ __forceinline__ float log(float x) {
  float r = x > 0.0f ? log_poly(x) : __uint_as_float(0xFFFFFFFFu);
  r = fabsf(x) < kFltMin ? __uint_as_float(0xFF800000u) : r;
  return x == __uint_as_float(0x7F800000u) ? x : r;
}

// XLA:CPU's f32 log1p: x - x^2 / 2 + x^3 P(x) / Q(x) for |x| < sqrt(2) - 1
// (Horner steps fused), else log(1 + x)
__device__ __forceinline__ float log1p(float x0) {
  const float x = flush(x0);
  const float x2 = x * x;
  float q = x + 0x1.e2035ap+3f;
  q = fmaf(q, x, 0x1.4c30b6p+6f);
  q = fmaf(q, x, 0x1.bb865ap+7f);
  q = fmaf(q, x, 0x1.351946p+8f);
  q = fmaf(q, x, 0x1.b0db14p+7f);
  q = fmaf(q, x, 0x1.e0f304p+5f);
  float p = fmaf(x, 0x1.7bc096p-15f, 0x1.fe818ap-2f);
  p = fmaf(p, x, 0x1.a509f4p+2f);
  p = fmaf(p, x, 0x1.de9738p+4f);
  p = fmaf(p, x, 0x1.e798ecp+5f);
  p = fmaf(p, x, 0x1.c8e75ap+5f);
  p = fmaf(p, x, 0x1.40a202p+4f);
  const float small = x + ((x * x2) * (p / q) - x2 * 0.5f);
  return fabsf(x) < 0x1.a8279ap-2f ? small : f32math::log(x + 1.0f);
}

// glibc's cosf, in double: r = x - n pi/2 (|r| <= pi/4; n from glibc's
// 2^24-scaled reduction), cos or sin of r by the quadrant, rounded once to
// f32; 1 where |x| < 2^-12. The reduction is glibc's fused multiply-add,
// exact here as two exact products and exact differences (f32math.py).
// Exact for |x| < 120, every argument of a draw.
__device__ __forceinline__ float cos(float x) {
  const uint32_t top = (__float_as_uint(x) >> 20) & 0x7FFu;
  const double xd = (double)x;
  int n = ((int)(xd * 0x1.45f306dc9c883p+23) + 0x800000) >> 24;
  n = top < 0x3F4u ? 0 : n;
  const double nd = (double)n;
  const double r = (xd - nd * 0x1.921fb54442dp+0) - nd * 0x1.8p-48;
  const double r2 = r * r;
  const double r4 = r2 * r2;
  const double cos_p =
      ((1.0 + r2 * -0x1.ffffffd0c621cp-2) + r4 * 0x1.55553e1068f19p-5) +
      (r2 * r4) * (-0x1.6c087e89a359dp-10 + r2 * 0x1.99343027bf8c3p-16);
  const double r3 = r2 * r;
  const double sin_p =
      (r + r3 * -0x1.555545995a603p-3) +
      (r3 * r2) * (0x1.1107605230bc4p-7 + r2 * -0x1.994eb3774cf24p-13);
  double out = (n & 1) == 0 ? cos_p : sin_p;
  out = ((n + 1) & 2) == 0 ? out : -out;
  return top < 0x398u ? 1.0f : (float)out;
}

}  // namespace f32math
