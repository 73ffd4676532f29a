// The large-capacity body of the expert entry in the kernel library: its
// plan, its launch after aimc_mvm.cu's DAC pass, and the check that gates
// its branch-free epilogue. The body itself, and what bounds it and why it
// is built so, are in aimc_experts.cuh.
#include "aimc_experts.cuh"

extern "C" int aimc_dac_launch(const void* x, const void* s_x, void* codes,
                               int rows, int KB, int M, int Mp,
                               int rows_per_scale, void* stream);

namespace {

using namespace aimc_experts;

size_t codes_bytes(int B, int KB, int M, int G) {
  return ((size_t)G * B * KB * round_up(M, kBK) + 255) / 256 * 256;
}

// The branch-free epilogue against the library calls it replaces, bit for
// bit: over every 24-bit word n, bm_radius(n) against cprng.cuh's radius
// (sqrtf of -2 log u1, bad[0]); every float a in the division's domain (+0
// and kDivLeast <= |a| <= kDivMost, both signs) through div_fast against
// a / adc_step (bad[1]); gauss_fast against cprng.cuh's gauss_from_counter
// on 2^24 counters (bad[2]). bad[3] takes the least nonzero |angle_cos|
// (its float bits), which the division's domain relies on.
__global__ void aimc_experts_check_kernel(float adc_step, float rcp,
                                          unsigned long long* bad) {
  unsigned* min_cos = reinterpret_cast<unsigned*>(bad + 3);
  const uint32_t least = __float_as_uint(kDivLeast);
  const uint32_t top = __float_as_uint(kDivMost);
  const uint32_t stride = blockDim.x * gridDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i <= top;
       i += stride) {
    if (i == 0 || i >= least) {
#pragma unroll
      for (uint32_t sign = 0; sign < 2; ++sign) {
        if (i == 0 && sign) continue;   // -0 is no sum (see kDivLeast)
        const float a = __uint_as_float(i | (sign << 31));
        if (__float_as_uint(div_fast(a, adc_step, rcp)) !=
            __float_as_uint(a / adc_step))
          atomicAdd(&bad[1], 1ull);
      }
    }
    if (i >= (1u << 24)) continue;
    if (__float_as_uint(bm_radius(i)) != __float_as_uint(aimc::radius(i)))
      atomicAdd(&bad[0], 1ull);
    const float c = aimc::angle_cos(i);
    if (c != 0.0f && fabsf(c) < 1e-3f)
      atomicMin(min_cos, __float_as_uint(fabsf(c)));
    const uint32_t seed = 0xC0FFEEu;
    if (__float_as_uint(gauss_fast(seed, i)) !=
        __float_as_uint(aimc::gauss_from_counter(seed, i)))
      atomicAdd(&bad[2], 1ull);
  }
}

}  // namespace

// The body's workspace for a shape (the int8 codes [G, B, KB*Mp], Mp = M
// rounded up to 128, in 256-byte units) and its rows per tile.
extern "C" int aimc_experts_wide_plan(int B, int KB, int M, int Np, int G,
                                      long long* work_bytes) {
  *work_bytes = 0;
  if (B <= 0 || KB < 1 || M < 1 || G < 1) return 0;
  *work_bytes = (long long)codes_bytes(B, KB, M, G);
  return kBM;
}

// The DAC pass and the body on `stream` (aimc_mvm.cu's
// aimc_mvm_experts_launch calls it when the wrapper chose this body):
// operands, ld, col0 and nc as there; fast = 1 takes the branch-free
// epilogue where every sum lies within what aimc_experts_check covered.
// Returns cudaGetLastError() after the launches, or a CUDA error code for
// a shape it does not take or a tensor map the driver refused.
extern "C" int aimc_experts_wide_launch(const void* x, const void* w_q,
                                        const void* s_w, const void* s_x,
                                        const void* seeds, void* out, int B,
                                        int KB, int M, int Np, int G,
                                        float adc_step, float sigma,
                                        void* stream, void* work, int ld,
                                        int col0, int nc, int fast) {
  if (B <= 0) return 0;
  if (!wide_shape_ok(work, w_q, B, KB, M, Np, ld, col0, nc, G) ||
      (sigma > 0.0f && seeds == nullptr))
    return (int)cudaErrorInvalidValue;
  const int Mp = round_up(M, kBK);
  int err = aimc_dac_launch(x, s_x, work, G * B, KB, M, Mp, B, stream);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* codes = static_cast<const int8_t*>(work);
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const float* sw = static_cast<const float*>(s_w);
  const float* sx = static_cast<const float*>(s_x);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  float* o = static_cast<float*>(out);
  switch (wide_mode(fast, M, sigma)) {
    case kOff:
      return launch_wide<kOff, kAll>(codes, w, sw, sx, sd, o, B, KB, M, Np,
                                     ld, col0, nc, G, adc_step, sigma, st);
    case kNoise:
      return launch_wide<kNoise, kAll>(codes, w, sw, sx, sd, o, B, KB, M, Np,
                                       ld, col0, nc, G, adc_step, sigma, st);
    default:
      return launch_wide<kExact, kAll>(codes, w, sw, sx, sd, o, B, KB, M, Np,
                                       ld, col0, nc, G, adc_step, sigma, st);
  }
}

// Launch aimc_experts_check_kernel on `stream`: bad is 4 uint64 on the
// device, zero but for bad[3] = 0x7f800000 (+inf's bits); returns
// cudaGetLastError() after the launch.
extern "C" int aimc_experts_check(float adc_step, void* bad, void* stream) {
  aimc_experts_check_kernel<<<sm_count() * 8, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      adc_step, 1.0f / adc_step, static_cast<unsigned long long*>(bad));
  return (int)cudaGetLastError();
}
