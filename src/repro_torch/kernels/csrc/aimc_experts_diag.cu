// Measurement-only unit beside the kernel library, never on a model's
// path: tools/expert_profile.py builds it on its own and times the large-
// capacity expert body (aimc_experts.cuh) with parts of it left out, the
// noise draws alone, and reads the SASS of one epilogue element from the
// never-launched probes.
#include "aimc_experts.cuh"

namespace {

using namespace aimc_experts;

// The epilogue element alone at full occupancy: each thread runs
// `per_thread` elements of the noise-on epilogue (the counter draw and the
// ADC on an integer sum), unrolled by 4 so that a thread carries four
// chains, and stores its sum. What the card's SMs take for the draws when
// nothing else competes.
__global__ void __launch_bounds__(256)
aimc_experts_draw_bench_kernel(float* __restrict__ out, uint32_t seed,
                               float sigma, float adc_step, float rcp,
                               int per_thread) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  float y[4] = {-0.0f, -0.0f, -0.0f, -0.0f};
  for (int j = 0; j < per_thread; j += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t ctr = t * (uint32_t)per_thread + (uint32_t)(j + u);
      const float a =
          (float)(int)(ctr & 0xFFFFu) + sigma * gauss_fast(seed, ctr);
      y[u] = y[u] + adc_code<kNoise>(a, adc_step, rcp);
    }
  }
  out[t] = (y[0] + y[1]) + (y[2] + y[3]);
}

// never launched: the epilogue probes below
template <int N, int kMode>
__device__ __forceinline__ void epilogue_probe(const int* acc,
                                               const float* sws, float* y,
                                               uint32_t seed, float sigma,
                                               float adc_step) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int a0 = acc[i];
  const float sw = sws[i];
  float out = y[i];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float a = (float)(a0 + j);
    if (kMode == kNoise)
      a = a + sigma * gauss_fast(seed, (uint32_t)(i * N + j));
    out = out + adc_code<kMode>(a, adc_step, 1.0f / adc_step) * sw;
  }
  y[i] = out;
}

}  // namespace

// The body alone on codes [G, B, KB*Mp] made by the library's
// aimc_dac_launch, with only the parts in `part` (kLoads 1: the TMA feed,
// kMacs 2: ldmatrix and wgmma, kEpilogue 4: the draws, ADC, dequant and
// output stores; the hand-offs always run), the epilogue mode `mode` (0
// noise off, 1 counter noise, fast paths) and, for the whole body with
// noise, the MMA group's share of the draws `draw` (0-5 n8 blocks of 8;
// -1: the library's kMmaDraw). Returns a CUDA error code.
extern "C" int aimc_experts_part_launch(const void* codes, const void* w_q,
                                        const void* s_w, const void* s_x,
                                        const void* seeds, void* out, int B,
                                        int KB, int M, int Np, int G,
                                        float adc_step, float sigma,
                                        void* stream, int part, int mode,
                                        int draw) {
  if (!wide_shape_ok(codes, w_q, B, KB, M, Np, Np, 0, Np, G) || B <= 0 ||
      (mode == kNoise && seeds == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const float* sw = static_cast<const float*>(s_w);
  const float* sx = static_cast<const float*>(s_x);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  float* o = static_cast<float*>(out);
#define AIMC_DRAW(D)                                                        \
  case D:                                                                   \
    return launch_wide<kNoise, kAll, D>(c, w, sw, sx, sd, o, B, KB, M, Np,  \
                                        Np, 0, Np, G, adc_step, sigma, st);
  if (mode == kNoise && part == kAll && draw >= 0) {
    switch (draw) {
      AIMC_DRAW(0)
      AIMC_DRAW(1)
      AIMC_DRAW(2)
      AIMC_DRAW(3)
      AIMC_DRAW(4)
      AIMC_DRAW(5)
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
#undef AIMC_DRAW
#define AIMC_PART(P)                                                         \
  case P:                                                                    \
    return mode == kNoise                                                    \
               ? launch_wide<kNoise, P>(c, w, sw, sx, sd, o, B, KB, M, Np, \
                                        Np, 0, Np, G, adc_step, sigma, st)   \
               : launch_wide<kOff, P>(c, w, sw, sx, sd, o, B, KB, M, Np, Np, \
                                      0, Np, G, adc_step, 0.0f, st);
  switch (part) {
    AIMC_PART(0)
    AIMC_PART(1)
    AIMC_PART(2)
    AIMC_PART(3)
    AIMC_PART(4)
    AIMC_PART(5)
    AIMC_PART(6)
    AIMC_PART(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef AIMC_PART
}

// Launch aimc_experts_draw_bench_kernel: `blocks` blocks of 256 threads,
// `per_thread` (a multiple of 4) elements each, one float per thread to
// `out`; returns cudaGetLastError().
extern "C" int aimc_experts_draw_bench(void* out, int blocks, int per_thread,
                                       float sigma, float adc_step,
                                       void* stream) {
  aimc_experts_draw_bench_kernel<<<blocks, 256, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), 0xC0FFEEu, sigma, adc_step,
      1.0f / adc_step, per_thread);
  return (int)cudaGetLastError();
}

// SASS probes of the epilogue, never launched: the instructions of one
// element are those of the two-element probe's hot path less the
// one-element probe's (tools/expert_profile.py epilogue_sass).
extern "C" __global__ void aimc_probe_adc1(const int* acc, const float* sws,
                                           float* y, uint32_t seed,
                                           float sigma, float adc_step) {
  epilogue_probe<1, kOff>(acc, sws, y, seed, sigma, adc_step);
}
extern "C" __global__ void aimc_probe_adc2(const int* acc, const float* sws,
                                           float* y, uint32_t seed,
                                           float sigma, float adc_step) {
  epilogue_probe<2, kOff>(acc, sws, y, seed, sigma, adc_step);
}
extern "C" __global__ void aimc_probe_draw1(const int* acc, const float* sws,
                                            float* y, uint32_t seed,
                                            float sigma, float adc_step) {
  epilogue_probe<1, kNoise>(acc, sws, y, seed, sigma, adc_step);
}
extern "C" __global__ void aimc_probe_draw2(const int* acc, const float* sws,
                                            float* y, uint32_t seed,
                                            float sigma, float adc_step) {
  epilogue_probe<2, kNoise>(acc, sws, y, seed, sigma, adc_step);
}
