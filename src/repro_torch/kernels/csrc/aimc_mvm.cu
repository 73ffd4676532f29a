// Fused AIMC crossbar MVM for Hopper (sm_90a): DAC -> int8 MAC -> read
// noise -> ADC -> dequant -> row-block accumulate -> bias + activation.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/aimc_mvm.py:
//   K1  aimc_matmul_pallas          (body _aimc_mvm_kernel, :83)
//   K2  aimc_matmul_pallas_v2       (body _aimc_mvm_kernel_v2, :186)
//   K3  aimc_matmul_pallas_stacked  (body _aimc_mvm_kernel_stacked, :297)
//   K4  the noise_source="hw" branch of _in_kernel_noise (:160-170)
// K3 is K2 with a gate index (blockIdx.z): gate g reads w_q[g], s_w[g],
// bias[g], draws noise under stack_seed(seed, g) and applies its own
// activation; x and its DAC scale are shared. K1 is K2 with the noise read
// from an explicit [KB, B, Np] operand and no epilogue. K4 is K2/K3 with
// the per-element noise drawn by Philox4x32-10 (philox.cuh) in place of
// the counter hash. The plain PyTorch versions are
// repro_torch/kernels/ref.py (aimc_matmul_ref, aimc_matmul_ref_v2,
// aimc_matmul_stacked_ref; noise_source="hw" for K4).
//
// Bound on an H100 SXM: decode moves the int8 weight panel once, so the
// kernel is bound by bytes (w_q + s_w + x + out over 3.35 TB/s; K1 adds its
// f32 noise operand, KB*B*Np*4 bytes, several times the int8 panel at
// square shapes); at a prefill batch of 16 the int8 MACs are still far
// below the card's int8 rate; the CNNs' im2col convolutions (B up to ~95k
// patch rows) are bound by operations. This first version does not reach that bound: it uses CUDA-core
// IMADs and 4-byte weight loads, no wgmma, no TMA, and launches one block
// per 32 columns, so narrow projections (wk/wv, 1024 columns) fill only a
// few dozen SMs. Measured times are in PERF.md.
//
// Design:
//  * Grid (Np/32, ceil(B/BB), G); 256 threads; BB in {1,2,4,8,16} batch rows
//    per block (template), picked from B by the launcher, so decode (B=4)
//    does not compute 16 rows.
//  * The TPU kernel's sequential row-block grid axis becomes a loop over
//    k = 0..KB-1 inside the block; nothing carries between blocks.
//  * DAC: the block quantizes x[rows, k*M:(k+1)*M] into int8 shared memory
//    with rintf(x / s_x) (IEEE division, half-to-even) and clips to +-127;
//    rows past B are masked to 0 (no padded copy of x). s_x is read from
//    device memory.
//  * MAC: thread (quad, slice) owns 4 columns and every 32nd row of the row
//    block; weights are read as char4, contiguous along n. The int32 partial
//    sums of the 32 slices are reduced exactly (integer adds) by warp
//    shuffles and shared memory, so the ADC sees the whole row block.
//  * Noise: counter (k*b_logical + row)*Np + col in uint32 wraparound,
//    Box-Muller with logf/sqrtf/cosf (cprng.cuh); or Philox keyed
//    (seed, k) at counter (row, col >> 1) (philox.cuh, K4); or K1's
//    operand noise[k, row, col].
//  * ADC + dequant: codes = clip(rintf((acc + sigma*noise) / adc_step));
//    out += codes * (s_w[k,n] * (adc_step * s_x)), the Pallas kernel's
//    association. Built with --fmad=false so no multiply-add is contracted.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cprng.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;                     // columns per block
constexpr int kQuads = kBN / 4;             // threads across the columns
constexpr int kSlices = kThreads / kQuads;  // threads across a row block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGates = 16;               // 2-bit activation codes in acts

__device__ __forceinline__ float epilogue(float y, int act) {
  switch (act) {
    case 1: return fmaxf(y, 0.0f);                   // relu
    case 2: return 1.0f / (1.0f + expf(-y));         // sigmoid
    case 3: return tanhf(y);                         // tanh
    default: return y;                               // none
  }
}

template <int BB>
__device__ __forceinline__ void load_codes(const int8_t* p, int (&v)[BB]) {
  if constexpr (BB >= 4) {
#pragma unroll
    for (int i = 0; i < BB / 4; ++i) {
      const char4 c = reinterpret_cast<const char4*>(p)[i];
      v[4 * i] = c.x;
      v[4 * i + 1] = c.y;
      v[4 * i + 2] = c.z;
      v[4 * i + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BB; ++i) v[i] = p[i];
  }
}

template <int BB>
__global__ void __launch_bounds__(kThreads)
aimc_mvm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w_q,
                const float* __restrict__ s_w, const float* __restrict__ s_x,
                const float* __restrict__ bias,
                const float* __restrict__ noise, float* __restrict__ out,
                int B, int b_logical, int KB, int M, int Np, float adc_step,
                float sigma, uint32_t seed, int stacked, uint32_t acts,
                int philox) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* part = reinterpret_cast<int32_t*>(smem);  // [kWarps][BB][kBN]
  int8_t* xq = reinterpret_cast<int8_t*>(smem + kWarps * BB * kBN * 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int quad = tid % kQuads;
  const int slice = tid / kQuads;
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * BB;
  const int g = blockIdx.z;
  const size_t K = (size_t)KB * M;

  const int8_t* wg = w_q + (size_t)g * K * Np;
  const float* swg = s_w + (size_t)g * KB * Np;
  const uint32_t seed_g = stacked ? aimc::stack_seed(seed, (uint32_t)g) : seed;
  const int act = (acts >> (2 * g)) & 3;
  const float sx = *s_x;
  const float scale_xs = adc_step * sx;

  constexpr int kOut = (BB * kBN + kThreads - 1) / kThreads;
  float y[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) y[i] = 0.0f;

  for (int k = 0; k < KB; ++k) {
    // ---- DAC (CM_QUEUE): int8 codes of this row block's inputs ----------
    for (int e = tid; e < BB * M; e += kThreads) {
      const int r = e / M;
      const int m = e - r * M;
      const int row = row0 + r;
      int8_t q = 0;
      if (row < B) {
        const float v = rintf(x[(size_t)row * K + (size_t)k * M + m] / sx);
        q = (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
      }
      xq[m * BB + r] = q;
    }
    __syncthreads();

    // ---- crossbar MAC (CM_PROCESS): int8 x int8 -> int32 -----------------
    int acc[BB][4];
#pragma unroll
    for (int r = 0; r < BB; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0;
    const int8_t* wk = wg + (size_t)k * M * Np + n0 + quad * 4;
#pragma unroll 4
    for (int m = slice; m < M; m += kSlices) {
      const char4 w4 = *reinterpret_cast<const char4*>(wk + (size_t)m * Np);
      int xv[BB];
      load_codes<BB>(xq + m * BB, xv);
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        acc[r][0] += xv[r] * (int)w4.x;
        acc[r][1] += xv[r] * (int)w4.y;
        acc[r][2] += xv[r] * (int)w4.z;
        acc[r][3] += xv[r] * (int)w4.w;
      }
    }
    // the 4 slices of a warp differ in lane bits 3 and 4
#pragma unroll
    for (int r = 0; r < BB; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int v = acc[r][j];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < kQuads) part[(warp * BB + r) * kBN + quad * 4 + j] = v;
      }
    __syncthreads();

    // ---- noise + ADC + dequant (CM_DEQUEUE), digital accumulate ----------
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int e = tid + i * kThreads;
      if (e < BB * kBN) {
        const int r = e / kBN;
        const int c = e - r * kBN;
        int a = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) a += part[(w * BB + r) * kBN + c];
        float af = (float)a;
        if (noise != nullptr) {
          if (row0 + r < B)
            af = af + noise[((size_t)k * B + row0 + r) * Np + n0 + c];
        } else if (sigma > 0.0f) {
          float z;
          if (philox) {
            z = aimc::gauss_philox(seed_g, (uint32_t)k, (uint32_t)(row0 + r),
                                   (uint32_t)(n0 + c));
          } else {
            const uint32_t ctr =
                ((uint32_t)k * (uint32_t)b_logical + (uint32_t)(row0 + r)) *
                    (uint32_t)Np + (uint32_t)(n0 + c);
            z = aimc::gauss_from_counter(seed_g, ctr);
          }
          af = af + sigma * z;
        }
        const float code = fminf(fmaxf(rintf(af / adc_step), -127.0f), 127.0f);
        const float contrib = code * (swg[(size_t)k * Np + n0 + c] * scale_xs);
        y[i] = (k == 0) ? contrib : y[i] + contrib;
      }
    }
    __syncthreads();  // xq and part are rewritten by the next row block
  }

  // ---- epilogue on the last row block: bias + activation, store ----------
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int e = tid + i * kThreads;
    if (e < BB * kBN) {
      const int r = e / kBN;
      const int c = e - r * kBN;
      const int row = row0 + r;
      if (row < B) {
        float v = y[i];
        if (bias != nullptr) v = v + bias[(size_t)g * Np + n0 + c];
        out[((size_t)g * B + row) * Np + n0 + c] = epilogue(v, act);
      }
    }
  }
}

template <int BB>
int launch(const float* x, const int8_t* w_q, const float* s_w,
           const float* s_x, const float* bias, const float* noise,
           float* out, int B, int KB, int M, int Np, int G, float adc_step,
           float sigma, uint32_t seed, int stacked, uint32_t acts,
           int philox, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * BB * kBN * 4 + (size_t)M * BB;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        aimc_mvm_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(Np / kBN, (B + BB - 1) / BB, G);
  aimc_mvm_kernel<BB><<<grid, kThreads, smem, stream>>>(
      x, w_q, s_w, s_x, bias, noise, out, B, B, KB, M, Np, adc_step, sigma,
      seed, stacked, acts, philox);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes (repro_torch/kernels/aimc_mvm.py).
// x f32 [B, KB*M] contiguous, w_q int8 [G, KB, M, Np], s_w f32 [G, KB, Np],
// s_x f32 [1], bias f32 [G, Np] or null, noise f32 [KB, B, Np] or null (K1:
// G = 1, sigma = 0), out f32 [G, B, Np]; Np % 32 == 0.
// stacked = 0 is K2 (G must be 1, seed used as is), 1 is K3.
// acts packs a 2-bit activation code per gate (0 none, 1 relu, 2 sigmoid,
// 3 tanh). philox = 1 draws the sigma-scaled noise with Philox (K4), 0
// with the counter hash. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int aimc_mvm_launch(const void* x, const void* w_q, const void* s_w,
                               const void* s_x, const void* bias,
                               const void* noise, void* out, int B, int KB,
                               int M, int Np, int G, float adc_step,
                               float sigma, unsigned int seed, int stacked,
                               unsigned int acts, int philox, void* stream) {
  if (B <= 0) return 0;
  if (Np % kBN != 0 || G < 1 || G > kMaxGates || M < 1 || KB < 1)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const float* sw = static_cast<const float*>(s_w);
  const float* sx = static_cast<const float*>(s_x);
  const float* b = static_cast<const float*>(bias);
  const float* nz = static_cast<const float*>(noise);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 1)
    return launch<1>(xf, w, sw, sx, b, nz, o, B, KB, M, Np, G, adc_step,
                     sigma, seed, stacked, acts, philox, st);
  if (B <= 2)
    return launch<2>(xf, w, sw, sx, b, nz, o, B, KB, M, Np, G, adc_step,
                     sigma, seed, stacked, acts, philox, st);
  if (B <= 4)
    return launch<4>(xf, w, sw, sx, b, nz, o, B, KB, M, Np, G, adc_step,
                     sigma, seed, stacked, acts, philox, st);
  if (B <= 8)
    return launch<8>(xf, w, sw, sx, b, nz, o, B, KB, M, Np, G, adc_step,
                     sigma, seed, stacked, acts, philox, st);
  return launch<16>(xf, w, sw, sx, b, nz, o, B, KB, M, Np, G, adc_step,
                    sigma, seed, stacked, acts, philox, st);
}
