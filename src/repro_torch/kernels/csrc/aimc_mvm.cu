// Fused AIMC crossbar MVM for Hopper (sm_90a): DAC -> int8 MAC -> read
// noise -> ADC -> dequant -> row-block accumulate -> bias + activation.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/aimc_mvm.py:
//   K1  aimc_matmul_pallas          (body _aimc_mvm_kernel, :83)
//   K2  aimc_matmul_pallas_v2       (body _aimc_mvm_kernel_v2, :186)
//   K3  aimc_matmul_pallas_stacked  (body _aimc_mvm_kernel_stacked, :297)
//   K4  the noise_source="hw" branch of _in_kernel_noise (:160-170)
// K3 is K2 with a gate index: gate g reads w_q[g], s_w[g], bias[g], draws
// noise under stack_seed(seed, g) and applies its own activation; x and its
// DAC scale are shared. K1 is K2 with the noise read from an explicit
// [KB, B, Np] operand and no epilogue. K4 is K2/K3 with the per-element
// noise drawn by Philox4x32-10 (philox.cuh) in place of the counter hash.
// The plain PyTorch versions are repro_torch/kernels/ref.py
// (aimc_matmul_ref, aimc_matmul_ref_v2, aimc_matmul_stacked_ref;
// noise_source="hw" for K4).
//
// What bounds it on an H100 SXM, by regime:
//  * B <= 16 (granite decode and prefill pad, the MLP, the LSTM): the int8
//    weight panel is read once, so the bound is bytes (w_q + s_w + x + out
//    over 3.35 TB/s). Reaching it needs every SM streaming, with enough
//    bytes in flight per SM (~15 KB at ~600 ns latency), and a grid that
//    covers 132 SMs even where Np is narrow (wk/wv: 1024 columns).
//  * large B (the CNNs' im2col rows, 1,352 to 95,048): the f32 x read and
//    the int8 MACs. The MACs need the tensor cores (the int8 rate is
//    ~30x the CUDA cores' IMAD rate), and x must be read and quantized
//    once, not once per column block.
//
// Design (one body for K1-K4; the programmed layout w_q [G, KB, M, Np],
// n contiguous, is unchanged and no second copy of the codes is kept):
//  1. DAC once: aimc_dac_kernel turns x f32 [B, KB*M] into int8 codes
//     [B, KB*Mp] (Mp = M rounded up to 128, zero padded) with
//     rintf(x / s_x) (IEEE division, half-to-even) clipped to +-127. The
//     wrapper passes the workspace; no kernel allocates.
//  2. MAC on the tensor cores: mma.sync m16n8k32 s8 x s8 -> s32. A is the
//     codes tile (row-major, k contiguous, as the instruction wants). B
//     needs k contiguous per column, the programmed panel has n
//     contiguous: each thread reads four 32-bit words (4 k rows x 4
//     columns) from shared memory and transposes the 4x4 bytes in
//     registers with __byte_perm (8 PRMT for 4 fragments). Chosen over a
//     byte gather (16 LDS.U8 for the same 4 fragments) and over a
//     transposed copy in shared memory (a second pass and a barrier). The
//     transpose hands thread (g, t) physical columns 4g..4g+3, so n8 tile
//     j of a warp's 32-column group holds physical column 4*l + j at its
//     logical column l; the accumulator of thread (g, t) then covers the
//     8 contiguous columns 8t..8t+7 (float4 loads of s_w, float4 stores).
//  3. Weights stream through a 4-stage cp.async ring of BK-row k tiles
//     (16-byte copies; BK = 64 at 16 rows per block, 8 KB of weights per
//     stage; BK = 128 at 64 rows, where each stage must carry enough MACs
//     to cover the copy latency), so three tiles are in flight while the
//     tensor cores work on the fourth. Weight rows are
//     XOR-swizzled per 16-byte chunk (chunk ^ 2*((row >> 2) & 3)) so the
//     fragment reads are free of bank conflicts; codes rows are padded to
//     80 bytes for the same reason.
//  4. ADC at each row-block boundary, in the fragment's own registers: the
//     int32 sums of a row block are exact whatever the k order, get their
//     noise addressed by the LOGICAL element (counter (k*B + r)*Np + c;
//     Philox (seed_g, k, r, c); K1's noise[k, r, c]) so no tiling moves a
//     draw, then codes = clip(rintf((acc + sigma*z) / adc_step)) and
//     out += codes * (s_w[k, c] * (adc_step * s_x)), in k order, the
//     Pallas kernel's association. Bias and activation follow the last row
//     block. Built with --fmad=false so nothing is contracted, so the
//     tiling moves no bit: tools/kernel_ab.py holds every output to an
//     earlier build of this library (a CUDA-core IMAD loop) bit for bit.
//  5. Narrow grids split over row blocks: when the output tiles number
//     fewer than two waves (2 x SMs), KB > 1 and the f32 scratch round
//     trip costs no more bytes than the weights it spreads (8*B <= M),
//     each block takes one row block and stores its dequantized
//     contribution to a scratch [G, KB, B, Np]; aimc_rowblock_sum_kernel
//     adds k = 0..KB-1 in that order and applies bias and activation, so
//     split and unsplit outputs are bit-equal. The CNN shapes never split
//     (B >= 1352: their scratch would outweigh the weights many times).
//  6. Tiles: BN = 128 columns; BM = 16 rows (one m16 tile, 4 warps) unless
//     B > 16 and BM = 64 (8 warps, 2 m16 tiles each) still gives at least
//     one block per SM. Rows past B read zero codes and are not stored.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cprng.cuh"
#include "philox.cuh"

namespace {

constexpr int kBN = 128;          // columns per block
constexpr int kMaxBK = 128;       // deepest k tile; codes rows pad to it
constexpr int kStages = 4;        // cp.async ring depth
constexpr int kMaxGates = 16;     // 2-bit activation codes in acts

__device__ __forceinline__ float epilogue(float y, int act) {
  switch (act) {
    case 1: return fmaxf(y, 0.0f);                   // relu
    case 2: return 1.0f / (1.0f + expf(-y));         // sigmoid
    case 3: return tanhf(y);                         // tanh
    default: return y;                               // none
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;   // 0 source bytes: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4x4 byte transpose: word i holds row i's bytes (columns 0..3); word j of
// the result holds column j's bytes (rows 0..3), row 0 lowest.
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1,
                                             uint32_t w2, uint32_t w3,
                                             uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// byte offset of (row, 16-byte chunk) in a swizzled weight stage
__device__ __forceinline__ int w_offset(int row, int chunk) {
  return row * kBN + ((chunk ^ (((row >> 2) & 3) << 1)) << 4);
}

// DAC (CM_QUEUE): codes[row, k*Mp + m] = clip(rintf(x[row, k*M + m] / s_x))
// for m < M, 0 for M <= m < Mp; four codes per thread.
__global__ void aimc_dac_kernel(const float* __restrict__ x,
                                const float* __restrict__ s_x,
                                int8_t* __restrict__ codes, int B, int KB,
                                int M, int Mp) {
  const size_t K = (size_t)KB * M;
  const int quads = KB * Mp / 4;
  const size_t n = (size_t)B * quads;
  const float sx = *s_x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t row = e / quads;
    const int col = (int)(e - row * quads) * 4;
    const int k = col / Mp;
    const int m = col - k * Mp;
    const float* xr = x + row * K + (size_t)k * M;
    int8_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      q[j] = 0;
      if (m + j < M) {
        const float v = rintf(xr[m + j] / sx);
        q[j] = (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
      }
    }
    reinterpret_cast<char4*>(codes)[e] = make_char4(q[0], q[1], q[2], q[3]);
  }
}

// MAC (CM_PROCESS) + noise + ADC + dequant (CM_DEQUEUE) over row blocks
// [k0, k1) of gate g. MT m16 tiles per warp, WM warps along the rows, 4
// warps of 32 columns along the columns. part == nullptr: all row blocks,
// bias + activation, store to out. Otherwise one row block (blockIdx.z =
// g*KB + k) whose dequantized contribution goes to part [G, KB, B, Np].
template <int MT, int WM, int BK>
__global__ void __launch_bounds__(WM * 128)
aimc_mvm_mma_kernel(const int8_t* __restrict__ xq,
                    const int8_t* __restrict__ w_q,
                    const float* __restrict__ s_w,
                    const float* __restrict__ s_x,
                    const float* __restrict__ bias,
                    const float* __restrict__ noise, float* __restrict__ out,
                    float* __restrict__ part, int B, int KB, int M, int Mp,
                    int Np, float adc_step, float sigma, uint32_t seed,
                    int stacked, uint32_t acts, int philox) {
  constexpr int BM = 16 * MT * WM;
  constexpr int kThreads = WM * 128;
  constexpr int kAPitch = BK + 16;   // bytes per codes row in shared memory
  constexpr int kAStage = BM * kAPitch;
  constexpr int kWTile = BK * kBN;   // bytes of weights per stage
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sA = smem;                          // [kStages][BM][80]
  unsigned char* sW = smem + kStages * kAStage;      // [kStages][BK][128]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;      // mma groupID
  const int tq = lane & 3;       // mma thread in group
  const int wn = warp & 3;       // 32-column group of this warp
  const int wm = warp >> 2;
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * BM;
  const bool split = part != nullptr;
  const int g = split ? (int)blockIdx.z / KB : (int)blockIdx.z;
  const int k0 = split ? (int)blockIdx.z - g * KB : 0;
  const int k1 = split ? k0 + 1 : KB;
  const int KT = Mp / BK;
  const int tiles = (k1 - k0) * KT;
  const size_t Kp = (size_t)KB * Mp;

  const int8_t* wg = w_q + (size_t)g * KB * M * Np;
  const float* swg = s_w + (size_t)g * KB * Np;
  const uint32_t seed_g = stacked ? aimc::stack_seed(seed, (uint32_t)g) : seed;
  const int act = (acts >> (2 * g)) & 3;
  const float sx = *s_x;
  const float scale_xs = adc_step * sx;

  auto load_tile = [&](int it) {
    const int stage = it % kStages;
    const int kk = k0 + it / KT;
    const int kt = it - (it / KT) * KT;
    unsigned char* a = sA + stage * kAStage;
    for (int c = tid; c < BM * (BK / 16); c += kThreads) {
      const int r = c / (BK / 16);
      const int ch = c % (BK / 16);
      const int row = row0 + r;
      const bool ok = row < B;
      const int8_t* src =
          ok ? xq + (size_t)row * Kp + (size_t)kk * Mp + kt * BK + ch * 16
             : xq;
      cp_async16(a + r * kAPitch + ch * 16, src, ok);
    }
    unsigned char* w = sW + stage * kWTile;
    for (int c = tid; c < BK * (kBN / 16); c += kThreads) {
      const int r = c >> 3;
      const int ch = c & 7;
      const int m = kt * BK + r;
      const bool ok = m < M;
      const int8_t* src =
          ok ? wg + ((size_t)kk * M + m) * Np + n0 + ch * 16 : wg;
      cp_async16(w + w_offset(r, ch), src, ok);
    }
  };

  int acc[MT][4][4];
  float y[MT][2][8];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c) y[mt][h][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_tile(s);
    cp_async_commit();
  }

  const int col = n0 + wn * 32 + 8 * tq;   // first of this thread's 8
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < tiles) load_tile(it + kStages - 1);
    cp_async_commit();

    const unsigned char* a = sA + (it % kStages) * kAStage;
    const unsigned char* w = sW + (it % kStages) * kWTile;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* ar =
            a + (wm * 16 * MT + mt * 16 + gq) * kAPitch + ks + 4 * tq;
        af[mt][0] = lds32(ar);
        af[mt][1] = lds32(ar + 8 * kAPitch);
        af[mt][2] = lds32(ar + 16);
        af[mt][3] = lds32(ar + 8 * kAPitch + 16);
      }
      uint32_t bf[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ks + 16 * half + 4 * tq;
        const int ch = 2 * wn + (gq >> 2);
        const int wo = (gq & 3) * 4;
        transpose4x4(lds32(w + w_offset(r, ch) + wo),
                     lds32(w + w_offset(r + 1, ch) + wo),
                     lds32(w + w_offset(r + 2, ch) + wo),
                     lds32(w + w_offset(r + 3, ch) + wo), bf[half]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], af[mt], bf[0][j],
                                           bf[1][j]);
    }

    if ((it + 1) % KT != 0) continue;
    // ---- row block kk done: noise + ADC + dequant, in registers ---------
    const int kk = k0 + it / KT;
    const float* swk = swg + (size_t)kk * Np + col;
    float* partk = split ? part + ((size_t)g * KB + kk) * B * Np + col
                         : nullptr;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm * 16 * MT + mt * 16 + gq + 8 * h;
        const bool live = row < B;
#pragma unroll
        for (int c = 0; c < 8; c += 2) {
          // columns col + c, col + c + 1: n8 tiles c & 3 and (c + 1) & 3,
          // accumulator register 2h + (c >> 2)
          float a0 = (float)acc[mt][c & 3][2 * h + (c >> 2)];
          float a1 = (float)acc[mt][(c + 1) & 3][2 * h + (c >> 2)];
          if (noise != nullptr) {
            if (live) {
              const float2 nz = *reinterpret_cast<const float2*>(
                  noise + ((size_t)kk * B + row) * Np + col + c);
              a0 = a0 + nz.x;
              a1 = a1 + nz.y;
            }
          } else if (sigma > 0.0f && live) {
            float z0, z1;
            if (philox) {
              aimc::gauss_philox_pair(seed_g, (uint32_t)kk, (uint32_t)row,
                                      (uint32_t)((col + c) >> 1), z0, z1);
            } else {
              const uint32_t ctr =
                  ((uint32_t)kk * (uint32_t)B + (uint32_t)row) *
                      (uint32_t)Np + (uint32_t)(col + c);
              z0 = aimc::gauss_from_counter(seed_g, ctr);
              z1 = aimc::gauss_from_counter(seed_g, ctr + 1u);
            }
            a0 = a0 + sigma * z0;
            a1 = a1 + sigma * z1;
          }
          const float2 sw = *reinterpret_cast<const float2*>(swk + c);
          const float v0 =
              fminf(fmaxf(rintf(a0 / adc_step), -127.0f), 127.0f) *
              (sw.x * scale_xs);
          const float v1 =
              fminf(fmaxf(rintf(a1 / adc_step), -127.0f), 127.0f) *
              (sw.y * scale_xs);
          if (split) {
            if (live)
              *reinterpret_cast<float2*>(partk + (size_t)row * Np + c) =
                  make_float2(v0, v1);
          } else {
            y[mt][h][c] = (kk == 0) ? v0 : y[mt][h][c] + v0;
            y[mt][h][c + 1] = (kk == 0) ? v1 : y[mt][h][c + 1] + v1;
          }
        }
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
  }
  cp_async_wait<0>();
  if (split) return;

  // ---- epilogue after the last row block: bias + activation, store -------
  float bv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    bv[c] = bias != nullptr ? bias[(size_t)g * Np + col + c] : 0.0f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * 16 * MT + mt * 16 + gq + 8 * h;
      if (row >= B) continue;
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        v[c] = y[mt][h][c];
        if (bias != nullptr) v[c] = v[c] + bv[c];
        v[c] = epilogue(v[c], act);
      }
      float4* dst =
          reinterpret_cast<float4*>(out + ((size_t)g * B + row) * Np + col);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
}

// Split grids: out[g, row, c] = act(((part[g,0] + part[g,1]) + ...) + bias),
// the row-block sum in k order, as the unsplit body takes it.
__global__ void aimc_rowblock_sum_kernel(const float* __restrict__ part,
                                         const float* __restrict__ bias,
                                         float* __restrict__ out, int B,
                                         int KB, int Np, int G,
                                         uint32_t acts) {
  const size_t plane = (size_t)B * Np;
  const size_t n = (size_t)G * plane;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int g = (int)(e / plane);
    const size_t rc = e - (size_t)g * plane;
    const float* p = part + (size_t)g * KB * plane + rc;
    float y = p[0];
    for (int k = 1; k < KB; ++k) y = y + p[(size_t)k * plane];
    if (bias != nullptr) y = y + bias[(size_t)g * Np + rc % Np];
    out[e] = epilogue(y, (acts >> (2 * g)) & 3);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// The launcher's tiling and split choice, shared by the workspace query
// and the launch so both agree.
struct Plan {
  int bm;             // 16 or 64 rows per block
  bool split;         // one row block per block + aimc_rowblock_sum_kernel
  int Mp;             // M rounded up to kMaxBK
  size_t codes_bytes; // int8 codes [B, KB*Mp], rounded up to 256 bytes
  size_t part_bytes;  // f32 scratch [G, KB, B, Np] when split
};

Plan make_plan(int B, int KB, int M, int Np, int G) {
  Plan p;
  const int sms = sm_count();
  const long long cols = (long long)(Np / kBN) * G;
  p.bm = (B > 16 && (long long)((B + 63) / 64) * cols >= sms) ? 64 : 16;
  const long long tiles = (long long)((B + p.bm - 1) / p.bm) * cols;
  p.split = KB > 1 && tiles < 2LL * sms && 8LL * B <= M;
  p.Mp = (M + kMaxBK - 1) / kMaxBK * kMaxBK;
  p.codes_bytes = ((size_t)B * KB * p.Mp + 255) / 256 * 256;
  p.part_bytes = p.split ? (size_t)G * KB * B * Np * sizeof(float) : 0;
  return p;
}

template <int MT, int WM, int BK>
int launch_mma(const int8_t* xq, const int8_t* w_q, const float* s_w,
               const float* s_x, const float* bias, const float* noise,
               float* out, float* part, int B, int KB, int M, int Mp, int Np,
               int G, float adc_step, float sigma, uint32_t seed, int stacked,
               uint32_t acts, int philox, cudaStream_t stream) {
  constexpr int BM = 16 * MT * WM;
  const size_t smem = (size_t)kStages * (BM * (BK + 16) + BK * kBN);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        aimc_mvm_mma_kernel<MT, WM, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(Np / kBN, (B + BM - 1) / BM,
                  part != nullptr ? G * KB : G);
  aimc_mvm_mma_kernel<MT, WM, BK><<<grid, WM * 128, smem, stream>>>(
      xq, w_q, s_w, s_x, bias, noise, out, part, B, KB, M, Mp, Np, adc_step,
      sigma, seed, stacked, acts, philox);
  return (int)cudaGetLastError();
}

int grid_for(size_t n, int threads) {
  const size_t blocks = (n + threads - 1) / threads;
  const size_t cap = (size_t)sm_count() * 16;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

// The launcher's choice for this shape: returns the rows per block (16 or
// 64), plus 256 if the grid is split over row blocks (three kernels per
// call, else two), and stores the bytes of the workspace aimc_mvm_launch
// needs (the int8 DAC codes and, split, the f32 per-row-block scratch).
extern "C" int aimc_mvm_plan(int B, int KB, int M, int Np, int G,
                             long long* work_bytes) {
  *work_bytes = 0;
  if (B <= 0 || KB < 1 || M < 1 || G < 1) return 0;
  const Plan p = make_plan(B, KB, M, Np, G);
  *work_bytes = (long long)(p.codes_bytes + p.part_bytes);
  return p.bm | (p.split ? 256 : 0);
}

// C entry point bound with ctypes (repro_torch/kernels/aimc_mvm.py).
// x f32 [B, KB*M] contiguous, w_q int8 [G, KB, M, Np], s_w f32 [G, KB, Np],
// s_x f32 [1], bias f32 [G, Np] or null, noise f32 [KB, B, Np] or null (K1:
// G = 1, sigma = 0), out f32 [G, B, Np]; Np % 128 == 0; work holds the
// bytes aimc_mvm_plan gives for the shape, 16-byte aligned.
// stacked = 0 is K2 (G must be 1, seed used as is), 1 is K3.
// acts packs a 2-bit activation code per gate (0 none, 1 relu, 2 sigmoid,
// 3 tanh). philox = 1 draws the sigma-scaled noise with Philox (K4), 0
// with the counter hash. Issues the DAC pass, the MVM and, on a split
// grid, the row-block sum on `stream`; returns cudaGetLastError() after
// the launches (0 = launched).
extern "C" int aimc_mvm_launch(const void* x, const void* w_q, const void* s_w,
                               const void* s_x, const void* bias,
                               const void* noise, void* out, int B, int KB,
                               int M, int Np, int G, float adc_step,
                               float sigma, unsigned int seed, int stacked,
                               unsigned int acts, int philox, void* stream,
                               void* work) {
  if (B <= 0) return 0;
  if (Np % kBN != 0 || G < 1 || G > kMaxGates || M < 1 || KB < 1 ||
      work == nullptr || reinterpret_cast<uintptr_t>(work) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, KB, M, Np, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* codes = static_cast<int8_t*>(work);
  float* part = p.split ? reinterpret_cast<float*>(
                              static_cast<unsigned char*>(work) +
                              p.codes_bytes)
                        : nullptr;
  const size_t quads = (size_t)B * KB * p.Mp / 4;
  aimc_dac_kernel<<<grid_for(quads, 256), 256, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(s_x), codes, B,
      KB, M, p.Mp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const float* sw = static_cast<const float*>(s_w);
  const float* sx = static_cast<const float*>(s_x);
  const float* b = static_cast<const float*>(bias);
  const float* nz = static_cast<const float*>(noise);
  float* o = static_cast<float*>(out);
  err = p.bm == 64
            ? launch_mma<2, 2, 128>(codes, w, sw, sx, b, nz, o, part, B, KB,
                                    M, p.Mp, Np, G, adc_step, sigma, seed,
                                    stacked, acts, philox, st)
            : launch_mma<1, 1, 64>(codes, w, sw, sx, b, nz, o, part, B, KB,
                                   M, p.Mp, Np, G, adc_step, sigma, seed,
                                   stacked, acts, philox, st);
  if (err || !p.split) return err;
  const size_t n = (size_t)G * B * Np;
  aimc_rowblock_sum_kernel<<<grid_for(n, 256), 256, 0, st>>>(
      part, b, o, B, KB, Np, G, acts);
  return (int)cudaGetLastError();
}
