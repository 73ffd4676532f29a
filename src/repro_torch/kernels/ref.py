"""Plain PyTorch versions of the AIMC crossbar MVM (port of
`repro/kernels/ref.py`): what the CUDA kernels in `csrc/aimc_mvm.cu`
compute, written as bulk tensor ops. The CPU path runs these; on the card
`chip_smoke.py` holds the kernels against them.

Interface contract (shared with `kernels/aimc_mvm.py` and `kernels/ops.py`):

  x          f32      [B, KB*M]   activations, K zero-padded to whole blocks
  w_q        int8     [KB, M, Np] programmed conductance codes
  s_w        f32      [KB, Np]    per (row-block, bit-line) weight scale
  s_x        f32      [1, 1]      DAC input scale (device tensor)
  read_noise f32      [KB, B, Np] additive bit-line noise in LSBs
  adc_step   float                ADC step in accumulator LSBs

Returns f32 [B, Np]: the sum over row blocks of
``ADC8(x_q_block @ w_q_block + noise) * s_w_block``, times
``adc_step * s_x``. The int8 x int8 product is taken in float64, which is
exact here (|acc| <= M * 127^2 < 2^53) and runs on cuBLAS, which has no
int32 GEMM.

Read noise of the v2/stacked versions comes from a scalar seed, by
``noise_source``: "counter" (`kernels/cprng`, the reference's generator) or
"hw", the Philox4x32-10 stream that stands in on Hopper for the TPU's
hardware PRNG (`philox_read_noise_array`, the plain version of
`csrc/philox.cuh`).
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import adc_quantize, quantize
from repro_torch.kernels import cprng

EPILOGUE_FNS = {
    "none": lambda y: y,
    "relu": lambda y: torch.clamp_min(y, 0.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


NOISE_SOURCES = ("counter", "hw")

# Philox4x32-10 (Salmon et al., SC'11; Random123): multipliers, Weyl key bumps
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_M32 = 0xFFFFFFFF


def _mulhilo(a, m: int):
    """(hi, lo) words of the 64-bit product of uint32 ``a`` (int or int64
    tensor) and the constant ``m``; the halves of ``m`` keep every int64
    product below 2^48."""
    p0 = a * (m & 0xFFFF)
    p1 = a * (m >> 16)
    t = p0 + ((p1 & 0xFFFF) << 16)
    return ((t >> 32) + (p1 >> 16)) & _M32, t & _M32


def philox4x32(ctr, key):
    """Philox4x32-10 on uint32 words (ints or int64 tensors): counter
    ``(c0, c1, c2, c3)``, key ``(k0, k1)`` -> four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & _M32, (k1 + PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_read_noise_array(seed, kb: int, b: int, np_: int,
                            device=None) -> torch.Tensor:
    """The `[KB, B, Np]` standard-normal tensor of "hw" read noise: element
    (k, row, col) takes key ``(seed, k)`` and counter ``(row, col >> 1, 0,
    0)``; words 0-1 feed the even column and words 2-3 the odd one through
    Box-Muller. Addressed by the logical element, so no launch tiling or
    batch padding moves a draw."""
    rows = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(np_, dtype=torch.int64, device=device)[None, :]
    rows, pairs = torch.broadcast_tensors(rows, cols >> 1)
    odd = (cols & 1).bool()
    zero = torch.zeros_like(rows)
    out = torch.empty((kb, b, np_), dtype=torch.float32, device=device)
    for k in range(kb):
        w0, w1, w2, w3 = philox4x32((rows, pairs, zero, zero),
                                    (int(seed) & _M32, k))
        out[k] = cprng.box_muller(torch.where(odd, w2, w0),
                                  torch.where(odd, w3, w1))
    return out


def read_noise_array(seed, kb: int, b: int, np_: int, noise_source: str,
                     device=None) -> torch.Tensor:
    """Standard-normal `[KB, B, Np]` read noise from ``seed``."""
    if noise_source == "counter":
        return cprng.read_noise_array(seed, kb, b, np_, device=device)
    if noise_source == "hw":
        return philox_read_noise_array(seed, kb, b, np_, device=device)
    raise ValueError(f"unknown noise_source {noise_source!r}")


def aimc_matmul_ref(x, w_q, s_w, s_x, read_noise, *, adc_step: float):
    """Plain version of kernel K1: the explicit `[KB, B, Np]` noise operand
    (or None), no epilogue."""
    if x.dim() != 2 or w_q.dim() != 3:
        raise ValueError(f"bad ranks: x{tuple(x.shape)} w_q{tuple(w_q.shape)}")
    kb, m, np_ = w_q.shape
    b = x.shape[0]
    if x.shape[1] != kb * m:
        raise ValueError(f"x K={x.shape[1]} != KB*M={kb * m}")
    x_q = quantize(x.reshape(b, kb, m).to(torch.float32), s_x.reshape(()))
    acc = torch.einsum("bkm,kmn->kbn", x_q.to(torch.float64),
                       w_q.to(torch.float64)).to(torch.float32)
    if read_noise is not None:
        acc = acc + read_noise
    codes = adc_quantize(acc, adc_step)                          # [KB,B,Np]
    contrib = codes.to(torch.float32) * s_w[:, None, :]
    return contrib.sum(0) * (s_x.reshape(()) * adc_step)


def aimc_matmul_ref_v2(x, w_q, s_w, s_x, seed=None, bias=None, *,
                       adc_step: float, sigma: float = 0.0,
                       activation: str = "none",
                       noise_source: str = "counter"):
    """Plain version of kernel K2 (and of K4 with ``noise_source="hw"``):
    seed-addressed noise + epilogue."""
    kb, m, np_ = w_q.shape
    noise = None
    if sigma > 0.0:
        if seed is None:
            raise ValueError("sigma > 0 requires a seed")
        noise = sigma * read_noise_array(seed, kb, x.shape[0], np_,
                                         noise_source, device=x.device)
    y = aimc_matmul_ref(x, w_q, s_w, s_x, noise, adc_step=adc_step)
    if bias is not None:
        y = y + bias.reshape(1, np_).to(torch.float32)
    return EPILOGUE_FNS[activation](y)


def aimc_matmul_stacked_ref(x, w_q, s_w, s_x, seed=None, bias=None, *,
                            adc_step: float, sigma: float = 0.0,
                            activations="none",
                            noise_source: str = "counter"):
    """Plain version of kernel K3: per-gate K2 under `stack_seed`."""
    g_ = w_q.shape[0]
    if isinstance(activations, str):
        activations = (activations,) * g_
    return torch.stack([
        aimc_matmul_ref_v2(
            x, w_q[g], s_w[g], s_x,
            cprng.stack_seed(seed, g) if seed is not None else None,
            bias[g] if bias is not None else None,
            adc_step=adc_step, sigma=sigma, activation=activations[g],
            noise_source=noise_source)
        for g in range(g_)])
