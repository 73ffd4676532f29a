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


def aimc_matmul_ref(x, w_q, s_w, s_x, read_noise, *, adc_step: float):
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
                       activation: str = "none"):
    """Plain version of kernel K2: counter-addressed noise + epilogue."""
    kb, m, np_ = w_q.shape
    noise = None
    if sigma > 0.0:
        if seed is None:
            raise ValueError("sigma > 0 requires a seed")
        noise = sigma * cprng.read_noise_array(seed, kb, x.shape[0], np_,
                                               device=x.device)
    y = aimc_matmul_ref(x, w_q, s_w, s_x, noise, adc_step=adc_step)
    if bias is not None:
        y = y + bias.reshape(1, np_).to(torch.float32)
    return EPILOGUE_FNS[activation](y)


def aimc_matmul_stacked_ref(x, w_q, s_w, s_x, seed=None, bias=None, *,
                            adc_step: float, sigma: float = 0.0,
                            activations="none"):
    """Plain version of kernel K3: per-gate K2 under `stack_seed`."""
    g_ = w_q.shape[0]
    if isinstance(activations, str):
        activations = (activations,) * g_
    return torch.stack([
        aimc_matmul_ref_v2(
            x, w_q[g], s_w[g], s_x,
            cprng.stack_seed(seed, g) if seed is not None else None,
            bias[g] if bias is not None else None,
            adc_step=adc_step, sigma=sigma, activation=activations[g])
        for g in range(g_)])
