"""DAC/ADC quantization math for the simulated AIMC tile (PyTorch port of
`repro/core/quant.py`).

  * DAC: signed 8-bit input quantization with a per-call max-abs scale
    (dynamic) or a fixed one (static, as the paper recommends).
  * Crossbar: int8 x int8 -> int32 exact MAC.
  * ADC: signed 8-bit output quantization with a per-tile step sized to the
    statistical bit-line range, ``adc_alpha * sqrt(M) * 127`` LSBs.

Rounding is half-to-even everywhere (`torch.round`, the reference's
`jnp.round`; the CUDA kernel uses `rintf`), and the code range is the
symmetric [-127, 127].

Every division by a constant goes through `true_div`: on a CUDA tensor,
PyTorch divides by a Python scalar as a multiply by its reciprocal, which is
off by one ulp often enough to move codes that sit on a .5 tie.
"""

from __future__ import annotations

import torch

QMAX = 127
QMIN = -127


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """IEEE ``x / divisor`` in x's dtype on any device (see module doc)."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def sym_scale(x: torch.Tensor, dim=None, eps: float = 1e-12) -> torch.Tensor:
    """Symmetric max-abs quantization scale so x/scale fits in [-127, 127].
    Stays a device tensor (no host sync)."""
    ax = x.abs()
    amax = ax.amax() if dim is None else ax.amax(dim=dim, keepdim=True)
    return true_div(amax.clamp_min(eps), QMAX)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even signed-8-bit quantization (returns int8)."""
    return torch.round(x / scale).clamp(QMIN, QMAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale.to(torch.float32)


def adc_step_lsb(tile_rows: int, adc_alpha: float) -> float:
    """ADC quantization step in int32-accumulator LSBs: an 8-bit ADC whose
    full scale covers the statistical bit-line range sqrt(M) * 127 * 127."""
    return float(max(1.0, adc_alpha * (tile_rows ** 0.5) * QMAX))


def adc_quantize(acc: torch.Tensor, step: float) -> torch.Tensor:
    """Quantize a bit-line accumulation to int32 codes in [-127, 127]."""
    return torch.round(true_div(acc.to(torch.float32), step)).clamp(
        QMIN, QMAX).to(torch.int32)
