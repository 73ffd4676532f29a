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


# Projection weight names, [..., K(reduce), N(out)]: the name sets of
# `repro/launch/shardings.py:21-26`, copied (the port imports nothing of
# the reference). `QUANTIZABLE` is what `--int8` packs.
IN_PROJ = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "cq", "ck", "cv",
           "router", "w_rnn_in", "w_a", "w_x", "w_q", "w_k", "w_v", "w_if",
           "w_zifo", "w_ff_gate", "w_ff_up", "wd_gate", "wd_up"}
OUT_PROJ = {"wo", "w_down", "w_out", "co", "w_ff_down", "wd_down"}
EXPERT_IN = {"we_gate", "we_up"}
EXPERT_OUT = {"we_down"}
QUANTIZABLE = IN_PROJ | OUT_PROJ | EXPERT_IN | EXPERT_OUT | {"unembed"}


def quantize_weight_int8(w: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8 quantization of a [..., K, N]
    weight: {"q": int8 codes, "s": f32 scales [..., 1, N]}, the serving
    number format `models.layers.as_weight` reads. A stack is packed one
    [K, N] instance at a time, so the f32 temporaries are one matrix
    large (each instance's scales depend on that instance alone)."""
    *lead, k, n = w.shape
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((*lead, 1, n), dtype=torch.float32, device=w.device)
    flat_w, flat_q, flat_s = (w.reshape(-1, k, n), q.reshape(-1, k, n),
                              s.reshape(-1, 1, n))
    for i in range(flat_w.shape[0]):
        wi = flat_w[i].to(torch.float32)
        si = sym_scale(wi, dim=-2)
        flat_s[i].copy_(si)
        flat_q[i].copy_(quantize(wi, si))
    return {"q": q, "s": s}


def quantize_params_int8(params, quantizable=QUANTIZABLE, skip=("embed",)):
    """Tree-wide int8 packing of the projection matrices named in
    ``quantizable`` (by leaf name); every other float leaf is cast to
    bf16, integer leaves pass through. A new tree; the input is left as it
    is."""
    def conv(name, leaf):
        if isinstance(leaf, dict):
            return {k: conv(k, v) for k, v in leaf.items()}
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            return leaf
        if name in quantizable and name not in skip and leaf.dim() >= 2:
            return quantize_weight_int8(leaf)
        return leaf.to(torch.bfloat16)

    return conv("", params)
