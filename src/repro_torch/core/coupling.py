"""Tight vs loose AIMC coupling as executable PyTorch (paper §IV-A, §VII-B;
port of `repro/core/coupling.py`).

The paper's distinction, custom-instruction access to a private tile vs
memory-mapped I/O-bus transactions, maps onto the card as a fusion
distinction:

  * tight — one call of kernel K2 (`kernels.ops.aimc_matmul_v2`): DAC,
    crossbar MAC, read noise, ADC and the row-block accumulation share one
    launcher; the analog-domain values (bit-line sums, ADC codes) live in
    registers.
  * loose — every pipeline stage is a separate eager PyTorch op whose
    result is a tensor in global memory, mirroring each value crossing the
    I/O bus: x -> x_q -> per-block bit-line sums -> ADC codes ->
    dequantized output.

Both compute the same function (noise off). The crossbar MAC of the loose
path must be exact: CUDA has no int32 matmul, so it multiplies the int8
codes as f64 (every partial sum is an integer below 2^53, exact in any
order), a plain `torch.matmul`, as the reference leaves this product to
XLA outside any kernel.

`hbm_bytes_tight` / `hbm_bytes_loose` count the global-memory traffic of
the two paths for this port's launcher (the analogue of the reference's
HBM->VMEM streaming); see their docstrings for what each count covers.
"""

from __future__ import annotations

import torch

from repro_torch.core.aimc import AimcConfig, AimcLinearState
from repro_torch.core.quant import adc_quantize, quantize, sym_scale
from repro_torch.kernels import ops as kernel_ops

BN = 128     # output columns per block of the K2 launcher (csrc kBN)
MP_ALIGN = 128   # the launcher pads each row block's codes to this (kMaxBK)


def _padded_input(state: AimcLinearState, x: torch.Tensor) -> torch.Tensor:
    kb, m, _ = state.w_q.shape
    xf = x.to(torch.float32)
    if xf.shape[1] != kb * m:
        xf = torch.nn.functional.pad(xf, (0, kb * m - xf.shape[1]))
    return xf.contiguous()


def tight_forward(state: AimcLinearState, x: torch.Tensor,
                  cfg: AimcConfig) -> torch.Tensor:
    """Fused execution: one call of kernel K2 (on a CUDA tensor), noise off,
    no epilogue."""
    xf = _padded_input(state, x)
    s_x = sym_scale(xf).reshape(1, 1)
    y = kernel_ops.aimc_matmul_v2(xf, state.w_q, state.s_w, s_x,
                                  adc_step=cfg.adc_step)
    return y[:, :state.n]


def loose_forward(state: AimcLinearState, x: torch.Tensor,
                  cfg: AimcConfig) -> torch.Tensor:
    """Staged execution: each stage's result is materialised in global
    memory before the next stage reads it."""
    kb, m, _ = state.w_q.shape
    b = x.shape[0]
    xf = _padded_input(state, x)
    step = torch.tensor(cfg.adc_step, dtype=torch.float32, device=x.device)
    # stage 1: DAC quantization (CPU -> bus -> tile input memory)
    s_x = sym_scale(xf)
    x_q = quantize(xf.reshape(b, kb, m), s_x)
    # stage 2: crossbar MAC per row block, exact (f64 sums of int8 products)
    acc = torch.matmul(x_q.transpose(0, 1).to(torch.float64),
                       state.w_q.to(torch.float64)).to(torch.float32)
    # stage 3: ADC quantization (tile output memory -> bus)
    codes = adc_quantize(acc, cfg.adc_step)
    # stage 4: digital dequant + row-block accumulation (CPU side)
    contrib = codes.to(torch.float32) * state.s_w[:, None, :]
    y = contrib.sum(dim=0) * (step * s_x)
    return y[:, :state.n]


# ---------------------------------------------------------------------------
# Global-memory traffic (the quantitative tight-vs-loose gap on the card)
# ---------------------------------------------------------------------------

def hbm_bytes_tight(state: AimcLinearState, batch: int, *,
                    rows_per_block: int, split: bool) -> int:
    """Bytes one K2 call (noise from its seed, no bias) requests from global
    memory, L2 hits included: each CUDA block's reads of distinct bytes plus
    every store, for the launcher's plan (``rows_per_block`` 16 or 64 and
    ``split``, as `kernels.aimc_mvm.launch_plan` reports them; the plan
    depends on the card's SM count, so it is an argument here). The DAC
    scale's 4-byte reads are left out.

      * DAC pass: x f32 [B, KB*M] read once, int8 codes [B, KB*Mp] written
        (Mp = M rounded up to 128, zero padded).
      * MVM: every 128-column block reads its rows' codes again (L2 hits
        after the first), and every block of ``rows_per_block`` rows reads
        its weight panel and s_w columns, so the int8 codes [KB, M, Np] are
        requested once per row block of the batch.
      * unsplit: the f32 output [B, Np] is written once. Split (narrow
        grids): each row block's contribution goes to an f32 scratch
        [KB, B, Np], which the row-block sum reads back before it writes
        the output.
    """
    kb, m, np_ = state.w_q.shape
    return tight_bytes(batch, kb, m, np_, rows_per_block=rows_per_block,
                       split=split)


def tight_bytes(b: int, kb: int, m: int, np_: int, *, rows_per_block: int,
                split: bool, g: int = 1, per_gate_x: bool = False) -> int:
    """`hbm_bytes_tight` by shape, for ``g`` gates (K3: one x, one DAC
    pass) or ``g`` experts (``per_gate_x``: each its own x [B, KB*M], as
    the expert entry takes it): the DAC pass over every x row, then per
    gate the codes re-read per column block, the weights per row block,
    the split scratch and the output."""
    mp = -(-m // MP_ALIGN) * MP_ALIGN
    row_tiles = -(-b // rows_per_block)
    rows = b * (g if per_gate_x else 1)
    dac = rows * kb * m * 4 + rows * kb * mp
    codes = (np_ // BN) * b * kb * mp
    weights = row_tiles * (kb * m * np_ + kb * np_ * 4)
    out = b * np_ * 4
    scratch = 2 * kb * b * np_ * 4 if split else 0
    return dac + g * (codes + weights + scratch + out)


def hbm_bytes_loose(state: AimcLinearState, batch: int) -> int:
    """Bytes of the staged data flow of `loose_forward`: every stage reads
    its inputs from global memory once and writes its output once, and the
    next stage reads it back (x f32 -> x_q int8 -> bit-line sums f32
    [KB, B, Np] -> ADC codes int32 [KB, B, Np] -> y f32 [B, Np]; w_q and s_w
    read once). A lower bound of what the eager ops request: the
    temporaries inside a stage (the f64 copies of the MAC operands that an
    exact product needs on CUDA, the rounding and clamping passes) are left
    out, as is the DAC scale that both paths compute alike."""
    kb, m, np_ = state.w_q.shape
    k_pad = kb * m
    x = batch * k_pad * 4
    x_q = batch * k_pad
    w = k_pad * np_ + kb * np_ * 4
    acc = kb * batch * np_ * 4
    codes = kb * batch * np_ * 4
    out = batch * np_ * 4
    return x + 2 * x_q + w + 2 * acc + 2 * codes + out
