"""Dispatch of the AIMC MVM by device (port of `repro/kernels/ops.py`).

A tensor on the CPU takes the plain version (`kernels/ref.py`); a tensor on
a CUDA device launches the hand-written kernel (`kernels/aimc_mvm.py`) and
raises if it cannot. There is no knob that sends a CUDA tensor to the plain
version. The reference's TPU block picking (`_pick_blocks`) has no
counterpart: the CUDA launcher tiles by itself and masks the ragged batch
edge, so x is never padded here.

Under a step counter (`launch.stepstats`) a ``meta`` tensor takes neither:
each wrapper returns its output's shape and counts one launch of its
kernel, its int8 operations and its bytes.

``noise_source="hw"`` (kernel K4, Philox on the card) has no CPU version,
just as the reference's oracle has no hardware PRNG: with read noise on, a
CPU tensor raises instead of quietly drawing counter noise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import aimc_mvm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import EPILOGUE_FNS  # noqa: F401  (re-export)
from repro_torch.launch import stepstats

EPILOGUES = tuple(EPILOGUE_FNS)


def _counted(c, name: str, x, w_q, *, experts: bool = False):
    """A wrapper's call on a ``meta`` x under a step counter
    (`launch.stepstats`): the output's shape and what `aimc_mvm._launch`
    allocates (the output, and the workspace of the launcher's plan on
    the counter's card), counted as one crossbar launch of ``name``:
    2*G*B*KB*M*Np int8 operations and `core.coupling.tight_bytes` for that
    plan. w_q is [G, KB, M, Np] (E in place of G for the expert entry)."""
    from repro_torch.core.coupling import tight_bytes
    g, kb, m, np_ = w_q.shape
    b = x.shape[-2]
    code, work, _ = aimc_mvm.plan_for(b, kb, m, np_, g, c.sms, experts)
    out = torch.empty((g, b, np_), dtype=torch.float32, device=x.device)
    ws = torch.empty(work, dtype=torch.uint8, device=x.device)
    del ws
    c.crossbar(name, 2 * g * b * kb * m * np_,
               tight_bytes(b, kb, m, np_, rows_per_block=code & 255,
                           split=bool(code & 256), g=g,
                           per_gate_x=experts))
    return out


def _hw(name: str, noise_source: str, sigma: float) -> str:
    return name + ("_hw" if noise_source == "hw" and sigma > 0.0 else "")


def _check_noise_source(noise_source: str, sigma: float, x) -> None:
    if noise_source not in _ref.NOISE_SOURCES:
        raise ValueError(f"unknown noise_source {noise_source!r}")
    if sigma > 0.0 and noise_source == "hw" and not x.is_cuda:
        raise ValueError(
            'noise_source="hw" draws Philox noise inside the CUDA kernel; a '
            'CPU tensor has no such generator (use "counter")')


def _cols(col0: int, nc) -> dict:
    """The column-piece arguments of a launch, passed on only for a piece
    (a whole launch keeps the wrappers' call of before)."""
    return {} if col0 == 0 and nc is None else {"col0": col0, "nc": nc}


def aimc_matmul(x, w_q, s_w, s_x, read_noise=None, *, adc_step: float):
    """v1-contract AIMC matmul (kernel K1): an explicit `[KB, B, Np]` noise
    tensor in accumulator LSBs, no epilogue. ``read_noise=None`` is
    noise-off and runs kernel K2 with no operand."""
    if read_noise is None:
        return aimc_matmul_v2(x, w_q, s_w, s_x, adc_step=adc_step)
    c = stepstats.counting(x)
    if c is not None:
        return _counted(c, "aimc_mvm_v1", x, w_q.unsqueeze(0))[0]
    if x.is_cuda:
        return aimc_mvm.aimc_mvm_v1(x, w_q, s_w, s_x, read_noise,
                                    adc_step=adc_step)
    return _ref.aimc_matmul_ref(x, w_q, s_w, s_x, read_noise,
                                adc_step=adc_step)


def aimc_matmul_v2(x, w_q, s_w, s_x, seed=None, bias=None, *,
                   adc_step: float, sigma: float = 0.0,
                   activation: str = "none", noise_source: str = "counter",
                   col0: int = 0, nc=None):
    """Fused AIMC matmul (kernel K2; K4 with ``noise_source="hw"``):
    x f32 [B, KB*M] -> f32 [B, Np], read noise drawn from ``seed`` when
    ``sigma > 0``, epilogue applied. ``w_q``/``s_w`` may be columns
    ``[col0, col0 + Np)`` of a state ``nc`` columns wide (a view), which
    draw the whole's noise for those columns."""
    if activation not in EPILOGUES:
        raise ValueError(f"unknown epilogue {activation!r}")
    _check_noise_source(noise_source, sigma, x)
    c = stepstats.counting(x)
    if c is not None:
        return _counted(c, _hw("aimc_mvm_v2", noise_source, sigma), x,
                        w_q.unsqueeze(0))[0]
    if x.is_cuda:
        return aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, seed, bias,
                                    adc_step=adc_step, sigma=sigma,
                                    activation=activation,
                                    noise_source=noise_source,
                                    **_cols(col0, nc))
    return _ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, seed, bias,
                                   adc_step=adc_step, sigma=sigma,
                                   activation=activation, **_cols(col0, nc))


def aimc_matmul_stacked(x, w_q, s_w, s_x, seed=None, bias=None, *,
                        adc_step: float, sigma: float = 0.0,
                        activations="none", noise_source: str = "counter",
                        col0: int = 0, nc=None):
    """Gate-fused multi-MVM (kernel K3): `[G, KB, M, Np]` stack, shared x ->
    f32 [G, B, Np]; bit-equal to G `aimc_matmul_v2` calls with the seeds
    `cprng.stack_seed(seed, g)`, under either noise source."""
    _check_noise_source(noise_source, sigma, x)
    c = stepstats.counting(x)
    if c is not None:
        return _counted(c, _hw("aimc_mvm_stacked", noise_source, sigma), x,
                        w_q)
    if x.is_cuda:
        return aimc_mvm.aimc_mvm_stacked(x, w_q, s_w, s_x, seed, bias,
                                         adc_step=adc_step, sigma=sigma,
                                         activations=activations,
                                         noise_source=noise_source,
                                         **_cols(col0, nc))
    return _ref.aimc_matmul_stacked_ref(x, w_q, s_w, s_x, seed, bias,
                                        adc_step=adc_step, sigma=sigma,
                                        activations=activations,
                                        **_cols(col0, nc))


def aimc_matmul_experts(x, w_q, s_w, s_x, seeds=None, *, adc_step: float,
                        sigma: float = 0.0, col0: int = 0, nc=None):
    """K2 over an `[E, ...]` expert stack, expert e on its own input x[e],
    DAC scale s_x[e] and read seed seeds[e] (E host ints, needed when
    ``sigma > 0``): x f32 [E, B, KB*M] -> f32 [E, B, Np], one launch on the
    card (`aimc_mvm.aimc_mvm_experts`)."""
    c = stepstats.counting(x)
    if c is not None:
        return _counted(c, "aimc_mvm_experts", x, w_q, experts=True)
    if x.is_cuda:
        return aimc_mvm.aimc_mvm_experts(x, w_q, s_w, s_x, seeds,
                                         adc_step=adc_step, sigma=sigma,
                                         **_cols(col0, nc))
    return _ref.aimc_matmul_experts_ref(x, w_q, s_w, s_x, seeds,
                                        adc_step=adc_step, sigma=sigma,
                                        **_cols(col0, nc))
