"""Dispatch of the AIMC MVM by device (port of `repro/kernels/ops.py`).

A tensor on the CPU takes the plain version (`kernels/ref.py`); a tensor on
a CUDA device launches the hand-written kernel (`kernels/aimc_mvm.py`) and
raises if it cannot. There is no knob that sends a CUDA tensor to the plain
version. The reference's TPU block picking (`_pick_blocks`) has no
counterpart: the CUDA launcher tiles by itself and masks the ragged batch
edge, so x is never padded here.
"""

from __future__ import annotations

from repro_torch.kernels import aimc_mvm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import EPILOGUE_FNS  # noqa: F401  (re-export)

EPILOGUES = tuple(EPILOGUE_FNS)


def aimc_matmul_v2(x, w_q, s_w, s_x, seed=None, bias=None, *,
                   adc_step: float, sigma: float = 0.0,
                   activation: str = "none"):
    """Fused AIMC matmul (kernel K2): x f32 [B, KB*M] -> f32 [B, Np], read
    noise drawn from ``seed`` when ``sigma > 0``, epilogue applied."""
    if activation not in EPILOGUES:
        raise ValueError(f"unknown epilogue {activation!r}")
    if x.is_cuda:
        return aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, seed, bias,
                                    adc_step=adc_step, sigma=sigma,
                                    activation=activation)
    return _ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, seed, bias,
                                   adc_step=adc_step, sigma=sigma,
                                   activation=activation)


def aimc_matmul_stacked(x, w_q, s_w, s_x, seed=None, bias=None, *,
                        adc_step: float, sigma: float = 0.0,
                        activations="none"):
    """Gate-fused multi-MVM (kernel K3): `[G, KB, M, Np]` stack, shared x ->
    f32 [G, B, Np]; bit-equal to G `aimc_matmul_v2` calls with the seeds
    `cprng.stack_seed(seed, g)`."""
    if x.is_cuda:
        return aimc_mvm.aimc_mvm_stacked(x, w_q, s_w, s_x, seed, bias,
                                         adc_step=adc_step, sigma=sigma,
                                         activations=activations)
    return _ref.aimc_matmul_stacked_ref(x, w_q, s_w, s_x, seed, bias,
                                        adc_step=adc_step, sigma=sigma,
                                        activations=activations)
