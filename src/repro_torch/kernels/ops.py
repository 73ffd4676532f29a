"""Dispatch of the AIMC MVM by device (port of `repro/kernels/ops.py`).

A tensor on the CPU takes the plain version (`kernels/ref.py`); a tensor on
a CUDA device launches the hand-written kernel (`kernels/aimc_mvm.py`) and
raises if it cannot. There is no knob that sends a CUDA tensor to the plain
version. The reference's TPU block picking (`_pick_blocks`) has no
counterpart: the CUDA launcher tiles by itself and masks the ragged batch
edge, so x is never padded here.

``noise_source="hw"`` (kernel K4, Philox on the card) has no CPU version,
just as the reference's oracle has no hardware PRNG: with read noise on, a
CPU tensor raises instead of quietly drawing counter noise.
"""

from __future__ import annotations

from repro_torch.kernels import aimc_mvm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import EPILOGUE_FNS  # noqa: F401  (re-export)

EPILOGUES = tuple(EPILOGUE_FNS)


def _check_noise_source(noise_source: str, sigma: float, x) -> None:
    if noise_source not in _ref.NOISE_SOURCES:
        raise ValueError(f"unknown noise_source {noise_source!r}")
    if sigma > 0.0 and noise_source == "hw" and not x.is_cuda:
        raise ValueError(
            'noise_source="hw" draws Philox noise inside the CUDA kernel; a '
            'CPU tensor has no such generator (use "counter")')


def aimc_matmul(x, w_q, s_w, s_x, read_noise=None, *, adc_step: float):
    """v1-contract AIMC matmul (kernel K1): an explicit `[KB, B, Np]` noise
    tensor in accumulator LSBs, no epilogue. ``read_noise=None`` is
    noise-off and runs kernel K2 with no operand."""
    if read_noise is None:
        return aimc_matmul_v2(x, w_q, s_w, s_x, adc_step=adc_step)
    if x.is_cuda:
        return aimc_mvm.aimc_mvm_v1(x, w_q, s_w, s_x, read_noise,
                                    adc_step=adc_step)
    return _ref.aimc_matmul_ref(x, w_q, s_w, s_x, read_noise,
                                adc_step=adc_step)


def aimc_matmul_v2(x, w_q, s_w, s_x, seed=None, bias=None, *,
                   adc_step: float, sigma: float = 0.0,
                   activation: str = "none", noise_source: str = "counter"):
    """Fused AIMC matmul (kernel K2; K4 with ``noise_source="hw"``):
    x f32 [B, KB*M] -> f32 [B, Np], read noise drawn from ``seed`` when
    ``sigma > 0``, epilogue applied."""
    if activation not in EPILOGUES:
        raise ValueError(f"unknown epilogue {activation!r}")
    _check_noise_source(noise_source, sigma, x)
    if x.is_cuda:
        return aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, seed, bias,
                                    adc_step=adc_step, sigma=sigma,
                                    activation=activation,
                                    noise_source=noise_source)
    return _ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, seed, bias,
                                   adc_step=adc_step, sigma=sigma,
                                   activation=activation)


def aimc_matmul_stacked(x, w_q, s_w, s_x, seed=None, bias=None, *,
                        adc_step: float, sigma: float = 0.0,
                        activations="none", noise_source: str = "counter"):
    """Gate-fused multi-MVM (kernel K3): `[G, KB, M, Np]` stack, shared x ->
    f32 [G, B, Np]; bit-equal to G `aimc_matmul_v2` calls with the seeds
    `cprng.stack_seed(seed, g)`, under either noise source."""
    _check_noise_source(noise_source, sigma, x)
    if x.is_cuda:
        return aimc_mvm.aimc_mvm_stacked(x, w_q, s_w, s_x, seed, bias,
                                         adc_step=adc_step, sigma=sigma,
                                         activations=activations,
                                         noise_source=noise_source)
    return _ref.aimc_matmul_stacked_ref(x, w_q, s_w, s_x, seed, bias,
                                        adc_step=adc_step, sigma=sigma,
                                        activations=activations)
