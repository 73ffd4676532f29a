"""Parity of the port's DAC/ADC math (`repro_torch/core/quant.py`) with the
JAX reference (`repro/core/quant.py`). Tolerance: exact — scales, codes
and ADC steps are bit-equal, half-to-even ties included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq


def _x(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("seed,shape", [(0, (64,)), (1, (8, 33)),
                                        (2, (4, 5, 7))])
def test_sym_scale_and_quantize_bit_equal(seed, shape):
    x = _x(seed, shape)
    s_j = jq.sym_scale(jnp.asarray(x))
    s_t = tq.sym_scale(torch.from_numpy(x))
    assert np.asarray(s_j).tobytes() == s_t.numpy().tobytes()
    q_j = np.asarray(jq.quantize(jnp.asarray(x), s_j))
    q_t = tq.quantize(torch.from_numpy(x), s_t).numpy()
    assert q_t.dtype == np.int8
    np.testing.assert_array_equal(q_t, q_j)


@pytest.mark.parametrize("axis", [0, 1])
def test_sym_scale_axis_bit_equal(axis):
    x = _x(3, (6, 10))
    s_j = np.asarray(jq.sym_scale(jnp.asarray(x), axis=axis))
    s_t = tq.sym_scale(torch.from_numpy(x), dim=axis).numpy()
    np.testing.assert_array_equal(s_t, s_j)


def test_half_to_even_ties():
    """Values exactly on .5 codes round to even in both (not away from 0)."""
    scale = np.float32(0.25)
    x = (np.arange(-20, 21, dtype=np.float32) + 0.5) * scale
    q_j = np.asarray(jq.quantize(jnp.asarray(x), jnp.float32(scale)))
    q_t = tq.quantize(torch.from_numpy(x), torch.tensor(scale)).numpy()
    np.testing.assert_array_equal(q_t, q_j)
    assert q_t[20] == 0 and q_t[21] == 2          # 0.5 -> 0, 1.5 -> 2


@pytest.mark.parametrize("rows,alpha", [(512, 1.0), (64, 0.5), (1, 0.01),
                                        (300, 2.0)])
def test_adc_step_lsb_equal(rows, alpha):
    assert tq.adc_step_lsb(rows, alpha) == jq.adc_step_lsb(rows, alpha)


@pytest.mark.parametrize("step", [2873.6, 127.0, 1.0])
def test_adc_quantize_bit_equal(step):
    acc = np.random.default_rng(4).integers(
        -200_000, 200_000, (16, 40)).astype(np.int32)
    acc[0, :5] = np.array([0.5, 1.5, -0.5, 2.5, -2.5]) * step   # near ties
    c_j = np.asarray(jq.adc_quantize(jnp.asarray(acc), jnp.float32(step)))
    c_t = tq.adc_quantize(torch.from_numpy(acc), step).numpy()
    assert c_t.dtype == np.int32
    np.testing.assert_array_equal(c_t, c_j)
