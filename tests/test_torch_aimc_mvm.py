"""Parity of the port's plain AIMC MVM versions (`repro_torch/kernels/ref.py`
through `kernels/ops.py` on CPU tensors — what the CUDA kernels K2/K3 are
held to on the card) with the JAX Pallas kernels `aimc_matmul_pallas_v2`
and `aimc_matmul_pallas_stacked` run in interpret mode.

Tolerance: atol=1e-5, the reference's own kernel-vs-oracle bar
(tests/test_kernel_v2.py:60): the Pallas kernel adds each row block's
dequantized contribution in turn, the plain version scales once at the end.
The card-side checks of the kernels themselves are
`test_torch_kernels_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import sym_scale as j_sym_scale
from repro.kernels import ops as jops
from repro_torch.core.quant import adc_step_lsb
from repro_torch.kernels import ops as tops

ATOL = 1e-5


def _operands(b, kb, m, np_, g=None, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if g is None else (g,)
    x = rng.standard_normal((b, kb * m)).astype(np.float32)
    w_q = rng.integers(-127, 128, lead + (kb, m, np_), dtype=np.int8)
    s_w = ((rng.random(lead + (kb, np_)) + 0.5) * 1e-3).astype(np.float32)
    bias = rng.standard_normal(lead + (np_,)).astype(np.float32)
    s_x = np.asarray(j_sym_scale(jnp.asarray(x))).reshape(1, 1)
    return x, w_q, s_w, s_x, bias


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("b,kb,m,np_,sigma", [
    (8, 1, 128, 128, 0.0),
    (5, 2, 128, 256, 0.0),       # ragged batch, two row blocks
    (5, 2, 128, 256, 57.5),      # ... with in-kernel read noise
    (16, 3, 64, 384, 20.0),      # three row blocks, ragged Np tiling
    (1, 1, 256, 128, 40.0),
])
def test_v2_matches_pallas_interpret(b, kb, m, np_, sigma):
    x, w_q, s_w, s_x, _ = _operands(b, kb, m, np_)
    step = adc_step_lsb(m, 1.0)
    y_j = jops.aimc_matmul_v2(jnp.asarray(x), jnp.asarray(w_q),
                              jnp.asarray(s_w), jnp.asarray(s_x),
                              jnp.uint32(0xC0FFEE), adc_step=step,
                              sigma=sigma, impl="pallas_interpret",
                              block_b=8, block_n=128)
    xt, wt, swt, sxt = _t(x, w_q, s_w, s_x)
    y_t = tops.aimc_matmul_v2(xt, wt, swt, sxt, 0xC0FFEE, adc_step=step,
                              sigma=sigma)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("act", ["none", "relu", "sigmoid", "tanh"])
def test_v2_epilogues_with_bias(act):
    x, w_q, s_w, s_x, bias = _operands(6, 2, 64, 128, seed=1)
    step = adc_step_lsb(64, 1.0)
    y_j = jops.aimc_matmul_v2(jnp.asarray(x), jnp.asarray(w_q),
                              jnp.asarray(s_w), jnp.asarray(s_x),
                              jnp.uint32(3), jnp.asarray(bias), adc_step=step,
                              sigma=10.0, activation=act,
                              impl="pallas_interpret", block_b=8)
    xt, wt, swt, sxt, bt = _t(x, w_q, s_w, s_x, bias)
    y_t = tops.aimc_matmul_v2(xt, wt, swt, sxt, 3, bt, adc_step=step,
                              sigma=10.0, activation=act)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("sigma", [0.0, 30.0])
def test_stacked_per_gate_activations_match_pallas(sigma):
    x, w_q, s_w, s_x, bias = _operands(7, 2, 64, 256, g=3, seed=2)
    step = adc_step_lsb(64, 1.0)
    acts = ("sigmoid", "tanh", "relu")
    y_j = jops.aimc_matmul_stacked(jnp.asarray(x), jnp.asarray(w_q),
                                   jnp.asarray(s_w), jnp.asarray(s_x),
                                   jnp.uint32(99), jnp.asarray(bias),
                                   adc_step=step, sigma=sigma,
                                   activations=acts, impl="pallas_interpret",
                                   block_b=8, block_n=128)
    xt, wt, swt, sxt, bt = _t(x, w_q, s_w, s_x, bias)
    y_t = tops.aimc_matmul_stacked(xt, wt, swt, sxt, 99, bt, adc_step=step,
                                   sigma=sigma, activations=acts)
    assert tuple(y_t.shape) == (3, 7, 256)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("b,kb,m,np_", [
    (8, 1, 128, 128), (5, 2, 128, 256), (16, 3, 64, 384), (1, 1, 256, 128)])
def test_v1_noise_operand_matches_pallas_interpret(b, kb, m, np_):
    """Kernel K1's plain version through `ops.aimc_matmul` with a noise
    tensor, against the reference's v1 Pallas kernel in interpret mode."""
    x, w_q, s_w, s_x, _ = _operands(b, kb, m, np_, seed=5)
    noise = (np.random.default_rng(6).standard_normal((kb, b, np_))
             * 40.0).astype(np.float32)
    step = adc_step_lsb(m, 1.0)
    y_j = jops.aimc_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(s_w),
                           jnp.asarray(s_x), jnp.asarray(noise),
                           adc_step=step, impl="pallas_interpret",
                           block_b=8, block_n=128)
    xt, wt, swt, sxt, nt = _t(x, w_q, s_w, s_x, noise)
    y_t = tops.aimc_matmul(xt, wt, swt, sxt, nt, adc_step=step)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=ATOL)


def test_v1_without_noise_routes_to_v2():
    x, w_q, s_w, s_x, _ = _operands(6, 2, 64, 128, seed=7)
    step = adc_step_lsb(64, 1.0)
    xt, wt, swt, sxt = _t(x, w_q, s_w, s_x)
    y = tops.aimc_matmul(xt, wt, swt, sxt, None, adc_step=step)
    assert torch.equal(y, tops.aimc_matmul_v2(xt, wt, swt, sxt,
                                              adc_step=step))
    y_j = jops.aimc_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(s_w),
                           jnp.asarray(s_x), None, adc_step=step)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("stacked", [False, True])
def test_hw_noise_raises_on_cpu_in_both_packages(stacked):
    """Neither the reference's oracle nor a CPU tensor has the "hw"
    generator: with read noise on, both packages refuse instead of drawing
    counter noise; with it off, "hw" is the noise-free kernel."""
    x, w_q, s_w, s_x, _ = _operands(4, 1, 64, 128, g=2 if stacked else None)
    kw = dict(adc_step=8.0, sigma=10.0, noise_source="hw")
    j_fn = jops.aimc_matmul_stacked if stacked else jops.aimc_matmul_v2
    t_fn = tops.aimc_matmul_stacked if stacked else tops.aimc_matmul_v2
    with pytest.raises(ValueError, match="hw"):
        j_fn(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(s_w),
             jnp.asarray(s_x), jnp.uint32(1), **kw)
    xt, wt, swt, sxt = _t(x, w_q, s_w, s_x)
    with pytest.raises(ValueError, match="hw"):
        t_fn(xt, wt, swt, sxt, 1, **kw)
    kw["sigma"] = 0.0
    assert torch.equal(t_fn(xt, wt, swt, sxt, 1, **kw),
                       t_fn(xt, wt, swt, sxt, adc_step=8.0))
