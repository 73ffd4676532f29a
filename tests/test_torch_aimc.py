"""Parity of the port's tile model (`repro_torch/core/aimc.py`) with the JAX
reference (`repro/core/aimc.py`, impl="ref") on the same numpy inputs.

Tolerances: programming is exact (bit-equal int8 codes, equal scales);
applied outputs agree to atol=1e-5 (f32 summation order, the reference's
kernel-vs-oracle bar); fused and unfused epilogues, and a gate stack vs
per-gate calls, are bit-equal inside the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aimc as ja
from repro_torch.core import aimc as ta

ATOL = 1e-5


def _w(seed, shape, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("k,n,rows", [(64, 64, 512), (300, 130, 128),
                                      (256, 200, 64)])
def test_program_linear_bit_equal(k, n, rows):
    w = _w(0, (k, n))
    st_j = ja.program_linear(jnp.asarray(w), ja.AimcConfig(tile_rows=rows))
    st_t = ta.program_linear(torch.from_numpy(w), ta.AimcConfig(tile_rows=rows))
    assert (st_t.k, st_t.n) == (st_j.k, st_j.n)
    np.testing.assert_array_equal(st_t.w_q.numpy(), np.asarray(st_j.w_q))
    np.testing.assert_array_equal(st_t.s_w.numpy(), np.asarray(st_j.s_w))


def test_program_stacked_bit_equal():
    w = _w(1, (3, 96, 160))
    st_j = ja.program_stacked(jnp.asarray(w), ja.AimcConfig(tile_rows=64))
    st_t = ta.program_stacked(torch.from_numpy(w), ta.AimcConfig(tile_rows=64))
    assert st_t.stack_shape == (3,) and st_t.instances == 3
    np.testing.assert_array_equal(st_t.w_q.numpy(), np.asarray(st_j.w_q))
    np.testing.assert_array_equal(st_t.s_w.numpy(), np.asarray(st_j.s_w))
    assert torch.equal(st_t[1].w_q, st_t.w_q[1])
    aged_t, aged_j = st_t.with_gain(0.9), st_j.with_gain(0.9)
    assert aged_t.w_q is st_t.w_q
    np.testing.assert_array_equal(aged_t.s_w.numpy(), np.asarray(aged_j.s_w))


@pytest.mark.parametrize("act", ["none", "relu", "sigmoid", "tanh"])
@pytest.mark.parametrize("fuse", [True, False])
def test_aimc_apply_matches_reference(act, fuse):
    w, x, bias = _w(2, (200, 150)), _w(3, (2, 3, 200), 1.0), _w(4, (150,), 1.0)
    cfg_j = ja.AimcConfig(tile_rows=64, impl="ref", fuse_epilogue=fuse)
    cfg_t = ta.AimcConfig(tile_rows=64, fuse_epilogue=fuse)
    y_j = ja.aimc_apply(ja.program_linear(jnp.asarray(w), cfg_j),
                        jnp.asarray(x), cfg_j, bias=jnp.asarray(bias),
                        activation=act)
    y_t = ta.aimc_apply(ta.program_linear(torch.from_numpy(w), cfg_t),
                        torch.from_numpy(x), cfg_t,
                        bias=torch.from_numpy(bias), activation=act)
    assert tuple(y_t.shape) == (2, 3, 150)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=ATOL)


def test_fused_epilogue_equals_unfused_in_port():
    w, x, bias = _w(5, (96, 64)), _w(6, (5, 96), 1.0), _w(7, (64,), 1.0)
    outs = []
    for fuse in (True, False):
        cfg = ta.AimcConfig(tile_rows=64, fuse_epilogue=fuse)
        st = ta.program_linear(torch.from_numpy(w), cfg)
        outs.append(ta.aimc_apply(st, torch.from_numpy(x), cfg,
                                  bias=torch.from_numpy(bias),
                                  activation="tanh"))
    assert torch.equal(outs[0], outs[1])


def test_static_input_scale_matches_reference():
    w, x = _w(8, (128, 128)), _w(9, (4, 128), 1.0)
    cfg_j = ja.AimcConfig(tile_rows=128, impl="ref", input_scale=0.02)
    cfg_t = ta.AimcConfig(tile_rows=128, input_scale=0.02)
    y_j = ja.aimc_apply(ja.program_linear(jnp.asarray(w), cfg_j),
                        jnp.asarray(x), cfg_j)
    y_t = ta.aimc_apply(ta.program_linear(torch.from_numpy(w), cfg_t),
                        torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("fuse", [True, False])
def test_stacked_apply_bit_equal_per_gate_and_matches_reference(fuse):
    ws = [_w(10 + g, (96, 160)) for g in range(2)]
    x, biases = _w(12, (3, 96), 1.0), _w(13, (2, 160), 1.0)
    acts = ("relu", "sigmoid")
    cfg_t = ta.AimcConfig(tile_rows=64, fuse_epilogue=fuse)
    sts = [ta.program_linear(torch.from_numpy(w), cfg_t) for w in ws]
    stack = ta.stack_states(sts)
    xt, bt = torch.from_numpy(x), torch.from_numpy(biases)
    y = ta.aimc_apply_stacked(stack, xt, cfg_t, biases=bt, activations=acts)
    for g in range(2):
        assert torch.equal(y[g], ta.aimc_apply(sts[g], xt, cfg_t, bias=bt[g],
                                               activation=acts[g]))
    cfg_j = ja.AimcConfig(tile_rows=64, impl="ref", fuse_epilogue=fuse)
    stack_j = ja.stack_states([ja.program_linear(jnp.asarray(w), cfg_j)
                               for w in ws])
    y_j = ja.aimc_apply_stacked(stack_j, jnp.asarray(x), cfg_j,
                                biases=jnp.asarray(biases), activations=acts)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0, atol=ATOL)


def test_stack_states_layer_dim_and_shape_checks():
    cfg = ta.AimcConfig(tile_rows=64)
    a = ta.program_stacked(torch.from_numpy(_w(14, (2, 64, 128))), cfg)
    b = ta.program_stacked(torch.from_numpy(_w(15, (2, 64, 128))), cfg)
    st = ta.stack_states([a, b], dim=1)
    assert st.stack_shape == (2, 2)
    assert torch.equal(st[0].w_q[1], b.w_q[0])
    c = ta.program_stacked(torch.from_numpy(_w(16, (2, 64, 256))), cfg)
    with pytest.raises(ValueError):
        ta.stack_states([a, c], dim=1)


def test_noise_seed_is_deterministic_per_generator():
    from repro_torch.core.noise import NoiseModel
    from repro_torch.core.prng import PRNGKey
    cfg = ta.AimcConfig(tile_rows=64, noise=NoiseModel(sigma_read=0.005))
    st = ta.program_linear(torch.from_numpy(_w(17, (64, 128))), cfg)
    x = torch.from_numpy(_w(18, (4, 64), 1.0))

    def run(seed):
        return ta.aimc_apply(st, x, cfg, PRNGKey(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


@pytest.mark.parametrize("shape,rows", [((300, 130), 128), ((3, 96, 160), 64)])
def test_noise_on_programming_matches_reference(shape, rows):
    """Programming noise drawn from the same key (`split` per stack
    instance): int8 codes equal the reference's except where an ulp-level
    difference of the Gaussian moves a code across a rounding tie — at most
    1e-5 of the codes, each off by one. Scales are exact."""
    from repro.core.noise import NoiseModel as JNoise
    from repro_torch.core.noise import NoiseModel
    from repro_torch.core.prng import PRNGKey
    import jax
    w = _w(20, shape)
    cfg_j = ja.AimcConfig(tile_rows=rows, noise=JNoise())
    cfg_t = ta.AimcConfig(tile_rows=rows, noise=NoiseModel())
    st_j = ja.program_stacked(jnp.asarray(w), cfg_j, jax.random.PRNGKey(3))
    st_t = ta.program_stacked(torch.from_numpy(w), cfg_t, PRNGKey(3))
    diff = np.abs(st_t.w_q.numpy().astype(np.int32)
                  - np.asarray(st_j.w_q).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-5
    np.testing.assert_array_equal(st_t.s_w.numpy(), np.asarray(st_j.s_w))
    quiet = ta.program_stacked(torch.from_numpy(w), cfg_t)
    assert not torch.equal(quiet.w_q, st_t.w_q)


@pytest.mark.parametrize("stacked", [False, True])
def test_noise_on_apply_counter_matches_reference(stacked):
    """Read noise on (counter generator), the reference's programmed state
    carried across: the read seed is the same threefry draw, so outputs
    agree within 1e-5 * max(1, max|y|) (the f32 association of the row-block
    sum)."""
    import jax
    from repro.core.noise import NoiseModel as JNoise
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.noise import NoiseModel
    from repro_torch.core.prng import PRNGKey
    cfg_j = ja.AimcConfig(tile_rows=64, impl="ref",
                          noise=JNoise(sigma_read=0.003))
    cfg_t = ta.AimcConfig(tile_rows=64, noise=NoiseModel(sigma_read=0.003))
    x = _w(21, (5, 150), 1.0)
    if stacked:
        st_j = ja.stack_states([ja.program_linear(jnp.asarray(_w(22 + g,
                                (150, 96))), cfg_j, jax.random.PRNGKey(g))
                                for g in range(3)])
        y_j = ja.aimc_apply_stacked(st_j, jnp.asarray(x), cfg_j,
                                    jax.random.PRNGKey(9),
                                    activations="tanh")
        st_t = params_from_numpy(jax.tree.map(np.asarray, st_j))
        y_t = ta.aimc_apply_stacked(st_t, torch.from_numpy(x), cfg_t,
                                    PRNGKey(9), activations="tanh")
    else:
        st_j = ja.program_linear(jnp.asarray(_w(22, (150, 96))), cfg_j,
                                 jax.random.PRNGKey(1))
        y_j = ja.aimc_apply(st_j, jnp.asarray(x), cfg_j,
                            jax.random.PRNGKey(9), activation="relu")
        st_t = params_from_numpy(jax.tree.map(np.asarray, st_j))
        y_t = ta.aimc_apply(st_t, torch.from_numpy(x), cfg_t, PRNGKey(9),
                            activation="relu")
    tol = 1e-5 * max(1.0, float(np.abs(np.asarray(y_j)).max()))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=tol)
    if stacked:
        quiet = ta.aimc_apply_stacked(st_t, torch.from_numpy(x), cfg_t,
                                      activations="tanh")
    else:
        quiet = ta.aimc_apply(st_t, torch.from_numpy(x), cfg_t,
                              activation="relu")
    assert not torch.equal(quiet, y_t)
