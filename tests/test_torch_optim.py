"""Parity of the port's optimizers (`repro_torch/optim`: AdamW, Adafactor,
`global_norm`, `clip_by_global_norm`, `warmup_cosine`) with the JAX
reference (`repro/optim`), on trees and gradients drawn from a seed with
numpy, and the port's versions of `tests/test_substrate.py`'s optimizer
tests.

The trees hold a vector, matrices and a [L, K, N] stack (Adafactor
factors every leaf of rank >= 2 over its last two dims); the gradients are
scaled so that the global norm exceeds ``grad_clip`` (clipping active) or
stays under it. Tolerance: 1e-6 x max(1, max|ref|) per leaf after 3
updates (f32 op order of the reductions and of XLA's ``pow``/``cos``);
steps are equal."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import make_optimizer as jmake
from repro.optim import adamw as jadamw
from repro.optim.schedule import warmup_cosine as j_wc
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import make_optimizer as tmake
from repro_torch.optim.schedule import warmup_cosine as t_wc

TOL = 1e-6


def _tree(rng, scale=1.0):
    return {"b": (rng.standard_normal((16,)) * scale).astype(np.float32),
            "w": (rng.standard_normal((12, 20)) * scale).astype(np.float32),
            "blocks": {"wq": (rng.standard_normal((3, 8, 24))
                              * scale).astype(np.float32),
                       "ln": (rng.standard_normal((3, 8))
                              * scale).astype(np.float32)}}


def _close(t, j):
    for name in ("b", "w"):
        _leaf(t[name], j[name], name)
    for name in ("wq", "ln"):
        _leaf(t["blocks"][name], j["blocks"][name], name)


def _leaf(t, j, name):
    j = np.asarray(j, np.float32)
    t = t.detach().to(torch.float32).numpy()
    tol = TOL * max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t, j, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("gscale", [0.01, 3.0], ids=["unclipped", "clipped"])
def test_update_matches_reference(name, gscale):
    rng = np.random.default_rng(0)
    p_np = _tree(rng, 0.5)
    jinit, jupd, _ = jmake(name, weight_decay=0.05)
    tinit, tupd, _ = tmake(name, weight_decay=0.05)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = params_from_numpy(p_np)
    js, ts = jinit(jp), tinit(tp)
    for step in range(3):
        g_np = _tree(rng, gscale)
        jp, js, jm = jupd(jax.tree.map(jnp.asarray, g_np), js, jp, 0.7)
        tp, ts, tm = tupd(params_from_numpy(g_np), ts, tp, 0.7)
        _close(tp, jp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for field in ts._fields[1:]:
        _close(getattr(ts, field), getattr(js, field))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_carries_from_reference(name):
    """A state built by the JAX package (numpy leaves) carried into the
    port (`convert.opt_state_from_numpy`) continues the same update."""
    rng = np.random.default_rng(1)
    p_np = _tree(rng)
    jinit, jupd, _ = jmake(name)
    _, tupd, _ = tmake(name)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jinit(jp)
    jp, js, _ = jupd(jax.tree.map(jnp.asarray, _tree(rng)), js, jp)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    g_np = _tree(rng)
    jp, js, _ = jupd(jax.tree.map(jnp.asarray, g_np), js, jp)
    tp, ts, _ = tupd(params_from_numpy(g_np), ts, tp)
    _close(tp, jp)
    assert int(ts.step) == 2


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(2)
    g_np = _tree(rng, 2.0)
    jn = jadamw.global_norm(jax.tree.map(jnp.asarray, g_np))
    tn = tadamw.global_norm(params_from_numpy(g_np))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    jc, _ = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np), 1.0)
    tc, _ = tadamw.clip_by_global_norm(params_from_numpy(g_np), 1.0)
    _close(tc, jc)
    assert float(tadamw.global_norm(tc)) == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("step", [0, 1, 100, 199, 200, 201, 5000, 9999,
                                  10000, 12000])
def test_warmup_cosine_matches_reference(step):
    for kw in ({}, {"warmup": 10, "total": 50, "min_ratio": 0.2}):
        want = float(j_wc(jnp.asarray(step), **kw))
        assert float(t_wc(step, **kw)) == pytest.approx(want, abs=1e-6)


# the port's versions of tests/test_substrate.py's optimizer tests

@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_reduces_quadratic(name):
    init, update, _ = tmake(name, lr=5e-2)
    w_true = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.ones(3), "m": 0.1 * torch.ones((2, 3))}
    state = init(params)

    def loss(p):
        return ((p["w"] - w_true) ** 2).sum() + (p["m"] ** 2).sum()

    l0 = float(loss(params))
    for _ in range(100):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        g = torch.autograd.grad(loss(live), list(live.values()))
        params, state, metrics = update(dict(zip(live, g)), state, params)
    assert float(loss(params)) < 0.2 * l0
    assert "grad_norm" in metrics


def test_adamw_moment_dtype():
    init, _, _ = tmake("adamw", moment_dtype="bfloat16")
    state = init({"w": torch.zeros((4, 4))})
    assert state.mu["w"].dtype == torch.bfloat16


def test_adafactor_factored_shapes():
    init, _, _ = tmake("adafactor")
    state = init({"w": torch.zeros((8, 16)), "b": torch.zeros(16),
                  "s": torch.zeros((3, 8, 16))})
    assert tuple(state.vr["w"].shape) == (8,)
    assert tuple(state.vc["w"].shape) == (16,)
    assert tuple(state.vr["s"].shape) == (3, 8)
    assert tuple(state.vc["s"].shape) == (3, 16)
    assert tuple(state.vr["b"].shape) == (16,)
    assert tuple(state.vc["b"].shape) == (1,)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tmake("sgd")
