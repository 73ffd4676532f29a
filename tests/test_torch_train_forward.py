"""Parity of the port's training forward (`models.transformer.forward`,
`block_forward`, the per-block `torch.utils.checkpoint`) and of the train
step's loss (`launch.steps.chunked_ce` + 0.01 x aux) and its gradients
with the JAX reference, at the llama3.2-3b, olmoe-1b-7b and granite-8b
smoke configs, digital and AIMC on the fly with noise on
(``NoiseModel(sigma_read=0.002)``, programming noise at its defaults), and
internvl2-1b's patch positions digitally. Weights are the reference's
(`jt.init` on seed 0, carried over with `convert.params_from_numpy`); the
tokens and labels are drawn with numpy. JAX runs as its own tests run it:
``impl="ref"``, functions driven directly, no mesh; one `value_and_grad`
per case (module-scoped).

Tolerances: hidden states within 1e-5 x max(1, max|ref|); the loss within
1e-5 relative; every gradient leaf within GTOL x max|ref leaf| (GTOL =
1e-5; the f32 op order of the norms, the softmax and the matmuls moves
grads by < 1e-6 of a leaf's largest entry at these configs)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core.noise import NoiseModel as JNM
from repro.launch.steps import chunked_ce as jce
from repro.models import transformer as jt
from repro.models.layers import Execution as JExe
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import prng
from repro_torch.core.noise import NoiseModel as TNM
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tt
from repro_torch.models.layers import Execution as TExe
from repro_torch.optim.adamw import tree_leaves

ATOL = 1e-5
GTOL = 1e-5
CASES = [("llama32_3b", "digital"), ("llama32_3b", "aimc"),
         ("olmoe_1b_7b", "digital"), ("olmoe_1b_7b", "aimc"),
         ("granite_8b", "digital"), ("granite_8b", "aimc"),
         ("internvl2_1b", "digital")]


def _exes(mode):
    if mode == "digital":
        return JExe(compute_dtype="float32"), TExe(compute_dtype="float32")
    return (JExe(mode="aimc", aimc=ja.AimcConfig(
                impl="ref", noise=JNM(sigma_read=0.002)),
                 compute_dtype="float32"),
            TExe(mode="aimc", aimc=ta.AimcConfig(
                noise=TNM(sigma_read=0.002)), compute_dtype="float32"))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{m}" for a, m in CASES])
def case(request):
    arch, mode = request.param
    cfg = get_arch(arch).smoke_cfg
    jexe, texe = _exes(mode)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    patches = None
    if cfg.n_patches:
        labels[:, :cfg.n_patches] = -1
        patches = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    jparams = jt.init(jax.random.PRNGKey(0), cfg)
    key = jax.random.PRNGKey(7)

    def loss(p):
        h, aux = jt.forward(p, jnp.asarray(toks), cfg, jexe, key,
                            patch_embeds=None if patches is None
                            else jnp.asarray(patches), return_hidden=True)
        ls, n = jce(h, jt.unembed_matrix(p, cfg), jnp.asarray(labels))
        plain = ls / jnp.maximum(n, 1.0)
        return plain + 0.01 * aux, (plain, h, aux)

    (total, (plain, h, aux)), grads = jax.value_and_grad(
        loss, has_aux=True)(jparams)
    ref = {"total": float(total), "loss": float(plain), "h": np.asarray(h),
           "aux": float(aux), "grads": jax.tree.map(np.asarray, grads)}
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    port = _port(cfg, texe, toks, labels, patches, params,
                 torch.tensor(np.asarray(key, np.int64)))
    return params, ref, port


def _port(cfg, texe, toks, labels, patches, params, key):
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    p = tsteps._tree_with(params, live)
    h, aux = tt.forward(p, torch.from_numpy(toks), cfg, texe, key,
                        patch_embeds=None if patches is None
                        else torch.from_numpy(patches), return_hidden=True)
    ls, n = tsteps.chunked_ce(h, tt.unembed_matrix(p, cfg),
                              torch.from_numpy(labels))
    plain = ls / torch.clamp_min(n, 1.0)
    total = plain + 0.01 * aux
    grads = torch.autograd.grad(total, live, allow_unused=True)
    return (float(total.detach()), float(plain.detach()), h.detach(),
            float(torch.as_tensor(aux).detach()),
            tsteps._tree_with(params, grads))


def test_forward_hidden_and_loss_match_reference(case):
    _, ref, (total, plain, h, aux, _) = case
    np.testing.assert_allclose(h.numpy(), ref["h"], rtol=0,
                               atol=ATOL * max(1.0, np.abs(ref["h"]).max()))
    assert float(plain) == pytest.approx(ref["loss"], rel=1e-5)
    assert float(total) == pytest.approx(ref["total"], rel=1e-5)
    assert float(aux) == pytest.approx(ref["aux"], rel=1e-5, abs=1e-7)


def _walk(t, j, path=""):
    if isinstance(j, dict):
        for k in j:
            yield from _walk(t[k], j[k], f"{path}/{k}")
    else:
        yield path, t, j


def test_grads_match_reference(case):
    params, ref, (*_, grads) = case
    n = 0
    for path, t, j in _walk(grads, ref["grads"]):
        t = np.zeros_like(j) if t is None else t.numpy()
        np.testing.assert_allclose(
            t, j, rtol=0, atol=GTOL * max(float(np.abs(j).max()), 1e-30),
            err_msg=path)
        n += 1
    assert n == len(tree_leaves(params))


def test_forward_logits_and_unembed_match_reference():
    """``return_hidden=False`` gives the f32 logits through
    `unembed_matrix` (llama3.2-3b's tied ``embed.T``), no key: the
    reference's forward without an rng."""
    cfg = get_arch("llama32_3b").smoke_cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24)).astype(
        np.int32)
    jparams = jt.init(jax.random.PRNGKey(2), cfg)
    jexe, texe = _exes("digital")
    lj, auxj = jt.forward(jparams, jnp.asarray(toks), cfg, jexe)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    with torch.no_grad():
        lt, auxt = tt.forward(params, torch.from_numpy(toks), cfg, texe)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL * max(1.0, np.abs(lj).max()))
    assert float(auxt) == float(auxj) == 0.0
    np.testing.assert_array_equal(tt.unembed_matrix(params, cfg).numpy(),
                                  np.asarray(jt.unembed_matrix(jparams, cfg)))


def test_backward_recomputes_each_block_with_its_keys(monkeypatch):
    """Under autograd every block runs twice (forward, checkpoint
    recompute) with the same key, so an on-the-fly projection programs
    twice and draws the same noise; without grad it runs once."""
    cfg = get_arch("olmoe_1b_7b").smoke_cfg
    params = tt.init(prng.PRNGKey(0), cfg, device="cpu")
    _, texe = _exes("aimc")
    seen = []
    orig = tt.block_forward

    def rec(h, blk, cfg_, exe, key, positions):
        seen.append(tuple(key.tolist()))
        return orig(h, blk, cfg_, exe, key, positions)

    monkeypatch.setattr(tt, "block_forward", rec)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tt.forward(params, toks, cfg, texe, prng.PRNGKey(3))
    assert len(seen) == cfg.n_layers
    seen.clear()
    w = params["blocks"]["wq"].requires_grad_(True)
    logits, aux = tt.forward(params, toks, cfg, texe, prng.PRNGKey(3))
    (logits.sum() + aux).backward()
    assert len(seen) == 2 * cfg.n_layers
    assert seen[:cfg.n_layers] == seen[cfg.n_layers:][::-1]
    assert w.grad is not None and torch.isfinite(w.grad).all()
