"""Parity of the port's dense transformer (`repro_torch/models/
transformer.py` + `models/layers.py`) with the JAX reference on the
granite-8b smoke config (2 layers, d_model 64), weights carried across
with `params_from_numpy`.

Tolerance: logits and KV caches agree to atol=1e-5 (f32 op order in
attention, norms and the vocab matmul; |logits| ~ 3). Inside the port,
`fuse_gate_stacks` is bit-equal to the unfused path, as the reference
claims (transformer.py:148)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core import program as jp
from repro.models.layers import Execution as JExe
from repro_torch.configs import get_arch as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import prng
from repro_torch.core import program as tp
from repro_torch.models import layers as tl
from repro_torch.models.layers import Execution as TExe

ATOL = 1e-5
SPEC = get_arch("granite-8b")
CFG = SPEC.smoke_cfg
JM = SPEC.model_module()
TCFG = tget("granite-8b").smoke_cfg
TM = tget("granite-8b").model_module()


@pytest.fixture(scope="module")
def models():
    jparams = JM.init(jax.random.PRNGKey(0), CFG)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    out = {"digital": (JExe(compute_dtype="float32"), jparams,
                       TExe(compute_dtype="float32"), tparams)}
    jcfg, tcfg = ja.AimcConfig(impl="ref"), ta.AimcConfig()
    out["aimc"] = (
        JExe(mode="aimc", aimc=jcfg, compute_dtype="float32",
             programmed=True),
        jp.program_model(jparams, jp.MappingPlan(), jcfg).install(jparams),
        TExe(mode="aimc", aimc=tcfg, compute_dtype="float32",
             programmed=True),
        tp.program_model(tparams, tp.MappingPlan(), tcfg).install(tparams))
    return out


def _prompts():
    rng = np.random.default_rng(0)
    return (rng.integers(1, CFG.vocab, (3, 8)).astype(np.int32),
            np.array([8, 5, 3], np.int32))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_prefill_logits_and_cache(models, mode):
    je, jparams, te, tparams = models[mode]
    toks, vl = _prompts()
    lj, cj = JM.prefill(jparams, jnp.asarray(toks), CFG, je, max_seq=12,
                        cache_dtype=jnp.float32, valid_len=jnp.asarray(vl))
    lt, ct = TM.prefill(tparams, torch.from_numpy(toks), TCFG, te,
                        max_seq=12, cache_dtype=torch.float32,
                        valid_len=torch.from_numpy(vl))
    assert tuple(lt.shape) == (3, 1, CFG.vocab)
    _close(lt, lj)
    _close(ct["k"], cj["k"])
    _close(ct["v"], cj["v"])
    np.testing.assert_array_equal(ct["len"].numpy(), vl)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
@pytest.mark.parametrize("ragged", [True, False])
def test_decode_step_logits(models, mode, ragged):
    je, jparams, te, tparams = models[mode]
    toks, vl = _prompts()
    if not ragged:
        vl = np.full(3, 8, np.int32)
    _, cj = JM.prefill(jparams, jnp.asarray(toks), CFG, je, max_seq=12,
                       cache_dtype=jnp.float32, valid_len=jnp.asarray(vl))
    _, ct = TM.prefill(tparams, torch.from_numpy(toks), TCFG, te, max_seq=12,
                       cache_dtype=torch.float32,
                       valid_len=torch.from_numpy(vl))
    nxt = np.array([[5], [7], [9]], np.int32)
    for _ in range(2):
        lj, cj = JM.decode_step(jparams, cj, jnp.asarray(nxt), CFG, je,
                                ragged=ragged)
        lt, ct2 = TM.decode_step(tparams, ct, torch.from_numpy(nxt), TCFG, te,
                                 ragged=ragged)
        _close(lt, lj)
        _close(ct2["k"], cj["k"])
        assert not torch.equal(ct2["k"], ct["k"])     # input cache untouched
        ct = ct2


def test_fuse_gate_stacks_bit_equal(models):
    _, _, te, tparams = models["aimc"]
    fused = TM.fuse_gate_stacks(tparams)
    blocks = fused["blocks"]
    assert "w_gu" in blocks and "w_gate" not in blocks and "w_up" not in blocks
    assert "wqkv" not in blocks            # GQA: K/V widths differ from Q
    assert blocks["w_gu"].stack_shape == (CFG.n_layers, 2)
    toks, vl = _prompts()
    outs = [TM.prefill(p, torch.from_numpy(toks), TCFG, te, max_seq=12,
                       cache_dtype=torch.float32,
                       valid_len=torch.from_numpy(vl))
            for p in (tparams, fused)]
    assert torch.equal(outs[0][0], outs[1][0])
    nxt = torch.tensor([[5], [7], [9]], dtype=torch.int32)
    d0 = TM.decode_step(tparams, outs[0][1], nxt, TCFG, te, ragged=True)[0]
    d1 = TM.decode_step(fused, outs[1][1], nxt, TCFG, te, ragged=True)[0]
    assert torch.equal(d0, d1)


def test_fuse_gate_stacks_is_noop_on_digital(models):
    _, _, _, tparams = models["digital"]
    assert TM.fuse_gate_stacks(tparams)["blocks"].keys() == \
        tparams["blocks"].keys()


@pytest.mark.parametrize("s,chunk", [(8, 4), (5, 2), (16, 16)])
def test_flash_attention_matches_reference(s, chunk):
    from repro.models.layers import flash_attention as jflash
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    oj = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                q_chunk=chunk, kv_chunk=chunk)
    ot = tl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), q_chunk=chunk,
                            kv_chunk=chunk)
    _close(ot, oj)


def test_mha_fuses_qkv_bit_equal():
    """With n_kv_heads == n_heads, wq/wk/wv also stack (wqkv, G=3) and the
    fused prefill stays bit-equal to the unfused one."""
    import dataclasses
    cfg = dataclasses.replace(TCFG, n_kv_heads=TCFG.n_heads)
    params = TM.init(prng.PRNGKey(3), cfg, device="cpu")
    acfg = ta.AimcConfig()
    inst = tp.program_model(params, tp.MappingPlan(), acfg).install(params)
    fused = TM.fuse_gate_stacks(inst)
    assert fused["blocks"]["wqkv"].stack_shape == (cfg.n_layers, 3)
    exe = TExe(mode="aimc", aimc=acfg, compute_dtype="float32",
               programmed=True)
    toks, vl = _prompts()
    outs = [TM.prefill(p, torch.from_numpy(toks), cfg, exe,
                       valid_len=torch.from_numpy(vl))[0]
            for p in (inst, fused)]
    assert torch.equal(outs[0], outs[1])


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7])
def test_init_on_keys_matches_reference(seed):
    """`init(PRNGKey(s))` draws the reference's weights: the unit norms
    exactly, every drawn leaf within 4 ulps (`prng.normal`: XLA's CPU
    `log1p` is not PyTorch's). Programmed noise-free, the int8 codes are
    equal; an ulp can move a code only where w / s_w sits on a rounding tie,
    so every differing code must be such a tie, and the ties are counted and
    named (none occur at these seeds)."""
    jparams = JM.init(jax.random.PRNGKey(seed), CFG)
    tparams = TM.init(prng.PRNGKey(seed), TCFG, device="cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    jleaves = {"/".join(str(getattr(k, "key", k)) for k in path): v
               for path, v in jflat.items()}
    tleaves = dict(tp._flatten(tparams))
    assert sorted(tleaves) == sorted(jleaves)
    for path, t in tleaves.items():
        j = np.asarray(jleaves[path])
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
        if "ln" in path or "norm" in path:
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            assert _ulps(t.numpy(), j).max() <= 4, path
    cfg_j, cfg_t = ja.AimcConfig(impl="ref"), ta.AimcConfig()
    pj = jp.program_model(jparams, jp.MappingPlan(), cfg_j)
    pt = tp.program_model(tparams, tp.MappingPlan(), cfg_t)
    assert pt.names == pj.names
    ties = []
    for name in pj.names:
        cj, ct = np.asarray(pj[name].w_q), pt[name].w_q.numpy()
        for idx in zip(*np.nonzero(cj != ct)):
            ties.append(f"{name}{list(idx)}")
        np.testing.assert_array_equal(pt[name].s_w.numpy() != 0,
                                      np.asarray(pj[name].s_w) != 0)
    assert not ties, f"{len(ties)} codes differ (rounding ties): {ties[:8]}"


def test_init_keeps_no_generator_and_refuses_unported():
    import inspect
    src = inspect.getsource(TM) + inspect.getsource(tl)
    assert "Generator" not in src
    with pytest.raises(NotImplementedError):
        tl.dense_init(prng.PRNGKey(0), 4, 4, dtype=torch.bfloat16,
                      device="cpu")
    import dataclasses as dc

    @dc.dataclass(frozen=True)
    class Tied:
        tie_embeddings: bool = True
    with pytest.raises(NotImplementedError):
        TM.init(prng.PRNGKey(0), Tied(), device="cpu")


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError):
        tget("olmoe-1b-7b")
    with pytest.raises(KeyError):
        tget("no-such-arch")
    with pytest.raises(NotImplementedError):
        tl.linear(torch.zeros(1, 4), torch.zeros(4, 4),
                  TExe(mode="aimc", programmed=False))
