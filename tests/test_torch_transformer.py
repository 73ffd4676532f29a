"""Parity of the port's dense transformer (`repro_torch/models/
transformer.py` + `models/layers.py`) with the JAX reference on the
granite-8b smoke config (2 layers, d_model 64) and on the smoke configs of
the rest of the dense zoo (glm4-9b, llama3.2-3b with tied embeddings,
qwen1.5-110b with random nonzero QKV biases, internvl2-1b with its patch
prefix), weights carried across with `params_from_numpy`; and of the
paged-cache functions (`paged_view`, `prefill_chunk`).

Tolerance: logits and KV caches agree to atol=1e-5 (f32 op order in
attention, norms and the vocab matmul; |logits| ~ 3). Inside the port,
`fuse_gate_stacks` is bit-equal to the unfused path, as the reference
claims (transformer.py:148)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

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


@pytest.mark.parametrize("seed", [0, 7])
def test_init_on_keys_matches_reference(seed):
    """`init(PRNGKey(s))` draws the reference's weights bit for bit, the
    unit norms and every drawn leaf (`prng.normal`). Programmed noise-free,
    the int8 codes are equal: any code that differed is named."""
    _check_init_on_keys(JM, CFG, TM, TCFG, seed)


def _check_init_on_keys(jm, cfg, tm, tcfg, seed):
    jparams = jm.init(jax.random.PRNGKey(seed), cfg)
    tparams = tm.init(prng.PRNGKey(seed), tcfg, device="cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    jleaves = {"/".join(str(getattr(k, "key", k)) for k in path): v
               for path, v in jflat.items()}
    tleaves = dict(tp._flatten(tparams))
    assert sorted(tleaves) == sorted(jleaves)
    for path, t in tleaves.items():
        j = np.asarray(jleaves[path])
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), j, err_msg=path)
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
    # bf16 init (ported): the f32 draw on the same key, rounded once
    k = prng.PRNGKey(0)
    got = tl.expert_stack_init(k, 1, 2, 4, 4, dtype=torch.bfloat16,
                               device="cpu")
    want = tl.expert_stack_init(k, 1, 2, 4, 4, device="cpu")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_unported_paths_raise():
    """What is not there raises (an unknown arch is a KeyError); bf16
    weight init and the on-the-fly AIMC linear are ported now: the init
    rounds the f32 draw, the linear runs the STE."""
    with pytest.raises(KeyError):
        tget("no-such-arch")
    k = prng.PRNGKey(0)
    assert torch.equal(
        tl.dense_init(k, 4, 4, dtype=torch.bfloat16, device="cpu"),
        tl.dense_init(k, 4, 4, device="cpu").to(torch.bfloat16))
    x = torch.linspace(-1.0, 1.0, 8).reshape(2, 4)
    w = torch.linspace(-0.5, 0.5, 16).reshape(4, 4)
    exe = TExe(mode="aimc", programmed=False, compute_dtype="float32")
    assert torch.equal(tl.linear(x, w, exe),
                       ta.aimc_linear_ste(x, w, None, exe.aimc))


# ---------------------------------------------------------------------------
# the dense zoo: glm4-9b, llama3.2-3b, qwen1.5-110b, internvl2-1b
# ---------------------------------------------------------------------------

ZOO = ("glm4_9b", "llama32_3b", "qwen15_110b", "internvl2_1b")
_ZOO_MODELS: dict = {}


def _zoo(arch):
    js, ts = get_arch(arch), tget(arch)
    return js.smoke_cfg, js.model_module(), ts.smoke_cfg, ts.model_module()


def _zoo_models(arch, mode):
    """(jax exe, jax params, port exe, port params) of one smoke arch;
    qwen's QKV biases are set to random nonzero values first (init makes
    them zeros), so the bias epilogue is exercised."""
    if (arch, mode) in _ZOO_MODELS:
        return _ZOO_MODELS[arch, mode]
    cfg, jm, _, _ = _zoo(arch)
    jparams = jm.init(jax.random.PRNGKey(1), cfg)
    if cfg.qkv_bias:
        rng = np.random.default_rng(3)
        jparams["blocks"] = dict(jparams["blocks"], **{
            b: jnp.asarray(rng.standard_normal(
                jparams["blocks"][b].shape).astype(np.float32) * 0.5)
            for b in ("bq", "bk", "bv")})
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    if mode == "digital":
        out = (JExe(compute_dtype="float32"), jparams,
               TExe(compute_dtype="float32"), tparams)
    else:
        jcfg, tcfg = ja.AimcConfig(impl="ref"), ta.AimcConfig()
        out = (JExe(mode="aimc", aimc=jcfg, compute_dtype="float32",
                    programmed=True),
               jp.program_model(jparams, jp.MappingPlan(), jcfg)
               .install(jparams),
               TExe(mode="aimc", aimc=tcfg, compute_dtype="float32",
                    programmed=True),
               tp.program_model(tparams, tp.MappingPlan(), tcfg)
               .install(tparams))
    _ZOO_MODELS[arch, mode] = out
    return out


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_init_on_keys_matches_reference(arch):
    """The zoo's smoke configs draw the reference's weights key for key
    (same bar as granite): QKV biases are zeros that consume no key, and a
    tied model has no unembed leaf."""
    cfg, jm, tcfg, tm = _zoo(arch)
    _check_init_on_keys(jm, cfg, tm, tcfg, 0)
    tparams = tm.init(prng.PRNGKey(0), tcfg, device="cpu")
    assert ("unembed" in tparams) == (not cfg.tie_embeddings)
    assert ("bq" in tparams["blocks"]) == cfg.qkv_bias


def _zoo_prompts(cfg):
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab, (3, 12)).astype(np.int32)
    vl = np.array([12, 9, 10], np.int32)
    patches = (rng.standard_normal((3, cfg.n_patches, cfg.d_model))
               .astype(np.float32) if cfg.n_patches else None)
    return toks, vl, patches


@pytest.mark.parametrize("mode", ["digital", "aimc"])
@pytest.mark.parametrize("arch", ZOO)
def test_zoo_prefill_decode_match_reference(arch, mode):
    """Prefill logits and caches, then two ragged decode steps, within
    ATOL of the reference (run with impl="ref"; the port on its plain
    kernels). internvl2 runs with zero and with random patch embeddings;
    qwen with random nonzero biases in K2's epilogue."""
    cfg, jm, tcfg, tm = _zoo(arch)
    je, jparams, te, tparams = _zoo_models(arch, mode)
    toks, vl, patches = _zoo_prompts(cfg)
    embeds = [None] if patches is None else [np.zeros_like(patches), patches]
    for pe in embeds:
        lj, cj = jm.prefill(jparams, jnp.asarray(toks), cfg, je, max_seq=16,
                            patch_embeds=None if pe is None
                            else jnp.asarray(pe),
                            cache_dtype=jnp.float32,
                            valid_len=jnp.asarray(vl))
        lt, ct = tm.prefill(tparams, torch.from_numpy(toks), tcfg, te,
                            max_seq=16, patch_embeds=None if pe is None
                            else torch.from_numpy(pe),
                            cache_dtype=torch.float32,
                            valid_len=torch.from_numpy(vl))
        assert tuple(lt.shape) == (3, 1, cfg.vocab)
        _close(lt, lj)
        _close(ct["k"], cj["k"])
        _close(ct["v"], cj["v"])
    nxt = np.array([[5], [7], [9]], np.int32)
    for _ in range(2):
        lj, cj = jm.decode_step(jparams, cj, jnp.asarray(nxt), cfg, je,
                                ragged=True)
        lt, ct = tm.decode_step(tparams, ct, torch.from_numpy(nxt), tcfg, te,
                                ragged=True)
        _close(lt, lj)
        _close(ct["v"], cj["v"])


def test_qkv_bias_rides_the_epilogue_and_stacks():
    """qwen's programmed QKV with a nonzero bias: the epilogue result equals
    the unfused bias add, and the MHA-stacked wqkv (with ``biases=``) is
    bit-equal to the per-projection path."""
    import dataclasses as dc
    _, _, tcfg, tm = _zoo("qwen15_110b")
    cfg = dc.replace(tcfg, n_kv_heads=tcfg.n_heads)
    params = tm.init(prng.PRNGKey(4), cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for b in ("bq", "bk", "bv"):
        params["blocks"][b] = torch.randn(params["blocks"][b].shape,
                                          generator=gen)
    acfg = ta.AimcConfig()
    inst = tp.program_model(params, tp.MappingPlan(), acfg).install(params)
    fused = tm.fuse_gate_stacks(inst)
    assert fused["blocks"]["wqkv"].stack_shape == (cfg.n_layers, 3)
    exe = TExe(mode="aimc", aimc=acfg, compute_dtype="float32",
               programmed=True)
    unfused_exe = TExe(mode="aimc", compute_dtype="float32", programmed=True,
                       aimc=dc.replace(acfg, fuse_epilogue=False))
    toks, vl, _ = _zoo_prompts(cfg)
    outs = [tm.prefill(p, torch.from_numpy(toks), cfg, e,
                       valid_len=torch.from_numpy(vl))[0]
            for p, e in ((inst, exe), (fused, exe), (inst, unfused_exe))]
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0], outs[2], rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 5),
                                              (False, 0)])
def test_flash_attention_offset_matches_reference(causal, q_offset):
    from repro.models.layers import flash_attention as jflash
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 4, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 12, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 12, 2, 8)).astype(np.float32)
    oj = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=causal, q_offset=q_offset, q_chunk=2, kv_chunk=4)
    ot = tl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal,
                            q_offset=q_offset, q_chunk=2, kv_chunk=4)
    _close(ot, oj)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_paged_functions_match_reference(mode):
    """`paged_view` gathers the reference's view and one `prefill_chunk`
    leg (llama3.2 smoke, tied) returns the reference's token and page pools
    (ATOL) from the same pools and page-table row; untouched pages stay as
    they were, bit for bit."""
    cfg, jm, tcfg, tm = _zoo("llama32_3b")
    je, jparams, te, tparams = _zoo_models("llama32_3b", mode)
    rng = np.random.default_rng(5)
    pools = {n: rng.standard_normal((cfg.n_layers, 9, 4, cfg.n_kv_heads,
                                     cfg.hd)).astype(np.float32)
             for n in ("kp", "vp")}
    pt = np.array([[3, 1, 5, 0], [2, 4, 6, 7]], np.int32)
    kj, vj = jm.paged_view(jnp.asarray(pools["kp"]),
                           jnp.asarray(pools["vp"]), jnp.asarray(pt), 14)
    kt, vt = tm.paged_view(torch.from_numpy(pools["kp"]),
                           torch.from_numpy(pools["vp"]),
                           torch.from_numpy(pt), 14)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    toks = rng.integers(1, cfg.vocab, (1, 4)).astype(np.int32)
    row = pt[0]
    tj, kpj, vpj = jm.prefill_chunk(
        jparams, jnp.asarray(toks), cfg, je, jnp.asarray(pools["kp"]),
        jnp.asarray(pools["vp"]), jnp.asarray(row), jnp.int32(4),
        jnp.int32(3), page_size=4, context_len=12)
    kp_t = torch.from_numpy(pools["kp"].copy())
    vp_t = torch.from_numpy(pools["vp"].copy())
    tt, kp2, vp2 = tm.prefill_chunk(
        tparams, torch.from_numpy(toks), tcfg, te, kp_t, vp_t,
        torch.from_numpy(row), 4, 3, page_size=4, context_len=12)
    assert kp2 is kp_t and vp2 is vp_t           # written in place
    assert tt.tolist() == np.asarray(tj).tolist()
    for j in (1,):                               # the touched page
        _close(kp2[:, j], kpj[:, j])
        _close(vp2[:, j], vpj[:, j])
    for j in (2, 3, 4, 5, 6, 7, 8):              # untouched: bit for bit
        np.testing.assert_array_equal(kp2[:, j].numpy(), pools["kp"][:, j])


@pytest.mark.parametrize("arch", ["qwen15_110b", "llama32_3b"])
def test_npz_round_trip_carries_biases_and_tied_tree(arch, tmp_path):
    """`convert.load_npz` (the CLI's ``--weights``) rebuilds qwen's tree
    with its QKV biases and llama3.2's tree without an unembed leaf, leaf
    for leaf equal to the reference's arrays."""
    from repro_torch.convert import flatten_to_numpy, load_npz
    cfg, jm, _, _ = _zoo(arch)
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), cfg))
    flat = flatten_to_numpy(jparams)
    np.savez(tmp_path / "w.npz", **flat)
    got = flatten_to_numpy(load_npz(tmp_path / "w.npz"))
    assert sorted(got) == sorted(flat)
    assert ("blocks/bq" in got) == cfg.qkv_bias
    assert ("unembed" in got) == (not cfg.tie_embeddings)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v)
