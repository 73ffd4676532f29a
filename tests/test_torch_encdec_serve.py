"""Parity of the port's enc-dec serving half (`repro_torch/models/encdec.py`:
`init_cache`, `prefill`, `decode_step`, `_dec_cross_kv`,
`init_paged_cache`, `paged_view`; `layers.decode_attention` over a whole
cache) with the JAX reference at the seamless-m4t-large-v2 smoke config
(2 + 2 layers, d_model 32), digital and programmed (every projection on
the crossbar, cross ``ck``/``cv`` included, noise off). Weights are the
reference's (`init` on seed 0, carried over with
`convert.params_from_numpy`); frames and tokens are drawn with numpy. JAX
runs as its own tests run it: ``impl="ref"``, functions driven directly,
no mesh.

Tolerances: logits and every cache tensor within ATOL x max(1, max|ref|)
(ATOL = 1e-5; f32 op order in attention and norms), lengths and greedy
tokens exact, the programmed codes exact; a bf16 cache is the f32 cache
rounded once (bit for bit), and the reference's up to one bf16 ulp where
an f32 value sits at a rounding tie. Programmed runs log the
reference's DAC inputs and replay its code in the port wherever the two
round a tie apart (`tests/torch_code_replay.py`, within GELU_TIE of a
tie: the FFN's GeLU differs by a few ulps between the frameworks); a code
that differs away from a tie fails. Also ported: the reference's
`test_encdec_decode_matches_forward` (its atol 2e-3) and
`test_encdec_paged_view_matches_dense_layout` (exact), and the engine's
and serve CLI's refusal of the audio family."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core import program as jp
from repro.models import encdec as je
from repro.models.layers import Execution as JExe
from repro_torch.configs import get_arch as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import prng
from repro_torch.core import program as tp
from repro_torch.models import encdec as te
from repro_torch.models import layers as tl
from repro_torch.models.layers import Execution as TExe
from torch_code_replay import logging_reference, replaying_in_port

ATOL = 1e-5
# a DAC input's tie window in code units: the FFN's tanh GeLU differs
# between XLA:CPU and torch by up to 3 ulps where |y| > 1 (2e6 normal
# inputs), so a value the reference puts 4 ulps below x.5 can be x.5 in the
# port; 8 ulps of 127 (the default window is 1e-5, about 1.3 ulps)
GELU_TIE = 8 * 2.0 ** -17
CFG = get_arch("seamless_m4t_large_v2").smoke_cfg
TCFG = tget("seamless-m4t-large-v2").smoke_cfg
B, S_SRC, S_TGT, MAX_SEQ = 2, 24, 10, 16


def _close(got, want, atol=ATOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def models():
    """mode -> (JAX exe, JAX params, port exe, port params); programmed
    params are installed trees, and the two programs' codes are equal."""
    jparams = je.init(jax.random.PRNGKey(0), CFG)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    out = {"digital": (JExe(compute_dtype="float32"), jparams,
                       TExe(compute_dtype="float32"), tparams)}
    jcfg, tcfg = ja.AimcConfig(impl="ref"), ta.AimcConfig()
    jprog = jp.program_model(jparams, jp.MappingPlan(), jcfg)
    tprog = tp.program_model(tparams, tp.MappingPlan(), tcfg)
    assert tuple(tprog.names) == tuple(jprog.names)
    assert {n.rsplit("/", 1)[-1] for n in tprog.names if "dec/" in n} >= {
        "ck", "cv", "cq", "co"}
    for name in tprog.names:
        np.testing.assert_array_equal(tprog[name].w_q.numpy(),
                                      np.asarray(jprog[name].w_q), name)
    out["aimc"] = (
        JExe(mode="aimc", aimc=jcfg, compute_dtype="float32",
             programmed=True), jprog.install(jparams),
        TExe(mode="aimc", aimc=tcfg, compute_dtype="float32",
             programmed=True), tprog.install(tparams))
    return out


def _inputs(seed=0, s_tgt=S_TGT):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_SRC, CFG.d_model)).astype(np.float32)
    toks = rng.integers(1, CFG.vocab, (B, s_tgt)).astype(np.int32)
    return frames, toks


def _serve(models, mode, steps):
    """Prefill + ``steps`` greedy decode steps in both packages on f32
    caches (the port replaying the reference's DAC codes at ties) -> per
    call (JAX (logits, cache), port (logits, cache))."""
    je_, jparams, te_, tparams = models[mode]
    frames, toks = _inputs()
    log, seen = {}, {}
    with logging_reference(log):
        jout = [je.prefill(jparams, jnp.asarray(frames), jnp.asarray(toks),
                           CFG, je_, max_seq=MAX_SEQ,
                           cache_dtype=jnp.float32)]
        for _ in range(steps):
            lj, cj = jout[-1]
            nxt = jnp.argmax(lj[:, -1:], -1).astype(jnp.int32)
            jout.append(je.decode_step(jparams, cj, nxt, CFG, je_))
    with replaying_in_port(log, seen, GELU_TIE):
        tout = [te.prefill(tparams, torch.from_numpy(frames),
                           torch.from_numpy(toks), TCFG, te_,
                           max_seq=MAX_SEQ, cache_dtype=torch.float32)]
        for _ in range(steps):
            lt, ct = tout[-1]
            nxt = lt[:, -1:].argmax(-1).to(torch.int32)
            tout.append(te.decode_step(tparams, ct, nxt, TCFG, te_))
    assert seen["away"] == 0, seen
    return list(zip(jout, tout))


def test_init_cache_layout():
    """Self K/V [n_dec, B, max_seq, Hkv, hd], cross K/V [n_dec, B, src_len,
    Hkv, hd] in the cache dtype, len [B] int32, all zero: the reference's
    layout."""
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        jc = je.init_cache(CFG, 3, 12, 20, jdt)
        tc = te.init_cache(TCFG, 3, 12, 20, tdt, device="cpu")
        assert sorted(tc) == sorted(jc) == ["ck", "cv", "k", "len", "v"]
        for name in tc:
            assert tuple(tc[name].shape) == jc[name].shape, name
            assert str(tc[name].dtype).split(".")[-1] == str(
                jc[name].dtype), name
            assert not tc[name].any(), name
        assert tuple(tc["k"].shape) == (CFG.n_dec_layers, 3, 12,
                                        CFG.n_kv_heads, CFG.hd)
        assert tuple(tc["ck"].shape)[2] == 20


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_prefill_and_decode_match_reference(models, mode):
    """Prefill (logits of the last position, self K/V rows [0, s) of
    max_seq, cross K/V of every layer, len = s) and 4 greedy decode steps
    (the one-hot row write at len, self-attention to len + 1, cross
    attention to the whole ``ck``/``cv``): logits and caches within ATOL,
    tokens and lengths exact."""
    for i, ((lj, cj), (lt, ct)) in enumerate(_serve(models, mode, 4)):
        assert tuple(lt.shape) == (B, 1, CFG.vocab)
        _close(lt, lj)
        np.testing.assert_array_equal(
            lt[:, -1].argmax(-1).numpy(), np.asarray(jnp.argmax(lj[:, -1],
                                                                -1)))
        np.testing.assert_array_equal(ct["len"].numpy(),
                                      np.asarray(cj["len"]))
        assert int(ct["len"][0]) == S_TGT + i
        for name in ("k", "v", "ck", "cv"):
            assert tuple(ct[name].shape) == cj[name].shape, name
            _close(ct[name], cj[name])


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_bf16_cache_rounds_the_f32_cache(models, mode):
    """A bf16 cache (the serving specs' dtype) holds the f32 cache's values
    rounded once: the port's bf16 prefill cache equals its f32 cache cast
    to bf16, bit for bit, with the same logits; it is the reference's bf16
    cache up to one bf16 ulp where an f32 value sits at a rounding tie
    (rtol 2^-7). A decode step from the reference's own bf16 cache gives
    logits within ATOL and writes only row ``len``."""
    je_, jparams, te_, tparams = models[mode]
    frames, toks = _inputs(2)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(toks)
    l32, c32 = te.prefill(tparams, tf, tt, TCFG, te_, max_seq=MAX_SEQ,
                          cache_dtype=torch.float32)
    l16, c16 = te.prefill(tparams, tf, tt, TCFG, te_, max_seq=MAX_SEQ,
                          cache_dtype=torch.bfloat16)
    assert torch.equal(l16, l32)
    _, cj = je.prefill(jparams, jnp.asarray(frames), jnp.asarray(toks), CFG,
                       je_, max_seq=MAX_SEQ, cache_dtype=jnp.bfloat16)
    for name in ("k", "v", "ck", "cv"):
        assert c16[name].dtype == torch.bfloat16, name
        assert torch.equal(c16[name], c32[name].to(torch.bfloat16)), name
        np.testing.assert_allclose(
            c16[name].to(torch.float32).numpy(),
            np.asarray(cj[name].astype(jnp.float32)), rtol=2 ** -7, atol=0)
    tcj = {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
           .to(torch.bfloat16 if k != "len" else torch.int32)
           for k, v in cj.items()}
    nxt = np.array([[3], [5]], np.int32)
    lj, cj1 = je.decode_step(jparams, cj, jnp.asarray(nxt), CFG, je_)
    lt, ct1 = te.decode_step(tparams, tcj, torch.from_numpy(nxt), TCFG, te_)
    _close(lt, lj)
    row = np.arange(MAX_SEQ) != S_TGT
    for name in ("k", "v"):
        assert ct1[name].dtype == torch.bfloat16
        assert torch.equal(ct1[name][:, :, row], tcj[name][:, :, row])
        np.testing.assert_allclose(
            ct1[name][:, :, S_TGT].to(torch.float32).numpy(),
            np.asarray(cj1[name][:, :, S_TGT].astype(jnp.float32)),
            rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_decode_step_leaves_input_cache_untouched(models, mode):
    _, _, te_, tparams = models[mode]
    frames, toks = _inputs(3)
    _, c0 = te.prefill(tparams, torch.from_numpy(frames),
                       torch.from_numpy(toks), TCFG, te_, max_seq=MAX_SEQ,
                       cache_dtype=torch.float32)
    before = {k: v.clone() for k, v in c0.items()}
    _, c1 = te.decode_step(tparams, c0, torch.ones((B, 1), dtype=torch.int32),
                           TCFG, te_)
    for k in before:
        assert torch.equal(c0[k], before[k]), k
    assert not torch.equal(c1["k"], c0["k"])
    assert c1["ck"] is c0["ck"] and c1["cv"] is c0["cv"]   # read-only


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_dec_cross_kv_matches_reference(models, mode):
    """Per-layer cross K/V of an encoder output: [n_dec, B, S, Hkv, hd]
    within ATOL."""
    je_, jparams, te_, tparams = models[mode]
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((B, S_SRC, CFG.d_model)).astype(np.float32)
    jk, jv = je._dec_cross_kv(jparams, jnp.asarray(enc), CFG, je_)
    tk, tv = te._dec_cross_kv(tparams, torch.from_numpy(enc), TCFG, te_)
    assert tuple(tk.shape) == jk.shape == (CFG.n_dec_layers, B, S_SRC,
                                           CFG.n_kv_heads, CFG.hd)
    _close(tk, jk)
    _close(tv, jv)


def test_decode_attention_covers_the_whole_cache_without_kv_len():
    """``kv_len=None`` attends to every row (the cross-attention decode),
    as the reference's; equal to kv_len = Skv."""
    from repro.models import layers as jl
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    got = tl.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    _close(got, jl.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v)))
    full = torch.full((2,), 6, dtype=torch.int32)
    assert torch.equal(got, tl.decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), kv_len=full))


def test_encdec_decode_matches_forward():
    """The reference's `test_encdec_decode_matches_forward` on the port:
    the teacher-forced forward's last position equals prefill of the first
    tgt - 1 tokens plus one decode step (digital f32, the reference's
    atol 2e-3)."""
    params = te.init(prng.PRNGKey(0), TCFG, device="cpu")
    exe = TExe(compute_dtype="float32")
    b, src, tgt = 2, 16, 6
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, src, TCFG.d_model)).astype(np.float32))
    toks = (torch.arange(b * tgt).reshape(b, tgt) * 5 + 1) % TCFG.vocab
    batch = {"frames": frames, "tokens": toks, "labels": toks}
    with torch.no_grad():
        logits_full, _ = te.forward(params, batch, TCFG, exe)
        _, cache = te.prefill(params, frames, toks[:, :-1], TCFG, exe,
                              max_seq=tgt, cache_dtype=torch.float32)
        logits_step, _ = te.decode_step(params, cache, toks[:, -1:], TCFG,
                                        exe)
    np.testing.assert_allclose(logits_step[:, -1].numpy(),
                               logits_full[:, -1].numpy(), rtol=0, atol=2e-3)


def test_encdec_paged_view_matches_dense_layout():
    """The reference's `test_encdec_paged_view_matches_dense_layout`: the
    decoder self-attention pools [n_dec, n_pages, P, Hkv, hd] (the cross
    K/V stay dense), and the gathered view is the named pages row for row;
    and the port's view equals the reference's on the same pools."""
    pools = te.init_paged_cache(TCFG, n_pages=5, page_size=2,
                                dtype=torch.float32, device="cpu")
    jpools = je.init_paged_cache(CFG, n_pages=5, page_size=2,
                                 dtype=jnp.float32)
    assert sorted(pools) == sorted(jpools) == ["kp", "vp"]
    assert tuple(pools["kp"].shape) == jpools["kp"].shape
    n_dec = pools["kp"].shape[0]
    assert tuple(pools["kp"].shape[1:3]) == (5, 2)
    key = jax.random.PRNGKey(1)
    jkp = jax.random.normal(key, jpools["kp"].shape)
    jvp = jax.random.normal(key, jpools["vp"].shape)
    kp = torch.from_numpy(np.asarray(jkp))
    vp = torch.from_numpy(np.asarray(jvp))
    pt = torch.tensor([[1, 3], [4, 2]])                  # 2 slots, 2 pages
    k, v = te.paged_view(kp, vp, pt, max_seq=4)
    assert tuple(k.shape[:3]) == (n_dec, 2, 4)
    assert torch.equal(k[:, 0, :2], kp[:, 1])
    assert torch.equal(k[:, 0, 2:], kp[:, 3])
    assert torch.equal(v[:, 1, :2], vp[:, 4])
    assert torch.equal(v[:, 1, 2:], vp[:, 2])
    jk, jv = je.paged_view(jkp, jvp, jnp.asarray(pt.numpy()), max_seq=4)
    assert np.array_equal(k.numpy(), np.asarray(jk))
    assert np.array_equal(v.numpy(), np.asarray(jv))


def test_engine_and_serve_cli_refuse_the_audio_family(models):
    """As the reference's (`runtime/engine.py:298`, `launch/serve.py:552`):
    the continuous-batching engine and the serve CLI refuse the enc-dec
    family, which is served through `launch.steps`' cells."""
    from repro.runtime.engine import ServeEngine as JEngine
    from repro_torch.launch import serve as tserve
    from repro_torch.runtime.engine import ServeEngine as TEngine
    je_, jparams, te_, tparams = models["digital"]
    with pytest.raises(ValueError, match="launch.steps"):
        JEngine(je, CFG, je_, jparams, family="audio", module="encdec")
    with pytest.raises(ValueError, match="launch.steps"):
        TEngine(te, TCFG, te_, tparams, family="audio", module="encdec")
    with pytest.raises(SystemExit, match="launch.steps"):
        tserve.main(["--arch", "seamless-m4t-large-v2", "--smoke",
                     "--device", "cpu"])
