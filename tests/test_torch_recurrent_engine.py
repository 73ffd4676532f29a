"""The port's recurrent serving (`repro_torch/runtime/engine.py` with the
xlstm and rglru modules, `static_generate`) on the xlstm-350m and
recurrentgemma-9b smoke configs, against the port's own manual decode loop
and against the JAX engine and `static_generate` on the same weights
(carried across with `params_from_numpy`).

Ports of the reference's own engine tests (tests/test_engine.py:187-230,
tests/test_paged_engine.py:243-270), each also held to the JAX engine:
  * a ragged Poisson trace serves with no new shapes after warmup and
    closed vector books; tokens and books equal the JAX engine's;
  * the engine equals feeding the prompt token by token and decoding
    greedily;
  * a snapshot-page hit restores the deepest page-aligned state and is
    bit-equal to the dense engine, with the reference's hit vectors; the
    same with chunked legs;
  * `static_generate` equals the reference's and is the engine's oracle
    (bit-equal on a synchronized trace, digital and programmed with a
    fixed DAC scale);
  * the decode state is batch-invariant on the programmed path
    (`test_torch_recurrent_serve.py` holds the CLI to the reference's).

Tolerance: tokens equal; vector books equal (integers). Digital lanes are
row-independent, so a ragged trace's tokens do not depend on the clock
that decides batch composition; programmed runs use synchronized arrivals
(or a fixed DAC scale), where the decode batches are the same."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models.layers import Execution as JExe
from repro.runtime import batcher as jb
from repro.runtime.engine import ServeEngine as JEngine
from repro.runtime.engine import static_generate as jstatic
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import program as tp
from repro_torch.models.layers import Execution as TExe
from repro_torch.runtime import batcher as tb
from repro_torch.runtime.engine import ServeEngine, static_generate

ARCHS = ("xlstm-350m", "recurrentgemma-9b")
EXE = TExe(compute_dtype="float32")
JEXE = JExe(compute_dtype="float32")
KW = dict(n_slots=2, prompt_pad=6, max_seq=16)
_W: dict = {}


def weights(arch):
    """(jax params, port params) of one smoke arch, seed 0."""
    if arch not in _W:
        js = jget(arch)
        jp_ = js.model_module().init(jax.random.PRNGKey(0), js.smoke_cfg)
        _W[arch] = jp_, params_from_numpy(jax.tree.map(np.asarray, jp_))
    return _W[arch]


def port_engine(arch, params=None, exe=EXE, **kw):
    spec = get_arch(arch)
    return ServeEngine(spec.model_module(), spec.smoke_cfg, exe,
                       weights(arch)[1] if params is None else params,
                       family=spec.family, module=spec.module,
                       **(KW | kw))


def jax_engine(arch, **kw):
    spec = jget(arch)
    return JEngine(spec.model_module(), spec.smoke_cfg, JEXE, weights(arch)[0],
                   family=spec.family, module=spec.module,
                   cache_dtype=jnp.float32, **(KW | kw))


def _books(rec):
    return (rec.tokens, rec.finish_reason, rec.prefill_vectors,
            rec.decode_vectors, rec.pad_vectors)


def _same_records(rep_t, rep_j):
    assert set(rep_t.records) == set(rep_j.records)
    for rid, rec in rep_j.records.items():
        assert _books(rep_t.records[rid]) == _books(rec), f"request {rid}"


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_arch_serves_ragged_trace(arch):
    cfg = get_arch(arch).smoke_cfg
    eng = port_engine(arch)
    eng.warmup()
    reqs = tb.poisson_trace(5, rate=500.0, seed=7, prompt_len=(2, 6),
                            max_new=(1, 5), vocab=cfg.vocab)
    report = eng.serve(reqs)
    assert len(report.records) == 5
    assert eng.compile_counts() == {"prefill": 1, "insert": 1, "decode": 1}
    assert report.observed_vectors == report.useful_vectors
    for rec in report.records.values():
        assert 1 <= len(rec.tokens) <= rec.request.max_new
        assert rec.vectors == (len(rec.request.prompt)
                               + len(rec.tokens) - 1)
    jeng = jax_engine(arch)
    jeng.warmup()
    _same_records(report, jeng.serve(jb.poisson_trace(
        5, rate=500.0, seed=7, prompt_len=(2, 6), max_new=(1, 5),
        vocab=cfg.vocab)))


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_engine_matches_manual_decode_loop(arch):
    spec = get_arch(arch)
    cfg, model = spec.smoke_cfg, spec.model_module()
    params = weights(arch)[1]
    prompt = tuple(range(1, 7))
    eng = port_engine(arch, n_slots=1)
    eng.warmup()
    got = eng.serve([tb.Request(rid=0, prompt=prompt, max_new=5)]).tokens(0)
    # feed the prompt token by token, then greedy-decode
    cache = model.init_cache(cfg, 1, 16, torch.float32)
    toks = torch.tensor([prompt], dtype=torch.int32)
    for t in range(len(prompt)):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                          cfg, EXE)
    ref = [int(logits[0, -1].argmax())]
    for _ in range(4):
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[ref[-1]]], dtype=torch.int32), cfg,
            EXE)
        ref.append(int(logits[0, -1].argmax()))
    assert got == ref
    jm, jcfg = jget(arch).model_module(), jget(arch).smoke_cfg
    jcache = jm.init_cache(jcfg, 1, 16, jnp.float32)
    for t in range(len(prompt)):
        jl, jcache = jm.decode_step(weights(arch)[0], jcache,
                                    jnp.asarray([[prompt[t]]], jnp.int32),
                                    jcfg, JEXE)
    assert int(jnp.argmax(jl[0, -1])) == ref[0]


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_snapshot_hit_bit_equal(arch, chunk):
    """Two requests with one 6-token prompt through snapshot pages of 2.
    Unchunked (legs of one page, each admission drained) the second
    restores the page-4 snapshot (the boundary at 6 is capped: the
    continuation keeps >= 1 token); chunked (4-token legs interleaved with
    decode) it is admitted before the first registers and misses. Either
    way the tokens are the dense engine's, and books, hits and the page
    ledger equal the JAX engine's."""
    kw = dict(page_size=2, prefix_cache=True, prefill_chunk=chunk)
    dense = port_engine(arch)
    dense.warmup()
    snap = port_engine(arch, **kw)
    counts = snap.warmup()
    assert counts["snapshot"] == 1 and counts["restore"] == 1
    assert counts["prefill_chunk"] == 1
    shared = (3, 7, 11, 2, 9, 5)
    reqs = [tb.Request(rid=i, prompt=shared, max_new=4) for i in range(2)]
    r1 = dense.serve(list(reqs))
    r2 = snap.serve(list(reqs))
    for r in reqs:
        assert r1.tokens(r.rid) == r2.tokens(r.rid), \
            f"req {r.rid}: snapshot restore changed the output"
    if not chunk:
        assert r2.records[0].prefill_vectors == 6
        assert r2.records[1].prefill_vectors == 2
        assert r2.prefix_hits == 1 and r2.prefix_hit_vectors == 4
    assert r2.observed_vectors == r2.useful_vectors
    assert r2.page_ledger_exact
    assert r2.page_ledger["held"] == len(snap.prefix)
    assert snap.compile_counts() == counts
    jsnap = jax_engine(arch, **kw)
    jsnap.warmup()
    rj = jsnap.serve([jb.Request(rid=i, prompt=shared, max_new=4)
                      for i in range(2)])
    _same_records(r2, rj)
    assert (r2.prefix_hits, r2.prefix_hit_vectors, r2.prefill_chunks) == \
        (rj.prefix_hits, rj.prefix_hit_vectors, rj.prefill_chunks)
    assert r2.page_ledger == rj.page_ledger


def test_recurrent_snapshot_validation():
    with pytest.raises(ValueError, match="multiple of page_size"):
        port_engine("xlstm-350m", page_size=4, prefix_cache=True,
                    prefill_chunk=6)
    eng = port_engine("xlstm-350m", page_size=2, prefill_chunk=4)
    assert eng.pages is None and eng._legs_rec and not eng._snap
    assert eng.warmup() == {"prefill": 1, "insert": 1, "decode": 1,
                            "prefill_chunk": 1}


def test_recurrent_lanes_have_no_max_seq_cap():
    """O(1) state: a request may decode past max_seq (the reference skips
    the cap for recurrent archs); a transformer lane retires there."""
    eng = port_engine("xlstm-350m", max_seq=8)
    rep = eng.serve([tb.Request(rid=0, prompt=(1, 2, 3, 4, 5, 6),
                                max_new=6)])
    assert len(rep.tokens(0)) == 6 and rep.records[0].finish_reason == "length"


def _fixed_scale_exe():
    return TExe(mode="aimc", aimc=ta.AimcConfig(input_scale=0.05),
                compute_dtype="float32", programmed=True)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
@pytest.mark.parametrize("arch", ARCHS)
def test_static_generate_is_the_engine_oracle(arch, mode):
    """Synchronized arrivals through the engine equal `static_generate`
    bit for bit (programmed: with a fixed DAC scale, since the dynamic one
    is the max-abs over whatever shares the call)."""
    spec = get_arch(arch)
    cfg, model = spec.smoke_cfg, spec.model_module()
    params, exe = weights(arch)[1], EXE
    if mode == "aimc":
        exe = _fixed_scale_exe()
        params = tp.program_model(params, tp.MappingPlan(),
                                  exe.aimc).install(params)
    reqs = tb.synchronized_trace(3, prompt_len=6, max_new=5, seed=1,
                                 vocab=cfg.vocab)
    eng = port_engine(arch, params=params, exe=exe, n_slots=3)
    eng.warmup()
    report = eng.serve(reqs)
    prompts = torch.tensor([r.prompt for r in reqs], dtype=torch.int32)
    gen, (t_pre, t_dec) = static_generate(model, cfg, exe, params, prompts, 5,
                                          max_seq=16)
    assert tuple(gen.shape) == (3, 5) and t_dec > 0.0
    for r in reqs:
        assert report.tokens(r.rid) == gen[r.rid].tolist()
    _, (_, t0) = static_generate(model, cfg, exe, params, prompts, 1)
    assert t0 == 0.0


@pytest.mark.parametrize("arch", ARCHS + ("granite-8b",))
def test_static_generate_matches_reference(arch):
    js = jget(arch)
    jp_ = js.model_module().init(jax.random.PRNGKey(1), js.smoke_cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jp_))
    prompts = np.random.default_rng(4).integers(
        1, js.smoke_cfg.vocab, (3, 6)).astype(np.int32)
    gj, _ = jstatic(js.model_module(), js.smoke_cfg, JEXE, jp_,
                    jnp.asarray(prompts), 4, max_seq=12)
    spec = get_arch(arch)
    gt, _ = static_generate(spec.model_module(), spec.smoke_cfg, EXE, tparams,
                            torch.from_numpy(prompts), 4, max_seq=12)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_rows_are_batch_invariant(arch):
    """Programmed with a fixed DAC scale, a row's next state is the same
    bits whether it decodes in a batch of 3 or alone (K2's rows are
    independent, and `layers.row_sum` takes every cross-feature sum): what
    lets the engine, which prefills one request at a time, equal
    `static_generate` on the card too. (Digital projections are BLAS
    matmuls, whose order may follow the batch size.)"""
    spec = get_arch(arch)
    cfg, model = spec.smoke_cfg, spec.model_module()
    exe = _fixed_scale_exe()
    params = tp.program_model(weights(arch)[1], tp.MappingPlan(),
                              exe.aimc).install(weights(arch)[1])
    toks = torch.tensor([[3, 9, 4], [7, 1, 8], [5, 5, 2]], dtype=torch.int32)
    _, cache = model.prefill(params, toks[:, :2], cfg, exe, max_seq=8,
                             cache_dtype=torch.float32)
    _, big = model.decode_step(params, cache, toks[:, 2:], cfg, exe)
    for b in range(3):
        one = {k: v.narrow(0 if k == "len" else 1, b, 1)
               for k, v in cache.items()}
        _, c1 = model.decode_step(params, one, toks[b:b + 1, 2:], cfg, exe)
        for k, v in c1.items():
            assert torch.equal(big[k].narrow(0 if k == "len" else 1, b, 1),
                               v), (b, k)
