"""The port's paged serving (`repro_torch/runtime/engine.py` with
`page_size > 0`, `runtime/pages.py`, `transformer.prefill_chunk`) on the
llama3.2-3b smoke config (tied embeddings), against the port's own dense
engine and against the reference's paged engine on the same trace.

Pinned, as the reference pins them (tests/test_paged_engine.py):
  * paged decode (dense prefill, paged insert) emits the dense engine's
    tokens bit for bit, synchronized and ragged, and every page is freed;
  * with a prefix cache, 8 requests sharing 8 prompt tokens emit the dense
    engine's tokens; the shared span is prefilled and billed once, and the
    per-request prefill vectors, prefix hits and hit vectors equal the
    reference engine's (fixed DAC scale ``input_scale=0.1``: with the
    dynamic scale, AIMC tokens depend on what shares the call);
  * chunked prefill emits the dense tokens and pays less prompt padding;
  * pools and prefix pages outlive a session; no closure sees a new shape
    after warmup; the page ledger is exact; the reference's validation
    errors;
  * ``--paged-verify`` through the port's CLI exits 0.
Tolerance: tokens equal; vector books equal (integers)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.core import aimc as ja
from repro.core import program as jp
from repro.models.layers import Execution as JExe
from repro.runtime import batcher as jb
from repro.runtime.engine import ServeEngine as JEngine
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import program as tp
from repro_torch.launch import serve as tserve
from repro_torch.models.layers import Execution as TExe
from repro_torch.runtime import batcher as tb
from repro_torch.runtime.engine import ServeEngine

ARCH = "llama32_3b"
SPEC = get_arch(ARCH)
CFG = SPEC.smoke_cfg
MODEL = SPEC.model_module()
EXE = TExe(compute_dtype="float32")


@pytest.fixture(scope="module")
def jparams():
    return jget(ARCH).model_module().init(jax.random.PRNGKey(0),
                                          jget(ARCH).smoke_cfg)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams))


def make_engine(params, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("prompt_pad", 8)
    kw.setdefault("max_seq", 24)
    kw.setdefault("family", SPEC.family)
    kw.setdefault("module", SPEC.module)
    return ServeEngine(MODEL, kw.pop("cfg", CFG), kw.pop("exe", EXE),
                       params, **kw)


def shared_prompt_trace(n, shared, suffix_len, vocab, max_new=5, seed=0,
                        request=tb.Request):
    """n requests sharing one system prompt + a unique per-request tail."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        tail = tuple(rng.randint(1, vocab - 1) for _ in range(suffix_len))
        out.append(request(rid=i, prompt=tuple(shared) + tail,
                           max_new=max_new, arrival=0.0))
    return out


def test_paged_decode_bit_equal_sync_and_pages_all_freed(params):
    dense = make_engine(params)
    assert dense.warmup() == {"prefill": 1, "insert": 1, "decode": 1}
    paged = make_engine(params, page_size=4)
    assert paged.warmup() == {"prefill": 1, "insert": 1, "decode": 1}
    reqs = tb.synchronized_trace(3, prompt_len=8, max_new=6, seed=1,
                                 vocab=CFG.vocab)
    r1 = dense.serve(list(reqs))
    r2 = paged.serve(list(reqs))
    for r in reqs:
        assert r1.tokens(r.rid) == r2.tokens(r.rid), \
            f"req {r.rid}: paged decode diverged from dense"
    assert r2.page_ledger_exact
    assert r2.page_ledger["held"] == 0
    assert r2.page_ledger["free"] == paged.pages.n_pages - 1
    assert r2.observed_vectors == r2.useful_vectors


def test_paged_decode_ragged_bit_equal_no_new_shapes(params):
    dense = make_engine(params, decode_chunk=3)
    dense.warmup()
    paged = make_engine(params, page_size=4, decode_chunk=3)
    counts = paged.warmup()
    assert counts["decode"] == len(ServeEngine.chunk_ladder(3))
    reqs = tb.poisson_trace(10, rate=400.0, seed=5, prompt_len=(2, 8),
                            max_new=(1, 7), vocab=CFG.vocab)
    r1 = dense.serve(list(reqs))
    r2 = paged.serve(list(reqs))
    for r in reqs:
        assert r1.tokens(r.rid) == r2.tokens(r.rid), \
            f"req {r.rid}: paged decode diverged on the ragged trace"
    assert paged.compile_counts() == counts, \
        "ragged trace gave a paged closure a new shape after warmup"
    assert r2.page_ledger_exact and r2.page_ledger["held"] == 0


def test_prefix_cache_exactly_once_equals_reference_engine(jparams, params):
    """8 requests share 8 prompt tokens (2 pages of 4) on the programmed
    path with a fixed DAC scale: the port's paged engine emits its dense
    engine's tokens and the reference paged engine's tokens, with the
    reference's per-request prefill vectors, hits and hit vectors."""
    jcfg = ja.AimcConfig(impl="ref", input_scale=0.1)
    jprog = jp.program_model(jparams, jp.MappingPlan(), jcfg,
                             jax.random.PRNGKey(3))
    shared = tuple(range(1, 9))
    jreqs = shared_prompt_trace(8, shared, 3, CFG.vocab, max_new=4, seed=2,
                                request=jb.Request)
    jeng = JEngine(jget(ARCH).model_module(), jget(ARCH).smoke_cfg,
                   JExe(mode="aimc", aimc=jcfg, compute_dtype="float32",
                        programmed=True),
                   jprog.install(jparams), n_slots=3, prompt_pad=12,
                   max_seq=24, family=SPEC.family, module=SPEC.module,
                   program=jprog, page_size=4, prefix_cache=True)
    jeng.warmup()
    rj = jeng.serve(jreqs)

    from repro_torch.core import prng
    tcfg = ta.AimcConfig(input_scale=0.1)
    prog = tp.program_model(params, tp.MappingPlan(), tcfg, prng.PRNGKey(3))
    exe = TExe(mode="aimc", aimc=tcfg, compute_dtype="float32",
               programmed=True)
    inst = prog.install(params)
    kw = dict(n_slots=3, prompt_pad=12, max_seq=24, program=prog, exe=exe)
    dense = make_engine(inst, **kw)
    dense.warmup()
    paged = make_engine(inst, page_size=4, prefix_cache=True, **kw)
    counts = paged.warmup()
    assert counts["prefill_chunk"] == 1 and counts["register"] == 1
    reqs = shared_prompt_trace(8, shared, 3, CFG.vocab, max_new=4, seed=2)
    r1 = dense.serve(list(reqs))
    r2 = paged.serve(list(reqs))
    for r in reqs:
        assert r2.tokens(r.rid) == r1.tokens(r.rid), \
            f"req {r.rid}: prefix-cache serving changed the output"
        assert r2.tokens(r.rid) == rj.tokens(r.rid), \
            f"req {r.rid}: differs from the reference paged engine"
        assert (r2.records[r.rid].prefill_vectors
                == rj.records[r.rid].prefill_vectors)
    assert r2.records[0].prefill_vectors == 11
    assert all(r2.records[i].prefill_vectors == 3 for i in range(1, 8))
    assert (r2.prefix_hits, r2.prefix_hit_vectors) == \
        (rj.prefix_hits, rj.prefix_hit_vectors) == (7, 7 * 8)
    assert r2.observed_vectors == r2.useful_vectors
    led, static = tb.reconcile(prog, r2.records, r2.observed_vectors)
    assert led == static
    assert r2.page_ledger_exact
    assert r2.page_ledger["held"] == len(paged.prefix) == \
        rj.page_ledger["held"]
    assert paged.compile_counts() == counts


def test_prefix_pool_outlives_session(params):
    eng = make_engine(params, n_slots=2, page_size=4, prefix_cache=True)
    eng.warmup()
    shared = tuple(range(3, 11))
    reqs = shared_prompt_trace(2, shared, 0, CFG.vocab, max_new=3, seed=4)
    r1 = eng.serve(list(reqs))
    # sharing is capped one token short of the prompt (the legs must
    # produce the first-token logits): 8 tokens / P=4 -> 1 page reused
    assert r1.records[1].prefill_vectors == 8 - 4
    r2 = eng.serve(list(shared_prompt_trace(2, shared, 0, CFG.vocab,
                                            max_new=3, seed=5)))
    assert r2.prefix_hits == 2
    assert all(rec.prefill_vectors == 4 for rec in r2.records.values())
    assert r1.tokens(0) == r2.tokens(0)
    assert r2.page_ledger_exact


def test_chunked_prefill_bit_equal_and_cuts_pad_waste(params):
    kw = dict(n_slots=3, prompt_pad=12, max_seq=24)
    dense = make_engine(params, **kw)
    dense.warmup()
    paged = make_engine(params, page_size=4, prefill_chunk=4, **kw)
    counts = paged.warmup()
    reqs = tb.poisson_trace(10, rate=400.0, seed=9, prompt_len=(2, 12),
                            max_new=(1, 7), vocab=CFG.vocab)
    r1 = dense.serve(list(reqs))
    r2 = paged.serve(list(reqs))
    for r in reqs:
        assert r1.tokens(r.rid) == r2.tokens(r.rid), \
            f"req {r.rid}: chunked prefill changed the output"
    assert paged.compile_counts() == counts
    assert r2.prefill_pad_vectors < r1.prefill_pad_vectors
    assert r2.prefill_chunks >= r2.n_prefills
    assert r2.observed_vectors == r2.useful_vectors
    assert r2.page_ledger_exact and r2.page_ledger["held"] == 0


def test_prefix_plus_chunk_interleaved_books_close(params):
    kw = dict(n_slots=2, prompt_pad=12, max_seq=24)
    dense = make_engine(params, **kw)
    dense.warmup()
    paged = make_engine(params, page_size=4, prefix_cache=True,
                        prefill_chunk=4, **kw)
    counts = paged.warmup()
    reqs = shared_prompt_trace(6, tuple(range(5, 13)), 4, CFG.vocab,
                               max_new=4, seed=6)
    r1 = dense.serve(list(reqs))
    r2 = paged.serve(list(reqs))
    for r in reqs:
        assert r1.tokens(r.rid) == r2.tokens(r.rid)
    assert r2.prefix_hits >= 1
    assert r2.observed_vectors == r2.useful_vectors
    assert r2.page_ledger_exact
    assert r2.page_ledger["held"] == len(paged.prefix)
    assert paged.compile_counts() == counts


def test_legged_eos_retires_and_frees_pages(params):
    """An EOS taken from what the legged engine emits at run time retires
    that request at its first token or mid-decode; its pages go back and
    the other requests keep their tokens (digital lanes are
    independent)."""
    kw = dict(n_slots=3, prompt_pad=8, max_seq=20, page_size=4,
              prefill_chunk=4)
    reqs = tb.synchronized_trace(3, prompt_len=8, max_new=6, seed=3,
                                 vocab=CFG.vocab)
    free = make_engine(params, **kw).serve(list(reqs))
    eos = free.tokens(1)[2]
    rep = make_engine(params, eos_id=eos, **kw).serve(list(reqs))
    for rid, rec in rep.records.items():
        toks = free.tokens(rid)
        cut = toks.index(eos) if eos in toks else len(toks)
        assert rec.tokens == toks[:cut]
        assert rec.finish_reason == ("eos" if eos in toks else "length")
    assert rep.page_ledger_exact and rep.page_ledger["held"] == 0
    assert rep.observed_vectors == rep.useful_vectors


def test_paged_config_validation(params):
    with pytest.raises(ValueError, match="require page_size"):
        make_engine(params, prefix_cache=True)
    with pytest.raises(ValueError, match="require page_size"):
        make_engine(params, prefill_chunk=4)
    with pytest.raises(ValueError, match="> max_seq"):
        make_engine(params, page_size=64)
    with pytest.raises(ValueError, match="max-length request"):
        make_engine(params, page_size=4, n_pages=4)   # needs 24/4 + 1 = 7
    with pytest.raises(ValueError, match="float32"):
        make_engine(params, page_size=4, prefix_cache=True,
                    cache_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"prompt_pad 8 > max_seq"):
        make_engine(params, max_seq=4)
    with pytest.raises(ValueError, match="enc-dec"):
        make_engine(params, family="audio")
    with pytest.raises(ValueError, match="transformer module"):
        make_engine(params, page_size=4, module="encdec")
    with pytest.raises(ValueError, match="multiple of page_size"):
        make_engine(params, page_size=4, prefix_cache=True, prefill_chunk=6,
                    module="xlstm")
    moe = dataclasses.replace(CFG, n_experts=4, top_k=2)
    with pytest.raises(ValueError, match="MoE"):
        make_engine(params, cfg=moe, page_size=4, prefix_cache=True)
    # paged decode (no legs) serves any cache dtype
    make_engine(params, page_size=4, cache_dtype=torch.bfloat16)


def test_vlm_validation():
    """internvl2's patch prefix: prompt_pad must hold it, prompts must
    cover it, and legs cannot carry it; dense and paged decode serve it."""
    spec = get_arch("internvl2-1b")
    cfg = spec.smoke_cfg
    from repro_torch.core import prng
    p = spec.model_module().init(prng.PRNGKey(0), cfg, device="cpu")
    kw = dict(family="vlm", module="transformer", cfg=cfg, n_slots=2,
              max_seq=16)
    with pytest.raises(ValueError, match="patch positions"):
        make_engine(p, prompt_pad=cfg.n_patches - 1, **kw)
    with pytest.raises(ValueError, match="cannot serve vlm"):
        make_engine(p, prompt_pad=10, page_size=4, prefix_cache=True, **kw)
    eng = make_engine(p, prompt_pad=10, page_size=4, **kw)
    with pytest.raises(ValueError, match="< n_patches"):
        eng.serve([tb.Request(rid=0, prompt=(1, 2, 3), max_new=2)])
    reqs = tb.synchronized_trace(2, prompt_len=10, max_new=4, seed=0,
                                 vocab=cfg.vocab)
    dense = make_engine(p, prompt_pad=10, **kw).serve(list(reqs))
    paged = eng.serve(list(reqs))
    assert [dense.tokens(r.rid) for r in reqs] == \
        [paged.tokens(r.rid) for r in reqs]


@pytest.mark.parametrize("extra", [
    ["--exec", "aimc", "--prefix-cache", "--shared-prefix", "8"],
    ["--prefix-cache", "--prefill-chunk", "4", "--shared-prefix", "8"]],
    ids=["prefix-aimc", "prefix+chunk"])
def test_paged_verify_cli_exits_zero(extra):
    run = tserve.main(["--arch", "llama3.2-3b", "--smoke", "--requests", "4",
                       "--prompt-len", "12", "--gen", "4", "--slots", "4",
                       "--page-size", "4", "--paged-verify", "--device",
                       "cpu"] + extra)
    rep = run.report
    assert rep.page_ledger_exact and len(rep.records) == 4
    if "--prefill-chunk" not in extra:
        # synchronized and unchunked: one producer, three sharers
        assert sorted(r.prefill_vectors for r in rep.records.values()) == \
            [4, 4, 4, 12]
    with pytest.raises(SystemExit):
        tserve.main(["--smoke", "--device", "cpu", "--prefix-cache"])
