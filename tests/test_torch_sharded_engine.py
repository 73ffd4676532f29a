"""The port's sharded serving engine (`repro_torch.runtime.engine.
ShardedServeEngine`) on CPU meshes of positions, held to the JAX
reference's single-device `ServeEngine` on the same weights (the JAX init,
carried across with `params_from_numpy`), the same program (both programmed
under `PRNGKey(2)`) and the same trace: the reference's own claim is that
its sharded engine emits the single-device engine's tokens bit for bit
(`repro/runtime/engine.py:1807-1810`), so the single-device JAX engine is
the oracle at every mesh. The reference's sharded engine itself runs as
the oracle of `tests/test_torch_mesh_serve.py` (on 4 forced host devices,
its mesh built with ``Auto`` axes, `tests/torch_mesh_oracle.py`). As a
second check,
every sharded run also equals the port's own single-device `ServeEngine`
on the same trace, books included.

Meshes (1,1), (2,1), (1,2) and (2,2) over ("data", "model"), every
position on the CPU. Configs: granite smoke programmed (dynamic and fixed
DAC scale) and digital; xlstm (d_model 128), rglru (d_ff 256) and olmoe
(expert d_ff 256) smoke, programmed: the smoke widths are widened just so
far that every family has states whose Np divides 256, so model:2 really
splits them into column pieces (and others stay whole: the 128-aligned
rule). Pinned: tokens, finish reasons, `compile_counts` after warmup, one
kernel call per column piece (counted at the dispatch, the plain version
here), the CM_* ledgers, `reconcile_cores` and `device_ledgers` against
the schedule's totals; paged, prefix-cache, legged and snapshot runs equal
to their single-device twins with the same books; a chaos run at a fixed
DAC scale; rotation refused; a read key on a split state draws the
whole's noise.
Tolerance: tokens equal; books equal (integers). Every request arrives
before the first decode step (rate 1e7), so both frameworks decode the same
batches and with them the same dynamic DAC scale; the Poisson trace runs
at a fixed DAC scale, whose lanes do not depend on the batch."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses
import functools

import jax
import jax.numpy as jnp
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
from repro_torch.core import isa
from repro_torch.core.prng import PRNGKey
from repro_torch.core.program import MappingPlan, installed_entries, \
    program_model
from repro_torch.core.schedule import CoreSchedule
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import Execution
from repro_torch.runtime import batcher as tb
from repro_torch.runtime.engine import ServeEngine, ShardedServeEngine

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
WIDEN = {"granite-8b": {}, "xlstm-350m": {"d_model": 128},
         "recurrentgemma-9b": {"d_ff": 256}, "olmoe-1b-7b": {"d_ff": 256}}
# name -> (arch, exec, fixed DAC scale)
CONFIGS = {"granite-dyn": ("granite-8b", "aimc", 0.0),
           "granite-fixed": ("granite-8b", "aimc", 0.1),
           "granite-digital": ("granite-8b", "digital", 0.0),
           "xlstm": ("xlstm-350m", "aimc", 0.0),
           "rglru": ("recurrentgemma-9b", "aimc", 0.0),
           "olmoe": ("olmoe-1b-7b", "aimc", 0.0)}
PROMPT, GEN = 8, 6


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), ["cpu"])


@functools.lru_cache(maxsize=None)
def _jax_weights(arch):
    """The JAX init of the widened smoke config, seed 0."""
    spec = jget(arch)
    cfg = dataclasses.replace(spec.smoke_cfg, **WIDEN[arch])
    return cfg, spec.model_module().init(jax.random.PRNGKey(0), cfg)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(spec, cfg, exe, installed params, program, schedule) on the CPU,
    on the JAX init's weights; two cores, so the schedule splits the books
    over the model axis."""
    arch, mode, scale = CONFIGS[name]
    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.smoke_cfg, **WIDEN[arch])
    params = params_from_numpy(jax.tree.map(np.asarray,
                                            _jax_weights(arch)[1]))
    if mode == "digital":
        return spec, cfg, Execution(compute_dtype="float32"), params, None, \
            None
    acfg = ta.AimcConfig(input_scale=scale)
    prog = program_model(params, MappingPlan(n_contexts=2), acfg,
                         PRNGKey(2))
    exe = Execution(mode="aimc", aimc=acfg, compute_dtype="float32",
                    programmed=True)
    return spec, cfg, exe, prog.install(params), prog, \
        CoreSchedule.from_program(prog)


def _trace(cfg, rate=1e7, n=4, seed=0, shared=0):
    reqs = tb.poisson_trace(n, rate, seed=seed, prompt_len=(PROMPT // 2,
                                                             PROMPT),
                            max_new=(2, GEN), vocab=cfg.vocab)
    if shared:
        head = list(reqs[0].prompt[:shared]) + [1] * shared
        reqs = [dataclasses.replace(r, prompt=head[:shared]
                                    + list(r.prompt[shared:]) + [3])
                for r in reqs]
    return reqs


COMMON = dict(n_slots=4, prompt_pad=PROMPT + 1, max_seq=PROMPT + 1 + GEN,
              decode_chunk=2)


def _engine(name, mesh=None, **kw):
    spec, cfg, exe, params, prog, sched = _setup(name)
    common = dict(COMMON, family=spec.family, module=spec.module,
                  program=prog, schedule=sched)
    common.update(kw)
    if mesh is None:
        return ServeEngine(spec.model_module(), cfg, exe, params, **common)
    return ShardedServeEngine(spec.model_module(), cfg, exe, params,
                              mesh=_mesh(mesh), **common)


class _Calls:
    """Kernel dispatches (one per launch on the card) during a block."""

    NAMES = ("aimc_matmul_v2", "aimc_matmul_stacked", "aimc_matmul_experts")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.NAMES:
            orig = getattr(kernel_ops, name)

            def counted(*a, _orig=orig, **k):
                self.n += 1
                return _orig(*a, **k)
            monkeypatch.setattr(kernel_ops, name, counted)


def _calls_per_pass(params, mesh):
    """Kernel calls one forward pass makes, reckoned here from each
    programmed state's padded Np (not from the placement's own rule): a
    state runs once per layer, as M column pieces where Np divides 128 x M
    (M the model axis) and whole elsewhere."""
    m = mesh[1]
    return sum((m if st.w_q.shape[-1] % (128 * m) == 0 else 1)
               * st.w_q.shape[0] for st in installed_entries(params).values())


def _served(eng, reqs):
    counts = eng.warmup()
    return eng.serve(reqs), counts


@functools.lru_cache(maxsize=None)
def _jax_report(name, rate, shared, engine_kw):
    """The JAX single-device engine's report on the same weights, program
    and trace (the oracle)."""
    arch, mode, scale = CONFIGS[name]
    spec = jget(arch)
    cfg, params = _jax_weights(arch)
    program, exe = None, JExe(compute_dtype="float32")
    if mode == "aimc":
        acfg = ja.AimcConfig(impl="ref", input_scale=scale)
        program = jp.program_model(params, jp.MappingPlan(n_contexts=2),
                                   acfg, jax.random.PRNGKey(2))
        params = program.install(params)
        exe = JExe(mode="aimc", aimc=acfg, compute_dtype="float32",
                   programmed=True)
    eng = JEngine(spec.model_module(), cfg, exe, params,
                  cache_dtype=jnp.float32, family=spec.family,
                  module=spec.module, program=program,
                  **(COMMON | dict(engine_kw)))
    eng.warmup()
    reqs = _trace(_setup(name)[1], rate, shared=shared)
    return eng.serve([jb.Request(**dataclasses.asdict(r)) for r in reqs])


def _same_as_reference(rep, name, rate=1e7, shared=0, **engine_kw):
    """Tokens and finish reasons equal the JAX engine's; on a trace that
    arrives at once, so do the per-request vector books."""
    want = _jax_report(name, rate, shared, tuple(sorted(engine_kw.items())))
    _same_tokens(rep, want)
    if rate < 1e7:
        return
    for field in ("n_prefills", "prefix_hits", "prefix_hit_vectors",
                  "prefill_chunks"):
        assert getattr(rep, field) == getattr(want, field), field
    for rid, rec in want.records.items():
        got = rep.records[rid]
        assert (got.prefill_vectors, got.decode_vectors, got.pad_vectors) \
            == (rec.prefill_vectors, rec.decode_vectors, rec.pad_vectors)


@functools.lru_cache(maxsize=None)
def _oracle(name, rate=1e7):
    eng = _engine(name)
    rep, counts = _served(eng, _trace(_setup(name)[1], rate))
    return rep, counts


def _same_tokens(rep, want):
    assert set(rep.records) == set(want.records)
    for rid, rec in want.records.items():
        assert rep.tokens(rid) == rec.tokens, f"request {rid} diverged"
        assert rep.records[rid].finish_reason == rec.finish_reason


def _books_close(eng, rep):
    prog, sched = eng.program, eng.schedule
    led, static = tb.reconcile(prog, rep.records, rep.observed_vectors)
    assert led == static
    core_sum, sched_total = tb.reconcile_cores(sched, rep.records,
                                               rep.observed_vectors)
    assert core_sum == sched_total
    devs = eng.device_ledgers(rep)
    assert sorted(devs) == list(range(min(eng.mesh.shape["model"],
                                          sched.n_cores)))
    assert isa.total(devs.values()) == \
        sched.ledger_totals().scaled(rep.useful_vectors)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_tokens_equal_single_device(name, mesh, monkeypatch):
    want, counts0 = _oracle(name)
    eng = _engine(name, mesh)
    calls = _Calls(monkeypatch)
    rep, counts = _served(eng, _trace(eng.cfg))
    _same_as_reference(rep, name)
    _same_tokens(rep, want)
    assert counts == counts0
    assert eng.compile_counts() == counts0     # nothing new after warmup
    assert rep.observed_vectors == rep.useful_vectors
    if eng.program is not None:
        assert calls.n == eng.forward_passes * _calls_per_pass(eng.params,
                                                               mesh)
        _books_close(eng, rep)


def test_model_axis_really_splits(monkeypatch):
    """At model:2 a granite smoke pass runs w_gate and w_up as two pieces
    each (Np 256) and the 128-wide states whole: 7 + 2 calls per layer."""
    eng = _engine("granite-dyn", (2, 2))
    for path, st in installed_entries(eng.params).items():
        want = 2 if path.endswith(("w_gate", "w_up")) else 0
        assert len(st.pieces) == want, path
    assert _calls_per_pass(eng.params, (2, 2)) == 2 * 9
    assert _calls_per_pass(eng.params, (1, 1)) == 2 * 7
    eng.warmup()
    before = eng.forward_passes
    calls = _Calls(monkeypatch)
    eng.serve(_trace(eng.cfg))
    assert calls.n == 18 * (eng.forward_passes - before)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2)])
def test_sharded_poisson_trace_equals_single_device(mesh):
    want, counts0 = _oracle("granite-fixed", 300.0)
    eng = _engine("granite-fixed", mesh)
    rep, counts = _served(eng, _trace(eng.cfg, 300.0))
    _same_as_reference(rep, "granite-fixed", 300.0)
    _same_tokens(rep, want)
    assert eng.compile_counts() == counts0
    _books_close(eng, rep)


def _paged_pair(name, mesh, trace_kw, **kw):
    base = _engine(name, **kw)
    want, c0 = _served(base, _trace(base.cfg, **trace_kw))
    eng = _engine(name, mesh, **kw)
    rep, c1 = _served(eng, _trace(eng.cfg, **trace_kw))
    _same_as_reference(rep, name, **trace_kw, **kw)
    _same_tokens(rep, want)
    assert c1 == c0 and eng.compile_counts() == base.compile_counts()
    for field in ("prefix_hits", "prefix_hit_vectors", "prefill_chunks",
                  "n_prefills", "page_evictions", "observed_vectors"):
        assert getattr(rep, field) == getattr(want, field), field
    assert rep.page_ledger == want.page_ledger
    assert rep.page_ledger_exact
    for rid, rec in want.records.items():
        assert rep.records[rid].prefill_vectors == rec.prefill_vectors
    return eng, rep


PAGED = [
    ("granite-dyn", {}, {"page_size": 4, "n_pages": 24}),
    ("granite-dyn", {"shared": 4}, {"page_size": 4, "prefix_cache": True,
                                    "n_pages": 24}),
    # chunked legs interleave with decode chunks; arrivals at t=0 keep the
    # admission order (and so the dynamic DAC scale's batches) off the
    # wall clock
    ("granite-dyn", {"shared": 4},
     {"page_size": 4, "prefix_cache": True, "prefill_chunk": 4,
      "n_pages": 24}),
    ("olmoe", {}, {"page_size": 4, "n_pages": 24}),
    ("xlstm", {"shared": 4}, {"page_size": 2, "prefix_cache": True}),
    ("rglru", {"shared": 4}, {"page_size": 2, "prefix_cache": True,
                              "prefill_chunk": 4}),
]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name,trace_kw,kw", PAGED)
def test_sharded_paged_and_snapshots_equal_single_device(name, trace_kw, kw,
                                                         mesh):
    eng, rep = _paged_pair(name, mesh, trace_kw, **kw)
    if eng._paged_kv:
        cache = eng.begin().cache
        # pools split at the page axis over data, table and lengths at
        # the slot axis (n_pages 24 and n_slots 4 both divide data:2)
        assert cache["kp"].counts[1] == mesh[0]
        assert cache["pt"].counts[0] == mesh[0]
    if kw.get("prefix_cache") and not kw.get("prefill_chunk"):
        assert rep.prefix_hits > 0
    _books_close(eng, rep)


def test_lane_state_lives_on_its_data_position():
    eng = _engine("granite-dyn", (2, 2))
    eng.warmup()
    sess = eng.begin()
    k = sess.cache["k"]
    assert k.counts[1] == 2 and len(k.pieces) == 2  # a block per lane pair
    assert sess.tok_buf.counts == (2, 1)
    assert sess.state["active"].counts == (2,)
    eng.admit(sess, tb.Request(rid=0, prompt=[5, 6, 7], max_new=3), 0.0)
    eng.admit(sess, tb.Request(rid=1, prompt=[8, 9], max_new=3), 0.0)
    eng.admit(sess, tb.Request(rid=2, prompt=[3], max_new=3), 0.0)
    rows = sess.state["active"]
    assert rows.piece((0, 0)).tolist() == [True, True]
    assert rows.piece((1, 0)).tolist() == [True, False]
    assert sess.cache["len"].piece((1, 1)).tolist() == [1, 0]


@pytest.mark.parametrize("kw", [{"page_size": 4, "n_pages": 24},
                                {"page_size": 4, "n_pages": 24,
                                 "prefix_cache": True, "prefill_chunk": 4}])
def test_paged_admission_moves_only_the_requests_pages(kw, monkeypatch):
    """A paged insert or prefill leg reads and writes the request's pages
    in the data block that holds each one: no pool is gathered whole, and
    every other page keeps its contents."""
    from repro_torch.launch import shardings
    eng = _engine("granite-dyn", (2, 2), **kw)
    eng.warmup()
    sess = eng.begin()
    before = {n: sess.cache[n].gather("cpu").clone() for n in ("kp", "vp")}
    gathers = []
    real = shardings.Placed.gather
    monkeypatch.setattr(shardings.Placed, "gather",
                        lambda self, d: gathers.append(self.shape)
                        or real(self, d))
    req = tb.Request(rid=0, prompt=tuple(range(3, 3 + PROMPT)), max_new=3)
    eng.admit(sess, req, 0.0)
    while sess.jobs:                      # chunked legs run one at a time
        eng._advance_prefill(sess, 0.0)
    monkeypatch.setattr(shardings.Placed, "gather", real)
    assert gathers == []
    owned = sess.slot_pages[0][0]
    assert owned and all(p != 0 for p in owned)
    pools = {n: sess.cache[n].gather("cpu") for n in ("kp", "vp")}
    for n in ("kp", "vp"):
        other = [p for p in range(kw["n_pages"]) if p not in owned]
        assert torch.equal(pools[n][:, other], before[n][:, other])
        assert not torch.equal(pools[n][:, owned], before[n][:, owned])
    pt = sess.cache["pt"].gather("cpu")[0].tolist()
    assert pt[:len(owned)] == owned


def test_sharded_chaos_equals_single_device_chaos():
    from repro_torch.launch import serve as tserve
    argv = ["--arch", "granite-8b", "--smoke", "--exec", "aimc", "--device",
            "cpu", "--requests", "6", "--prompt-len", "8", "--gen", "6",
            "--slots", "4", "--trace", "poisson:300", "--decode-chunk", "2",
            "--cores", "2", "--input-scale", "0.1",
            "--chaos", "corrupt:0@1:0.5,kill:1@3"]
    one = tserve.main(argv)
    two = tserve.main(argv + ["--mesh", "data:2,model:2"])
    assert isinstance(two.engine, ShardedServeEngine)
    assert two.report.n_recals == one.report.n_recals >= 2
    for rid, rec in one.report.records.items():
        assert two.report.tokens(rid) == rec.tokens
    # repaired states came back whole and were split again
    for path, st in installed_entries(two.engine.params).items():
        want = 2 if path.endswith(("w_gate", "w_up")) else 0
        assert len(st.pieces) == want, path


def test_rotation_refused_and_read_key_on_pieces_raises():
    with pytest.raises(ValueError, match="rotation"):
        _engine("granite-dyn", (2, 2), rotation=object())
    eng = _engine("granite-dyn", (1, 2))
    st = eng.params["blocks"]["w_gate"][0]
    assert len(st.pieces) == 2
    x = torch.randn(3, st.k)
    cfg = eng.exe.aimc
    y = ta.aimc_apply(st, x, cfg)
    whole = dataclasses.replace(st, pieces=())
    assert torch.equal(y, ta.aimc_apply(whole, x, cfg))
    # a read key on the pieces draws the whole launch's noise: each piece's
    # counters carry its column offset and the whole's width
    noisy = dataclasses.replace(cfg, noise=type(cfg.noise)(sigma_read=0.01))
    yk = ta.aimc_apply(st, x, noisy, PRNGKey(1))
    assert torch.equal(yk, ta.aimc_apply(whole, x, noisy, PRNGKey(1)))
    assert not torch.equal(yk, ta.aimc_apply(whole, x, noisy))
