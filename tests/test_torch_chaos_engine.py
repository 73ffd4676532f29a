"""Mid-trace recovery through the port's engine against the JAX engine
(DESIGN.md §14): a kill trace and a corruption trace on granite-8b's smoke
config over 2 cores, the heartbeat, the engine's wiring checks, and the
CLI's --chaos / --drift / --heartbeat.

The JAX engine is built once for the module and serves the unfaulted, the
kill and the corruption trace in turn (its compiled closures take the
parameter tree as an argument, so each run only swaps the tree, the
monitor and the injector). Arrivals are all at t=0 (ragged prompts and
budgets), so both engines admit, dispatch and probe on the same chunk
boundaries; the DAC scale is fixed at 0.1, as in the reference's own test.
Tolerance: tokens, retirements, fault and recal events (reasons, cores,
matrices, CM_INITIALIZE), probe counts and per-request CM_* books are
equal; the faulted tokens equal the unfaulted run's."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core import program as jp
from repro.core.schedule import CoreSchedule as JSchedule
from repro.models.layers import Execution as JExe
from repro.runtime import batcher as jb
from repro.runtime import chaos as jchaos
from repro.runtime import health as jhealth
from repro.runtime.engine import ServeEngine as JEngine
from repro_torch.configs import get_arch as tget
from repro_torch.core import aimc as ta
from repro_torch.core import program as tp
from repro_torch.core.prng import PRNGKey
from repro_torch.core.schedule import CoreSchedule as TSchedule
from repro_torch.launch import serve as tserve
from repro_torch.models.layers import Execution as TExe
from repro_torch.runtime import batcher as tb
from repro_torch.runtime import chaos as tchaos
from repro_torch.runtime import health as thealth
from repro_torch.runtime.engine import ServeEngine as TEngine
from repro_torch.runtime.fault_tolerance import Heartbeat

SCALE, KEY = 0.1, 3
ENGINE_KW = dict(n_slots=3, prompt_pad=8, max_seq=24, decode_chunk=4)


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v.numpy())
            for k, v in tree.items()}


def _trace(n, seed, max_new):
    """A ragged trace (prompts 3-8 tokens, budgets ``max_new``) all
    arriving at t=0."""
    return [dataclasses.replace(r, arrival=0.0) for r in tb.poisson_trace(
        n, 300.0, seed=seed, prompt_len=(3, 8), max_new=max_new,
        vocab=tget("granite-8b").smoke_cfg.vocab)]


@pytest.fixture(scope="module")
def fx():
    tm = tget("granite-8b")
    tparams = tm.model_module().init(PRNGKey(0), tm.smoke_cfg, device="cpu")
    jparams = _to_jax(tparams)
    tplan, jplan = tp.MappingPlan(n_contexts=2), jp.MappingPlan(n_contexts=2)
    tprog = tp.program_model(tparams, tplan, ta.AimcConfig(input_scale=SCALE),
                             PRNGKey(KEY))
    jprog = jp.program_model(jparams, jplan,
                             ja.AimcConfig(impl="ref", input_scale=SCALE),
                             jax.random.PRNGKey(KEY))
    spec = get_arch("granite-8b")
    jeng = JEngine(spec.model_module(), spec.smoke_cfg,
                   JExe(mode="aimc", aimc=jprog.cfg, compute_dtype="float32",
                        programmed=True),
                   jprog.install(jparams), family=spec.family,
                   module=spec.module, program=jprog,
                   schedule=JSchedule.from_program(jprog),
                   cache_dtype=jnp.float32, **ENGINE_KW)
    jeng.warmup()
    return tparams, jparams, tprog, jprog, tplan, jplan, jeng


def _jax_serve(fx, reqs, spec=""):
    """Serve ``reqs`` on the module's JAX engine, reset to a fresh program
    (and, with a chaos ``spec``, a fresh monitor and injector)."""
    _, jparams, _, jprog, _, jplan, eng = fx
    eng.params = jprog.install(jparams)
    eng.program, eng.schedule = jprog, JSchedule.from_program(jprog)
    eng.health = eng.chaos = None
    if spec:
        eng.health = jhealth.build_health(jprog, jparams, jplan,
                                          jax.random.PRNGKey(KEY))
        eng.chaos = jchaos.parse_chaos(spec)
    eng._chunks_dispatched = 0
    return eng.serve([jb.Request(**dataclasses.asdict(r)) for r in reqs])


def _port_engine(fx, spec="", **kw):
    tparams, _, tprog, _, tplan, _, _ = fx
    tm = tget("granite-8b")
    health = chaos = None
    if spec:
        health = thealth.build_health(tprog, tparams, tplan, PRNGKey(KEY))
        chaos = tchaos.parse_chaos(spec)
    eng = TEngine(tm.model_module(), tm.smoke_cfg,
                  TExe(mode="aimc", aimc=tprog.cfg, compute_dtype="float32",
                       programmed=True),
                  tprog.install(tparams), family=tm.family, module=tm.module,
                  program=tprog, schedule=TSchedule.from_program(tprog),
                  health=health, chaos=chaos, **ENGINE_KW, **kw)
    eng.warmup()
    return eng


def _events(report):
    return ([e.describe() for e in report.fault_events],
            [(e.reason, e.cores, e.names, e.initialize)
             for e in report.recal_events],
            report.probes, report.n_recals, report.recal_initialize)


def _books(eng, report):
    return {rid: dataclasses.astuple(cm)
            for rid, cm in eng.ledgers(report).items()}


def _tokens(report):
    return {rid: (list(rec.tokens), rec.finish_reason)
            for rid, rec in report.records.items()}


@pytest.mark.parametrize("spec,seed,max_new,reason", [
    ("kill:1@2", 9, (1, 9), "dead_core"),
    ("corrupt:0@1:0.5", 4, (2, 8), "fault")], ids=["kill", "corrupt"])
def test_faulted_engine_matches_reference(fx, spec, seed, max_new, reason):
    tprog, jprog = fx[2], fx[3]
    reqs = _trace(8 if reason == "dead_core" else 6, seed, max_new)
    ref_j = _jax_serve(fx, reqs)
    rep_j = _jax_serve(fx, reqs, spec)
    jeng = fx[6]
    eng = _port_engine(fx, spec)
    rep_t = eng.serve(list(reqs))
    # recovery is invisible in the tokens, on both sides
    assert _tokens(rep_t) == _tokens(rep_j) == _tokens(ref_j)
    assert _tokens(_port_engine(fx).serve(list(reqs))) == _tokens(rep_t)
    assert _events(rep_t) == _events(rep_j)
    assert eng.chaos.exhausted and rep_t.n_recals >= 1
    assert rep_t.recal_events[0].reason == reason
    assert set(rep_t.records) == {r.rid for r in reqs}
    assert eng.program.contexts == jeng.program.contexts
    if reason == "dead_core":
        assert 1 not in eng.program.contexts and eng.health.dead == set()
        # the engine's schedule follows the remapped program
        assert {s.core for s in eng.schedule.shards} == {0}
    else:
        assert eng.program.contexts == tprog.contexts   # repaired in place
    led, static = tb.reconcile(eng.program, rep_t.records,
                               rep_t.observed_vectors)
    assert led == static
    assert _books(eng, rep_t) == _books(jeng, rep_j)
    assert thealth.reconcile_recal(eng.program, rep_t)
    assert rep_t.recal_initialize == tprog.reprogram_counts(
        rep_t.recal_events[0].names).initialize
    assert jprog.reprogram_counts(rep_t.recal_events[0].names).initialize \
        == rep_t.recal_initialize
    # the recal chunk is exempt from the straggler EWMA
    assert len(eng.monitor.exempted) >= 1 and eng.monitor.flagged == []


def test_heartbeat_beats_once_per_chunk(fx, tmp_path, monkeypatch):
    hb = Heartbeat(str(tmp_path / "hb.json"))
    beats = []
    orig = hb.beat
    monkeypatch.setattr(hb, "beat", lambda step, **kw: (beats.append(step),
                                                       orig(step, **kw)))
    eng = _port_engine(fx, heartbeat=hb)
    rep = eng.serve(_trace(4, 2, (2, 6)))
    assert len(beats) == eng._chunks_dispatched > 0
    assert beats == sorted(beats) and beats[-1] == rep.n_steps
    beat = hb.read()
    for field in ("step", "time", "slots_busy", "slots_free", "chunk_len",
                  "last_chunk_s", "wall_decode_s", "n_recals"):
        assert field in beat, field
    assert beat["slots_busy"] + beat["slots_free"] == eng.n_slots
    assert beat["n_recals"] == 0


def test_engine_validates_health_and_chaos_wiring(fx):
    tparams, _, tprog, _, tplan, _, _ = fx
    tm = tget("granite-8b")
    health = thealth.build_health(tprog, tparams, tplan, PRNGKey(KEY))
    with pytest.raises(ValueError, match="requires an AimcProgram"):
        TEngine(tm.model_module(), tm.smoke_cfg, TExe(compute_dtype="float32"),
                tparams, health=health)
    with pytest.raises(ValueError, match="requires a HealthMonitor"):
        TEngine(tm.model_module(), tm.smoke_cfg, TExe(compute_dtype="float32"),
                tparams, program=tprog, chaos=tchaos.parse_chaos("kill:1@2"))


def _cli(*extra):
    return tserve.main(["--arch", "granite-8b", "--smoke", "--exec", "aimc",
                        "--requests", "6", "--prompt-len", "8", "--gen", "6",
                        "--slots", "3", "--decode-chunk", "2", "--cores", "2",
                        "--input-scale", "0.1", "--device", "cpu", *extra])


def test_cli_chaos_drift_and_heartbeat(tmp_path):
    """`make serve-chaos`'s events through the port's CLI: both fire, the
    recal reasons are fault then dead_core, the books close (the CLI exits
    non-zero otherwise) and the tokens are the unfaulted run's; --drift
    re-trips the probe and recalibrates with reason drift."""
    base = _cli()
    hb = tmp_path / "hb.json"
    run = _cli("--chaos", "corrupt:0@1:0.5,kill:1@3", "--heartbeat", str(hb))
    rep = run.report
    assert [e.reason for e in rep.recal_events] == ["fault", "dead_core"]
    assert len(rep.fault_events) == 2
    assert 1 not in run.engine.program.contexts
    assert _tokens(rep) == _tokens(base.report)
    assert Heartbeat(str(hb)).read()["n_recals"] == 2
    drift = _cli("--drift", "0.3", "--drift-t0", "1e-6")
    assert drift.report.n_recals >= 1
    assert {e.reason for e in drift.report.recal_events} == {"drift"}


@pytest.mark.parametrize("argv", [
    ["--chaos", "kill:1@2", "--exec", "aimc"],            # one core
    ["--chaos", "kill:1@2", "--cores", "2"],              # digital
    ["--drift", "0.1"],                                   # digital
    ["--drift", "-0.1", "--exec", "aimc"],
    ["--drift", "0.1", "--exec", "aimc", "--static"]])
def test_cli_refuses_what_the_reference_refuses(argv):
    from repro.launch import serve as jserve
    with pytest.raises(SystemExit):
        jserve.parse_args(argv)
    with pytest.raises(SystemExit):
        tserve.parse_args(argv)


def test_cli_refuses_drift_on_fused_stacks():
    with pytest.raises(SystemExit):
        tserve.parse_args(["--drift", "0.1", "--exec", "aimc",
                           "--fuse-gates"])
