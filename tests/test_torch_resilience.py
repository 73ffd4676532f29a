"""Drift, program ages, remap and health of the port against the JAX
reference (DESIGN.md §14): `core.noise.apply_drift`, the program-age clock
and drift views of `core.program.AimcProgram`, `install_updates`,
`remap_context`, `reprogram_counts`, `runtime.health` probes and bit-exact
recalibration, and `runtime.chaos` spec parsing.

Inputs: granite-8b's smoke weights drawn by the port on JAX's keys and
carried to the reference through numpy, programmed on 2 contexts with a
fixed DAC scale of 0.1 (the reference's own fixture). Tolerances: codes,
scales, ages, gains, tile maps, contexts and CM_* counts are equal
exactly; probe errors agree within 1e-6 and read exactly 0.0 on a fresh or
repaired program; recalibrated states are equal bit for bit."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aimc as ja
from repro.core import noise as jnoise
from repro.core import program as jp
from repro.runtime import chaos as jchaos
from repro.runtime import health as jhealth
from repro_torch.configs import get_arch as tget
from repro_torch.core import aimc as ta
from repro_torch.core import noise as tnoise
from repro_torch.core import program as tp
from repro_torch.core.prng import PRNGKey
from repro_torch.runtime import chaos as tchaos
from repro_torch.runtime import health as thealth

SCALE, KEY = 0.1, 3


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v.numpy())
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def fx():
    """(torch params, jax params, torch program, jax program, plans)."""
    tm = tget("granite-8b")
    tparams = tm.model_module().init(PRNGKey(0), tm.smoke_cfg, device="cpu")
    jparams = _to_jax(tparams)
    tplan, jplan = tp.MappingPlan(n_contexts=2), jp.MappingPlan(n_contexts=2)
    tprog = tp.program_model(tparams, tplan, ta.AimcConfig(input_scale=SCALE),
                             PRNGKey(KEY))
    jprog = jp.program_model(jparams, jplan,
                             ja.AimcConfig(impl="ref", input_scale=SCALE),
                             jax.random.PRNGKey(KEY))
    assert tprog.names == jprog.names and tprog.contexts == jprog.contexts
    return tparams, jparams, tprog, jprog, tplan, jplan


@pytest.fixture(scope="module")
def monitors(fx):
    tparams, jparams, tprog, jprog, tplan, jplan = fx
    return (thealth.build_health(tprog, tparams, tplan, PRNGKey(KEY)),
            jhealth.build_health(jprog, jparams, jplan,
                                 jax.random.PRNGKey(KEY)))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_apply_drift_matches():
    w = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    for nm_t, nm_j in ((tnoise.NoiseModel(drift_t_ratio=10.0, drift_nu=0.1),
                        jnoise.NoiseModel(drift_t_ratio=10.0, drift_nu=0.1)),
                       (tnoise.DISABLED, jnoise.DISABLED)):
        _eq(tnoise.apply_drift(torch.from_numpy(w), nm_t),
            jnoise.apply_drift(jnp.asarray(w), nm_j))


@pytest.mark.parametrize("spread", [0.0, 0.5])
def test_ages_drift_gains_and_aged_entries_equal(fx, spread):
    _, _, tprog, jprog, _, _ = fx
    name = tprog.names[2]
    tprog2 = tprog.reprogrammed({name: tprog.states[2]}, 5.0)
    jprog2 = jprog.reprogrammed({name: jprog.states[2]}, 5.0)
    assert tprog.t_programmed == (0.0,) * len(tprog.names)
    assert tprog2.t_programmed == jprog2.t_programmed
    assert tprog2.ages(7.5) == jprog2.ages(7.5)
    nm_t = tnoise.drift_only(nu=0.1, t0=1.0, core_spread=spread)
    nm_j = jnoise.drift_only(nu=0.1, t0=1.0, core_spread=spread)
    for t in (0.5, 10.0, 100.0):
        assert (tprog2.drift_gains(t, nm_t, seed=4)
                == jprog2.drift_gains(t, nm_j, seed=4))
    aged_t = tprog2.aged_entries(100.0, nm_t)
    aged_j = jprog2.aged_entries(100.0, nm_j)
    assert set(aged_t) == set(aged_j) == set(tprog.names)
    for n in aged_t:
        _eq(aged_t[n].w_q, aged_j[n].w_q)
        _eq(aged_t[n].s_w, aged_j[n].s_w)
    assert tprog2.aged_entries(0.5, nm_t) == {} == jprog2.aged_entries(
        0.5, nm_j)
    with pytest.raises(KeyError):
        tprog.reprogrammed({"nope": tprog.states[0]}, 1.0)


def test_install_updates_swaps_only_named_states(fx):
    tparams, _, tprog, _, _, _ = fx
    installed = tprog.install(tparams)
    name, other = tprog.names[0], tprog.names[1]
    aged = tprog.states[0].with_gain(0.5)
    updated = tprog.install_updates(installed, {name: aged})
    live = tp.installed_entries(updated)
    assert set(live) == set(tprog.names)
    assert live[name] is aged
    assert live[other] is tp.installed_entries(installed)[other]
    assert updated["embed"] is installed["embed"]
    # install over an installed tree leaves the live states as they are
    assert tp.installed_entries(tprog.install(updated))[name] is aged
    with pytest.raises(KeyError):
        tprog.install_updates(installed, {"nope": aged})


def _tile_rows(tm):
    return [dataclasses.astuple(p) for p in tm.placements]


def test_remap_context_equal_tile_maps_and_contexts(fx):
    _, _, tprog, jprog, _, _ = fx
    for dead in (0, 1):
        t2, j2 = tprog.remap_context(dead), jprog.remap_context(dead)
        assert t2.contexts == j2.contexts and dead not in t2.contexts
        assert t2.names == tprog.names
        for tmt, tmj in zip(t2.tile_maps, j2.tile_maps):
            assert tmt.n_tiles == tmj.n_tiles
            assert _tile_rows(tmt) == _tile_rows(tmj)
        assert t2.mvm_counts() == tprog.mvm_counts()
        assert t2.initialize_counts() == tprog.initialize_counts()
    with pytest.raises(ValueError):
        tprog.remap_context(99)


def test_remap_single_context_has_nowhere_to_drain(fx):
    tparams = fx[0]
    single = tp.program_model(tparams, tp.MappingPlan(),
                              ta.AimcConfig(input_scale=SCALE))
    with pytest.raises(tp.CapacityError):
        single.remap_context(0)


def test_reprogram_counts_equal(fx):
    _, _, tprog, jprog, _, _ = fx
    for names in (tprog.names, tprog.names[:2], tprog.names[3:4], ()):
        assert (dataclasses.astuple(tprog.reprogram_counts(names))
                == dataclasses.astuple(jprog.reprogram_counts(names)))
    assert (tprog.reprogram_counts(tprog.names)
            == tprog.initialize_counts())


def test_recalibration_bit_exact(fx, monitors):
    tparams, _, tprog, jprog, tplan, _ = fx
    th, _ = monitors
    for name, st, jst in zip(tprog.names, tprog.states, jprog.states):
        fresh = th.recal.fresh_state(name)
        assert torch.equal(fresh.w_q, st.w_q) and torch.equal(fresh.s_w,
                                                              st.s_w)
        _eq(fresh.w_q, jst.w_q)
        _eq(fresh.s_w, jst.s_w)
    # with programming noise the original keys reproduce the draw
    noisy = ta.AimcConfig(input_scale=SCALE, noise=tnoise.NoiseModel(
        sigma_read=0.0))
    prog = tp.program_model(tparams, tplan, noisy, PRNGKey(KEY))
    rec = thealth.Recalibrator(prog, tparams, tplan, PRNGKey(KEY))
    for name, st in zip(prog.names, prog.states):
        fresh = rec.fresh_state(name)
        assert torch.equal(fresh.w_q, st.w_q), name
        assert torch.equal(fresh.s_w, st.s_w), name
    assert not torch.equal(prog.states[0].w_q, tprog.states[0].w_q)


def test_probe_errors_equal_and_zero_when_fresh(fx, monitors):
    _, _, tprog, jprog, _, _ = fx
    th, jh = monitors
    for name in tprog.names:
        np.testing.assert_allclose(th._probes[name].numpy(),
                                   np.asarray(jh._probes[name]), rtol=1e-6,
                                   atol=1e-6)
        assert abs(th.quant_floor[name] - jh.quant_floor[name]) <= 1e-6
    fresh_t = dict(zip(tprog.names, tprog.states))
    fresh_j = dict(zip(jprog.names, jprog.states))
    s0 = th.probe(fresh_t, 0.0)
    assert set(s0.errors) == {0, 1}
    assert all(e == 0.0 for e in s0.errors.values())
    assert th.failing_cores(s0) == ()
    cases = [
        ({n: st.with_gain(0.9) for n, st in fresh_t.items()},
         {n: st.with_gain(0.9) for n, st in fresh_j.items()}),
        ({**fresh_t, **tchaos.corrupt_entries(tprog, 1, 1.0)},
         {**fresh_j, **jchaos.corrupt_entries(jprog, 1, 1.0)}),
        ({**fresh_t, **tchaos.corrupt_entries(tprog, 0, 0.5)},
         {**fresh_j, **jchaos.corrupt_entries(jprog, 0, 0.5)}),
    ]
    for t_entries, j_entries in cases:
        st, sj = th.probe(t_entries, 1.0), jh.probe(j_entries, 1.0)
        assert set(st.errors) == set(sj.errors)
        for c in st.errors:
            assert abs(st.errors[c] - sj.errors[c]) <= 1e-6, c
        assert th.failing_cores(st) == jh.failing_cores(sj)
    dead = th.probe(cases[1][0], 2.0)
    assert dead.errors[1] == pytest.approx(1.0) and dead.errors[0] == 0.0
    # a dead core reaches the kernel as an all-zero scale: zero output
    st = tchaos.corrupt_entries(tprog, 1, 1.0)
    for s in st.values():
        assert not s.s_w.any()


@pytest.mark.parametrize("compensate", [False, True])
def test_drifted_entries_probe_equal(fx, compensate):
    tparams, jparams, tprog, jprog, tplan, jplan = fx
    th = thealth.build_health(
        tprog, tparams, tplan, PRNGKey(KEY),
        noise=tnoise.drift_only(nu=0.1, t0=1.0, core_spread=0.5,
                                compensate=compensate))
    jh = jhealth.build_health(
        jprog, jparams, jplan, jax.random.PRNGKey(KEY),
        noise=jnoise.drift_only(nu=0.1, t0=1.0, core_spread=0.5,
                                compensate=compensate))
    fresh_t = dict(zip(tprog.names, tprog.states))
    fresh_j = dict(zip(jprog.names, jprog.states))
    dt, dj = th.drifted_entries(100.0), jh.drifted_entries(100.0)
    assert set(dt) == set(dj) == set(tprog.names)
    for n in dt:
        _eq(dt[n].s_w, dj[n].s_w)
    st = th.probe({**fresh_t, **dt}, 100.0)
    sj = jh.probe({**fresh_j, **dj}, 100.0)
    for c in st.errors:
        assert abs(st.errors[c] - sj.errors[c]) <= 1e-6, c
        assert st.errors[c] > 0.0
    assert th.drifted_entries(100.0) == {} == jh.drifted_entries(100.0)


def test_recalibrate_dead_core_equal(fx):
    tparams, jparams, tprog, jprog, tplan, jplan = fx
    th = thealth.build_health(tprog, tparams, tplan, PRNGKey(KEY))
    jh = jhealth.build_health(jprog, jparams, jplan, jax.random.PRNGKey(KEY))
    for h in (th, jh):
        h.mark_dead(1)
    et, nt, cmt = th.recalibrate({1}, t_now=3.0)
    ej, nj, cmj = jh.recalibrate({1}, t_now=3.0)
    assert nt == nj and cmt.initialize > 0
    assert dataclasses.astuple(cmt) == dataclasses.astuple(cmj)
    assert cmt == tprog.reprogram_counts(nt)
    assert th.program.contexts == jh.program.contexts
    assert 1 not in th.program.contexts and th.dead == set()
    assert th.program.t_programmed == jh.program.t_programmed
    for tm_t, tm_j in zip(th.program.tile_maps, jh.program.tile_maps):
        assert _tile_rows(tm_t) == _tile_rows(tm_j)
    for n in nt:
        i = tprog.names.index(n)
        assert torch.equal(et[n].w_q, tprog.states[i].w_q)
        assert torch.equal(et[n].s_w, tprog.states[i].s_w)
        _eq(et[n].s_w, ej[n].s_w)
    # the repaired program probes exactly 0.0 again
    sample = th.probe(dict(zip(th.program.names, th.program.states)), 3.0)
    assert all(e == 0.0 for e in sample.errors.values())

    class Report:
        recal_events = [jhealth.RecalEvent(3.0, "dead_core", (1,), nt,
                                           cmt.initialize, 0.0)]
        recal_initialize = cmt.initialize

    assert thealth.reconcile_recal(th.program, Report)
    assert jhealth.reconcile_recal(jh.program, Report)
    Report.recal_initialize += 1
    assert not thealth.reconcile_recal(th.program, Report)


def test_engine_facing_health_refuses_foreign_raw_tree(fx):
    tparams, _, tprog, _, _, _ = fx
    with pytest.raises(ValueError, match="do not cover"):
        thealth.Recalibrator(tprog, {"embed": tparams["embed"]}, None, None)


@pytest.mark.parametrize("spec", [
    "kill:1@4", "corrupt:0@2:0.5,kill:1@6", " corrupt:2@3 , kill:0@1 ",
    "kill:1@5,kill:0@2"])
def test_parse_chaos_equal(spec):
    t, j = tchaos.parse_chaos(spec), jchaos.parse_chaos(spec)
    assert ([dataclasses.astuple(e) for e in t.events]
            == [dataclasses.astuple(e) for e in j.events])
    assert [e.describe() for e in t.events] == [e.describe()
                                                  for e in j.events]
    fired_t, fired_j = [], []
    for c in range(8):
        fired_t += [e.describe() for e in t.due(c)]
        fired_j += [e.describe() for e in j.due(c)]
        assert t.exhausted == j.exhausted
    assert fired_t == fired_j and len(t) == len(j)


@pytest.mark.parametrize("spec", [
    "", " , ", "explode:1@2", "kill:1", "kill:x@2", "corrupt:0@2:0",
    "corrupt:0@2:1.5", "kill@2", "corrupt:0@2:0.5:0.1"])
def test_parse_chaos_rejects_what_the_reference_rejects(spec):
    outcomes = []
    for mod in (jchaos, tchaos):
        try:
            outcomes.append([e.describe()
                             for e in mod.parse_chaos(spec).events])
        except ValueError as e:
            outcomes.append(type(e).__name__)
    assert outcomes == ["ValueError", "ValueError"]


def test_fault_event_validation_equal():
    for kw in ({"kind": "melt"}, {"magnitude": 0.0}, {"magnitude": 1.5}):
        args = {"at_chunk": 1, "kind": "kill", "core": 0} | kw
        with pytest.raises(ValueError):
            jchaos.FaultEvent(**args)
        with pytest.raises(ValueError):
            tchaos.FaultEvent(**args)
    inj = tchaos.FaultInjector([tchaos.FaultEvent(5, "kill", 1),
                                tchaos.FaultEvent(2, "kill", 0)])
    assert [e.at_chunk for e in inj.events] == [2, 5]
