"""Parity of the port's cost-model placement and rotation
(`repro_torch/core/placement.py`, `AimcProgram.install_subset`, the
engine's `_placement_tick`, the CLI's --placement) with the JAX reference.

At the reference's LOCKED placement smoke (granite-8b's smoke config,
`tile_rows=64`, `adc_alpha=0.5`, seed 89, budget 2; weights drawn by the
reference and carried across with `params_from_numpy`) the port is held to
the JAX package exactly: `layer_costs`, capped and uncapped
`plan_placement`, the `RotationPlan`, which leaves each `install_subset`
tree installs, the per-state packing, the feasibility frontier and
`PlacementRoofline.fit`. The port's rotating engine is held to the JAX
rotating engine (the fixture of the reference's own placement test,
driven directly): tokens, swap books, warmed shapes. The reference's claim
that the rotating engine equals the all-digital oracle does not hold
under this container's jax (its own test fails on request 0): the port is
held to the JAX rotating engine instead, and `--placement-verify` is held
to fail where the reference's does. At granite-8b's published widths the
port's plan, from zero-stride tensors shaped by `jax.eval_shape`, is
pinned as a constant.

Tolerance: exact, except the modelled times (within 1e-12 relative)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core import placement as jpl
from repro.core import program as jp
from repro.core import tile as jtile
from repro.launch import serve as jserve
from repro.models.layers import Execution as JExe
from repro.runtime import batcher as jb
from repro.runtime.engine import ServeEngine as JEngine
from repro_torch.configs import get_arch as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import placement as tpl
from repro_torch.core import program as tp
from repro_torch.core import tile as ttile
from repro_torch.core.prng import PRNGKey
from repro_torch.launch import serve as tserve
from repro_torch.models.layers import Execution as TExe
from repro_torch.runtime import batcher as tb
from repro_torch.runtime.engine import ServeEngine as TEngine

SEED, BUDGET = 89, 2
JCFG = ja.AimcConfig(impl="ref", adc_alpha=0.5, tile_rows=64)
TCFG = ta.AimcConfig(adc_alpha=0.5, tile_rows=64)
ENGINE_KW = dict(n_slots=4, prompt_pad=8, max_seq=14)
LOCKED_CLI = ["--arch", "granite-8b", "--smoke", "--exec", "aimc",
              "--placement", f"auto:{BUDGET}", "--tile-rows", "64",
              "--adc-alpha", "0.5", "--requests", "4", "--prompt-len", "8",
              "--gen", "6", "--seed", str(SEED), "--device", "cpu"]
# granite-8b at its published widths, 512x512 tiles, budget 16128: the
# reference's algorithm keeps w_gate hot and rotates the rest in 3 groups
FULL_BUDGET = 16128
FULL_PLAN = (("blocks/w_gate",),
             (("blocks/w_up",), ("blocks/w_down",),
              ("blocks/wo", "blocks/wq", "blocks/wk", "blocks/wv")), ())
FULL_TILES = {"blocks/w_gate": 8064, "blocks/w_up": 8064,
              "blocks/w_down": 8064, "blocks/wq": 2304, "blocks/wo": 2304,
              "blocks/wk": 576, "blocks/wv": 576}
FULL_PACKS = [16128, 16128, 13824]


@pytest.fixture(scope="module")
def locked():
    spec = get_arch("granite-8b")
    jparams = spec.model_module().init(jax.random.PRNGKey(SEED),
                                       spec.smoke_cfg)
    return spec, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _cost_key(c):
    return (c.path, c.k, c.n, c.instances, c.fold_index, c.tiles_alone)


def _approx(x):
    return pytest.approx(x, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("n_contexts,coupling", [(1, "tight"), (2, "tight"),
                                                 (1, "loose")])
def test_layer_costs_match_reference(locked, n_contexts, coupling):
    _, jparams, tparams = locked
    want = jpl.layer_costs(jparams, jp.MappingPlan(n_contexts=n_contexts),
                           JCFG, coupling=coupling)
    got = tpl.layer_costs(tparams, tp.MappingPlan(n_contexts=n_contexts),
                          TCFG, coupling=coupling)
    assert [_cost_key(c) for c in got] == [_cost_key(c) for c in want]
    for g, w in zip(got, want):
        assert g.t_digital == _approx(w.t_digital)
        assert g.t_analog == _approx(w.t_analog)
        assert g.density == _approx(w.density)
        assert g.item == w.item


def _rot_tuple(rot):
    return None if rot is None else dataclasses.astuple(rot)


@pytest.mark.parametrize("budget", [None, 1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_contexts", [1, 2])
def test_plan_placement_matches_reference(locked, budget, n_contexts):
    _, jparams, tparams = locked
    want = jpl.plan_placement(jparams, jp.MappingPlan(), JCFG,
                              tiles_per_context=budget,
                              n_contexts=n_contexts, swap_every=3)
    got = tpl.plan_placement(tparams, tp.MappingPlan(), TCFG,
                             tiles_per_context=budget, n_contexts=n_contexts,
                             swap_every=3)
    assert (got.analog, got.digital, got.overflow, got.n_contexts,
            got.tiles_per_context) == (want.analog, want.digital,
                                       want.overflow, want.n_contexts,
                                       want.tiles_per_context)
    for name in ("predicted_s", "predicted_digital_s",
                 "predicted_analog_fit_s"):
        assert getattr(got, name) == _approx(getattr(want, name))
    assert _rot_tuple(got.rotation) == _rot_tuple(want.rotation)
    assert (got.plan.include, got.plan.exclude, got.plan.n_contexts,
            got.plan.tiles_per_context) == (
        want.plan.include, want.plan.exclude, want.plan.n_contexts,
        want.plan.tiles_per_context)
    assert got.summary() == want.summary()
    assert got.predicted_for(got.analog[:1]) == _approx(
        want.predicted_for(want.analog[:1]))
    if budget is not None:
        for ns in (got.rotation.states() if got.rotation else (got.analog,)):
            per = ttile.pack_contexts([c.item for c in got.costs
                                       if c.path in set(ns)], n_contexts,
                                      TCFG.tile_rows, TCFG.tile_cols)
            assert max(per, default=0) <= budget


def _installed(tree, cls, prefix=""):
    """Paths of a tree's leaves that are installed states of ``cls``."""
    out = set()
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, cls):
            out.add(path)
        elif isinstance(v, dict):
            out |= _installed(v, cls, path)
    return out


@pytest.fixture(scope="module")
def rotation(locked):
    _, jparams, tparams = locked
    jres = jpl.plan_placement(jparams, jp.MappingPlan(), JCFG,
                              tiles_per_context=BUDGET)
    tres = tpl.plan_placement(tparams, tp.MappingPlan(), TCFG,
                              tiles_per_context=BUDGET)
    jprog = jp.program_model(jparams, jres.rotation.plan(), JCFG,
                             jax.random.PRNGKey(SEED + 2))
    tprog = tp.program_model(tparams, tres.rotation.plan(), TCFG,
                             PRNGKey(SEED + 2))
    return jres, tres, jprog, tprog


def test_rotation_states_install_subset_and_packing(locked, rotation):
    _, jparams, tparams = locked
    jres, tres, jprog, tprog = rotation
    jrot, trot = jres.rotation, tres.rotation
    assert trot.states() == jrot.states() and trot.n_states >= 2
    assert trot.all_names == jrot.all_names
    assert tprog.names == jprog.names and tprog.n_tiles == jprog.n_tiles
    for st_t, st_j in zip(tprog.states, jprog.states):
        np.testing.assert_array_equal(st_t.w_q.numpy(), np.asarray(st_j.w_q))
    for ns in trot.states():
        jtree = jprog.install_subset(jparams, ns)
        ttree = tprog.install_subset(tparams, ns)
        got = _installed(ttree, ta.AimcLinearState)
        assert got == set(ns)
        assert got == {path for path in tprog.names
                       if isinstance(_at(jtree, path), ja.AimcLinearState)}
        items = [c.item for c in tres.costs if c.path in set(ns)]
        assert (ttile.pack_contexts(items, 1, TCFG.tile_rows, TCFG.tile_cols)
                == jtile.pack_contexts(items, 1, TCFG.tile_rows, TCFG.tile_cols))
        assert max(ttile.pack_contexts(items, 1, TCFG.tile_rows, TCFG.tile_cols)) <= BUDGET
    for s in range(2 * trot.n_states):
        assert trot.incoming(s) == jrot.incoming(s)
    with pytest.raises(KeyError):
        tprog.install_subset(tparams, ["blocks/nope"])


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("n_contexts,rows", [(1, 64), (2, 64), (1, 32)])
def test_feasibility_frontier_matches_reference(locked, n_contexts, rows):
    """budget == the packed max programs; one tile less raises
    `CapacityError`, in both packages."""
    _, jparams, tparams = locked
    jcfg = dataclasses.replace(JCFG, tile_rows=rows)
    tcfg = dataclasses.replace(TCFG, tile_rows=rows)
    costs = tpl.layer_costs(tparams, None, tcfg)
    per = ttile.pack_contexts([c.item for c in costs], n_contexts, rows,
                             tcfg.tile_cols)
    assert per == jtile.pack_contexts([c.item for c in costs], n_contexts,
                                      rows, tcfg.tile_cols)
    packmax = max(per)
    prog = tp.program_model(tparams, tp.MappingPlan(
        n_contexts=n_contexts, tiles_per_context=packmax), tcfg)
    assert prog.n_tiles == sum(per)
    jp.program_model(jparams, jp.MappingPlan(
        n_contexts=n_contexts, tiles_per_context=packmax), jcfg)
    with pytest.raises(tp.CapacityError):
        tp.program_model(tparams, tp.MappingPlan(
            n_contexts=n_contexts, tiles_per_context=packmax - 1), tcfg)
    with pytest.raises(jp.CapacityError):
        jp.program_model(jparams, jp.MappingPlan(
            n_contexts=n_contexts, tiles_per_context=packmax - 1), jcfg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roofline_fit_matches_reference(seed):
    rng = np.random.default_rng(seed)
    modeled = list(rng.uniform(1e-6, 1e-4, size=3 + seed))
    measured = [2e-6 + 1.7 * t + rng.normal(0, 1e-7) for t in modeled]
    want = jpl.PlacementRoofline.fit(modeled, measured)
    got = tpl.PlacementRoofline.fit(modeled, measured)
    assert (got.t_fixed_s, got.scale) == (want.t_fixed_s, want.scale)
    assert got.predict_s(3e-5) == want.predict_s(3e-5)
    assert got.residuals(modeled, measured) == want.residuals(modeled,
                                                              measured)
    with pytest.raises(ValueError):
        tpl.PlacementRoofline.fit(modeled[:1], measured[:1])


def test_rotation_plan_surface_matches_reference():
    kw = dict(hot=("a",), groups=(("b",), ("c", "d")), digital=("e",),
              n_contexts=2, tiles_per_context=7, swap_every=2)
    got, want = tpl.RotationPlan(**kw), jpl.RotationPlan(**kw)
    assert (got.all_names, got.n_states, got.states(), got.summary()) == (
        want.all_names, want.n_states, want.states(), want.summary())
    assert (got.plan().include, got.plan().n_contexts) == (
        want.plan().include, want.plan().n_contexts)
    lone = dict(kw, groups=())
    assert tpl.RotationPlan(**lone).states() == (("a",),)
    assert tpl.RotationPlan(**lone).incoming(3) == ()
    with pytest.raises(ValueError):
        tpl.RotationPlan(**dict(kw, swap_every=0))
    with pytest.raises(ValueError):
        jpl.RotationPlan(**dict(kw, swap_every=0))


@pytest.fixture(scope="module")
def rotating(locked, rotation):
    """The reference's rotating-engine fixture, driven in both packages on
    the LOCKED smoke trace."""
    spec, jparams, tparams = locked
    jres, tres, jprog, tprog = rotation
    jrot, trot = jres.rotation, tres.rotation
    jtrees = tuple(jprog.install_subset(jparams, ns) for ns in jrot.states())
    ttrees = tuple(tprog.install_subset(tparams, ns) for ns in trot.states())
    jeng = JEngine(spec.model_module(), spec.smoke_cfg,
                   JExe(mode="aimc", aimc=JCFG, compute_dtype="float32",
                        programmed=True), jtrees[0], family=spec.family,
                   module=spec.module, program=jprog, rotation=jrot,
                   rotation_params=jtrees, **ENGINE_KW)
    tm = tget("granite-8b")
    texe = TExe(mode="aimc", aimc=TCFG, compute_dtype="float32",
                programmed=True)
    teng = TEngine(tm.model_module(), tm.smoke_cfg, texe, ttrees[0],
                   family=tm.family, module=tm.module, program=tprog,
                   rotation=trot, rotation_params=ttrees, **ENGINE_KW)
    jcounts, tcounts = jeng.warmup(), teng.warmup()
    reqs = jb.synchronized_trace(4, prompt_len=8, max_new=6, seed=SEED,
                                 vocab=spec.smoke_cfg.vocab)
    jrep = jeng.serve(reqs)
    trep = teng.serve([tb.Request(**dataclasses.asdict(r)) for r in reqs])
    return dict(jeng=jeng, teng=teng, jrep=jrep, trep=trep, reqs=reqs,
                jcounts=jcounts, tcounts=tcounts, tprog=tprog, jprog=jprog,
                ttrees=ttrees, texe=texe)


def _events(rep):
    return [(e.state, e.chunk, e.incoming, e.initialize)
            for e in rep.swap_events]


def test_rotating_engine_matches_reference(rotating):
    r = rotating
    jrep, trep = r["jrep"], r["trep"]
    for q in r["reqs"]:
        assert trep.tokens(q.rid) == jrep.tokens(q.rid)
    assert trep.n_swaps == jrep.n_swaps > 0
    assert _events(trep) == _events(jrep)
    assert trep.swap_initialize == jrep.swap_initialize
    assert tpl.reconcile_swaps(r["tprog"], trep)
    assert jpl.reconcile_swaps(r["jprog"], jrep)
    assert trep.observed_vectors == trep.useful_vectors
    assert r["tcounts"] == r["jcounts"] == {"prefill": 2, "insert": 1,
                                            "decode": 2}
    assert r["teng"].compile_counts() == r["tcounts"]
    with pytest.raises(ValueError, match="rotation"):
        r["teng"].ledgers(trep)


def test_swap_books_close_per_event_and_drift_when_tampered(rotating):
    r = rotating
    trep, tprog = r["trep"], r["tprog"]
    for ev in trep.swap_events:
        assert ev.initialize == tprog.reprogram_counts(ev.incoming).initialize
    bad = dataclasses.replace(trep, swap_initialize=trep.swap_initialize + 1)
    assert not tpl.reconcile_swaps(tprog, bad)


def _port_engine(r, **kw):
    tm = tget("granite-8b")
    return TEngine(tm.model_module(), tm.smoke_cfg, r["texe"], r["ttrees"][0],
                   family=tm.family, module=tm.module, **ENGINE_KW, **kw)


@pytest.mark.parametrize("case", ["no_program", "tree_count", "health",
                                  "chaos", "prefix_cache", "prefill_chunk"])
def test_rotation_refusals(rotating, case):
    r = rotating
    rot, trees, prog = r["teng"].rotation, r["ttrees"], r["tprog"]
    health = types.SimpleNamespace(program=prog)
    kw = {"no_program": dict(rotation=rot, rotation_params=trees),
          "tree_count": dict(program=prog, rotation=rot,
                             rotation_params=trees[:1]),
          "health": dict(program=prog, rotation=rot, rotation_params=trees,
                         health=health),
          "chaos": dict(program=prog, rotation=rot, rotation_params=trees,
                        health=health, chaos=object()),
          "prefix_cache": dict(program=prog, rotation=rot,
                               rotation_params=trees, prefix_cache=True,
                               page_size=4, n_pages=16),
          "prefill_chunk": dict(program=prog, rotation=rot,
                                rotation_params=trees, prefill_chunk=4,
                                page_size=4, n_pages=16)}[case]
    match = {"no_program": "AimcProgram", "tree_count": "state",
             "health": "health/chaos", "chaos": "health/chaos"}.get(
        case, "prefix_cache / prefill_chunk")
    with pytest.raises(ValueError, match=match):
        _port_engine(r, **kw)


def test_server_refuses_a_rotating_engine(rotating):
    from repro_torch.runtime.server import ModelServer
    from repro_torch.runtime.tenancy import TenantPolicy
    with pytest.raises(ValueError, match="rotation"):
        ModelServer({"m": rotating["teng"]}, [TenantPolicy("t", "m")])


def test_full_width_plan_from_shapes():
    """granite-8b at its published widths, 512x512 tiles, budget 16128,
    planned from zero-stride tensors shaped like the reference's init: the
    constant plan (hot w_gate; w_up | w_down | wo, wq, wk, wv), every state
    within the budget, the backing program the whole 29,952 tiles."""
    spec = get_arch("granite-8b")
    shapes = jax.eval_shape(
        lambda k: spec.model_module().init(k, spec.model_cfg),
        jax.random.PRNGKey(0))

    def zero_stride(s):
        return torch.zeros((), dtype=torch.float32).expand(*s.shape)

    params = jax.tree.map(zero_stride, shapes)
    res = tpl.plan_placement(params, tp.MappingPlan(), ta.AimcConfig(),
                             tiles_per_context=FULL_BUDGET)
    rot = res.rotation
    assert (rot.hot, rot.groups, rot.digital) == FULL_PLAN
    assert {c.path: c.tiles_alone for c in res.costs} == FULL_TILES
    assert sum(FULL_TILES.values()) == 29952
    packs = [max(ttile.pack_contexts([c.item for c in res.costs
                                      if c.path in set(ns)], 1, 512, 512))
             for ns in rot.states()]
    assert packs == FULL_PACKS
    assert res.analog == ("blocks/w_gate", "blocks/w_up")   # resident
    assert res.overflow and rot.n_states == 3


def _tokens(report):
    return {rid: list(rec.tokens) for rid, rec in report.records.items()}


def test_cli_placement_serves_the_reference_rotation(rotating):
    """`serve.main --placement auto:2` at the LOCKED smoke: the rotating
    engine's tokens and swap books of the JAX engine (the port's init on
    the same keys); --placement-verify then fails on the all-digital token
    check, as the reference's own check does on the same traffic."""
    run = tserve.main(LOCKED_CLI)
    jrep = rotating["jrep"]
    assert _tokens(run.report) == _tokens(jrep)
    assert _events(run.report) == _events(jrep)
    assert run.engine.rotation.states() == rotating["teng"].rotation.states()
    assert run.placement.rotation == rotating["teng"].rotation
    with pytest.raises(SystemExit) as e:
        tserve.main(LOCKED_CLI + ["--placement-verify"])
    assert e.value.code == 1


def test_cli_uncapped_placement_installs_the_plan(locked):
    """`--placement auto` (no budget): every positive-savings layer goes
    analog and nothing rotates; the per-request books reconcile."""
    run = tserve.main(["auto" if a == f"auto:{BUDGET}" else a
                       for a in LOCKED_CLI])
    assert run.engine.rotation is None
    assert set(run.program.names) == set(run.placement.analog)
    want = jpl.plan_placement(locked[1], jp.MappingPlan(), JCFG,
                              tiles_per_context=None)
    assert run.placement.analog == want.analog


@pytest.mark.parametrize("argv", [
    ["--placement", "manual"], ["--placement", "auto:0"],
    ["--placement", "auto:x"], ["--placement", "auto"],
    ["--exec", "aimc", "--placement", "auto", "--static"],
    ["--exec", "aimc", "--placement", "auto", "--page-size", "4",
     "--prefix-cache"],
    ["--exec", "aimc", "--placement", "auto", "--page-size", "4",
     "--prefill-chunk", "4"],
    ["--exec", "aimc", "--placement", "auto", "--drift", "0.1"],
    ["--placement-verify"],
    ["--exec", "aimc", "--placement", "auto", "--placement-verify",
     "--trace", "poisson:10"],
    ["--exec", "aimc", "--placement", "auto", "--placement-verify",
     "--eos", "3"],
    ["--swap-every", "0"]])
def test_cli_refuses_what_the_reference_refuses(argv):
    with pytest.raises(SystemExit):
        jserve.parse_args(argv)
    with pytest.raises(SystemExit):
        tserve.parse_args(argv)
