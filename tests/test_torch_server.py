"""Parity of the port's multi-tenant model server
(`repro_torch/runtime/server.py`, `TilePool`, the CLI's --models /
--tenants / --tile-budget) with the JAX reference's `runtime/server.py`.

`build_server(smoke=True)` with ci.sh's server models and tenants
(granite-8b and xlstm-350m, both co-programmed on ONE `TilePool`; weights
and programming keys ``PRNGKey(seed + i)`` / ``PRNGKey(seed + 100 + i)`` in
each package, the DAC scale fixed at 0.1) is built once per package for
the module, and both serve the same mixed Poisson trace and a saturated
trace cut by ``max_steps``: the same per-request tokens and retirements,
per-tenant CM_* ledgers and `reconcile` verdicts, tenant stats (counts),
fairness, fair shares, pool tiles, labels and placements, and the same
`--tile-budget` `CapacityError` frontier. The reference's CLI cannot serve
the transformer under this container's jax, so the port's CLI is held to
the JAX server driven directly on the trace its CLI draws.

Tolerance: exact (times are the host clock's and not compared)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses
import json

import pytest

from repro.configs import get_arch
from repro.launch import serve as jserve
from repro.runtime import batcher as jb
from repro.runtime import server as jsrv
from repro.runtime import tenancy as jt
from repro_torch.core.program import CapacityError
from repro_torch.core.tile import overlapping_placements
from repro_torch.launch import serve as tserve
from repro_torch.runtime import batcher as tb
from repro_torch.runtime import server as tsrv
from repro_torch.runtime import tenancy as tt
from repro_torch.runtime.fault_tolerance import Heartbeat

MODELS = (("granite-8b", "aimc"), ("xlstm-350m", "aimc"))
TENANTS = (("premium", "granite-8b", 2.0, "fifo"),
           ("standard", "granite-8b", 1.0, "sjf"),
           ("batch", "xlstm-350m", 1.0, "fifo"))
BUILD = dict(smoke=True, n_slots=3, prompt_pad=8, max_seq=12, seed=0)
CLI = ["--smoke", "--models", "granite-8b:aimc,xlstm-350m:digital",
       "--tenants", "premium:granite-8b:2,standard:granite-8b:1:sjf,"
       "batch:xlstm-350m", "--requests", "8", "--prompt-len", "8", "--gen",
       "4", "--slots", "2", "--trace", "poisson:200"]


def _build(pkg, models=MODELS, **kw):
    srv, ten = (jsrv, jt) if pkg == "jax" else (tsrv, tt)
    specs = [srv.ModelSpec(n, n, m) for n, m in models]
    tenants = [ten.TenantPolicy(*a) for a in TENANTS]
    if pkg == "torch":
        kw.setdefault("device", "cpu")
    return srv.build_server(specs, tenants, **{**BUILD, **kw})


def _vocab_of():
    return {n: get_arch(n).smoke_cfg.vocab for n, _ in MODELS}


def _trace(ten, n=8, seed=0):
    pols = [ten.TenantPolicy(*a) for a in TENANTS]
    return ten.mixed_poisson_trace(pols, n, 200.0, vocab_of=_vocab_of(),
                                   seed=seed, prompt_len=(4, 8),
                                   max_new=(1, 4))


def _saturated(ten, batcher):
    vocab = get_arch("granite-8b").smoke_cfg.vocab
    return [ten.TenantRequest(
        tenant="premium" if i % 2 == 0 else "standard",
        request=batcher.Request(rid=500 + i, prompt=tuple(
            (7 * j + i) % (vocab - 1) + 1 for j in range(6)), max_new=12,
            arrival=0.0)) for i in range(8)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both servers, warmed, after the mixed trace (the port's beating a
    heartbeat file) and the saturated trace cut at 8 steps per model."""
    out = {}
    hb_path = tmp_path_factory.mktemp("hb") / "hb.json"
    for pkg, ten, batcher in (("jax", jt, jb), ("torch", tt, tb)):
        srv = _build(pkg)
        counts = srv.warmup()
        hb = Heartbeat(str(hb_path)) if pkg == "torch" else None
        out[pkg] = dict(srv=srv, counts=counts,
                        mixed=srv.serve(_trace(ten), heartbeat=hb),
                        cut=srv.serve(_saturated(ten, batcher), max_steps=8))
    out["heartbeat"] = json.loads(hb_path.read_text())
    return out


def _tokens(report):
    return {rid: (list(rec.tokens), rec.finish_reason)
            for rep in report.model_reports.values()
            for rid, rec in rep.records.items()}


def _ledgers(srv, report):
    out = {}
    for m, eng in srv.engines.items():
        rep = report.model_reports[m]
        led = (jt if isinstance(srv, jsrv.ModelServer) else tt).tenant_ledgers(
            eng.program, rep.records, report.tenant_of)
        out[m] = {t: dataclasses.astuple(cm) for t, cm in led.items()}
    return out


@pytest.mark.parametrize("run", ["mixed", "cut"])
def test_tokens_ledgers_and_reconcile_match_reference(served, run):
    j, t = served["jax"], served["torch"]
    jrep, trep = j[run], t[run]
    assert _tokens(trep) == _tokens(jrep)
    assert trep.tenant_of == jrep.tenant_of
    assert _ledgers(t["srv"], trep) == _ledgers(j["srv"], jrep)
    assert t["srv"].reconcile(trep) == j["srv"].reconcile(jrep) == {
        "granite-8b": True, "xlstm-350m": True}
    for m, rep in trep.model_reports.items():
        assert rep.observed_vectors == rep.useful_vectors
        assert (rep.observed_vectors
                == jrep.model_reports[m].observed_vectors)


def _counts(stats):
    return {n: (s.name, s.model, s.n_requests, s.generated_tokens, s.vectors)
            for n, s in stats.items()}


@pytest.mark.parametrize("run", ["mixed", "cut"])
def test_report_stats_and_fairness_match_reference(served, run):
    j, t = served["jax"], served["torch"]
    jrep, trep = j[run], t[run]
    assert _counts(trep.tenant_stats()) == _counts(jrep.tenant_stats())
    for m in ("granite-8b", "xlstm-350m"):
        assert trep.fairness(m) == jrep.fairness(m)
        assert t["srv"].fair_shares(m) == j["srv"].fair_shares(m)
    assert trep.generated_tokens == jrep.generated_tokens
    assert all(st.generated_tokens > 0 for st in trep.tenant_stats().values()
               if st.n_requests)


def test_saturated_quota_tracks_weights(served):
    """The cut run (every tenant still holds backlog): premium's decode
    share on 3 slots is twice standard's, as the reference's quota
    guarantees."""
    rep = served["torch"]["cut"]
    shares = {n: sum(r.decode_vectors for r in rep.tenant_records(n).values())
              for n in ("premium", "standard")}
    assert shares["standard"] > 0
    assert shares["premium"] == 2 * shares["standard"]
    assert {r.finish_reason for m in rep.model_reports.values()
            for r in m.records.values()} >= {"cap"}


def test_pool_matches_reference(served):
    jpool, tpool = served["jax"]["srv"].pool, served["torch"]["srv"].pool
    assert (tpool.n_tiles, tpool.labels, tpool.utilization,
            tpool.capacity_tiles, tpool.summary()) == (
        jpool.n_tiles, jpool.labels, jpool.utilization,
        jpool.capacity_tiles, jpool.summary())
    assert ([dataclasses.astuple(p) for p in tpool.placements()]
            == [dataclasses.astuple(p) for p in jpool.placements()])
    assert tpool.labels == ["granite-8b", "xlstm-350m"]
    assert {p.matrix_id.split("/", 1)[0] for p in tpool.placements()} == set(
        tpool.labels)
    assert not any(overlapping_placements(a.placements)
                   for a in tpool.allocators)
    for m, eng in served["torch"]["srv"].engines.items():
        jeng = served["jax"]["srv"].engines[m]
        assert eng.program.n_tiles == jeng.program.n_tiles
        assert eng.program.names == jeng.program.names
    assert served["torch"]["counts"] == served["jax"]["counts"]


def test_tile_budget_frontier_matches_reference(served):
    """One tile below the pair's pack raises `CapacityError` at program
    time in both packages; the pack itself fits."""
    n = served["torch"]["srv"].pool.n_tiles
    from repro.core.program import CapacityError as JCapacityError
    with pytest.raises(JCapacityError) as want:
        _build("jax", tiles_per_context=n - 1)
    with pytest.raises(CapacityError) as got:
        _build("torch", tiles_per_context=n - 1)
    assert str(got.value) == str(want.value)
    assert _build("torch", tiles_per_context=n).pool.n_tiles == n


def test_single_model_server_bit_equal_to_engine(served):
    eng = served["torch"]["srv"].engines["granite-8b"]
    reqs = tb.synchronized_trace(3, prompt_len=8, max_new=3, seed=13,
                                 vocab=get_arch("granite-8b").smoke_cfg.vocab)
    direct = eng.serve(reqs)
    solo = tsrv.ModelServer({"granite-8b": eng},
                            [tt.TenantPolicy("only", "granite-8b")])
    rep = solo.serve([tt.TenantRequest("only", r) for r in reqs]
                     ).model_reports["granite-8b"]
    assert {rid: r.tokens for rid, r in rep.records.items()} == {
        rid: r.tokens for rid, r in direct.records.items()}
    assert rep.observed_vectors == direct.observed_vectors


def test_heartbeat_beats_per_pass(served):
    srv, beat = served["torch"]["srv"], served["heartbeat"]
    rep = served["torch"]["mixed"]
    assert beat["step"] >= 1
    assert set(beat["slots"]) == set(beat["n_steps"]) == set(srv.engines)
    assert beat["n_steps"] == {m: r.n_steps
                               for m, r in rep.model_reports.items()}
    assert beat["engine_clock_s"] <= rep.makespan_s


def test_registry_and_trace_validation(served):
    srv = served["torch"]["srv"]
    eng = srv.engines["granite-8b"]
    with pytest.raises(ValueError, match="unregistered model"):
        tsrv.ModelServer({"granite-8b": eng}, [tt.TenantPolicy("t", "nope")])
    with pytest.raises(ValueError, match="duplicate tenant"):
        tsrv.ModelServer({"granite-8b": eng},
                         [tt.TenantPolicy("t", "granite-8b")] * 2)
    with pytest.raises(ValueError, match="at least one"):
        tsrv.ModelServer({}, [tt.TenantPolicy("t", "granite-8b")])
    with pytest.raises(ValueError, match="exec_mode"):
        tsrv.ModelSpec("m", "granite-8b", "analog")
    with pytest.raises(ValueError, match="unknown tenant"):
        srv.serve([tt.TenantRequest("nobody", tb.Request(rid=0,
                                                         prompt=(1, 2)))])
    with pytest.raises(ValueError, match="unique"):
        srv.serve([tt.TenantRequest("premium", tb.Request(rid=0,
                                                          prompt=(1, 2))),
                   tt.TenantRequest("batch", tb.Request(rid=0,
                                                        prompt=(1, 2)))])
    with pytest.raises(ValueError, match="duplicate model"):
        _build("torch", models=(("granite-8b", "aimc"),) * 2)
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        _build("torch", mesh=object())


def test_cli_serves_the_reference_server():
    """`serve.main` with ci.sh's --models/--tenants (xlstm digital): the
    tokens the JAX server gives on the trace the CLI draws; the AIMC member
    alone on the pool; books reconcile."""
    run = tserve.main(CLI + ["--device", "cpu"])
    models = (("granite-8b", "aimc"), ("xlstm-350m", "digital"))
    jsrv_ = _build("jax", models=models)
    jsrv_.warmup()
    trace = [jt.TenantRequest(tr.tenant, jb.Request(
        **dataclasses.asdict(tr.request))) for tr in run.trace]
    want = jsrv_.serve(trace)
    assert _tokens(run.report) == _tokens(want)
    assert run.reconciled == jsrv_.reconcile(want) == {
        "granite-8b": True, "xlstm-350m": None}
    assert run.server.pool.labels == ["granite-8b"]


def test_cli_tile_budget_caps_the_pool(served):
    """--tile-budget reaches the pool (the smoke pair packs into 1 tile, so
    no budget >= 1 refuses it; the frontier is pinned above)."""
    assert served["torch"]["srv"].pool.n_tiles == 1
    run = tserve.main(CLI + ["--tile-budget", "1", "--requests", "2",
                             "--device", "cpu"])
    assert run.server.pool.capacity_tiles == 1
    assert run.server.pool.n_tiles == 1


@pytest.mark.parametrize("argv", [
    ["--tenants", "a:granite-8b"], ["--tile-budget", "3"],
    ["--models", "granite-8b:aimc", "--static"],
    ["--models", "granite-8b:aimc", "--int8"],
    ["--models", "granite-8b:aimc", "--cores", "2"],
    ["--models", "granite-8b:aimc", "--pipeline"],
    ["--models", "granite-8b:aimc", "--arrivals", "0"],
    ["--models", "granite-8b:aimc", "--shared-prefix", "2"],
    ["--models", "granite-8b:aimc", "--drift", "0.1"]])
def test_cli_refuses_what_the_reference_refuses(argv):
    with pytest.raises(SystemExit):
        jserve.parse_args(argv)
    with pytest.raises(SystemExit):
        tserve.parse_args(argv)


@pytest.mark.parametrize("models,tenants", [
    ("granite-8b:analog", ""), (":aimc", ""),
    ("granite-8b:aimc", "t:xlstm-350m"), ("granite-8b:aimc", "t"),
    ("granite-8b:aimc", "t:granite-8b:0"),
    ("granite-8b:aimc", "t:granite-8b:1:lifo")])
def test_model_and_tenant_specs_refused_like_reference(models, tenants):
    for mod in (jserve, tserve):
        with pytest.raises(SystemExit):
            specs = mod.parse_models(models)
            mod.parse_tenants(tenants, specs)


# ---------------------------------------------------------------------------
# the mesh: --mesh parsing, build_server(mesh=), the sharded CLI
# ---------------------------------------------------------------------------

MESH_ARGS = ["1x1", "2x4", "2x2x4", "data:2,model:2", "model:4",
             "data:1", "pod:2,data:2,model:2", "model:2,data:3",
             # refused
             "", "2", "2x", "axb", "0x2", "1x2x3x4", "data:0", "data:-1",
             "data:2,data:2", "data:2,", "data", "data:x", ":2",
             "data:2,model", "1x0"]


@pytest.mark.parametrize("arg", MESH_ARGS)
def test_parse_mesh_equals_reference(arg):
    for fn in ("parse_mesh", "parse_named_mesh"):
        try:
            want = getattr(jserve, fn)(arg)
        except SystemExit as e:
            with pytest.raises(SystemExit) as got:
                getattr(tserve, fn)(arg)
            assert str(got.value) == str(e)
            continue
        assert getattr(tserve, fn)(arg) == want


def test_build_server_on_a_mesh_equals_build_server():
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.engine import ShardedServeEngine
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"])
    plain, sharded = _build("torch", n_slots=4), _build("torch", n_slots=4,
                                                        mesh=mesh)
    assert all(isinstance(e, ShardedServeEngine)
               for e in sharded.engines.values())
    assert sharded.warmup() == plain.warmup()
    reps = [srv.serve(_trace(tt)) for srv in (plain, sharded)]
    assert _tokens(reps[1]) == _tokens(reps[0])
    assert sharded.reconcile(reps[1]) == plain.reconcile(reps[0])
    assert _ledgers(sharded, reps[1]) == _ledgers(plain, reps[0])


def test_sharded_cli_serves_and_prints_mesh_books(capsys):
    run = tserve.main(["--arch", "granite-8b", "--smoke", "--exec", "aimc",
                       "--device", "cpu", "--requests", "4", "--prompt-len",
                       "8", "--gen", "4", "--slots", "4", "--cores", "2",
                       "--mesh", "data:2,model:2"])
    out = capsys.readouterr().out
    assert "mesh data:2,model:2: 4 positions on 1 device (cpu)" in out
    assert ("per-core ledgers (aggregated across shards) reconcile with "
            "the schedule totals: True") in out
    assert "mesh device[model=0]" in out and "mesh device[model=1]" in out
    one = tserve.main(["--arch", "granite-8b", "--smoke", "--exec", "aimc",
                       "--device", "cpu", "--requests", "4", "--prompt-len",
                       "8", "--gen", "4", "--slots", "4", "--cores", "2",
                       "--mesh", "2x2"])
    assert type(one.engine).__name__ == "ServeEngine"
    for rid, rec in one.report.records.items():
        assert run.report.tokens(rid) == rec.tokens
    with pytest.raises(SystemExit, match="--static"):
        tserve.main(["--smoke", "--device", "cpu", "--static", "--mesh",
                     "data:2"])
