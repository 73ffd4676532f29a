"""The step counter (`repro_torch.launch.stepstats`), the port's
counterpart of `repro.launch.hlostats`.

  * The reference's `tests/test_hlostats.py` programs in torch: the
    scan-free MLP's FLOPs within 2% of `analyze_hlo` on its compiled
    program (the bar the reference holds itself to against XLA), its
    bytes at least the reference's (eager code fuses nothing; the ratio is
    printed); the 10-trip loop exactly 10 * 2 * 256^3, the 3 x 4 nested
    loops exactly 12 * 2 * 128^3.
  * Every `trips` site at a small size: the count with trips
    extrapolated equals the count with every trip executed (`count_step`
    with ``full=True``), FLOPs by class, bytes, launches, collectives and
    the peak, output and temporary bytes as integers; together the cases
    run every site of the port with more than 2 trips, except rglru's two
    tail loops, whose trip count (n_layers % 3) cannot exceed 2.
  * Whole steps against the reference on one device at a small granite
    config: the port's matmul + crossbar FLOPs against the dot and
    convolution FLOPs of the reference's compiled HLO (a test-local walk
    over `hlostats.parse_module`'s computations, each ``while`` body times
    its ``known_trip_count``), compiled on a 1x1 mesh with ``Auto`` axes
    (`tests/torch_mesh_oracle.py`'s recipe: the reference's own
    ``make_mesh`` leaves ``Explicit`` axes, under which its
    ``with_sharding_constraint`` asserts). Prefill and decode equal
    exactly; the AIMC decode's crossbar operations equal the reference's
    int einsum dots under ``AimcConfig(impl="ref")``. The train step is
    within 1%, and its one difference is named and checked exactly: under
    autograd each attention chunk pair is a checkpoint inside a
    checkpointed layer, and torch's recomputation of the layer runs each
    pair's score product [qc x kc] once more than XLA's remat of the same
    nesting (L x microbatches x pairs x 2*B*Hq*qc*kc*hd FLOPs).
  * Collectives on data:2,model:2: a train cell's gradient reduction
    (`dryrun.grad_collectives`) and a programmed decode cell's column-piece
    joins against a hand reckoning.
  * No side effects: with no counter active, each family's CPU step gives
    the same bits as with every hook replaced by the plain loop.

Tolerances: integers equal, except the MLP's FLOPs (2%) and the train
step's (1%, with the named difference exact)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro_torch.configs import ShapeCell, get_arch
from repro_torch.core import aimc as ta
from repro_torch.core import prng
from repro_torch.core import program as tp
from repro_torch.launch import dryrun, stepstats
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import encdec, layers, rglru, transformer, xlstm
from repro_torch.models.layers import Execution as TExe

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
KEYS = ("flops_by_class", "bytes", "launches", "collectives", "peak_bytes",
        "output_bytes", "temp_bytes", "argument_bytes")


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the reference's hlostats programs
# ---------------------------------------------------------------------------

def test_scanfree_mlp_against_reference():
    from repro.launch.hlostats import analyze_hlo

    def f(x, w1, w2):
        return jnp.tanh(jnp.maximum(x @ w1, 0) @ w2)
    shapes = ((128, 512), (512, 1024), (1024, 256))
    comp = jax.jit(f).lower(*(jax.ShapeDtypeStruct(s, jnp.float32)
                              for s in shapes)).compile()
    ref = analyze_hlo(comp.as_text())
    got = stepstats.count_step(
        lambda x, w1, w2: torch.tanh(torch.relu(x @ w1) @ w2),
        *(meta(*s) for s in shapes))
    assert got["flops"] == pytest.approx(ref["flops"], rel=0.02)
    assert got["bytes"] >= ref["bytes"]
    print(f"MLP bytes: port {got['bytes']} / reference {ref['bytes']:.0f} "
          f"= {got['bytes'] / ref['bytes']:.3f} (eager: no fusion)")


def test_loop_trip_count_multiplied():
    def f(x, w):
        for _ in stepstats.trips(10, x):
            x = torch.tanh(x @ w)
        return x
    got = stepstats.count_step(f, meta(256, 256), meta(256, 256))
    assert got["flops_by_class"]["matmul"] == 10 * 2 * 256 ** 3
    assert got["runs"] == 2


def test_nested_loops_multiply_through():
    def f(x, w):
        for _ in stepstats.trips(3, x):
            for _ in stepstats.trips(4, x):
                x = x @ w
        return x
    got = stepstats.count_step(f, meta(128, 128), meta(128, 128))
    assert got["flops_by_class"]["matmul"] == 12 * 2 * 128 ** 3
    assert got["flops"] == 12 * 2 * 128 ** 3


def test_rules_and_no_leak():
    """A slice write costs its slice twice, views nothing, a fill its
    result; no counter outlives its step."""
    def f(a, b):
        a[2:4] = b               # copy_ into a view: 2 x 2 x 8 x 4 bytes
        v = a.view(4, 16).t()    # free
        return torch.zeros_like(v)
    got = stepstats.count_step(f, meta(8, 8), meta(2, 8))
    assert got["bytes"] == 2 * 2 * 8 * 4 + 8 * 8 * 4
    assert got["flops"] == 0
    assert got["argument_bytes"] == (64 + 16) * 4
    assert got["output_bytes"] == 64 * 4
    assert stepstats.active() is None
    assert list(stepstats.trips(3, meta(1))) == [0, 1, 2]


# ---------------------------------------------------------------------------
# every trips site: extrapolated == executed
# ---------------------------------------------------------------------------

def _spec(arch, **cfg):
    spec = get_arch(arch)
    return dataclasses.replace(
        spec, model_cfg=dataclasses.replace(spec.smoke_cfg, **cfg),
        cache_dtype="float32")


def _bundle_case(arch, kind, seq, batch, program=None, exe=TExe(), **cfg):
    spec = _spec(arch, **cfg)
    bundle = tsteps.make_step(spec, ShapeCell(kind, seq, batch, kind), None,
                              exe, program=program)
    return bundle.fn, dryrun.step_inputs(bundle, kind)


def _cpu_params(spec, seed=0):
    """The arch's parameter tree on the CPU, N(0, 0.02^2) from a torch
    generator (the counts see shapes only; `prng`'s bit-exact draws are
    slow at the wider widths)."""
    g = torch.Generator().manual_seed(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return (torch.randn(tuple(t.shape), generator=g) * 0.02).to(t.dtype)
    return go(spec.model_module().init(prng.PRNGKey(0), spec.model_cfg,
                                       device="meta"))


def _programmed(arch, contexts=1, **cfg):
    """(program, exe) of a smoke-size programmed serving cell."""
    params = _cpu_params(_spec(arch, **cfg))
    tcfg = ta.AimcConfig()
    prog = tp.program_model(params, tp.MappingPlan(n_contexts=contexts),
                            tcfg)
    return prog, TExe(mode="aimc", aimc=tcfg, programmed=True)


def _ce_case():
    def f(h, u, labels):
        loss, n = tsteps.chunked_ce(h, u, labels, chunk=8)
        return torch.autograd.grad(loss / n, [h, u])
    h = meta(2, 40, 16).requires_grad_(True)
    u = meta(16, 32).requires_grad_(True)
    return f, (h, u, meta(2, 40, dtype=torch.int32))


def _paged_case():
    spec = _spec("granite-8b", n_layers=4)
    cfg = spec.model_cfg
    params = transformer.init(prng.PRNGKey(0), cfg, device="meta")
    pool = meta(cfg.n_layers, 6, 4, cfg.n_kv_heads, cfg.hd)

    def f(params, tokens, kp, vp, pt_row):
        return transformer.prefill_chunk(
            params, tokens, cfg, TExe(), kp, vp, pt_row, 4, 8, page_size=4,
            context_len=16, )
    return f, (params, meta(1, 8, dtype=torch.int32), pool, pool.clone(),
               meta(4, dtype=torch.int64))


def _rec_steps_case():
    spec = _spec("recurrentgemma-9b")
    cfg = spec.model_cfg
    params = rglru.init(prng.PRNGKey(0), cfg, device="meta")
    p = layers.layer_slice(params["units"]["rec_a"], 0)

    def f(h, conv, r):
        return rglru._rec_block(h, p, cfg, TExe(), None, conv, r)
    return f, (meta(2, 4, cfg.d_model), meta(2, cfg.conv_width - 1, cfg.drnn),
               meta(2, cfg.drnn))


# Each case is small, and runs its loops with more trips than the
# counted runs take (a plain loop 2 and 3, one whose trips a backward
# runs last one first 3 and 4, one that runs a backward inside each trip
# 1 and 2), so every loop's count is extrapolated.
CASES = {
    # granite: the training layers (5), attention chunk pairs (5 x 5) and
    # microbatches (3); prefill (4 layers, 4 x 4 pairs), decode, the AIMC
    # decode (28 kernel launches), the paged prefill leg
    "granite-train-layers": lambda: _bundle_case("granite-8b", "train", 16,
                                                 1, n_layers=5),
    "granite-train-chunks": lambda: _bundle_case("granite-8b", "train", 80,
                                                 1, n_layers=1),
    "granite-train-micro": lambda: _bundle_case("granite-8b", "train", 16, 3,
                                                n_layers=1),
    "granite-prefill": lambda: _bundle_case("granite-8b", "prefill", 64, 2,
                                            n_layers=4),
    "granite-decode": lambda: _bundle_case("granite-8b", "decode", 16, 2,
                                           n_layers=4),
    "granite-aimc-decode": lambda: _bundle_case(
        "granite-8b", "decode", 16, 2, *_programmed("granite-8b", n_layers=4),
        n_layers=4),
    "granite-paged-leg": _paged_case,
    "ce-chunks": _ce_case,
    # MoE (olmoe) training, and arctic's dense residual beside its MoE
    "olmoe-train": lambda: _bundle_case("olmoe-1b-7b", "train", 16, 1,
                                        n_layers=5),
    "arctic-decode": lambda: _bundle_case("arctic-480b", "decode", 16, 2,
                                          n_layers=4),
    # xlstm: pairs (5); one pair's mLSTM chunks (5) and sLSTM steps (40);
    # decode (4 pairs)
    "xlstm-train-pairs": lambda: _bundle_case("xlstm-350m", "train", 8, 1,
                                              n_layers=10),
    "xlstm-train-steps": lambda: _bundle_case("xlstm-350m", "train", 40, 1,
                                              n_layers=2),
    "xlstm-decode": lambda: _bundle_case("xlstm-350m", "decode", 16, 2,
                                         n_layers=8),
    # recurrentgemma: units (5) with a tail of 2; decode (4 units, tail
    # of 2); the stepped recurrence over 4 steps
    "rglru-train": lambda: _bundle_case("recurrentgemma-9b", "train", 16, 1,
                                        n_layers=17),
    "rglru-decode": lambda: _bundle_case("recurrentgemma-9b", "decode", 16,
                                         2, n_layers=14),
    "rglru-steps": _rec_steps_case,
    # seamless: encoder and decoder layers (5 each) in training; the
    # cross K/V, prefill and decode (4 decoder layers)
    "seamless-train": lambda: _bundle_case("seamless-m4t-large-v2", "train",
                                           16, 1, n_enc_layers=5,
                                           n_dec_layers=5),
    "seamless-prefill": lambda: _bundle_case("seamless-m4t-large-v2",
                                             "prefill", 64, 1,
                                             n_enc_layers=3,
                                             n_dec_layers=4),
    "seamless-decode": lambda: _bundle_case("seamless-m4t-large-v2", "decode",
                                            64, 2, n_enc_layers=3,
                                            n_dec_layers=4),
}
# The peak, where it is not exact: the highest live bytes of each moment
# class (its place in the loops and its rank there) is affine in each
# loop's trips once the trips a class sees are alike, but xlstm's sLSTM
# steps carry their gradients from step to step, so the backward of the
# second-last of 3 or 4 steps holds more than that of the second-last of
# 40 (+3.7%). FLOPs, bytes, launches and collectives are exact in every
# case, the peak in every other.
PEAK_BOUND = {"xlstm-train-steps": 0.05}
PEAK_KEYS = ("peak_bytes", "temp_bytes")
SEEN: set = set()


@pytest.mark.parametrize("case", list(CASES))
def test_extrapolated_equals_executed(case):
    fn, args = CASES[case]()
    got = stepstats.count_step(fn, *args)
    want = stepstats.count_step(fn, *args, full=True)
    for k in KEYS:
        if k in PEAK_KEYS and case in PEAK_BOUND:
            err = abs(got[k] - want[k]) / want["peak_bytes"]
            print(f"{case} {k}: {got[k]} extrapolated, {want[k]} executed "
                  f"({err:.4f} of the peak)")
            assert err <= PEAK_BOUND[case], (case, k, got[k], want[k])
            continue
        assert got[k] == want[k], (case, k, got[k], want[k])
    assert got["flops"] > 0 and want["runs"] == 1
    bumped = [lp for lp in got["loops"] if lp["n"] > lp["trips"]]
    assert bumped and got["runs"] in (1 + len(bumped), 2 + len(bumped))
    for lp in got["loops"]:
        if lp["n"] > lp["trips"] + 1:     # extrapolated past a counted run
            SEEN.add(lp["site"])


def _sites() -> set:
    """Every `trips` call site of the port, as ``module:line``."""
    out = set()
    for path in SRC.rglob("*.py"):
        if path.name == "stepstats.py":
            continue
        mod = "repro_torch." + ".".join(
            path.relative_to(SRC).with_suffix("").parts)
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"\bfor \w+ in (stepstats\.)?trips\(", line):
                out.add(f"{mod}:{i}")
    return out


def test_every_site_extrapolated():
    """Run after the cases (file order): every site was extrapolated past
    its counted runs in some case, but rglru's tail (n_layers % 3 <= 2
    trips)."""
    if not SEEN:                   # run alone: run the cases first
        for case in CASES:
            test_extrapolated_equals_executed(case)
    sites = _sites()
    lines = (SRC / "models" / "rglru.py").read_text().splitlines()
    tail = {s for s in sites if s.startswith("repro_torch.models.rglru:")
            and re.search(r"trips\((cfg\.n_tail|nt),",
                          lines[int(s.rsplit(":", 1)[1]) - 1])}
    assert len(tail) == 2, tail
    missing = sites - tail - SEEN
    assert not missing, missing


# ---------------------------------------------------------------------------
# whole steps against the reference's compiled HLO (one device)
# ---------------------------------------------------------------------------

def _ref_dot_flops(text: str) -> float:
    """Dot and convolution FLOPs of an optimized HLO module, every while
    body times its known trip count (nested loops multiply through),
    fusions and calls included."""
    from repro.launch import hlostats as hs
    a = hs.HloAnalyzer(text)
    memo: dict = {}

    def comp(name):
        if name in memo:
            return memo[name]
        memo[name] = 0.0
        tot = 0.0
        for ins in a.comps.get(name, []):
            if ins.opcode == "while":
                m = hs._TRIP_RE.search(ins.line)
                trips = int(m.group(1)) if m else 1
                for rx in (hs._BODY_RE, hs._COND_RE):
                    mm = rx.search(ins.line)
                    if mm:
                        tot += trips * comp(mm.group(1))
            elif ins.opcode in ("fusion", "call", "async-start"):
                mm = (hs._CALLS_RE.search(ins.line)
                      or hs._TO_APPLY_RE.search(ins.line))
                if mm:
                    tot += comp(mm.group(1))
            elif ins.opcode == "conditional":
                names = [s.strip().lstrip("%") for s in hs._BRANCHES_RE
                         .search(ins.line).group(1).split(",") if s.strip()]
                tot += sum(comp(n) for n in names) / len(names)
            elif ins.opcode == "dot":
                tot += a._dot_flops(ins)
            elif ins.opcode == "convolution":
                tot += a._conv_flops(ins)
        memo[name] = tot
        return tot
    return comp(a.entry)


def _ref_flops(kind, seq, batch, aimc=False, **cfg):
    from repro import configs as jconfigs
    from repro.compat import use_mesh
    from repro.core import program as jp
    from repro.core.aimc import AimcConfig
    from repro.launch import steps as jsteps
    from repro.launch.shardings import to_named
    from repro.models.layers import Execution as JExe
    spec = jconfigs.get_arch("granite-8b")
    spec = dataclasses.replace(
        spec, model_cfg=dataclasses.replace(spec.smoke_cfg, **cfg),
        cache_dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    exe, prog = JExe(), None
    if aimc:
        jcfg = AimcConfig(impl="ref")
        params = spec.model_module().init(jax.random.PRNGKey(0),
                                          spec.model_cfg)
        prog = jp.program_model(params, jp.MappingPlan(), jcfg)
        exe = JExe(mode="aimc", aimc=jcfg, programmed=True)
    with use_mesh(mesh):
        b = jsteps.make_step(spec, jconfigs.ShapeCell(kind, seq, batch, kind),
                             mesh, exe, program=prog)
        comp = jax.jit(b.fn, in_shardings=to_named(b.in_shardings, mesh),
                       out_shardings=to_named(b.out_shardings, mesh)
                       ).lower(*b.abstract_inputs).compile()
    return _ref_dot_flops(comp.as_text())


def _port_flops(kind, seq, batch, aimc=False, **cfg):
    prog_exe = _programmed("granite-8b", **cfg) if aimc else (None, TExe())
    fn, args = _bundle_case("granite-8b", kind, seq, batch, *prog_exe, **cfg)
    st = stepstats.count_step(fn, *args)
    return st, (st["flops_by_class"]["matmul"]
                + st["flops_by_class"]["crossbar"])


@pytest.mark.parametrize("kind,seq,batch,aimc,layers", [
    ("prefill", 64, 2, False, 2), ("decode", 64, 2, False, 2),
    ("decode", 16, 2, True, 1)])
def test_serving_step_flops_equal_reference(kind, seq, batch, aimc, layers):
    st, got = _port_flops(kind, seq, batch, aimc, n_layers=layers)
    want = _ref_flops(kind, seq, batch, aimc, n_layers=layers)
    assert got == want
    if aimc:    # every projection on the crossbar, 7 per layer
        assert st["launches"] == {"aimc_mvm_v2": 7 * layers}
        assert st["flops_by_class"]["crossbar"] > 0


def test_train_step_flops_against_reference():
    """granite's smoke widths with d_ff 320 (at the smoke's 160 the named
    difference is 1.09% of the step: attention is a larger share there)."""
    shape = dict(n_layers=3, d_ff=320)
    cfg = _spec("granite-8b", **shape).model_cfg
    seq, batch = 32, 4                 # 4 microbatches of 1 row
    _, got = _port_flops("train", seq, batch, **shape)
    want = _ref_flops("train", seq, batch, **shape)
    qc = kc = cfg.q_chunk
    pairs = (seq // qc) * (seq // kc)
    score = 2 * 1 * cfg.n_heads * qc * kc * cfg.hd
    assert got - want == cfg.n_layers * batch * pairs * score
    assert got == pytest.approx(want, rel=0.01)


# ---------------------------------------------------------------------------
# collectives on data:2,model:2
# ---------------------------------------------------------------------------

def _reference_histogram() -> dict:
    """The reference's collectives (`hlostats.analyze_hlo`, wire bytes per
    device) of the same train cell, compiled on 4 forced host devices by
    `tests/torch_mesh_oracle.py hlo` in a subprocess."""
    import os
    import pickle
    import subprocess
    import sys
    import tempfile
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "hlo.pkl"
        proc = subprocess.run(
            [sys.executable, str(root / "tests" / "torch_mesh_oracle.py"),
             "hlo", str(out)], env=env, capture_output=True, text=True,
            timeout=600, cwd=root)
        assert proc.returncode == 0 and "ORACLE_OK" in proc.stdout, \
            proc.stderr[-3000:]
        return pickle.loads(out.read_bytes())["granite-train-2x2"]


def test_train_collectives_2x2_hand_reckoned():
    """granite smoke (L=2, d=64, GQA 4/2 x 16, ff 160, vocab 128) on
    data:2,model:2: the norms (d + 2 L d floats) are replicated, so their
    f32 gradients are all-reduced over data (2x their bytes); every
    matrix is sharded on data and model, so its gradient is
    reduce-scattered over data from its model shard (numel / 2 floats).
    The reference's histogram of the same cell is printed beside it, not
    held to it: XLA's partitioner picks its own collectives (it gathers
    the FSDP-sharded weights in the forward, which the folded port has no
    counterpart of)."""
    from torch_mesh_oracle import HLO_CASES
    arch, shape, batch, seq = HLO_CASES["granite-train-2x2"]
    spec = _spec(arch)
    c = spec.model_cfg
    mesh = make_mesh(shape, ("data", "model"), ["meta"])
    bundle = tsteps.make_step(spec, ShapeCell("t", seq, batch, "train"),
                              mesh)
    st = stepstats.count_step(bundle.fn, *dryrun.step_inputs(bundle,
                                                             "train"))
    coll = dryrun.position_collectives(bundle, "train", st, mesh)
    d, ll, hd = c.d_model, c.n_layers, c.hd
    norms = d + 2 * ll * d
    mats = (2 * c.vocab * d + ll * (2 * d * c.n_heads * hd
                                    + 2 * d * c.n_kv_heads * hd
                                    + 3 * d * c.d_ff))
    assert coll == {"all-reduce": 2 * 4 * norms,
                    "reduce-scatter": 4 * mats // 2,
                    "total": 2 * 4 * norms + 4 * mats // 2}
    assert st["collectives"] == {"total": 0}     # digital: no joins
    ref = _reference_histogram()
    assert ref["total"] > 0
    print(f"granite smoke train cell on data:2,model:2, wire bytes per "
          f"position: port {coll}; reference (hlostats) "
          f"{ {k: int(v) for k, v in ref.items()} }")


def test_piece_joins_2x2_hand_reckoned():
    """A programmed decode cell on data:2,model:2 under a 2-core
    schedule, at widths whose padded Np splits into two 128-column pieces
    (d = 256, kv heads 4 x 64, ff 256): each of the 7 projections per layer
    is two launches whose [B, Np] f32 outputs are joined (an all-gather of
    the whole output) on x's device."""
    from repro_torch.core.schedule import CoreSchedule
    cfg = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
               head_dim=64, d_ff=256)
    spec = _spec("granite-8b", **cfg)
    prog, exe = _programmed("granite-8b", contexts=2, **cfg)
    sched = CoreSchedule.from_program(prog)
    mesh = make_mesh((2, 2), ("data", "model"), ["meta"])
    b = 2
    bundle = tsteps.make_step(spec, ShapeCell("d", 16, b, "decode"), mesh,
                              exe, program=sched)
    st = stepstats.count_step(bundle.fn, *dryrun.step_inputs(bundle,
                                                             "decode"))
    assert st["launches"] == {"aimc_mvm_v2": 2 * 7 * 2}
    assert st["collectives"] == {"all-gather": 2 * 7 * b * 256 * 4,
                                 "total": 2 * 7 * b * 256 * 4}
    coll = dryrun.position_collectives(bundle, "decode", st, mesh)
    assert coll["total"] == 2 * 7 * b * 256 * 4 / 2


# ---------------------------------------------------------------------------
# no side effects without a counter
# ---------------------------------------------------------------------------

def _plain_hooks(monkeypatch):
    """Every hook replaced by the plain loop it stands for."""
    for mod in (transformer, xlstm, rglru, encdec, tsteps):
        for name, plain in (("trips", lambda n, x=None: range(n)),
                            ("fill", lambda seq, n: seq),
                            ("keep_context", lambda fn: fn)):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, plain)
    monkeypatch.setattr(layers.stepstats, "trips",
                        lambda n, x=None: range(n))
    monkeypatch.setattr(layers.stepstats, "fill", lambda seq, n: seq)


def _cpu_inputs(abstract, seed):
    rng = np.random.default_rng(seed)

    def make(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype in (torch.int32, torch.int64):
            return torch.from_numpy(rng.integers(0, 8, tuple(t.shape))
                                    ).to(t.dtype)
        return torch.from_numpy(rng.standard_normal(tuple(t.shape)) * 0.1
                                ).to(t.dtype)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            vals = [go(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
        return make(t)
    return go(abstract)


def _leaves(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _leaves(v)]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t] if isinstance(t, torch.Tensor) else []


@pytest.mark.parametrize("arch,kind,cfg", [
    ("granite-8b", "train", dict(n_layers=2)),
    ("xlstm-350m", "prefill", dict(n_layers=4)),
    ("recurrentgemma-9b", "decode", dict(n_layers=4)),
    ("seamless-m4t-large-v2", "prefill", dict(n_enc_layers=2,
                                              n_dec_layers=2))])
def test_hooks_change_nothing_without_a_counter(monkeypatch, arch, kind,
                                                cfg):
    """The train step runs the transformer's checkpointed layers (under
    `keep_context`), its attention chunks, the CE chunks and the
    microbatches; the xlstm prefill its pairs, mLSTM chunks and sLSTM
    steps; the recurrentgemma decode its units and tail; the seamless
    prefill its encoder and decoder layers and the cross K/V."""
    spec = _spec(arch, **cfg)
    seq = 64 if spec.family == "audio" else 16
    bundle = tsteps.make_step(spec, ShapeCell(kind, seq, 2, kind), None)
    args = _cpu_inputs(bundle.abstract_inputs, 0)
    if kind == "train":
        from repro_torch.optim import make_optimizer
        params = _cpu_params(spec)
        args = (params, make_optimizer(spec.optimizer)[0](params), args[2],
                prng.PRNGKey(3))
    hooked = _leaves(bundle.fn(*args))
    _plain_hooks(monkeypatch)
    plain = _leaves(bundle.fn(*args))
    assert len(hooked) == len(plain) > 0
    for a, b in zip(hooked, plain):
        assert torch.equal(a, b)
