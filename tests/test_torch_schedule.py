"""Parity of the port's multi-core scheduler (`repro_torch/core/schedule.py`)
and multi-core paper nets (`models/paper_nets.py` `*_forward_multicore`,
`cnn_pipeline_stages`) with the JAX reference on the CPU.

Tolerances:
  * static books (ledgers, phase times, modeled latency, contexts, the
    roofline fit): equal with ``==``, the same float64 Python arithmetic;
  * `select_columns`: the int8 codes and f32 scales equal;
  * multi-core forwards against JAX's, noise off and with programming noise
    from a key, and every shard's output under counter read noise from a
    key: within the kernel-vs-oracle atol 1e-5 * max(1, max|y|)
    (`tests/test_kernel_v2.py:60`; f32 association of the row-block sum).
    Weights are the reference's, carried across with `params_from_numpy`;
  * inside the port, column splits equal the 1-core run bit for bit (noise
    off), and the CNN pipeline equals `cnn_forward_multicore` bit for bit
    and the single-core ctx path within 1e-5 (the fused relu epilogue).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import costmodel as jcm
from repro.core import program as jp
from repro.core import schedule as js
from repro.core.aimc import AimcConfig as JConfig
from repro.core.noise import NoiseModel as JNoise
from repro.models import paper_nets as jpn
from repro_torch.convert import params_from_numpy
from repro_torch.core import costmodel as tcm
from repro_torch.core import isa, prng
from repro_torch.core import program as tp
from repro_torch.core import schedule as ts
from repro_torch.core.aimc import AimcConfig as TConfig
from repro_torch.core.aimc import aimc_apply, program_linear
from repro_torch.core.noise import NoiseModel as TNoise
from repro_torch.models import paper_nets as tpn

NH, T_STEPS, B, LSTM_ROWS = 64, 3, 2, 164
NOISES = {"off": (JNoise(enabled=False), TNoise(enabled=False)),
          "on": (JNoise(sigma_read=0.003), TNoise(sigma_read=0.003)),
          # read noise large enough to move ADC codes on a few rows
          "loud": (JNoise(sigma_read=0.05), TNoise(sigma_read=0.05))}


def _cfgs(noise: str, rows: int):
    nm_j, nm_t = NOISES[noise]
    return (JConfig(tile_rows=rows, tile_cols=4096, impl="ref", noise=nm_j),
            TConfig(tile_rows=rows, tile_cols=4096, noise=nm_t))


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _close(y_t, y_j):
    y_j = np.asarray(y_j)
    assert tuple(y_t.shape) == y_j.shape
    err = np.abs(y_t.numpy() - y_j).max()
    assert err <= 1e-5 * max(1.0, float(np.abs(y_j).max())), err


def _books(sched, cm):
    """Everything static a schedule reports, priced on both Table I systems
    of the cost-model module ``cm``, as plain tuples."""
    out = {"ledgers": [dataclasses.astuple(led) for led in sched.ledgers()],
           "totals": dataclasses.astuple(sched.ledger_totals()),
           "n_cores": sched.n_cores, "n_phases": sched.n_phases}
    for sys_ in (cm.HIGH_POWER, cm.LOW_POWER):
        for coupling in ("tight", "loose"):
            key = f"{sys_.name}/{coupling}"
            out[key + "/phases"] = sched.phase_times(sys_, coupling=coupling)
            out[key + "/latency"] = sched.modeled_latency(sys_,
                                                          coupling=coupling)
    return out


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    return {
        "mlp": (jpn.mlp_init(jax.random.PRNGKey(0), 256),
                rng.standard_normal((3, 256)).astype(np.float32)),
        "lstm": (jpn.lstm_init(jax.random.PRNGKey(1), NH),
                 rng.standard_normal((T_STEPS, B, 50)).astype(np.float32)),
        "cnn": (jax.jit(lambda k: jpn.cnn_init(k, "F", img=64))(
            jax.random.PRNGKey(2)),
                rng.standard_normal((B, 64, 64, 3)).astype(np.float32)),
    }


def _programs(nets, net, noise="off"):
    """The reference's and the port's program of one net, and its rows."""
    rows = {"mlp": 128, "lstm": LSTM_ROWS, "cnn": 512}[net]
    cfg_j, cfg_t = _cfgs(noise, rows)
    p, _ = nets[net]
    fn_j = {"mlp": jpn.mlp_program, "lstm": jpn.lstm_program,
            "cnn": lambda p, c, k: jpn.cnn_program(p, "F", c, k)}[net]
    fn_t = {"mlp": tpn.mlp_program, "lstm": tpn.lstm_program,
            "cnn": lambda p, c, k: tpn.cnn_program(p, "F", c, k)}[net]
    return (fn_j(p, cfg_j, jax.random.PRNGKey(9)),
            fn_t(_carry(p), cfg_t, prng.PRNGKey(9)))


# ---------------------------------------------------------------------------
# static books equal the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mlp1", "mlp2", "mlp4", "mlp1_fused",
                                  "mlp2_fused", "lstm1", "lstm2", "lstm5",
                                  "cnn"])
def test_schedule_books_equal_reference(nets, case):
    net = case[:4] if case.startswith("lstm") else case[:3]
    pj, pt = _programs(nets, net)
    if net == "mlp":
        fused = case.endswith("_fused")
        cores = int(case[3])
        sj = js.mlp_schedule(pj, cores, fuse_epilogue=fused)
        st = ts.mlp_schedule(pt, cores, fuse_epilogue=fused)
    elif net == "lstm":
        cores = int(case[4])
        sj, st = js.lstm_schedule(pj, cores, NH), ts.lstm_schedule(pt, cores,
                                                                   NH)
    else:
        sj = js.cnn_schedule(pj, jpn.CNN_SPECS["F"], img=64)
        st = ts.cnn_schedule(pt, tpn.CNN_SPECS["F"], img=64)
    assert [dataclasses.astuple(s) for s in st.shards] == \
        [dataclasses.astuple(s) for s in sj.shards]
    assert _books(st, tcm) == _books(sj, jcm)
    assert st.summary() == sj.summary()


@pytest.mark.parametrize("n_contexts", [2, 4])
def test_from_program_books_and_contexts_equal_reference(n_contexts):
    spec = get_arch("granite-8b")
    jparams = spec.model_module().init(jax.random.PRNGKey(0), spec.smoke_cfg)
    tparams = _carry(jparams)
    jcfg, tcfg = JConfig(impl="ref"), TConfig()
    jprog = jp.program_model(jparams, jp.MappingPlan(n_contexts=n_contexts),
                             jcfg)
    tprog = tp.program_model(tparams, tp.MappingPlan(n_contexts=n_contexts),
                             tcfg)
    assert tprog.names == jprog.names
    assert tprog.contexts == jprog.contexts
    assert len(set(tprog.contexts)) == n_contexts
    for pipelined in (False, True):
        sj = js.CoreSchedule.from_program(jprog, pipelined=pipelined)
        st = ts.CoreSchedule.from_program(tprog, pipelined=pipelined)
        assert _books(st, tcm) == _books(sj, jcm)
        assert st.ledger_totals() == tprog.mvm_counts()


def test_modeled_latency_equals_costmodel_evaluate():
    """The schedule and the Workload IR price one mapping through the same
    accounting: equal (the reference holds them within 1e-9)."""
    from repro_torch.core import workloads as twl
    w = tpn.mlp_init(prng.PRNGKey(0), 128, device="cpu")
    prog = tpn.mlp_program(w, TConfig(tile_rows=128, tile_cols=4096))
    for cores, case in ((1, "ana_case1"), (2, "ana_case3"),
                        (4, "ana_case4")):
        want = tcm.evaluate(twl.mlp_workloads(128)[case],
                            tcm.HIGH_POWER).time_s
        got = ts.mlp_schedule(prog, cores).modeled_latency(tcm.HIGH_POWER)
        assert abs(got - want) <= 1e-9 * want


def test_overlap_roofline_fit_equals_reference():
    times = {1: 3.1e-3, 2: 2.2e-3, 4: 1.9e-3, 8: 1.6e-3}
    fj, ft = js.OverlapRoofline.fit(times), ts.OverlapRoofline.fit(times)
    assert (ft.t_step_s, ft.t_round_s) == (fj.t_step_s, fj.t_round_s)
    assert ft.speedup(1, 8) == fj.speedup(1, 8)
    assert ft.residuals(times) == fj.residuals(times)
    with pytest.raises(ValueError):
        ts.OverlapRoofline.fit({4: 1e-3})


# ---------------------------------------------------------------------------
# select_columns and the split forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranges", [((0, 77),), ((50, 100), (150, 200)),
                                    ((0, 200),)])
def test_select_columns_codes_equal_reference(ranges):
    from repro.core.aimc import program_linear as jprogram
    w = np.random.default_rng(3).standard_normal((300, 200)).astype(
        np.float32) * 0.05
    jcfg, tcfg = _cfgs("off", 128)
    sj = js.select_columns(jprogram(jnp.asarray(w), jcfg), ranges)
    st = ts.select_columns(program_linear(torch.from_numpy(w), tcfg), ranges)
    assert (st.k, st.n) == (sj.k, sj.n)
    np.testing.assert_array_equal(st.w_q.numpy(), np.asarray(sj.w_q))
    np.testing.assert_array_equal(st.s_w.numpy(), np.asarray(sj.s_w))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 300)).astype(np.float32))
    full = aimc_apply(program_linear(torch.from_numpy(w), tcfg), x, tcfg)
    idx = np.concatenate([np.arange(a, b) for a, b in ranges])
    assert torch.equal(aimc_apply(st, x, tcfg), full[:, idx])


def test_select_columns_validates():
    st = program_linear(torch.full((64, 32), 0.1), TConfig(tile_rows=128))
    with pytest.raises(ValueError):
        ts.select_columns(st, [(0, 40)])
    with pytest.raises(ValueError):
        ts.select_columns(st, [(0, 16), (8, 24)])
    prog = tpn.mlp_program(tpn.mlp_init(prng.PRNGKey(0), 128, device="cpu"),
                           TConfig(tile_rows=128))
    with pytest.raises(ValueError):
        ts.CoreSchedule(prog, [ts.Shard("fc1", 0, 0, cols=((0, 64),)),
                               ts.Shard("fc2", 0, 1)])
    with pytest.raises(KeyError):
        ts.CoreSchedule(prog, [ts.Shard("nope", 0, 0)])
    with pytest.raises(ValueError):
        tpn.lstm_forward_multicore(
            tpn.lstm_init(prng.PRNGKey(1), 30, device="cpu"),
            torch.zeros(1, 1, 50), 30, TConfig(tile_rows=128), cores=5)


@pytest.mark.parametrize("noise", ["off", "on"])
@pytest.mark.parametrize("cores", [1, 2, 4])
def test_mlp_multicore_matches_reference(nets, noise, cores):
    cfg_j, cfg_t = _cfgs(noise, 128)
    p, x = nets["mlp"]
    y_j, _ = jpn.mlp_forward_multicore(p, jnp.asarray(x), cfg_j, cores,
                                       jax.random.PRNGKey(5))
    y_t, sched = tpn.mlp_forward_multicore(_carry(p), torch.from_numpy(x),
                                           cfg_t, cores, prng.PRNGKey(5))
    assert sched.n_cores == cores
    _close(y_t, y_j)


@pytest.mark.parametrize("noise", ["off", "on"])
@pytest.mark.parametrize("cores", [1, 2, 5])
def test_lstm_multicore_matches_reference(nets, noise, cores):
    cfg_j, cfg_t = _cfgs(noise, LSTM_ROWS)
    p, xs = nets["lstm"]
    y_j, _ = jpn.lstm_forward_multicore(p, jnp.asarray(xs), NH, cfg_j, cores,
                                        jax.random.PRNGKey(6))
    y_t, sched = tpn.lstm_forward_multicore(_carry(p), torch.from_numpy(xs),
                                            NH, cfg_t, cores,
                                            prng.PRNGKey(6))
    assert sched.n_cores == cores
    _close(y_t, y_j)


@pytest.mark.parametrize("noise", ["off", "on"])
def test_cnn_multicore_matches_reference(nets, noise):
    cfg_j, cfg_t = _cfgs(noise, 512)
    p, x = nets["cnn"]
    y_j = jax.jit(lambda p, x, k: jpn.cnn_forward_multicore(
        p, x, "F", cfg_j, k)[0])(p, x, jax.random.PRNGKey(7))
    y_t, sched = tpn.cnn_forward_multicore(_carry(p), torch.from_numpy(x),
                                           "F", cfg_t, prng.PRNGKey(7))
    assert sched.pipelined and sched.n_cores == 5
    _close(y_t, y_j)


@pytest.mark.parametrize("net,cores", [("mlp", 4), ("lstm", 5)])
def test_split_apply_under_read_noise_matches_reference(nets, net, cores):
    """Counter read noise from a key: shard i draws from fold_in(key, i)."""
    pj, pt = _programs(nets, net, "loud")
    if net == "mlp":
        sj, st = js.mlp_schedule(pj, cores), ts.mlp_schedule(pt, cores)
    else:
        sj, st = js.lstm_schedule(pj, cores, NH), ts.lstm_schedule(pt, cores,
                                                                   NH)
    rng = np.random.default_rng(8)
    for name in pj.names:
        x = rng.standard_normal((3, pj[name].k)).astype(np.float32)
        y_j = sj.apply(name, jnp.asarray(x), jax.random.PRNGKey(11))
        y_t = st.apply(name, torch.from_numpy(x), prng.PRNGKey(11))
        _close(y_t, y_j)
        assert not torch.equal(y_t, st.apply(name, torch.from_numpy(x)))


@pytest.mark.parametrize("net,cores", [("mlp", 2), ("mlp", 4), ("lstm", 2),
                                       ("lstm", 5)])
def test_column_splits_bit_equal_to_one_core(nets, net, cores):
    p, x = nets[net]
    if net == "mlp":
        _, cfg = _cfgs("off", 128)
        run = lambda c: tpn.mlp_forward_multicore(  # noqa: E731
            _carry(p), torch.from_numpy(x), cfg, c)[0]
    else:
        _, cfg = _cfgs("off", LSTM_ROWS)
        run = lambda c: tpn.lstm_forward_multicore(  # noqa: E731
            _carry(p), torch.from_numpy(x), NH, cfg, c)[0]
    assert torch.equal(run(cores), run(1))


def test_cnn_pipeline_equals_multicore_and_ctx_path(nets):
    _, cfg = _cfgs("off", 512)
    p, x = nets["cnn"]
    tparams, xt = _carry(p), torch.from_numpy(x)
    y_mc, sched = tpn.cnn_forward_multicore(tparams, xt, "F", cfg)
    stages = tpn.cnn_pipeline_stages(tparams, "F", cfg, sched)
    outs, times = ts.pipeline_run(stages, [xt, xt])
    assert len(times) == 6 and all(t >= 0 for t in times)
    assert torch.equal(outs[0], y_mc) and torch.equal(outs[1], y_mc)
    y_ctx, _ = tpn.cnn_forward(tparams, xt, "F", cfg)
    err = float((y_mc - y_ctx).abs().max())
    assert err <= 1e-5 * max(1.0, float(y_ctx.abs().max()))


def test_ledgers_partition_and_scale(nets):
    pj, pt = _programs(nets, "mlp")
    tot, ref = ts.mlp_schedule(pt, 4).ledger_totals(), pt.mvm_counts()
    assert (tot.dequeue, tot.dequeue_bytes) == (ref.dequeue,
                                                ref.dequeue_bytes)
    assert (tot.queue, tot.process) == (2 * ref.queue, 2 * ref.process)
    for cores in (1, 2):
        assert ts.mlp_schedule(pt, cores).ledger_totals() == ref
    _, pc = _programs(nets, "cnn")
    sched = ts.cnn_schedule(pc, tpn.CNN_SPECS["F"], img=64)
    for led, sh in zip(sched.ledgers(), sched.shards):
        st = pc[sh.name]
        one = isa.mvm_counts(st.k, st.n, pc.cfg.tile_rows)
        assert led.cm == one.scaled(sh.count)


def test_serve_cli_cores_prints_books_that_sum_to_program(capsys):
    from repro_torch.launch import serve as tserve
    run = tserve.main(["--smoke", "--device", "cpu", "--exec", "aimc",
                       "--requests", "2", "--prompt-len", "4", "--gen", "3",
                       "--cores", "4", "--pipeline"])
    out = capsys.readouterr().out
    assert "per-core ledgers" in out and "core3:" in out
    assert run.schedule.pipelined and run.schedule.n_cores == 4
    assert run.schedule.ledger_totals() == run.program.mvm_counts()
    with pytest.raises(SystemExit):
        tserve.main(["--smoke", "--device", "cpu", "--cores", "2"])
