"""The port's serving stack against the JAX reference: `repro_torch.runtime.
engine.ServeEngine` and `repro_torch.launch.serve.main` (on ``--device
cpu``) emit the JAX `ServeEngine`'s tokens for the same weights (carried
across with `params_from_numpy` / an npz archive) and the same 4-request
Poisson trace, digital and programmed AIMC; the per-request CM_* ledgers
reconcile exactly.

Tolerance: tokens are equal. Logits differ between the frameworks by
~1e-6 (f32 op order), so every greedy choice must win by a top-2 margin of
at least MARGIN in a teacher-forced reference forward — a flipped token is
then a fault, not a near-tie. The arrival rate is high enough that every
request is admitted before the first decode step, so the decode batches
(and with them the dynamic DAC scale) are the same in both engines."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core import program as jp
from repro.models.layers import Execution as JExe
from repro.runtime import batcher as jb
from repro.runtime.engine import ServeEngine as JEngine
from repro_torch.configs import get_arch as tget
from repro_torch.convert import flatten_to_numpy, params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import program as tp
from repro_torch.launch import serve as tserve
from repro_torch.models.layers import Execution as TExe
from repro_torch.runtime import batcher as tb
from repro_torch.runtime.engine import ServeEngine as TEngine

MARGIN = 1e-4
SPEC = get_arch("granite-8b")
CFG = SPEC.smoke_cfg
N_REQ, PROMPT, GEN, RATE, SEED = 4, 8, 6, 1e7, 0


def _trace():
    return jb.poisson_trace(N_REQ, RATE, seed=SEED,
                            prompt_len=(PROMPT // 2, PROMPT),
                            max_new=(1, GEN), vocab=CFG.vocab)


@pytest.fixture(scope="module")
def weights():
    return SPEC.model_module().init(jax.random.PRNGKey(SEED), CFG)


def _jax_serve(params, mode, trace=None):
    if mode == "aimc":
        cfg = ja.AimcConfig(impl="ref")
        program = jp.program_model(params, jp.MappingPlan(), cfg)
        params = program.install(params)
        exe = JExe(mode="aimc", aimc=cfg, compute_dtype="float32",
                   programmed=True)
    else:
        program, exe = None, JExe(compute_dtype="float32")
    eng = JEngine(SPEC.model_module(), CFG, exe, params, n_slots=4,
                  prompt_pad=PROMPT, max_seq=PROMPT + GEN,
                  cache_dtype=jnp.float32, family=SPEC.family,
                  module=SPEC.module, program=program)
    eng.warmup()
    return eng.serve(trace or _trace()), params, exe


def _min_margin(params, exe, report):
    """Smallest top-2 logit margin over every generated token, by a
    teacher-forced reference forward of prompt + generated tokens."""
    model = SPEC.model_module()
    worst = np.inf
    for rec in report.records.values():
        seq = list(rec.request.prompt) + rec.tokens[:-1]
        logits, _ = model.forward(params, jnp.asarray([seq], jnp.int32),
                                  CFG, exe)
        lg = np.asarray(logits[0, len(rec.request.prompt) - 1:])
        top2 = np.sort(lg, axis=-1)[:, -2:]
        worst = min(worst, float((top2[:, 1] - top2[:, 0]).min()))
    return worst


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_port_engine_emits_reference_tokens(weights, mode):
    rep_j, jparams_inst, jexe = _jax_serve(weights, mode)
    assert _min_margin(jparams_inst, jexe, rep_j) >= MARGIN
    tparams = params_from_numpy(jax.tree.map(np.asarray, weights))
    program = None
    exe = TExe(compute_dtype="float32")
    if mode == "aimc":
        cfg = ta.AimcConfig()
        program = tp.program_model(tparams, tp.MappingPlan(), cfg)
        tparams = program.install(tparams)
        exe = TExe(mode="aimc", aimc=cfg, compute_dtype="float32",
                   programmed=True)
    eng = TEngine(tget("granite-8b").model_module(),
                  tget("granite-8b").smoke_cfg, exe, tparams, n_slots=4,
                  prompt_pad=PROMPT, max_seq=PROMPT + GEN, program=program)
    eng.warmup()
    reqs = [tb.Request(**dataclasses.asdict(r)) for r in _trace()]
    rep_t = eng.serve(reqs)
    for rid, rec in rep_j.records.items():
        assert rep_t.tokens(rid) == rec.tokens, f"request {rid} diverged"
        assert rep_t.records[rid].finish_reason == rec.finish_reason
    assert rep_t.n_prefills == rep_j.n_prefills
    assert rep_t.observed_vectors == rep_t.useful_vectors
    if mode == "aimc":
        led, static = tb.reconcile(program, rep_t.records,
                                   rep_t.observed_vectors)
        assert led == static
        books = eng.ledgers(rep_t)
        assert set(books) == set(rep_t.records)
        led_j, _ = jb.reconcile(jp.program_model(weights, jp.MappingPlan(),
                                                 ja.AimcConfig(impl="ref")),
                                rep_j.records, rep_j.observed_vectors)
        assert dataclasses.astuple(led) == dataclasses.astuple(led_j)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_serve_main_on_cpu_matches_reference(weights, mode, tmp_path):
    path = tmp_path / "granite_smoke.npz"
    np.savez(path, **flatten_to_numpy(jax.tree.map(np.asarray, weights)))
    run = tserve.main(["--arch", "granite-8b", "--smoke", "--exec", mode,
                       "--requests", str(N_REQ), "--prompt-len", str(PROMPT),
                       "--gen", str(GEN), "--slots", "4", "--trace",
                       f"poisson:{RATE:g}", "--seed", str(SEED),
                       "--device", "cpu", "--weights", str(path)])
    rep_j, _, _ = _jax_serve(weights, mode)
    for rid, rec in rep_j.records.items():
        assert run.report.tokens(rid) == rec.tokens
    assert (run.program is None) == (mode == "digital")


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_serve_from_seed_alone_matches_reference(weights, mode):
    """No weights carried across: the port draws granite's smoke weights
    from ``--seed`` on JAX's keys (`transformer.init(PRNGKey(seed))`) and
    serves the JAX engine's tokens on the same synchronized trace."""
    run = tserve.main(["--arch", "granite-8b", "--smoke", "--exec", mode,
                       "--requests", str(N_REQ), "--prompt-len", str(PROMPT),
                       "--gen", str(GEN), "--slots", "4", "--seed", str(SEED),
                       "--device", "cpu"])
    trace = jb.synchronized_trace(N_REQ, prompt_len=PROMPT, max_new=GEN,
                                  seed=SEED, vocab=CFG.vocab)
    assert [r.prompt for r in run.requests] == [r.prompt for r in trace]
    rep_j, jparams_inst, jexe = _jax_serve(weights, mode, trace)
    assert _min_margin(jparams_inst, jexe, rep_j) >= MARGIN
    for rid, rec in rep_j.records.items():
        assert run.report.tokens(rid) == rec.tokens, f"request {rid}"


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_decode_chunk_ladder_is_token_invariant(weights, chunk):
    """Digital lanes are row-independent: tokens do not depend on how many
    decode steps a chunk runs between host syncs."""
    tparams = params_from_numpy(jax.tree.map(np.asarray, weights))
    tm = tget("granite-8b")
    reqs = tb.synchronized_trace(3, prompt_len=PROMPT, max_new=GEN, seed=1,
                                 vocab=CFG.vocab)
    outs = []
    for k in (1, chunk):
        eng = TEngine(tm.model_module(), tm.smoke_cfg,
                      TExe(compute_dtype="float32"), tparams, n_slots=2,
                      prompt_pad=PROMPT, max_seq=PROMPT + GEN,
                      decode_chunk=k)
        rep = eng.serve(reqs)
        outs.append([rep.tokens(r.rid) for r in reqs])
        assert all(len(t) == GEN for t in outs[-1])
    assert outs[0] == outs[1]
    assert TEngine.chunk_ladder(6) == (1, 2, 4, 6)


def test_serve_refuses_missing_card_and_gen1_is_prefill_only(weights):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            tserve.main(["--smoke", "--requests", "1"])
    run = tserve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--gen", "1", "--prompt-len", "4"])
    assert run.report.n_steps == 0 and run.report.n_prefills == 3
    assert all(r.finish_reason == "length"
               for r in run.report.records.values())


def test_eos_retires_lane_and_is_not_payload(weights):
    """An EOS token retires its lane mid-decode ("eos"), is kept out of the
    delivered tokens, and still counts in the CM_* vector books. A fixed
    DAC scale makes lanes independent, so the other requests' tokens are
    those of the EOS-free run."""
    tparams = params_from_numpy(jax.tree.map(np.asarray, weights))
    tm = tget("granite-8b")
    cfg = ta.AimcConfig(input_scale=0.05)
    program = tp.program_model(tparams, tp.MappingPlan(), cfg)
    inst = program.install(tparams)
    exe = TExe(mode="aimc", aimc=cfg, compute_dtype="float32",
               programmed=True)
    reqs = tb.synchronized_trace(3, prompt_len=PROMPT, max_new=GEN, seed=2,
                                 vocab=CFG.vocab)

    def serve(eos):
        eng = TEngine(tm.model_module(), tm.smoke_cfg, exe, inst, n_slots=3,
                      prompt_pad=PROMPT, max_seq=PROMPT + GEN,
                      program=program, eos_id=eos)
        return eng.serve(reqs)

    free = serve(None)
    eos = free.tokens(0)[2]               # request 0 emits it at step 2
    rep = serve(eos)
    rec = rep.records[0]
    assert rec.finish_reason == "eos"
    assert rec.tokens == free.tokens(0)[:2]
    assert rec.vectors == PROMPT + 2
    for rid, r in rep.records.items():
        assert eos not in r.tokens
        assert r.tokens == free.tokens(rid)[:len(r.tokens)]
    led, static = tb.reconcile(program, rep.records, rep.observed_vectors)
    assert led == static


def test_serve_fuse_gates_matches_unfused_and_needs_aimc():
    """--fuse-gates serves w_gate + w_up as one stacked state (K3 on the
    card); on the same synchronized trace its tokens and CM_* books equal
    the unfused run's."""
    argv = ["--smoke", "--device", "cpu", "--exec", "aimc", "--requests", "3",
            "--prompt-len", "6", "--gen", "5"]
    plain = tserve.main(argv)
    fused = tserve.main(argv + ["--fuse-gates"])
    assert "w_gu" in fused.engine.params["blocks"]
    assert "w_gu" not in plain.engine.params["blocks"]
    for rid in plain.report.records:
        assert fused.report.tokens(rid) == plain.report.tokens(rid)
    assert fused.report.useful_vectors == plain.report.useful_vectors
    with pytest.raises(SystemExit):
        tserve.main(["--smoke", "--device", "cpu", "--fuse-gates"])
