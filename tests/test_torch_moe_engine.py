"""The MoE zoo (olmoe-1b-7b, arctic-480b smoke configs) through the port's
serving stack against the JAX reference: `repro_torch.launch.serve.main`
on ``--device cpu`` emits the JAX `ServeEngine`'s tokens for olmoe's seed
and Poisson trace, programmed (``--exec aimc``), and the CM_* ledgers of
both reconcile and are equal; arctic serves at a depth cut; the paged KV
engine serves MoE bit-equal to the dense one; the prefix cache and
chunked prefill refuse MoE as the reference does; ``--fuse-gates``
(olmoe's MHA QKV on one stack) serves the unfused tokens.

Tolerance: tokens are equal. The arrival rate admits every request before
the first decode step, so both engines route the same decode batches
(capacity routing depends on the batch, in the reference too)."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core import program as jp
from repro.models.layers import Execution as JExe
from repro.runtime import batcher as jb
from repro.runtime.engine import ServeEngine as JEngine
from repro_torch.configs import get_arch as tget
from repro_torch.launch import serve as tserve
from repro_torch.runtime import batcher as tb
from repro_torch.runtime.engine import ServeEngine as TEngine

RATE, PROMPT, GEN = 1e7, 10, 4


def _argv(arch, *extra):
    return ["--arch", arch, "--smoke", "--exec", "aimc", "--requests", "4",
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--slots", "4",
            "--seed", "1", "--device", "cpu", *extra]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b"])
def test_moe_serve_from_seed_matches_reference(arch):
    """The smoke config served through the CLI from ``--seed`` (weights on
    JAX's keys, programmed under ``PRNGKey(seed + 2)``) emits the JAX
    engine's tokens on the same Poisson trace; the per-request CM_*
    ledgers reconcile, and equal the reference's. (arctic's dense residual
    is held to the reference per function in `test_torch_moe.py`; a second
    JAX engine here would cost the tier-1 run more than it covers.)"""
    run = tserve.main(_argv(arch, "--trace", f"poisson:{RATE:g}"))
    led, static = tb.reconcile(run.program, run.report.records,
                               run.report.observed_vectors)
    assert led == static
    spec = get_arch(arch)
    jparams = spec.model_module().init(jax.random.PRNGKey(1), spec.smoke_cfg)
    cfg = ja.AimcConfig(impl="ref")
    program = jp.program_model(jparams, jp.MappingPlan(), cfg,
                               jax.random.PRNGKey(3))
    assert program.names == run.program.names
    eng = JEngine(spec.model_module(), spec.smoke_cfg,
                  JExe(mode="aimc", aimc=cfg, compute_dtype="float32",
                       programmed=True),
                  program.install(jparams), n_slots=4, prompt_pad=PROMPT,
                  max_seq=PROMPT + GEN, cache_dtype=jnp.float32,
                  family=spec.family, module=spec.module, program=program)
    eng.warmup()
    rep_j = eng.serve([jb.Request(**dataclasses.asdict(r))
                       for r in run.requests])
    assert rep_j.n_prefills == run.report.n_prefills == 4
    for rid, rec in rep_j.records.items():
        assert run.report.tokens(rid) == rec.tokens, f"{arch} request {rid}"
    led_j, static_j = jb.reconcile(program, rep_j.records,
                                   rep_j.observed_vectors)
    assert led_j == static_j
    assert dataclasses.astuple(led) == dataclasses.astuple(led_j)


def test_moe_fused_and_paged_serve_the_dense_tokens():
    """olmoe's --fuse-gates (wq/wk/wv on one G=3 stack, experts unfused)
    and the paged KV cache each serve the plain dense run's tokens on a
    synchronized trace."""
    plain = tserve.main(_argv("olmoe-1b-7b"))
    fused = tserve.main(_argv("olmoe-1b-7b", "--fuse-gates"))
    paged = tserve.main(_argv("olmoe-1b-7b", "--page-size", "4",
                              "--paged-verify"))
    blocks = fused.engine.params["blocks"]
    assert "wqkv" in blocks and "we_gate" in blocks
    for rid in plain.report.records:
        assert fused.report.tokens(rid) == plain.report.tokens(rid)
        assert paged.report.tokens(rid) == plain.report.tokens(rid)


def test_moe_refuses_prefix_cache_and_chunked_prefill():
    spec = tget("olmoe-1b-7b")
    from repro_torch.core import prng
    from repro_torch.models.layers import Execution
    params = spec.model_module().init(prng.PRNGKey(0), spec.smoke_cfg,
                                      device="cpu")
    for kw in ({"prefix_cache": True}, {"prefill_chunk": 4}):
        with pytest.raises(ValueError, match="MoE"):
            TEngine(spec.model_module(), spec.smoke_cfg,
                    Execution(compute_dtype="float32"), params,
                    max_seq=16, prompt_pad=8, page_size=4,
                    cache_dtype=torch.float32, **kw)
    with pytest.raises(ValueError, match="MoE"):
        tserve.main(_argv("olmoe-1b-7b", "--page-size", "4",
                          "--prefix-cache"))


def test_arctic_depth_cut_serves():
    """``--layers 1`` (the card's cut of arctic-480b) serves one layer of
    the smoke config and reconciles its ledgers."""
    run = tserve.main(_argv("arctic-480b", "--layers", "1"))
    assert run.engine.cfg.n_layers == 1
    assert run.program["blocks/we_gate"].stack_shape == (
        1, tget("arctic-480b").smoke_cfg.n_experts)
    assert run.report.generated_tokens > 0
