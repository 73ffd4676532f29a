"""The port's sharded serving held to the JAX package's own
`ShardedServeEngine` (`tests/torch_mesh_oracle.py serve`, one subprocess on
4 forced host-platform devices, meshes built with ``Auto`` axes):

  * ``serve --mesh data:2,model:2`` on digital olmoe smoke: the CLI serves
    inside the ambient mesh, as the reference's does, so the MoE
    dispatches per data shard (`moe._moe_sharded`); its tokens equal the
    reference engine's inside ``use_mesh`` on the CLI's synchronized
    requests (and differ from a dispatch with global capacity);
  * `ShardedServeEngine` outside an ambient mesh, the reference's own
    two-device test body: granite smoke programmed (fixed DAC scale 0.1,
    program key 2) on 2x1 and 1x2, xlstm smoke digital on 2x1.

Tolerance: tokens equal.
"""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core.prng import PRNGKey
from repro_torch.core.program import MappingPlan, program_model
from repro_torch.core.schedule import CoreSchedule
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Execution
from repro_torch.runtime.batcher import synchronized_trace
from repro_torch.runtime.engine import ShardedServeEngine
from torch_mesh_oracle import SERVE_CASES

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_oracle") / "oracle.pkl"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_oracle.py"),
         "serve", str(out)], env=env, capture_output=True, text=True,
        timeout=900, cwd=ROOT)
    assert proc.returncode == 0 and "ORACLE_OK" in proc.stdout, \
        proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def test_serve_cli_mesh_digital_moe_matches_reference(oracle, monkeypatch):
    calls = []
    real = tmoe._moe_sharded

    def spy(*a, **k):
        y = real(*a, **k)
        calls.append(y is not None)
        return y
    monkeypatch.setattr(tmoe, "_moe_sharded", spy)
    argv = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
            "--requests", "4", "--prompt-len", "8", "--gen", "6",
            "--slots", "4"]
    run = tserve.main(argv + ["--mesh", "data:2,model:2"])
    want = oracle["olmoe-digital-2x2-ambient"]
    got = {r.rid: list(run.report.tokens(r.rid)) for r in run.requests}
    assert got == want
    assert any(calls)
    legacy = tserve.main(argv + ["--mesh", "2x2"])   # same ambient mesh
    assert {r.rid: list(legacy.report.tokens(r.rid))
            for r in legacy.requests} == want
    plain = tserve.main(argv)                        # 1x1: global capacity
    assert {r.rid: list(plain.report.tokens(r.rid))
            for r in plain.requests} != want


def _engine(name):
    arch, programmed, shape, _ = SERVE_CASES[name]
    spec = get_arch(arch)
    cfg = spec.smoke_cfg
    jparams = jget(arch).model_module().init(jax.random.PRNGKey(0), cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    prog = sched = None
    exe = Execution(compute_dtype="float32")
    if programmed:
        acfg = ta.AimcConfig(input_scale=0.1)
        prog = program_model(params, MappingPlan(n_contexts=2), acfg,
                             PRNGKey(2))
        params = prog.install(params)
        sched = CoreSchedule.from_program(prog)
        exe = Execution(mode="aimc", aimc=acfg, compute_dtype="float32",
                        programmed=True)
    return spec, cfg, ShardedServeEngine(
        spec.model_module(), cfg, exe, params,
        mesh=make_mesh(shape, ("data", "model"), ["cpu"]), n_slots=2,
        prompt_pad=8, max_seq=20, family=spec.family, module=spec.module,
        cache_dtype=torch.float32, program=prog, schedule=sched)


@pytest.mark.parametrize("name", [n for n, c in SERVE_CASES.items()
                                  if not c[3]])
def test_sharded_engine_matches_reference_sharded_engine(oracle, name):
    _, cfg, eng = _engine(name)
    eng.warmup()
    reqs = synchronized_trace(4, prompt_len=8, max_new=6, seed=1,
                              vocab=cfg.vocab)
    rep = eng.serve(list(reqs))
    assert {r.rid: list(rep.tokens(r.rid)) for r in reqs} == oracle[name]
