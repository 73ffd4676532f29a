"""The port's sharded serving cells (`launch.steps.make_prefill_step` /
`make_serve_step` on a mesh) held to the JAX package's own jitted cells
(`tests/torch_mesh_oracle.py cells`, one subprocess on 4 forced
host-platform devices, meshes built with ``Auto`` axes, inputs placed with
``device_put(to_named(in_shardings))``, the cells run inside ``use_mesh``):

  * granite smoke programmed under a 2-context `CoreSchedule` (fixed DAC
    scale 0.1, program key 2) on 2x2 and 1x2: the states column-sharded
    by `shard_aimc_states`;
  * granite smoke ``--int8`` digital on 2x1 (`strip_fsdp`);
  * olmoe smoke digital on 2x2 (the MoE through `moe._moe_sharded`);
  * xlstm smoke digital on 2x2 (recurrent caches; its prefill cell is
    forward-only, so the decode cells start from the reference's
    `prefill` cache);
  * seamless smoke digital on 2x2 (the enc-dec cache, at the frames and
    decoder tokens of `tests/test_torch_encdec_serve.py`).

Each case runs one prefill cell and `CELL_STEPS` decode-cell steps (the
first fed the prefill cell's token) on seeded numpy inputs with f32
caches. Pinned: every leaf's in/out spec equals the reference's; tokens
equal the reference's bit for bit, replaying a DAC code only at a tie
(`tests/torch_code_replay.py`, within 8 ulps of 127); caches within
ATOL x max(1, max|ref|) (ATOL = 1e-5); tokens and caches bit-equal to the
port's one-device cells on the same inputs (the MoE's run inside the
ambient mesh: its per-data-shard capacity routes otherwise than one
device's, in both packages); one K2 dispatch per column piece (a state
splits where Np divides 128 x M, the one-device cell one per state).
Also: a cell takes `Placed` trees (granite on 2x2), and ``mesh=None``
keeps the one-device bundle (no specs).
"""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.configs import ShapeCell, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core.prng import PRNGKey
from repro_torch.core.program import (MappingPlan, installed_entries,
                                      program_model)
from repro_torch.core.schedule import CoreSchedule
from repro_torch.kernels import ops as tops
from repro_torch.launch import shardings as ts
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Execution
from torch_code_replay import replaying_in_port
from torch_mesh_oracle import CELL_CASES, CELL_STEPS, cell_inputs

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
GELU_TIE = 8 * 2.0 ** -17     # as tests/test_torch_serve_steps.py


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells_oracle") / "oracle.pkl"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_oracle.py"),
         "cells", str(out)], env=env, capture_output=True, text=True,
        timeout=900, cwd=ROOT)
    assert proc.returncode == 0 and "ORACLE_OK" in proc.stdout, \
        proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _spec(arch):
    spec = get_arch(arch)
    return dataclasses.replace(spec, model_cfg=spec.smoke_cfg,
                               cache_dtype="float32")


def _flat(specs):
    return {"/".join(ts._path_str(p)): tuple(s) for p, s in
            ts._flatten_with_path(specs, is_leaf=ts._is_spec)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not tree:
        return ()
    return torch.from_numpy(np.array(tree))


def _serving(name, ref):
    """(spec, exe, params, program) of a case, from the reference's init
    (the programmed codes checked equal to the reference's)."""
    arch, mode, _ = CELL_CASES[name]
    spec = _spec(arch)
    exe = Execution(compute_dtype="float32")
    if mode == "int8":
        return spec, dataclasses.replace(exe, serve_int8=True), \
            params_from_numpy(ref["params"]), None
    params = params_from_numpy(ref["raw"])
    if mode != "prog":
        return spec, exe, params, None
    acfg = ta.AimcConfig(input_scale=0.1)
    prog = program_model(params, MappingPlan(n_contexts=2), acfg, PRNGKey(2))
    for n, st in zip(prog.names, prog.states):
        np.testing.assert_array_equal(st.w_q.numpy(), ref["codes"][n], n)
    return spec, Execution(mode="aimc", aimc=acfg, compute_dtype="float32",
                           programmed=True), prog.install(params), \
        CoreSchedule.from_program(prog)


def _run(name, ref, mesh, place_inputs=False):
    """The port's cells on ``mesh`` (None: one device) for a case ->
    (prefill bundle, decode bundle, prefill (tok, cache), decode [(tok,
    cache)], K2 dispatches). The decode cells start from the reference's
    first cache and token; replayed DAC codes are counted."""
    spec, exe, params, sched = _serving(name, ref)
    seq, batch = cell_inputs(spec)
    b = batch["tokens"].shape[0]
    pre = tsteps.make_step(spec, ShapeCell("p", seq, b, "prefill"), mesh,
                           exe, program=sched)
    dec = tsteps.make_step(spec, ShapeCell("d", seq, b, "decode"), mesh,
                           exe, program=sched)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    cache0 = _torch(ref["cache0"])
    if place_inputs:
        params = ts.place_tree(params, pre.in_specs[0], mesh, views=True)
        tb = ts.place_tree(tb, pre.in_specs[1], mesh, views=True)
        cache0 = ts.place_tree(cache0, dec.in_specs[1], mesh, views=True)
    calls, seen = [0], {}
    with replaying_in_port(ref["log"], seen, GELU_TIE):
        replay = tops.aimc_matmul_v2

        def counted(*a, **k):
            calls[0] += 1
            return replay(*a, **k)
        tops.aimc_matmul_v2 = counted
        try:
            tok, cache = pre.fn(params, tb)
            first = (ts.whole_tree(tok), ts.whole_tree(cache))
            tok, cache = torch.from_numpy(ref["prefill"][0]), cache0
            steps = []
            for _ in range(CELL_STEPS):
                tok, cache = dec.fn(params, cache, tok)
                steps.append((ts.whole_tree(tok), ts.whole_tree(cache)))
        finally:
            tops.aimc_matmul_v2 = replay
    assert seen.get("away", 0) == 0, seen
    return pre, dec, first, steps, calls[0]


def _close(got, want, what):
    if isinstance(want, tuple) and not want:
        assert got == (), what
        return
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, (what, k)
        if k == "len":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} {k}")
            continue
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g.to(torch.float32).numpy(), w, rtol=0,
            atol=ATOL * max(1.0, float(np.abs(w).max())),
            err_msg=f"{what} {k}")


def _equal(a, b, what):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
        return
    assert sorted(a) == sorted(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


def _per_pass(params, mesh):
    """K2 dispatches per forward pass: each programmed state's layers
    times its column pieces under `shard_aimc_states`' spec."""
    n = 0
    for st in installed_entries(params).values():
        spec = ts.fit_spec(ts.aimc_state_spec(st.w_q.dim()),
                           tuple(st.w_q.shape), mesh)
        n += st.instances * ts.state_splits(st, spec, mesh)
    return n


@pytest.mark.parametrize("name", list(CELL_CASES))
def test_mesh_cells_match_reference_jitted_cells(oracle, name, monkeypatch):
    ref = oracle[name]
    arch, mode, shape = CELL_CASES[name]
    mesh = make_mesh(shape, ("data", "model"), ["cpu"])
    moe_calls = []
    real_moe = tmoe._moe_sharded
    monkeypatch.setattr(tmoe, "_moe_sharded", lambda *a, **k: moe_calls.append(
        1) or real_moe(*a, **k))
    pre, dec, first, steps, k2 = _run(name, ref, mesh,
                                      place_inputs=name == "granite-prog-2x2")
    # the specs: every leaf the reference's
    for kind, bundle in (("prefill", pre), ("decode", dec)):
        for i, tree in enumerate(bundle.in_specs):
            assert _flat(tree) == ref["specs"][f"{kind}_in"][i], (kind, i)
        for i, tree in enumerate(bundle.out_specs):
            assert _flat(tree) == ref["specs"][f"{kind}_out"][i], (kind, i)
    # tokens bit for bit, caches within ATOL of the reference's
    np.testing.assert_array_equal(first[0].numpy(), ref["prefill"][0])
    _close(first[1], ref["prefill"][1], f"{name} prefill")
    for i, ((tok, cache), (rtok, rcache)) in enumerate(zip(steps,
                                                          ref["decode"])):
        np.testing.assert_array_equal(tok.numpy(), rtok, f"{name} step {i}")
        _close(cache, rcache, f"{name} step {i}")
    # one K2 dispatch per column piece, and some state split
    if mode == "prog":
        _, _, params, _ = _serving(name, ref)
        per_pass = _per_pass(params, mesh)
        assert per_pass > sum(st.instances for st in
                              installed_entries(params).values())
        assert k2 == per_pass * (1 + CELL_STEPS), (k2, per_pass)
    else:
        assert k2 == 0
    assert bool(moe_calls) == (arch == "olmoe-1b-7b")
    # the port's one-device cells on the same inputs; the MoE's inside the
    # ambient mesh, whose per-data-shard capacity routes otherwise than
    # one device's (the reference's mesh cells route as the mesh does)
    with (compat.use_mesh(mesh) if arch == "olmoe-1b-7b"
          else contextlib.nullcontext()):
        one, _, first1, steps1, k21 = _run(name, ref, None)
    assert one.in_specs is None and one.out_specs is None
    _equal(first[0], first1[0], "prefill token")
    if first[1] != ():
        _equal(first[1], first1[1], "prefill cache")
    for i, ((t, c), (t1, c1)) in enumerate(zip(steps, steps1)):
        _equal(t, t1, f"token {i}")
        _equal(c, c1, f"cache {i}")
    if mode == "prog":
        assert k21 == (1 + CELL_STEPS) * sum(
            st.instances for st in installed_entries(params).values())
