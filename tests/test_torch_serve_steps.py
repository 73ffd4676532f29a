"""Parity of the port's serving step builders (`repro_torch/launch/steps.py`:
`make_prefill_step`, `make_serve_step`, `make_step`'s three kinds,
`_serve_params_shape`, `input_specs`; on `runtime.engine`'s
`static_prefill_closure` / `static_decode_closure`) with the JAX
reference, for every arch's smoke config, digital and programmed (noise
off). The reference's jitted `make_*_step` assert under this container's
jax mesh, so its side is composed from its parts as its steps compose
them: `static_prefill_closure` / `static_decode_closure` driven directly
(``impl="ref"``, no mesh) on a cache from its `prefill`. Weights are the
reference's (`init` on seed 0, `convert.params_from_numpy`); tokens,
frames and patch embeddings are drawn with numpy. The cells are tiny
(batch 2, seq 32; the audio cell seq 256, so that its
``max(seq // 4, 64)`` decoder tokens fit its cache) and the specs' cache
dtype is f32 here, so caches compare at ATOL.

Tolerances: greedy tokens and lengths exact, every cache tensor within
ATOL x max(1, max|ref|) (ATOL = 1e-5); shapes and dtypes of the abstract
inputs exact. Programmed runs replay the reference's DAC codes where the
two round a tie apart (`tests/torch_code_replay.py`, within GELU_TIE:
GeLU and SiLU differ by a few ulps between the frameworks); a code that
differs away from a tie fails."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import aimc as ja
from repro.core import program as jp
from repro.launch import steps as jsteps
from repro.models.layers import Execution as JExe
from repro.runtime import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.configs import ShapeCell
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import prng
from repro_torch.core import program as tp
from repro_torch.core.schedule import CoreSchedule
from repro_torch.launch import steps as tsteps
from repro_torch.models.layers import Execution as TExe
from torch_code_replay import logging_reference, replaying_in_port

ATOL = 1e-5
GELU_TIE = 8 * 2.0 ** -17     # as tests/test_torch_encdec_serve.py
ARCHS = tconfigs.list_archs()
B, PROMPT, STEPS = 2, 8, 2


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=0,
                               atol=ATOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _smoke_spec(spec):
    """The arch at its smoke config, as a serving spec with f32 caches."""
    return dataclasses.replace(
        spec, model_cfg=spec.smoke_cfg, cache_dtype="float32",
        n_patches=getattr(spec.smoke_cfg, "n_patches", spec.n_patches))


def _cell(spec, kind):
    return ShapeCell(kind, 256 if spec.family == "audio" else 32, B, kind)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch, JAX spec, port spec, mode -> (JAX exe, JAX params, port exe,
    port params, port program))."""
    name = request.param
    jspec = _smoke_spec(jconfigs.get_arch(name))
    tspec = _smoke_spec(tconfigs.get_arch(name))
    jparams = jspec.model_module().init(jax.random.PRNGKey(0),
                                        jspec.model_cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    modes = {"digital": (JExe(compute_dtype="float32"), jparams,
                         TExe(compute_dtype="float32"), tparams, None)}
    jcfg, tcfg = ja.AimcConfig(impl="ref"), ta.AimcConfig()
    jprog = jp.program_model(jparams, jp.MappingPlan(), jcfg)
    tprog = tp.program_model(tparams, tp.MappingPlan(), tcfg)
    for n in tprog.names:
        np.testing.assert_array_equal(tprog[n].w_q.numpy(),
                                      np.asarray(jprog[n].w_q), n)
    modes["aimc"] = (
        JExe(mode="aimc", aimc=jcfg, compute_dtype="float32",
             programmed=True), jprog.install(jparams),
        TExe(mode="aimc", aimc=tcfg, compute_dtype="float32",
             programmed=True), tprog.install(tparams), tprog)
    return name, jspec, tspec, modes


def _batch(spec, cell, seed):
    """A numpy batch of the cell's `batch_shapes` (float leaves f32)."""
    rng = np.random.default_rng(seed)
    vocab = spec.model_cfg.vocab
    out = {}
    for k, (shape, dt) in tsteps.batch_shapes(spec, cell).items():
        if dt == torch.int32:
            out[k] = rng.integers(1, vocab, shape).astype(np.int32)
        else:
            out[k] = rng.standard_normal(shape).astype(np.float32)
    return out


def _replayed(jfn, tfn):
    """``jfn()`` under the reference's DAC log, then ``tfn()`` replaying it;
    no code may differ away from a tie."""
    log, seen = {}, {}
    with logging_reference(log):
        jout = jfn()
    with replaying_in_port(log, seen, GELU_TIE):
        tout = tfn()
    assert seen.get("away", 0) == 0, seen
    return jout, tout


def _tree_close(tcache, jcache, what):
    if isinstance(jcache, tuple) and not jcache:
        assert tcache == ()
        return
    assert sorted(tcache) == sorted(jcache), what
    for k, jv in jcache.items():
        tv = tcache[k]
        assert tuple(tv.shape) == jv.shape, (what, k)
        if k == "len":
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        else:
            _close(tv, jv, f"{what} {k}")


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_prefill_cell_matches_reference_closure(arch, mode):
    """The prefill cell (max_seq = seq_len): the first token bit-equal and
    the cache within ATOL of the reference's `static_prefill_closure` on
    the same batch (recurrent archs: forward-only, an empty cache)."""
    name, jspec, tspec, modes = arch
    je_, jparams, te_, tparams, prog = modes[mode]
    cell = _cell(tspec, "prefill")
    bundle = tsteps.make_step(tspec, cell, None, te_, program=prog)
    jfn = jengine.static_prefill_closure(
        jspec.model_module(), jspec.model_cfg, je_, family=jspec.family,
        module=jspec.module, max_seq=cell.seq_len, cache_dtype=jnp.float32)
    batch = _batch(tspec, cell, 1)
    (jt, jc), (tt, tc) = _replayed(
        lambda: jfn(jparams, {k: jnp.asarray(v) for k, v in batch.items()}),
        lambda: bundle.fn(tparams, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}))
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (B, 1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _tree_close(tc, jc, name)
    # the abstract inputs: meta params (installed states under a program)
    # and the batch of `batch_shapes`
    p_abs, b_abs = bundle.abstract_inputs
    assert all(v.device.type == "meta" for v in b_abs.values())
    if prog is not None:
        states = tp.installed_entries(p_abs)
        assert sorted(states) == sorted(prog.names)
        for n, st in states.items():
            assert st.w_q.device.type == "meta"
            assert st.w_q.shape == prog[n].w_q.shape, n
            assert st.s_w.shape == prog[n].s_w.shape, n


def _prefilled(spec, model, params, exe, frames, toks, cache_dtype, max_seq,
               patches):
    """The model's own prefill cache of a [B, PROMPT] prompt."""
    kw = dict(max_seq=max_seq, cache_dtype=cache_dtype)
    if spec.family == "audio":
        return model.prefill(params, frames, toks, spec.model_cfg, exe, **kw)
    if spec.family == "vlm":
        kw["patch_embeds"] = patches
    return model.prefill(params, toks, spec.model_cfg, exe, **kw)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_decode_cell_matches_reference_closure(arch, mode):
    """The decode cell: STEPS greedy steps from a prefilled [B, PROMPT]
    cache of the cell's seq_len, each token bit-equal and each cache within
    ATOL of the reference's `static_decode_closure`; the abstract cache is
    the reference's `init_cache` layout (enc-dec: cross K/V of
    max(seq // tgt_ratio, 64) frames)."""
    name, jspec, tspec, modes = arch
    je_, jparams, te_, tparams, prog = modes[mode]
    cell = _cell(tspec, "decode")
    cfg = tspec.model_cfg
    bundle = tsteps.make_step(tspec, cell, None, te_, program=prog)
    jstep = jengine.static_decode_closure(jspec.model_module(),
                                          jspec.model_cfg, je_)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab, (B, PROMPT)).astype(np.int32)
    frames = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    patches = rng.standard_normal(
        (B, tspec.n_patches, cfg.d_model)).astype(np.float32)

    def jrun():
        _, c = _prefilled(jspec, jspec.model_module(), jparams, je_,
                          jnp.asarray(frames), jnp.asarray(toks),
                          jnp.float32, cell.seq_len, jnp.asarray(patches))
        out, tok = [], jnp.asarray(toks[:, -1:])
        for _ in range(STEPS):
            tok, c = jstep(jparams, c, tok)
            out.append((tok, c))
        return out

    def trun():
        _, c = _prefilled(tspec, tspec.model_module(), tparams, te_,
                          torch.from_numpy(frames), torch.from_numpy(toks),
                          torch.float32, cell.seq_len,
                          torch.from_numpy(patches))
        out, tok = [], torch.from_numpy(toks[:, -1:])
        for _ in range(STEPS):
            tok, c = bundle.fn(tparams, c, tok)
            out.append((tok, c))
        return out

    jout, tout = _replayed(jrun, trun)
    for i, ((jt, jc), (tt, tc)) in enumerate(zip(jout, tout)):
        assert tt.dtype == torch.int32 and tuple(tt.shape) == (B, 1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), f"step {i}")
        _tree_close(tc, jc, f"{name} step {i}")
    _, c_abs, t_abs = bundle.abstract_inputs
    model = jspec.model_module()
    if jspec.family == "audio":
        want = jax.eval_shape(lambda: model.init_cache(
            jspec.model_cfg, B, cell.seq_len,
            max(cell.seq_len // jspec.tgt_ratio, 64), jnp.float32))
    else:
        want = jax.eval_shape(lambda: model.init_cache(
            jspec.model_cfg, B, cell.seq_len, jnp.float32))
    assert sorted(c_abs) == sorted(want)
    for k, v in want.items():
        assert tuple(c_abs[k].shape) == v.shape, k
        assert str(c_abs[k].dtype).split(".")[-1] == str(v.dtype), k
        assert c_abs[k].device.type == "meta"
    assert tuple(t_abs.shape) == (B, 1) and t_abs.dtype == torch.int32


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("name", ARCHS)
def test_serve_params_shape_matches_reference(name):
    """`_serve_params_shape` at the published widths, bf16 and int8: the
    reference's `jax.eval_shape` tree leaf for leaf (path, shape, dtype),
    every leaf a meta tensor (nothing allocated)."""
    jspec, tspec = jconfigs.get_arch(name), tconfigs.get_arch(name)
    for int8 in (False, True):
        jshape = jsteps._serve_params_shape(
            jspec.model_module(), jspec, jspec.model_cfg, int8=int8)
        jflat = {"/" + "/".join(str(k.key) for k in path): leaf
                 for path, leaf in jax.tree_util.tree_flatten_with_path(
                     jshape)[0]}
        tflat = dict(_flat(tsteps._serve_params_shape(
            tspec.model_module(), tspec, tspec.model_cfg, int8=int8)))
        assert sorted(tflat) == sorted(jflat), int8
        for path, leaf in tflat.items():
            assert leaf.device.type == "meta", path
            assert tuple(leaf.shape) == jflat[path].shape, path
            assert str(leaf.dtype).split(".")[-1] == str(
                jflat[path].dtype), path
        if int8:
            assert any(p.endswith("/q") for p in tflat)


def test_make_step_builds_every_cell():
    """Every (arch, shape) cell of `all_cells` builds at the published
    widths without allocating: train, prefill and decode bundles whose
    batch is the reference's `abstract_batch` (a train cell's inputs end
    with its [2] key, as the reference's do) and, for decode, whose cache
    is the reference's `init_cache` layout of the cell."""
    for name, shape in tconfigs.all_cells():
        spec, jspec = tconfigs.get_arch(name), jconfigs.get_arch(name)
        cell, jcell = tconfigs.SHAPES[shape], jconfigs.SHAPES[shape]
        bundle = tsteps.make_step(spec, cell)
        abstract = tsteps.input_specs(spec, cell)
        assert len(abstract) == len(bundle.abstract_inputs)
        if cell.kind == "decode":
            _, cache, tok = abstract
            b, s = cell.global_batch, cell.seq_len
            model, dt = jspec.model_module(), jnp.dtype(jspec.cache_dtype)
            args = ((b, s, max(s // jspec.tgt_ratio, 64), dt)
                    if jspec.family == "audio" else (b, s, dt))
            want = jax.eval_shape(
                lambda: model.init_cache(jspec.model_cfg, *args))
            for k, v in want.items():
                assert tuple(cache[k].shape) == v.shape, (name, shape, k)
            assert tuple(tok.shape) == (b, 1)
            continue
        if cell.kind == "train":     # (params, opt_state, batch, key)
            key = abstract[3]
            assert tuple(key.shape) == (2,) and key.device.type == "meta"
        batch = abstract[2] if cell.kind == "train" else abstract[-1]
        jbatch = jsteps.abstract_batch(jspec, jcell)
        assert sorted(batch) == sorted(jbatch)
        for k, v in jbatch.items():
            assert tuple(batch[k].shape) == v.shape, (name, shape, k)
            assert batch[k].device.type == "meta"
            assert str(batch[k].dtype).split(".")[-1] == str(v.dtype)


def test_serving_steps_carry_the_schedule_and_refuse_a_mesh():
    """A `CoreSchedule` serves through its program and rides on the bundle
    (per-core ledgers); a training cell refuses a program; a mesh now
    builds both serving cells (the sharded serving cells), each with the
    reference's in specs leaf for leaf (`make_step` on an `AbstractMesh`
    of data:2,model:2: the states column-sharded under the 2-core
    schedule, a programmed state's spec keeping ``model`` where its Np
    divides 2)."""
    from jax.sharding import AbstractMesh
    from jax.sharding import PartitionSpec as JP

    from repro.core.schedule import CoreSchedule as JSched
    from repro.launch import shardings as js
    from repro_torch.launch import shardings as ts
    from repro_torch.launch.mesh import make_mesh
    spec = _smoke_spec(tconfigs.get_arch("granite-8b"))
    params = spec.model_module().init(prng.PRNGKey(0), spec.model_cfg,
                                      device="cpu")
    prog = tp.program_model(params, tp.MappingPlan(n_contexts=2),
                            ta.AimcConfig())
    sched = CoreSchedule.from_program(prog)
    exe = TExe(mode="aimc", programmed=True, compute_dtype="float32")
    for kind in ("prefill", "decode"):
        cell = _cell(spec, kind)
        bundle = tsteps.make_step(spec, cell, None, exe, program=sched)
        assert bundle.schedule is sched
        assert sorted(tp.installed_entries(bundle.abstract_inputs[0])) == \
            sorted(prog.names)
        assert tsteps.make_step(spec, cell, None, exe,
                                program=prog).schedule is None
        bundle = tsteps.make_step(spec, cell,
                                  make_mesh((2, 2), ("data", "model"),
                                            ["cpu"]), exe, program=sched)
        assert bundle.schedule is sched and callable(bundle.fn)
        jspec = _smoke_spec(jconfigs.get_arch("granite-8b"))
        jparams = jspec.model_module().init(jax.random.PRNGKey(0),
                                            jspec.model_cfg)
        jprog = jp.program_model(jparams, jp.MappingPlan(n_contexts=2),
                                 ja.AimcConfig(impl="ref"))
        want = jsteps.make_step(
            jspec, jconfigs.ShapeCell(kind, cell.seq_len, cell.global_batch,
                                      kind),
            AbstractMesh((2, 2), ("data", "model")),
            JExe(mode="aimc", aimc=ja.AimcConfig(impl="ref"),
                 compute_dtype="float32", programmed=True),
            program=JSched.from_program(jprog))
        for got, ref in zip(bundle.in_specs, want.in_shardings):
            flat_ref = {"/".join(js._path_str(p)): tuple(s) for p, s in
                        jax.tree_util.tree_flatten_with_path(
                            ref, is_leaf=lambda x: isinstance(x, JP))[0]}
            assert {"/".join(ts._path_str(p)): tuple(s) for p, s in
                    ts._flatten_with_path(got, is_leaf=ts._is_spec)} \
                == flat_ref, kind
    with pytest.raises(ValueError, match="serving-only"):
        tsteps.make_step(spec, ShapeCell("t", 16, 2, "train"), None, exe,
                         program=prog)
