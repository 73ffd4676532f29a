"""The JAX package's own mesh code as the oracle of the port's sharded
paths, run in a subprocess on 4 forced host-platform devices (XLA's device
count is fixed when its backend starts, so the parity tests cannot run it
in their own process):

    python tests/torch_mesh_oracle.py train OUT.pkl CKPT_DIR
    python tests/torch_mesh_oracle.py serve OUT.pkl
    python tests/torch_mesh_oracle.py cells OUT.pkl
    python tests/torch_mesh_oracle.py hlo OUT.pkl

The mesh is built as ``jax.make_mesh(shape, axes, axis_types=(Auto,) *
n)``: the reference's `launch.mesh.make_mesh` leaves this jax's default
``Explicit`` axes, under which its ``with_sharding_constraint`` asserts;
with ``Auto`` axes its mesh code runs unchanged. Inputs are placed with
``jax.device_put(x, to_named(specs, mesh))``. Results are pickled as numpy
trees (bf16 leaves as ml_dtypes arrays).

``train``: the jitted `make_train_step` of each `TRAIN_CASES` entry on
the seed-0 init, the seed-0 batch and rng [0, 0] (the DAC and programmed
codes logged for `torch_code_replay`), `moe_ffn` under `use_mesh` for
`MOE_CASES`, `make_global_array` and `checkpoint.restore(mesh=, pspecs=)`
per device. ``serve``: tokens of `ShardedServeEngine` for `SERVE_CASES`.
``cells``: the jitted `make_prefill_step` / `make_serve_step` of each
`CELL_CASES` entry inside ``use_mesh``: their spec trees, one prefill cell
and `CELL_STEPS` decode-cell steps on seeded numpy inputs (f32 caches; the
DAC codes logged for `torch_code_replay`). ``hlo``: the collective
histogram (`hlostats.analyze_hlo`) of the jitted `make_train_step` of
each `HLO_CASES` entry, compiled on its mesh.
"""

import contextlib
import dataclasses
import os
import pickle
import sys

import numpy as np

# name -> (arch, exec, mesh shape, global batch, seq)
TRAIN_CASES = {
    "olmoe-digital-2x2": ("olmoe-1b-7b", "digital", (2, 2), 16, 32),
    "olmoe-noise-1x2": ("olmoe-1b-7b", "noise", (1, 2), 8, 32),
    "olmoe-noise-2x2": ("olmoe-1b-7b", "noise", (2, 2), 16, 32),
    "granite-noise-1x2": ("granite-8b", "noise", (1, 2), 4, 32),
    "granite-noise-2x2": ("granite-8b", "noise", (2, 2), 4, 32),
    "arctic-bf16-2x2": ("arctic-480b", "digital", (2, 2), 8, 32),
}
SIGMA_READ = 0.002
# name -> (tokens, capacity factor): 16 tokens of olmoe smoke (8 experts,
# top-2) on data:2,model:2; 0.5 overflows experts within a shard
MOE_CASES = {"cf1.25": (16, 1.25), "cf0.5-overflow": (16, 0.5)}
# name -> (arch, programmed, mesh shape, in use_mesh)
SERVE_CASES = {
    "olmoe-digital-2x2-ambient": ("olmoe-1b-7b", False, (2, 2), True),
    "granite-prog-2x1": ("granite-8b", True, (2, 1), False),
    "granite-prog-1x2": ("granite-8b", True, (1, 2), False),
    "xlstm-digital-2x1": ("xlstm-350m", False, (2, 1), False),
}

# name -> (arch, mode, mesh shape); mode "prog" is programmed under a
# 2-context CoreSchedule (fixed DAC scale 0.1, program key 2), "int8" the
# digital int8 tree
CELL_CASES = {
    "granite-prog-2x2": ("granite-8b", "prog", (2, 2)),
    "granite-prog-1x2": ("granite-8b", "prog", (1, 2)),
    "granite-int8-2x1": ("granite-8b", "int8", (2, 1)),
    "olmoe-digital-2x2": ("olmoe-1b-7b", "digital", (2, 2)),
    "xlstm-digital-2x2": ("xlstm-350m", "digital", (2, 2)),
    "seamless-digital-2x2": ("seamless-m4t-large-v2", "digital", (2, 2)),
}
CELL_STEPS = 5
# name -> (arch, mesh shape, global batch, seq): granite smoke's train
# cell whose collectives tests/test_torch_stepstats.py reckons by hand
HLO_CASES = {"granite-train-2x2": ("granite-8b", (2, 2), 4, 32)}
# (batch, prompt, cell seq_len): xlstm's chunkwise forward needs a
# seq_len that its chunk (8) divides. The audio cell's frames and decoder
# tokens are those of tests/test_torch_encdec_serve.py; its seq_len is the
# least at which the reference builds the prefill cell (whose abstract
# batch holds max(seq // tgt_ratio, 64) decoder tokens in seq rows)
CELL_LM = (4, 8, 16)
CELL_AUDIO = (2, 24, 10, 64)     # batch, frames, decoder tokens, seq_len


def cell_inputs(spec, seed=0):
    """(the cell's seq_len, a numpy batch with every `batch_shapes` key):
    seeded tokens (and labels, which the prefill ignores), f32 frames."""
    rng = np.random.default_rng(seed)
    vocab = spec.smoke_cfg.vocab
    if spec.family == "audio":
        b, src, tgt, seq = CELL_AUDIO
        toks = rng.integers(1, vocab, (b, tgt)).astype(np.int32)
        frames = rng.standard_normal(
            (b, src, spec.smoke_cfg.d_model)).astype(np.float32)
        return seq, {"frames": frames, "tokens": toks, "labels": toks}
    b, prompt, seq = CELL_LM
    toks = rng.integers(1, vocab, (b, prompt)).astype(np.int32)
    return seq, {"tokens": toks, "labels": toks}


def flat_specs(tree):
    """{path: spec as a tuple} of a spec tree."""
    import jax
    from jax.sharding import PartitionSpec as JP

    from repro.launch import shardings as js
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(js._path_str(p)): tuple(s) for p, s in leaves}


def auto_mesh(shape, axes=("data", "model")):
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _opt_fields(state):
    return {f: _np(getattr(state, f)) for f in state._fields}


def _shards(arr, mesh):
    """{position: numpy block} of a sharded array, positions row-major."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return {pos: by_dev[d] for pos, d in np.ndenumerate(mesh.devices)}


def _exe(mode):
    from repro.core.aimc import AimcConfig
    from repro.core.noise import NoiseModel
    from repro.models.layers import Execution
    if mode == "noise":
        return Execution(mode="aimc", aimc=AimcConfig(
            impl="ref", noise=NoiseModel(sigma_read=SIGMA_READ)),
            compute_dtype="float32")
    return Execution(compute_dtype="float32")


def train_case(name):
    import jax
    import jax.numpy as jnp

    from repro.compat import use_mesh
    from repro.configs import ShapeCell, get_arch
    from repro.data.pipeline import DataConfig, host_batch
    from repro.launch.shardings import to_named
    from repro.launch.steps import make_train_step
    from repro.optim import make_optimizer
    from torch_code_replay import logging_reference

    arch, mode, shape, gb, seq = TRAIN_CASES[name]
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, model_cfg=spec.smoke_cfg)
    cfg = spec.model_cfg
    mesh = auto_mesh(shape)
    cell = ShapeCell("oracle", seq_len=seq, global_batch=gb, kind="train")
    pdtype = jnp.dtype(spec.param_dtype)
    params = jax.tree.map(lambda x: x.astype(pdtype),
                          spec.model_module().init(jax.random.PRNGKey(0),
                                                   cfg))
    opt = make_optimizer(spec.optimizer)[0](params)
    batch = {k: jnp.asarray(v) for k, v in host_batch(
        DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=0),
        0, 0, 1).items()}
    out = {"params": _np(params), "opt": _opt_fields(opt),
           "batch": _np(batch)}
    log = {}
    with use_mesh(mesh):
        bundle = make_train_step(spec, cell, mesh, _exe(mode))
        fn = jax.jit(bundle.fn,
                     in_shardings=to_named(bundle.in_shardings, mesh),
                     out_shardings=to_named(bundle.out_shardings, mesh))
        args = [jax.device_put(x, to_named(s, mesh)) for x, s in
                zip((params, opt, batch), bundle.in_shardings[:3])]
        ctx = (logging_reference(log) if mode == "noise"
               else contextlib.nullcontext())
        with ctx:
            new_p, new_o, metrics = fn(*args, jnp.asarray([0, 0], jnp.uint32))
            jax.block_until_ready(new_p)
    out.update(new_params=_np(new_p), new_opt=_opt_fields(new_o),
               loss=float(metrics["loss"]), log=log)
    return out


def moe_case(name):
    import jax

    from repro.compat import use_mesh
    from repro.configs import get_arch
    from repro.models import moe

    t, cf = MOE_CASES[name]
    cfg = get_arch("olmoe-1b-7b").smoke_cfg
    ks = jax.random.split(jax.random.PRNGKey(5), 5)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    ins = {"x": jax.random.normal(ks[0], (t, d)),
           "router_w": jax.random.normal(ks[1], (d, e)),
           "w_gate": jax.random.normal(ks[2], (e, d, f)) * 0.2,
           "w_up": jax.random.normal(ks[3], (e, d, f)) * 0.2,
           "w_down": jax.random.normal(ks[4], (e, f, d)) * 0.2}
    with use_mesh(auto_mesh((2, 2))):
        y, aux = moe.moe_ffn(ins["x"], ins["router_w"], ins["w_gate"],
                             ins["w_up"], ins["w_down"], top_k=cfg.top_k,
                             capacity_factor=cf, exe=_exe("digital"))
    return {"inputs": _np(ins), "y": np.asarray(y), "aux": float(aux),
            "top_k": cfg.top_k}


def placement_case(ckpt_dir):
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.checkpoint import checkpoint
    from repro.configs import get_arch
    from repro.data.pipeline import (DataConfig, host_batch,
                                     make_global_array)
    from repro.launch.shardings import fit_specs, get_param_specs

    mesh = auto_mesh((2, 2))
    batch = host_batch(DataConfig(vocab=128, seq_len=16, global_batch=8,
                                  seed=3), 1, 0, 1)
    glob = make_global_array(batch, mesh, P(("data",), None))
    spec = get_arch("olmoe-1b-7b")
    params = spec.model_module().init(jax.random.PRNGKey(0), spec.smoke_cfg)
    checkpoint.save(ckpt_dir, 1, {"params": params})
    pspecs = fit_specs(get_param_specs(params, mesh), params, mesh)
    tree, _ = checkpoint.restore(ckpt_dir, 1, {"params": params}, mesh,
                                 {"params": pspecs})
    leaves = {"embed": tree["params"]["embed"],
              "wq": tree["params"]["blocks"]["wq"],
              "we_down": tree["params"]["blocks"]["we_down"],
              "ln1": tree["params"]["blocks"]["ln1"]}
    return {"batch": batch,
            "global": {k: _shards(v, mesh) for k, v in glob.items()},
            "restored": {k: _shards(v, mesh) for k, v in leaves.items()}}


def serve_case(name):
    import jax
    import jax.numpy as jnp

    from repro.compat import use_mesh
    from repro.configs import get_arch
    from repro.core.aimc import AimcConfig
    from repro.core.program import MappingPlan, program_model
    from repro.core.schedule import CoreSchedule
    from repro.models.layers import Execution
    from repro.runtime.batcher import synchronized_trace
    from repro.runtime.engine import ShardedServeEngine

    arch, programmed, shape, ambient = SERVE_CASES[name]
    spec = get_arch(arch)
    cfg = spec.smoke_cfg
    model = spec.model_module()
    params = model.init(jax.random.PRNGKey(0), cfg)
    prog = sched = None
    if programmed:
        aimc = AimcConfig(impl="ref", input_scale=0.1)
        exe = Execution(mode="aimc", aimc=aimc, compute_dtype="float32",
                        programmed=True)
        prog = program_model(params, MappingPlan(n_contexts=2), aimc,
                             jax.random.PRNGKey(2))
        params = prog.install(params)
        sched = CoreSchedule.from_program(prog)
    else:
        exe = Execution(compute_dtype="float32")
    mesh = auto_mesh(shape)
    if ambient:      # the CLI's engine path: 4 slots, max_seq = 8 + 6
        kw, reqs = dict(n_slots=4, prompt_pad=8, max_seq=14), \
            synchronized_trace(4, prompt_len=8, max_new=6, seed=0,
                               vocab=cfg.vocab)
    else:            # the reference's own two-device test
        kw, reqs = dict(n_slots=2, prompt_pad=8, max_seq=20), \
            synchronized_trace(4, prompt_len=8, max_new=6, seed=1,
                               vocab=cfg.vocab)
    ctx = use_mesh(mesh) if ambient else contextlib.nullcontext()
    with ctx:
        eng = ShardedServeEngine(model, cfg, exe, params, mesh=mesh,
                                 family=spec.family, module=spec.module,
                                 cache_dtype=jnp.float32, program=prog,
                                 schedule=sched, **kw)
        eng.warmup()
        rep = eng.serve(list(reqs))
    return {r.rid: list(rep.tokens(r.rid)) for r in reqs}


def cells_case(name):
    import jax
    import jax.numpy as jnp

    from repro.compat import use_mesh
    from repro.configs import ShapeCell, get_arch
    from repro.core.aimc import AimcConfig
    from repro.core.program import MappingPlan, program_model
    from repro.core.quant import quantize_params_int8
    from repro.core.schedule import CoreSchedule
    from repro.launch import shardings as js
    from repro.launch.steps import make_prefill_step, make_serve_step
    from repro.models.layers import Execution
    from torch_code_replay import logging_reference

    arch, mode, shape = CELL_CASES[name]
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, model_cfg=spec.smoke_cfg,
                               cache_dtype="float32")
    cfg = spec.model_cfg
    model = spec.model_module()
    raw = model.init(jax.random.PRNGKey(0), cfg)
    params, program, codes = raw, None, {}
    exe = Execution(compute_dtype="float32")
    if mode == "prog":
        aimc = AimcConfig(impl="ref", input_scale=0.1)
        exe = Execution(mode="aimc", aimc=aimc, compute_dtype="float32",
                        programmed=True)
        prog = program_model(raw, MappingPlan(n_contexts=2), aimc,
                             jax.random.PRNGKey(2))
        params = prog.install(raw)
        program = CoreSchedule.from_program(prog)
        codes = {n: np.asarray(st.w_q) for n, st in zip(prog.names,
                                                         prog.states)}
    elif mode == "int8":
        exe = Execution(compute_dtype="float32", serve_int8=True)
        params = quantize_params_int8(
            raw, js.IN_PROJ | js.OUT_PROJ | js.EXPERT_IN | js.EXPERT_OUT
            | {"unembed"})
    seq, batch = cell_inputs(spec)
    b = batch["tokens"].shape[0]
    mesh = auto_mesh(shape)
    log = {}
    out = {"raw": _np(raw), "codes": codes, "batch": batch,
           "params": _np(params) if mode == "int8" else None}
    with use_mesh(mesh), logging_reference(log):
        pre = make_prefill_step(spec, ShapeCell("p", seq, b, "prefill"),
                                mesh, exe, program=program)
        dec = make_serve_step(spec, ShapeCell("d", seq, b, "decode"),
                              mesh, exe, program=program)
        out["specs"] = {
            "prefill_in": [flat_specs(t) for t in pre.in_shardings],
            "prefill_out": [flat_specs(t) for t in pre.out_shardings],
            "decode_in": [flat_specs(t) for t in dec.in_shardings],
            "decode_out": [flat_specs(t) for t in dec.out_shardings]}

        def jitted(bundle):
            named = js.to_named(bundle.in_shardings, mesh)
            fn = jax.jit(bundle.fn, in_shardings=named,
                         out_shardings=js.to_named(bundle.out_shardings,
                                                   mesh))
            return lambda *a: fn(*(jax.device_put(x, s)
                                   for x, s in zip(a, named)))

        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tok, cache = jitted(pre)(params, jb)
        out["prefill"] = (np.asarray(tok), _np(cache))
        tok = jnp.asarray(np.asarray(tok))
        if cache == ():          # a recurrent prefill cell: forward-only
            cache = model.prefill(params, jb["tokens"], cfg, exe,
                                  max_seq=seq, cache_dtype=jnp.float32)[1]
        out["cache0"] = _np(cache)
        step = jitted(dec)
        out["decode"] = []
        for _ in range(CELL_STEPS):
            tok, cache = step(params, cache, tok)
            out["decode"].append((np.asarray(tok), _np(cache)))
    out["log"] = log
    return out


def hlo_case(name):
    import jax

    from repro.compat import use_mesh
    from repro.configs import ShapeCell, get_arch
    from repro.launch.hlostats import analyze_hlo
    from repro.launch.shardings import to_named
    from repro.launch.steps import make_train_step

    arch, shape, batch, seq = HLO_CASES[name]
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, model_cfg=spec.smoke_cfg)
    mesh = auto_mesh(shape)
    with use_mesh(mesh):
        b = make_train_step(spec, ShapeCell("t", seq, batch, "train"), mesh)
        comp = jax.jit(b.fn, in_shardings=to_named(b.in_shardings, mesh),
                       out_shardings=to_named(b.out_shardings, mesh)
                       ).lower(*b.abstract_inputs).compile()
    return analyze_hlo(comp.as_text())["collectives"]


def main(argv):
    # only in the oracle's own process, before JAX starts its backend: the
    # parity tests import this module for its case tables
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    assert jax.device_count() == 4, jax.devices()
    what, out_path = argv[0], argv[1]
    if what == "train":
        res = {"train": {n: train_case(n) for n in TRAIN_CASES},
               "moe": {n: moe_case(n) for n in MOE_CASES},
               "placement": placement_case(argv[2])}
    elif what == "serve":
        res = {n: serve_case(n) for n in SERVE_CASES}
    elif what == "cells":
        res = {n: cells_case(n) for n in CELL_CASES}
    elif what == "hlo":
        res = {n: hlo_case(n) for n in HLO_CASES}
    else:
        raise SystemExit(f"unknown oracle {what!r}")
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    print("ORACLE_OK")


if __name__ == "__main__":
    main(sys.argv[1:])
