"""Step builders: train_step / prefill_step / serve_step per (architecture
x shape cell) (PyTorch port of `repro/launch/steps.py`).

`make_train_step` keeps the reference's order of operations
(`repro/launch/steps.py:144-220`): the global batch splits into
``n_micro = global_batch // (dp_total * microbatch)`` microbatches (every
leaf of the batch: tokens and labels, an enc-dec batch's frames, a VLM
batch's patch embeddings); microbatch ``i`` runs under ``key =
fold_in(rng, i)``; its loss is the chunked cross entropy over
non-negative labels plus ``0.01 * aux`` (`make_micro_grad`); gradients
are taken with `torch.autograd.grad` and accumulated in f32 as ``g_acc +
g / n_micro``; one ``opt_update(grads, opt_state, params, lr_scale)``
ends the step. Every family trains: the transformer (dense and MoE),
xlstm, rglru and the enc-dec model, each block (pair, unit, layer)
recomputed in the backward, with f32 or bf16 parameters.

On a mesh (`launch.mesh.Mesh`; positions folded onto torch devices) the
step runs inside the ambient mesh (`compat.use_mesh`): the parameters,
optimizer state and batch are placed by the reference's specs
(`fit_specs` of `get_param_specs` / `get_opt_specs` / `batch_specs`,
views on the controller's device: no copy), ``dp_total`` is the data
axes' size, and each microbatch is ONE forward and backward over all its
``dp_total * microbatch`` rows, which keeps the dynamic DAC scale and MoE
routing batch-global as XLA keeps them. The model axis is per-position
work inside that pass (column pieces of every programmed projection, the
expert STE per position's experts, `moe._moe_sharded` digitally). The
positions share the controller's device, so the f32 gradient
accumulators, the optimizer update and the new trees are whole tensors
(one add per leaf, `optim` unchanged), and the new trees come back
placed by the specs as views of them. ``mesh=None`` runs the same code
as one position.

`make_prefill_step` / `make_serve_step` build the serving cells on
`runtime.engine.static_prefill_closure` / `static_decode_closure`, the
math the engine shares: a prefill cell maps (params, batch) to the first
token [B, 1] and the cache (max_seq = the cell's seq_len; an enc-dec
batch is ``seq_len`` frames and ``seq_len // tgt_ratio`` decoder tokens,
a recurrent prefill is forward-only with an empty cache); a decode cell
maps (params, cache, tokens [B, 1]) to the next token and the new cache.
They are the only way the audio family is served (the engine refuses
it). ``program`` (an `AimcProgram` or a `CoreSchedule`) means
program-once serving: the parameters carry installed crossbar states.
`StepBundle.abstract_inputs` holds the step's inputs as ``meta`` tensors
(`_serve_params_shape`, `input_specs`), built without allocating a
weight.

On a mesh every cell also carries the reference's ``in_specs`` and
``out_specs`` (the port's `PartitionSpec` trees; None on one device). A
serving cell's parameters take `fit_specs(get_param_specs)`, through
`shard_aimc_states` under a multi-core `CoreSchedule` and `strip_fsdp`
under ``Execution.serve_int8``; the batch `batch_specs(mesh,
batch_kind(spec))`, the cache `cache_specs` and the next token ``P(dp,
None)``, each fitted to its shape. The cell takes plain or `Placed`
trees, splits each programmed state into column pieces by its spec
(`place_aimc_state`: views of the codes, whole where Np does not divide
``128 * M``), runs the closure inside the ambient mesh (`compat.use_mesh`:
a digital MoE dispatches per data shard, `moe._moe_sharded`) as ONE
forward over every row, which keeps the dynamic DAC scale batch-global,
and returns the token and the cache placed by ``out_specs`` as views.
Column pieces are exact, so a dense or recurrent cell's tokens and cache
equal the one-device cell's bit for bit. A train cell's abstract inputs
are its parameters, optimizer state, batch and [2] key (replicated,
``P()``, as in the reference's bundle; the port's key holds its two
uint32 words in int64, `core.prng`). The step reads the key's words on
the host, so a caller passes a CPU key.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from repro_torch import compat
from repro_torch.configs import ArchSpec, ShapeCell
from repro_torch.core import prng
from repro_torch.launch import shardings as sh
from repro_torch.launch import stepstats
from repro_torch.launch.mesh import axis_size, dp_axes
from repro_torch.models.layers import Execution
from repro_torch.optim import make_optimizer
from repro_torch.optim.adamw import tree_leaves

CE_CHUNK = 512


def chunked_ce(h, unembed, labels, chunk: int = CE_CHUNK):
    """Cross entropy over [B, S] without materialising [B, S, V]: logits
    ``chunk`` positions at a time (f32). labels < 0 are masked (VLM patch
    positions). Returns (sum_loss, n_tok); a ragged tail past the last
    whole chunk is dropped, as in the reference."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    loss, n = 0.0, 0.0
    for c in stepstats.trips(s // chunk, h):
        hx = h[:, c * chunk:(c + 1) * chunk]
        lx = labels[:, c * chunk:(c + 1) * chunk]
        logits = hx.to(torch.float32) @ unembed.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            lx.clamp_min(0).long()[..., None])[..., 0]
        mask = (lx >= 0).to(torch.float32)
        loss = loss + ((logz - gold) * mask).sum()
        n = n + mask.sum()
    return loss, n


def batch_shapes(spec: ArchSpec, cell: ShapeCell) -> dict:
    """Logical [global] shapes and dtypes of one training/prefill batch."""
    b, s = cell.global_batch, cell.seq_len
    cfg = spec.model_cfg
    if spec.family == "audio":
        tgt = max(s // spec.tgt_ratio, 64)
        return {"frames": ((b, s, cfg.d_model), torch.bfloat16),
                "tokens": ((b, tgt), torch.int32),
                "labels": ((b, tgt), torch.int32)}
    out = {"tokens": ((b, s), torch.int32), "labels": ((b, s), torch.int32)}
    if spec.family == "vlm":
        out["patch_embeds"] = ((b, spec.n_patches, cfg.d_model),
                               torch.bfloat16)
    return out


def batch_kind(spec: ArchSpec) -> str:
    return {"audio": "encdec", "vlm": "vlm"}.get(spec.family, "lm")


@dataclasses.dataclass
class StepBundle:
    """A step function, its inputs' shapes and, on a mesh, the reference's
    in/out shardings as `PartitionSpec` trees (donation has no
    counterpart: eager PyTorch frees an input when its last reference
    goes)."""
    fn: Callable
    abstract_inputs: tuple         # the step's inputs as meta tensors
    schedule: Any = None           # core.schedule.CoreSchedule, when serving
                                   # through a multi-core mapping
    in_specs: Any = None           # per input, a spec tree (mesh only)
    out_specs: Any = None          # per output, a spec tree (mesh only)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_batch(spec: ArchSpec, cell: ShapeCell) -> dict:
    """One batch of the cell as ``meta`` tensors."""
    return {k: _meta(shp, dt) for k, (shp, dt) in
            batch_shapes(spec, cell).items()}


def _model_forward_hidden(model, spec: ArchSpec, cfg, exe: Execution):
    """Uniform (params, batch, rng) -> (hidden, aux) across families."""
    def fwd(params, batch, rng):
        if spec.family == "audio":
            return model.forward(params, batch, cfg, exe, rng,
                                 return_hidden=True)
        if spec.family == "vlm":
            return model.forward(params, batch["tokens"], cfg, exe, rng,
                                 patch_embeds=batch["patch_embeds"],
                                 return_hidden=True)
        return model.forward(params, batch["tokens"], cfg, exe, rng,
                             return_hidden=True)
    return fwd


def _tree_with(tree, leaves):
    """``tree``'s structure with the leaves replaced in order."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return next(it)
    return go(tree)


def _place_out(tree, specs, mesh):
    """A cell's output placed by ``specs`` as views of the whole tensors;
    under a step counter (`launch.stepstats`), where views cost nothing,
    the whole tree itself."""
    if stepstats.active() is not None:
        return tree
    if isinstance(tree, torch.Tensor):
        return sh.place(tree, specs, mesh, views=True)
    return sh.place_tree(tree, specs, mesh, views=True)


def make_micro_grad(spec: ArchSpec, exe: Execution = Execution()):
    """The train step's per-microbatch loss and its gradients:
    ``(params, mb, key) -> (loss, grads)``, the forward's hidden states
    into `chunked_ce` over ``mb["labels"]`` (loss + 0.01 x aux is
    differentiated, the loss returned detached), gradients one per leaf of
    ``params`` in `tree_leaves` order (None where a leaf is unused), each
    in its leaf's dtype (bf16 parameters get bf16 gradients)."""
    cfg = spec.model_cfg
    model = spec.model_module()
    fwd = _model_forward_hidden(model, spec, cfg, exe)

    def micro_grad(params, mb, key):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        p = _tree_with(params, live)
        h, aux = fwd(p, mb, key)
        loss_sum, n_tok = chunked_ce(h, model.unembed_matrix(p, cfg),
                                     mb["labels"])
        loss = loss_sum / torch.clamp_min(n_tok, 1.0)
        grads = torch.autograd.grad(loss + 0.01 * aux, live,
                                    allow_unused=True)
        return loss.detach(), grads

    return micro_grad


def train_specs(mesh, params, opt_state):
    """(param specs, optimizer-state specs) of a train step's trees on
    ``mesh``: the reference's `get_param_specs` / `get_opt_specs`, fitted
    to the shapes (`fit_specs`)."""
    wp, wo = sh.whole_tree(params), sh.whole_tree(opt_state)
    return (sh.fit_specs(sh.get_param_specs(wp, mesh), wp, mesh),
            sh.fit_specs(sh.get_opt_specs(wo, wp, mesh), wo, mesh))


def make_train_step(spec: ArchSpec, cell: ShapeCell, mesh=None,
                    exe: Execution = Execution(), lr_scale: float = 1.0):
    """The training step ``(params, opt_state, batch, rng) -> (params,
    opt_state, metrics)``; ``rng`` is a [2] key. ``mesh=None`` is one
    position on the parameters' device: plain trees in and out. On a mesh
    the step takes plain or placed trees (`Placed` leaves are read whole)
    and returns the new parameters and optimizer state placed by
    `train_specs`, as views of the whole tensors."""
    opt_init, opt_update, _ = make_optimizer(spec.optimizer)
    dp_total = 1 if mesh is None else axis_size(mesh, dp_axes(mesh))
    n_micro = max(1, cell.global_batch // (dp_total * spec.microbatch))
    micro_grad = make_micro_grad(spec, exe)

    def train_step(params, opt_state, batch, rng):
        params, opt_state, batch = (sh.whole_tree(t)
                                    for t in (params, opt_state, batch))
        micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
                 for k, v in batch.items()}
        leaves = tree_leaves(params)
        g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss_acc = 0.0
        with (compat.use_mesh(mesh) if mesh is not None
              else contextlib.nullcontext()):
            for i in stepstats.trips(n_micro, batch["labels"]):
                mb = {k: v[i] for k, v in micro.items()}
                loss, grads = micro_grad(params, mb, prng.fold_in(rng, i))
                for a, g in zip(g_acc, grads):
                    if g is not None:
                        a.add_(g.to(torch.float32) / n_micro)
                del grads
                loss_acc = loss_acc + loss / n_micro
        new_params, new_opt, metrics = opt_update(
            _tree_with(params, g_acc), opt_state, params, lr_scale)
        if mesh is not None:
            pspecs, ospecs = train_specs(mesh, new_params, new_opt)
            new_params = _place_out(new_params, pspecs, mesh)
            new_opt = _place_out(new_opt, ospecs, mesh)
        return new_params, new_opt, dict(metrics, loss=loss_acc)

    params_shape = spec.model_module().init(
        prng.PRNGKey(0), spec.model_cfg,
        dtype=getattr(torch, spec.param_dtype), device="meta")
    opt_shape = opt_init(params_shape)
    abstract = (params_shape, opt_shape, abstract_batch(spec, cell),
                _meta((2,), torch.int64))
    if mesh is None:
        return StepBundle(train_step, abstract)
    pspecs, ospecs = train_specs(mesh, params_shape, opt_shape)
    bspecs = sh.fit_specs(sh.batch_specs(mesh, batch_kind(spec)),
                          abstract[2], mesh)
    return StepBundle(train_step, abstract,
                      in_specs=(pspecs, ospecs, bspecs, sh.P()),
                      out_specs=(pspecs, ospecs, None))


def _unwrap_program(program):
    """Serving steps take an `AimcProgram` or a multi-core `CoreSchedule`;
    installation goes through the underlying program, and the schedule
    rides on the bundle for per-core ledgers -> (program, schedule)."""
    from repro_torch.core.schedule import CoreSchedule
    if isinstance(program, CoreSchedule):
        return program.program, program
    return program, None


def _serve_params_shape(model, spec: ArchSpec, cfg, int8: bool = False):
    """The serving parameter tree as ``meta`` tensors: every float leaf
    bf16, or, with ``int8``, a {"q": int8, "s": f32 [..., 1, N]} pair for
    each matrix named in `quant.QUANTIZABLE` (the paper's number format;
    `Execution.serve_int8`). Built from ``model.init`` on the ``meta``
    device: shapes only, no weight is drawn or allocated."""
    from repro_torch.core.program import _map_leaves
    from repro_torch.core.quant import QUANTIZABLE
    shape = model.init(prng.PRNGKey(0), cfg, device="meta")

    def conv(path, leaf):
        if not leaf.is_floating_point():
            return leaf
        name = path.rsplit("/", 1)[-1]
        if int8 and name in QUANTIZABLE and leaf.dim() >= 2:
            return {"q": _meta(leaf.shape, torch.int8),
                    "s": _meta(leaf.shape[:-2] + (1, leaf.shape[-1]),
                               torch.float32)}
        return _meta(leaf.shape, torch.bfloat16)

    return _map_leaves(shape, conv)


def _serve_params(model, spec: ArchSpec, cfg, exe: Execution, program):
    """(the params' meta tree, the schedule) of a serving cell."""
    program, schedule = _unwrap_program(program)
    params_shape = _serve_params_shape(model, spec, cfg, int8=exe.serve_int8)
    if program is not None:     # program-once serving: mapped projections
        params_shape = program.install_shape(params_shape)  # are states
    return params_shape, schedule


def _serve_param_specs(params_shape, mesh, exe: Execution, schedule=None):
    """A serving cell's parameter specs on ``mesh``, as the reference's
    cells build them: `fit_specs(get_param_specs)`, the programmed states
    column-sharded over ``model`` under a multi-core schedule
    (`shard_aimc_states`), the FSDP axes dropped under int8 serving
    (`strip_fsdp`)."""
    pspecs = sh.fit_specs(sh.get_param_specs(params_shape, mesh),
                          params_shape, mesh)
    if schedule is not None and schedule.n_cores > 1:
        pspecs = sh.shard_aimc_states(pspecs, params_shape, mesh)
    if exe.serve_int8:
        pspecs = sh.strip_fsdp(pspecs, mesh)
    return pspecs


def _mesh_cell(fn, mesh, pspecs, out_specs):
    """``fn(params, *rest) -> (tok, cache)`` as a cell on ``mesh``: plain or
    `Placed` inputs read whole, the programmed states placed by
    ``pspecs``, ``fn`` run inside the ambient mesh, the outputs placed by
    ``out_specs`` as views of the whole tensors."""
    tok_spec, cspecs = out_specs

    def cell(params, *rest):
        params = sh.place_states(sh.whole_tree(params), pspecs, mesh)
        rest = [sh.whole_tree(r) for r in rest]
        with compat.use_mesh(mesh):
            tok, cache = fn(params, *rest)
        return (_place_out(tok, tok_spec, mesh),
                _place_out(cache, cspecs, mesh))
    return cell


def _cache_shape(model, spec: ArchSpec, cfg, b: int, s: int, src: int,
                 cache_dt):
    """A ``[b]``-row cache of ``s`` rows as ``meta`` tensors (an enc-dec
    cache with ``src`` cross frames)."""
    if spec.family == "audio":
        return model.init_cache(cfg, b, s, src, cache_dt, device="meta")
    return model.init_cache(cfg, b, s, cache_dt, device="meta")


def make_prefill_step(spec: ArchSpec, cell: ShapeCell, mesh=None,
                      exe: Execution = Execution(),
                      program=None) -> StepBundle:
    """The prefill cell: ``(params, batch) -> (next_tok [B, 1] int32,
    cache)`` with max_seq = ``cell.seq_len`` and the spec's cache dtype (on
    a mesh, both placed by ``out_specs``)."""
    from repro_torch.runtime.engine import static_prefill_closure
    cfg = spec.model_cfg
    model = spec.model_module()
    cache_dt = getattr(torch, spec.cache_dtype)
    params_shape, schedule = _serve_params(model, spec, cfg, exe, program)
    prefill = static_prefill_closure(
        model, cfg, exe, family=spec.family, module=spec.module,
        max_seq=cell.seq_len, cache_dtype=cache_dt)
    abstract = (params_shape, abstract_batch(spec, cell))
    if mesh is None:
        return StepBundle(prefill, abstract, schedule=schedule)
    b, s = cell.global_batch, cell.seq_len
    # the prefill's own cache: ``s`` rows (an enc-dec batch's ``s``
    # frames); a recurrent prefill returns none
    forward_only = (spec.family not in ("audio", "vlm")
                    and spec.module != "transformer")
    cache_shape = (() if forward_only
                   else _cache_shape(model, spec, cfg, b, s, s, cache_dt))
    cspecs = (sh.fit_specs(sh.cache_specs(cache_shape, mesh), cache_shape,
                           mesh) if cache_shape != () else ())
    pspecs = _serve_param_specs(params_shape, mesh, exe, schedule)
    bspecs = sh.fit_specs(sh.batch_specs(mesh, batch_kind(spec)),
                          abstract[1], mesh)
    out_specs = (sh.fit_spec(sh.P(dp_axes(mesh), None), (b, 1), mesh), cspecs)
    return StepBundle(_mesh_cell(prefill, mesh, pspecs, out_specs), abstract,
                      schedule=schedule, in_specs=(pspecs, bspecs),
                      out_specs=out_specs)


def make_serve_step(spec: ArchSpec, cell: ShapeCell, mesh=None,
                    exe: Execution = Execution(),
                    program=None) -> StepBundle:
    """One decode step against a ``cell.seq_len`` cache (the decode cells):
    ``(params, cache, tokens [B, 1]) -> (next_tok, cache)``. An enc-dec
    cell's cache holds cross K/V of ``max(seq_len // tgt_ratio, 64)``
    encoder frames; the step itself takes any cache ``prefill`` made."""
    from repro_torch.runtime.engine import static_decode_closure
    cfg = spec.model_cfg
    model = spec.model_module()
    cache_dt = getattr(torch, spec.cache_dtype)
    params_shape, schedule = _serve_params(model, spec, cfg, exe, program)
    b, s = cell.global_batch, cell.seq_len
    src = max(s // spec.tgt_ratio, 64) if spec.family == "audio" else 0
    cache_shape = _cache_shape(model, spec, cfg, b, s, src, cache_dt)
    abstract = (params_shape, cache_shape, _meta((b, 1), torch.int32))
    step = static_decode_closure(model, cfg, exe)
    if mesh is None:
        return StepBundle(step, abstract, schedule=schedule)
    pspecs = _serve_param_specs(params_shape, mesh, exe, schedule)
    cspecs = sh.fit_specs(sh.cache_specs(cache_shape, mesh), cache_shape,
                          mesh)
    tok_spec = sh.fit_spec(sh.P(dp_axes(mesh), None), (b, 1), mesh)
    out_specs = (tok_spec, cspecs)
    return StepBundle(_mesh_cell(step, mesh, pspecs, out_specs), abstract,
                      schedule=schedule, in_specs=(pspecs, cspecs, tok_spec),
                      out_specs=out_specs)


def make_step(spec: ArchSpec, cell: ShapeCell, mesh=None,
              exe: Execution = Execution(), program=None) -> StepBundle:
    """The front door. ``program`` (an `AimcProgram`, or a multi-core
    `CoreSchedule` wrapping one) selects program-once AIMC serving: the
    step's parameters carry the installed crossbar states; a training cell
    refuses it (the STE reprograms on every step)."""
    if cell.kind == "train":
        if program is not None:
            raise ValueError("AimcProgram is a serving-only handle; "
                             "noise-aware training re-programs per step")
        return make_train_step(spec, cell, mesh, exe)
    if cell.kind == "prefill":
        return make_prefill_step(spec, cell, mesh, exe, program)
    return make_serve_step(spec, cell, mesh, exe, program)


def input_specs(spec: ArchSpec, cell: ShapeCell, mesh=None,
                exe: Execution = Execution(), program=None) -> tuple:
    """The step's inputs as ``meta`` tensors, allocating nothing."""
    return make_step(spec, cell, mesh, exe, program).abstract_inputs
