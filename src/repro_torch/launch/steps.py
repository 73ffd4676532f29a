"""The training step on one device (PyTorch port of the training half of
`repro/launch/steps.py`).

`make_train_step` keeps the reference's order of operations
(`repro/launch/steps.py:144-220`): the global batch splits into
``n_micro = global_batch // microbatch`` microbatches (every leaf of the
batch: tokens and labels, an enc-dec batch's frames, a VLM batch's patch
embeddings); microbatch ``i`` runs under ``key = fold_in(rng, i)``; its
loss is the chunked cross entropy over non-negative labels plus ``0.01 *
aux`` (`make_micro_grad`); gradients are taken with `torch.autograd.grad`
and accumulated in f32 as ``g_acc + g / n_micro``; one ``opt_update(grads,
opt_state, params, lr_scale)`` ends the step. Every family trains: the
transformer (dense and MoE), xlstm, rglru and the enc-dec model, each
block (pair, unit, layer) recomputed in the backward. The reference's
sharding arguments and constraints have no counterpart on one device; a
mesh and bf16 parameters raise, queued in ROADMAP.md. The prefill and
serve step builders are not ported: the engine (`runtime/engine.py`)
serves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import ArchSpec, ShapeCell
from repro_torch.core import prng
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
    for c in range(s // chunk):
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
    """A step function and the shapes of its batch (the reference's
    shardings and donation have no counterpart on one device)."""
    fn: Callable
    abstract_inputs: tuple         # (batch shapes,) from `batch_shapes`


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


def check_trainable(spec: ArchSpec) -> None:
    """Raise for what the port cannot train yet (ROADMAP.md queues it):
    bf16 parameters."""
    if spec.param_dtype != "float32":
        raise NotImplementedError(
            f"{spec.arch_id} trains {spec.param_dtype} parameters; weight "
            f"init draws f32 only and bf16 init is not ported (ROADMAP.md)")


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


def make_micro_grad(spec: ArchSpec, exe: Execution = Execution()):
    """The train step's per-microbatch loss and its gradients:
    ``(params, mb, key) -> (loss, grads)``, the forward's hidden states
    into `chunked_ce` over ``mb["labels"]`` (loss + 0.01 x aux is
    differentiated, the loss returned detached), gradients one per leaf of
    ``params`` in `tree_leaves` order (None where a leaf is unused)."""
    check_trainable(spec)
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


def make_train_step(spec: ArchSpec, cell: ShapeCell, mesh=None,
                    exe: Execution = Execution(), lr_scale: float = 1.0):
    """The training step ``(params, opt_state, batch, rng) -> (params,
    opt_state, metrics)`` on one device; ``rng`` is a [2] key."""
    if mesh is not None:
        raise NotImplementedError(
            "a sharded train step needs the mesh slice (ROADMAP.md); the "
            "port trains on one device (mesh=None)")
    _, opt_update, _ = make_optimizer(spec.optimizer)
    n_micro = max(1, cell.global_batch // spec.microbatch)
    micro_grad = make_micro_grad(spec, exe)

    def train_step(params, opt_state, batch, rng):
        micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
                 for k, v in batch.items()}
        leaves = tree_leaves(params)
        g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss_acc = 0.0
        for i in range(n_micro):
            mb = {k: v[i] for k, v in micro.items()}
            loss, grads = micro_grad(params, mb, prng.fold_in(rng, i))
            for a, g in zip(g_acc, grads):
                if g is not None:
                    a.add_(g.to(torch.float32) / n_micro)
            del grads
            loss_acc = loss_acc + loss / n_micro
        new_params, new_opt, metrics = opt_update(
            _tree_with(params, g_acc), opt_state, params, lr_scale)
        return new_params, new_opt, dict(metrics, loss=loss_acc)

    return StepBundle(train_step, (batch_shapes(spec, cell),))


def make_step(spec: ArchSpec, cell: ShapeCell, mesh=None,
              exe: Execution = Execution(), program=None) -> StepBundle:
    """The front door: a training cell builds `make_train_step`. Prefill
    and decode cells are served by the engine; their step builders are not
    ported (ROADMAP.md)."""
    if cell.kind != "train":
        raise NotImplementedError(
            f"{cell.kind} step builders are not ported (the engine serves); "
            f"ROADMAP.md queues them")
    if program is not None:
        raise ValueError("AimcProgram is a serving-only handle; "
                         "noise-aware training re-programs per step")
    return make_train_step(spec, cell, mesh, exe)
