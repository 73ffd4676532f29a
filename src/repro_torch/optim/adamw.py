"""AdamW on tensor trees (port of `repro/optim/adamw.py`): functional
``init`` / ``update`` with the reference's f32 math and moment dtype.

`clip_by_global_norm` is the reference's; `update` applies the same clip
factor leaf by leaf (``g.float() * scale``, the same values) so that no
second f32 copy of the whole gradient tree is held. Square roots on the
CPU are taken in f64 and rounded once: PyTorch's f32 CPU ``sqrt`` is not
correctly rounded here, XLA's and the card's are.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # bf16 halves optimizer memory


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: dict


def tree_map(fn, *trees):
    """``fn`` over the leaves of same-structure trees (dicts, lists,
    tuples of tensors); dict keys keep the first tree's order."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree, in its own order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on either device."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _device(tree):
    return tree_leaves(tree)[0].device


def init(params, cfg: AdamWConfig) -> AdamWState:
    dt = getattr(torch, cfg.moment_dtype)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=dt), params))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return sqrt32(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads * min(1, max_norm / max(norm, 1e-9)) in f32, norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def update(grads, state: AdamWState, params, cfg: AdamWConfig,
           lr_scale=1.0):
    """Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=t.device), t)
    lr = cfg.lr * lr_scale
    dt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, mu, nu):
        g32 = g.to(torch.float32) * scale
        mu32 = b1 * mu.to(torch.float32) + (1 - b1) * g32
        nu32 = b2 * nu.to(torch.float32) + (1 - b2) * g32 * g32
        p32 = p.to(torch.float32)
        upd_ = (mu32 / bc1) / (sqrt32(nu32 / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            upd_ = upd_ + cfg.weight_decay * p32
        return ((p32 - lr * upd_).to(p.dtype), mu32.to(dt), nu32.to(dt))

    out = tree_map(upd, params, grads, state.mu, state.nu)
    return (pick(out, 0), AdamWState(step, pick(out, 1), pick(out, 2)),
            {"grad_norm": gnorm})


def pick(out, i):
    """Component ``i`` of a tree whose leaves are tuples of tensors."""
    if isinstance(out, dict):
        return {k: pick(v, i) for k, v in out.items()}
    if isinstance(out, list):
        return [pick(v, i) for v in out]
    if isinstance(out, tuple) and not isinstance(out[0], torch.Tensor):
        return tuple(pick(v, i) for v in out)
    return out[i]
