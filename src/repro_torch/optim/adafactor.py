"""Adafactor on tensor trees (port of `repro/optim/adafactor.py`):
factored second moments (O(rows + cols) per matrix), no first moment,
update clipping by RMS, parameter-scale step, in f32."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.optim.adamw import (_clip_scale, _device, global_norm,
                                     pick, sqrt32, tree_map)


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8              # t^-decay second-moment decay schedule
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    grad_clip: float = 1.0


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: dict   # row second moments (factored; full v for <2D leaves)
    vc: dict   # col second moments (a [1] placeholder for <2D leaves)


def _factored(p) -> bool:
    return p.dim() >= 2


def init(params, cfg: AdafactorConfig) -> AdafactorState:
    def vr_init(p):
        if _factored(p):
            return torch.zeros(p.shape[:-1], dtype=torch.float32,
                               device=p.device)
        return torch.zeros_like(p, dtype=torch.float32)

    def vc_init(p):
        if _factored(p):
            return torch.zeros(p.shape[:-2] + p.shape[-1:],
                               dtype=torch.float32, device=p.device)
        return torch.zeros((1,), dtype=torch.float32, device=p.device)

    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        vr=tree_map(vr_init, params), vc=tree_map(vc_init, params))


def update(grads, state: AdafactorState, params, cfg: AdafactorConfig,
           lr_scale=1.0):
    """Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    clip = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    t = step.to(torch.float32)
    beta2 = 1.0 - torch.pow(t, -cfg.decay)
    lr = cfg.lr * lr_scale

    def upd(p, g, vr, vc):
        g32 = g.to(torch.float32) * clip
        g2 = g32 * g32 + cfg.eps1
        if _factored(p):
            vr_new = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
            vc_new = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
            r = vr_new / torch.clamp_min(vr_new.mean(dim=-1, keepdim=True),
                                         cfg.eps1)
            u = g32 / (sqrt32(r)[..., None] * sqrt32(vc_new)[..., None, :]
                       + cfg.eps1)
        else:
            vr_new = beta2 * vr + (1 - beta2) * g2
            vc_new = vc
            u = g32 / (sqrt32(vr_new) + cfg.eps1)
        # update clipping (RMS(u) <= clip_threshold)
        rms_u = sqrt32((u * u).mean() + 1e-30)
        u = u / torch.clamp_min(rms_u / cfg.clip_threshold, 1.0)
        p32 = p.to(torch.float32)
        scale = torch.clamp_min(sqrt32((p32 * p32).mean()), cfg.eps2)
        new_p = p32 - lr * scale * u
        if cfg.weight_decay and p.dim() >= 2:
            new_p = new_p - lr * cfg.weight_decay * p32
        return new_p.to(p.dtype), vr_new, vc_new

    out = tree_map(upd, params, grads, state.vr, state.vc)
    return (pick(out, 0), AdafactorState(step, pick(out, 1), pick(out, 2)),
            {"grad_norm": gnorm})
