"""Optimizers on tensor trees: AdamW, Adafactor and LR schedules (PyTorch
port of `repro/optim`).

`make_optimizer(name)` returns ``(init_fn, update_fn, cfg)`` for the train
step, as the reference does. Parameter, gradient and state trees are
nested dicts (lists and tuples too) of tensors; `update` is functional and
returns new trees. The update math is the reference's, in f32, with its
moment dtype.
"""

from __future__ import annotations

from repro_torch.optim import adafactor, adamw, schedule  # noqa: F401


def make_optimizer(name: str, **overrides):
    if name == "adamw":
        cfg = adamw.AdamWConfig(**overrides)
        return (lambda p: adamw.init(p, cfg),
                lambda g, s, p, lr=1.0: adamw.update(g, s, p, cfg, lr), cfg)
    if name == "adafactor":
        cfg = adafactor.AdafactorConfig(**overrides)
        return (lambda p: adafactor.init(p, cfg),
                lambda g, s, p, lr=1.0: adafactor.update(g, s, p, cfg, lr),
                cfg)
    raise ValueError(f"unknown optimizer {name!r}")
