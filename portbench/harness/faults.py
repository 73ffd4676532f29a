"""Faults planted under the timed path, for showing that the comparison
catches them: a step that returns its state unchanged, half of the batch
left out with the mean taken over the rest, a token altered where it is
produced, a decode step that leaves the KV cache as it was. A training
fault wraps the step function, a serving fault the built engine. Used by
the tests at a small size and by ``run.py --fault`` on the card; never
by a benchmark run. `tf32_products` is the serving cell's TF32 control
on the CPU, where the card's flag does not reach."""

from __future__ import annotations

import contextlib

import torch


def state_unchanged(fn):
    def step(params, opt, batch, rng):
        return params, opt, fn(params, opt, batch, rng)[2]
    return step


def half_batch(fn):
    def step(params, opt, batch, rng):
        half = batch["tokens"].shape[0] // 2
        return fn(params, opt, {k: v[:half] for k, v in batch.items()}, rng)
    return step


def token_altered(engine):
    """Every third decode step, each active lane emits the next token id
    in place of the one it computed."""
    orig = engine._retire_step
    calls = [0]

    def step(state, tokens, logits, active):
        tokens, state, ys = orig(state, tokens, logits, active)
        calls[0] += 1
        if calls[0] % 3 == 0:
            tokens = torch.where(active[:, None],
                                 (tokens + 1) % engine.cfg.vocab, tokens)
            ys = torch.stack([tokens[:, 0], ys[1], ys[2]])
        return tokens, state, ys
    engine._retire_step = step


class _NoKvWrite:
    """The model with a decode step that leaves the cache as it was."""

    def __init__(self, model):
        self._m = model

    def __getattr__(self, name):
        return getattr(self._m, name)

    def decode_step(self, params, cache, tokens, cfg, exe=None, **kw):
        logits, new = self._m.decode_step(params, cache, tokens, cfg, exe,
                                          **kw)
        return logits, dict(cache, len=new["len"])


def kv_unwritten(engine):
    engine.model = _NoKvWrite(engine.model)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32).reshape(x.shape)


@contextlib.contextmanager
def tf32_products():
    """The TF32 control where the card's flag does not reach (the CPU):
    every f32 matrix product (`@`, `matmul`, `bmm`, `einsum`) takes its
    operands rounded to TF32, as the card's TF32 tensor cores do."""
    saved = {n: getattr(torch, n) for n in ("matmul", "bmm", "einsum")}
    mm = torch.Tensor.__matmul__

    def rounding(fn):
        return lambda *a, **k: fn(*[_tf32(t) for t in a], **k)

    def einsum(eq, *ops):
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = ops[0]
        return saved["einsum"](eq, *[_tf32(t) for t in ops])

    torch.matmul = rounding(saved["matmul"])
    torch.bmm = rounding(saved["bmm"])
    torch.einsum = einsum
    torch.Tensor.__matmul__ = lambda a, b: mm(_tf32(a), _tf32(b))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch, n, f)
        torch.Tensor.__matmul__ = mm


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch}
SERVE = {"token_altered": token_altered, "state_unchanged": kv_unwritten}
