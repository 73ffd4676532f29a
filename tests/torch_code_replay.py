"""Replay of the JAX reference's rounded codes in the port, for the
parity tests of AIMC training.

The two frameworks compute a DAC input ``x / s_x`` or a noisy weight code
``w / s_w + noise`` in f32 along different op orders, so a value that
lies at a rounding tie can round to one code in the reference and to its
neighbour in the port. `logging_reference` logs the values the
reference's codes round from (through `jax.debug.callback`, so jitted and
remat-recomputed calls log too); `replaying_in_port` then gives the port
the reference's code wherever one differs at a tie and counts it, and
counts a code that differs away from a tie (a test fails on any).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import aimc as ja
from repro_torch.core import aimc as ta
from repro_torch.kernels import ops as tops

TIE = 1e-5      # code units: an f32 ulp of a value <= 127 is 7.6e-6


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _codes(v):
    return np.clip(np.round(v), -127, 127)


@contextlib.contextmanager
def logging_reference(log):
    """The JAX package's K2 dispatch (`kernels.ops.aimc_matmul_v2`) and
    programming noise (`core.noise.programming_noise`) log each executed
    call's pre-round values in code units (numpy f32): the DAC inputs under
    ``log["dac"]``, the noisy weight codes under ``log["prog"]``."""
    log.setdefault("dac", [])
    log.setdefault("prog", [])

    def put(kind):
        def f(v, scale):
            log[kind].append(np.asarray(v, np.float32)
                             / np.asarray(scale, np.float32).reshape(()))
        return f

    def dac(orig):
        def rec(x, w_q, s_w, s_x, *a, **k):
            jax.debug.callback(put("dac"), x, s_x)
            return orig(x, w_q, s_w, s_x, *a, **k)
        return rec

    def prog(orig):
        def rec(key, w_codes, nm):
            r = orig(key, w_codes, nm)
            jax.debug.callback(put("prog"), w_codes + r, jnp.float32(1.0))
            return r
        return rec

    with _patched(ja.kernel_ops, "aimc_matmul_v2", dac), \
            _patched(ja.noise_lib, "programming_noise", prog):
        yield log


def _replay_codes(v, log, seen, kind, tie=TIE):
    """The reference's codes for the port's pre-round values ``v`` (numpy):
    ``v`` is matched to the logged reference call of its shape whose codes
    differ least (the calls of a model differ in nearly every code, so the
    match is unambiguous). A differing code counts under ``seen[kind]``,
    and under ``seen["away"]`` unless both values lie within ``tie`` of one
    rounding tie. Returns (the reference's codes, where they differ)."""
    code = _codes(v)
    cands = [r for r in log[kind] if r.shape == v.shape]
    assert cands, f"no reference {kind} call of shape {v.shape}"
    ref = min(cands, key=lambda r: int((_codes(r) != code).sum()))
    diff = _codes(ref) != code
    if diff.any():
        edge = np.floor(np.maximum(np.abs(v), np.abs(ref))) + 0.5
        at_tie = ((np.abs(np.abs(v) - edge) < tie)
                  & (np.abs(np.abs(ref) - edge) < tie))
        seen[kind] += int(diff.sum())
        seen["away"] += int((diff & ~at_tie).sum())
    return _codes(ref), diff


@contextlib.contextmanager
def replaying_in_port(log, seen, tie=TIE):
    """The port's K2 dispatch and programming noise take the reference's
    codes from ``log`` (`_replay_codes`, within ``tie`` code units of a
    tie): a DAC input that rounds the other way becomes the reference's
    code times s_x, and a noisy weight code that does gets the reference's
    code less the noiseless one as its noise. ``seen`` counts "dac",
    "prog" and "away"."""
    for k in ("dac", "prog", "away"):
        seen.setdefault(k, 0)

    def dac(orig):
        def rec(x, w_q, s_w, s_x, *a, **k):
            ref, diff = _replay_codes((x.detach() / s_x.reshape(())).numpy(),
                                      log, seen, "dac", tie)
            if diff.any():
                x = torch.where(torch.from_numpy(diff),
                                torch.from_numpy(ref) * s_x, x)
            return orig(x, w_q, s_w, s_x, *a, **k)
        return rec

    def prog(orig):
        def rec(keys, w_codes, nm):
            r = orig(keys, w_codes, nm)
            out = []
            for c, rj in zip(w_codes, r):
                ref, diff = _replay_codes((c + rj).numpy(), log, seen,
                                          "prog", tie)
                out.append(torch.where(torch.from_numpy(diff),
                                       torch.from_numpy(ref) - c, rj))
            return torch.stack(out)
        return rec

    with _patched(tops, "aimc_matmul_v2", dac), \
            _patched(ta.noise_lib, "programming_noise_batch", prog):
        yield seen
