"""Shared arithmetic of the per-layer metric readers (`portbench/metrics`):
each reader takes the run's context ({"kind", "cell", "got", "peaks"})
and returns a number, or None where the run has nothing to read."""

from __future__ import annotations

import statistics

from portbench.harness import counts


def traced(ctx, kind: str):
    """The trace of a run of ``kind`` ("train" or "serve"), or None."""
    if ctx["kind"] != kind:
        return None
    return ctx["got"].get("trace")


def roofline(ctx, kind: str, calls: str, label: str):
    """Sum of the logged calls' bounds over the device time of the
    kernels inside their ranges, in percent."""
    tr, pk = traced(ctx, kind), ctx["peaks"]
    if tr is None or pk is None:
        return None
    logged = ctx["got"]["calls"].get(calls) or []
    t = tr["by_range_s"].get(label)
    if not logged or not t:
        return None
    count = counts.expert_call if calls == "experts" else counts.k2_call
    bound = sum(counts.bound_s(*count(xs, ws), pk) for xs, ws in logged)
    return 100.0 * bound / t


def mfu(ctx, kind: str, flops: float):
    """``flops`` over the host seconds of the traced run's untimed part
    before its profiler starts (the profiler slows what it records),
    against the int8 peak, in percent."""
    pk, got = ctx["peaks"], ctx["got"]
    if ctx["kind"] != kind or pk is None or not got.get("mfu_s"):
        return None
    return 100.0 * flops / got["mfu_s"] / pk["int8_ops"]


def idle(ctx, kind: str):
    tr = traced(ctx, kind)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / ctx["got"]["window_s"])


def median_ms(xs):
    return 1e3 * statistics.median(xs) if xs else None
