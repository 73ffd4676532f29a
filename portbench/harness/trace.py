"""Spans and counts from the benchmark's side, and the reading of the
profiler's trace.

`instrument` wraps the port's entry points from outside for a traced
run: each crossbar call (`aimc_mvm_v2`, the expert entry) and each
programming call (`core.aimc.program_stacked`) runs inside a named
profiler range, and each crossbar call's shapes are logged for its
bound. `read` takes the raw kineto events (no Python event tree, which
takes minutes at 10^5 kernels): device busy time as the union of kernel,
copy and set intervals; per range, the device time of the kernels that
start inside its device-side span; kernels by name; idle gaps by the
benchmark range the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import time

RANGES = ("pb.k2", "pb.experts", "pb.program")


@contextlib.contextmanager
def patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def ranged(label, fn, log=None, shapes=None):
    """``fn`` inside profiler range ``label``; ``shapes(args)`` appended
    to ``log``."""
    from torch.profiler import record_function

    def wrapped(*a, **k):
        if log is not None:
            log.append(shapes(a))
        with record_function(label):
            return fn(*a, **k)
    return wrapped


@contextlib.contextmanager
def instrument(calls: dict):
    """Ranges and call logs around the port's crossbar and programming
    entry points; ``calls`` gets "k2" and "experts" lists of (x shape,
    codes shape)."""
    from repro_torch.core import aimc as core_aimc
    from repro_torch.kernels import aimc_mvm

    calls.setdefault("k2", [])
    calls.setdefault("experts", [])

    def shapes(a):
        return tuple(a[0].shape), tuple(a[1].shape)

    with contextlib.ExitStack() as st:
        st.enter_context(patched(aimc_mvm, "aimc_mvm_v2", lambda f: ranged(
            "pb.k2", f, calls["k2"], shapes)))
        st.enter_context(patched(aimc_mvm, "aimc_mvm_experts",
                                 lambda f: ranged("pb.experts", f,
                                                  calls["experts"], shapes)))
        st.enter_context(patched(core_aimc, "program_stacked",
                                 lambda f: ranged("pb.program", f)))
        yield calls


class Profiler:
    """A torch profiler (CPU ranges and device activity) that keeps its
    raw events only, started and stopped by hand: `stop` synchronises
    and returns the host seconds since `start`."""

    def __init__(self, dev):
        self.dev, self.prof, self.window_s = dev, None, None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._stack = contextlib.ExitStack()
        legacy = torch.autograd.profiler.profile
        if hasattr(legacy, "_parse_kineto_results"):
            self._stack.enter_context(patched(
                legacy, "_parse_kineto_results",
                lambda _o: lambda self, result: []))
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
        self.prof = self._stack.enter_context(profile(activities=acts))
        self._t = time.perf_counter()

    def stop(self) -> float:
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.window_s = time.perf_counter() - self._t
        self._stack.close()
        return self.window_s


@contextlib.contextmanager
def profiled(dev):
    """`Profiler` over the block; yields a dict that gets "prof" and the
    block's host "window_s"."""
    pr = Profiler(dev)
    out = {}
    pr.start()
    try:
        yield out
    finally:
        out["window_s"] = pr.stop()
        out["prof"] = pr.prof


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its namespaces, cut to ``width`` characters
    (templated names run to thousands)."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "std::", "c10::"):
        name = name.replace(noise, "")
    return name if len(name) <= width else name[:width - 3] + "..."


def _merge(iv):
    """Union of intervals (sorted) -> list of disjoint [a, b]."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(prof) -> dict:
    """busy_s, kernel seconds per range and per name, idle gaps by host
    range, from the profiler's raw events."""
    import torch

    if hasattr(torch._C._autograd._KinetoEvent, "is_user_annotation"):
        def annotation(ev):
            return ev.is_user_annotation()
    else:
        def annotation(ev):
            return "annotation" in str(ev.activity_type())
    cuda = torch.autograd.DeviceType.CUDA
    kernels, spans, host = [], {r: [] for r in RANGES}, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        a = ev.start_ns()
        b = a + ev.duration_ns()
        if ev.device_type() == cuda:
            if annotation(ev):
                if name in spans:
                    spans[name].append((a, b))
                continue
            kernels.append((a, b, name))
        elif name.startswith("pb."):
            host.append((a, b, name))
    busy = _merge([(a, b) for a, b, _ in kernels])
    busy_ns = sum(b - a for a, b in busy)
    by_name: dict = {}
    for a, b, n in kernels:
        by_name[n] = by_name.get(n, 0) + (b - a)
    by_range = {}
    for r, iv in spans.items():
        iv = _merge(iv)
        starts = [s for s, _ in iv]
        tot = 0
        for a, b, _ in kernels:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a < iv[i][1]:
                tot += b - a
        by_range[r] = tot / 1e9 if iv else None
    gaps: dict = {}
    host.sort()
    hstarts = [a for a, _, _ in host]
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        label = "host outside benchmark ranges"
        i = bisect.bisect_right(hstarts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):     # the innermost open
            a, b, n = host[j]
            if a <= mid < b:
                label = n
                break
        gaps[label] = gaps.get(label, 0) + (s1 - e0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns / 1e9, "by_range_s": by_range,
            "device_ops": [[short(n), v / 1e9] for n, v in top],
            "idle_gaps": [[n, v / 1e9] for n, v in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
            "kernels": len(kernels)}
