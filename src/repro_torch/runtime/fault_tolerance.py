"""Fault tolerance and straggler mitigation for the step loop (a copy of
`repro/runtime/fault_tolerance.py` on the port's own `core.noise.unit_hash`).

At thousand-node scale the failure model is: (a) hard node loss -> the run
dies and is restarted by the cluster scheduler; (b) transient device/runtime
errors -> retry in-process; (c) stragglers -> detect, log, and (on repeated
offence) trigger an elastic re-mesh restart.

This module implements the in-process half and the restart protocol:

  * `resilient_step`  — wraps a compiled step; retries transient failures,
    re-raising only after `max_retries` (at which point the supervisor
    restarts from the latest atomic checkpoint — which `checkpoint.restore`
    can load onto a DIFFERENT mesh, i.e. elastic shrink/grow).
  * `StragglerMonitor` — per-step wall-time EWMA + deviation; flags steps
    slower than `threshold`x the running mean, exposing a callback hook (on a
    real fleet: report the slow host to the scheduler for cordoning).
  * `Heartbeat` — step-progress file other processes / the scheduler can
    watch; doubles as the liveness probe in the launch scripts.

Public surface: `is_transient(exc)`, `resilient_step(fn, max_retries,
on_retry)`, `backoff_schedule`, `StragglerMonitor`, `Heartbeat`,
`elastic_mesh_shapes` (the re-mesh table over `launch.mesh` shapes).
Invariant: classification is on the error MESSAGE, not the type —
deterministic failures (RESOURCE_EXHAUSTED, INVALID_ARGUMENT, plain
RuntimeErrors) raise immediately; only recognized infrastructure flakes
retry (pinned by tests/test_engine.py).
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Callable

from repro_torch.core import noise as noise_lib

# The candidate exception TYPES a transient device/runtime failure surfaces
# as. Type alone is NOT enough to retry: the runtime raises RuntimeError
# for genuine bugs (INVALID_ARGUMENT) and for out-of-memory (RESOURCE_EXHAUSTED)
# just as it does for a flaky interconnect — retrying an OOM re-runs the
# allocation that already failed, and retrying a bug hides it. Classification
# is therefore on the error MESSAGE: terminal substrings always raise,
# transient substrings (plus plain I/O errors) retry.
TRANSIENT_ERRORS = (RuntimeError, OSError)

# Never retry: deterministic failures — the same call will fail the same way
# (or worse, an OOM retry loop wedges the host until the supervisor kills it).
TERMINAL_SUBSTRINGS = (
    "RESOURCE_EXHAUSTED", "out of memory", "OUT_OF_MEMORY",
    "INVALID_ARGUMENT", "FAILED_PRECONDITION", "UNIMPLEMENTED",
    "PERMISSION_DENIED", "NOT_FOUND",
)

# Worth retrying: infrastructure flakes that a backoff genuinely clears.
TRANSIENT_SUBSTRINGS = (
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "CANCELLED", "INTERNAL",
    "DATA_LOSS", "connection", "socket", "timed out", "timeout", "transient",
    "temporarily",
)


def is_transient(exc: BaseException) -> bool:
    """Should this step failure be retried in-process?

    Terminal substrings win outright (an OSError carrying RESOURCE_EXHAUSTED
    is still terminal). Otherwise OSErrors — I/O against a live fleet — are
    presumed transient, while RuntimeErrors must positively look like an
    infrastructure flake: an unrecognized RuntimeError is a bug and raises
    immediately rather than being retried as "transient".
    """
    if not isinstance(exc, TRANSIENT_ERRORS):
        return False
    low = str(exc).lower()
    if any(s.lower() in low for s in TERMINAL_SUBSTRINGS):
        return False
    if isinstance(exc, OSError):
        return True
    return any(s.lower() in low for s in TRANSIENT_SUBSTRINGS)


def backoff_schedule(max_retries: int, base: float = 0.05, cap: float = 2.0,
                     jitter: float = 0.5, seed: int = 0) -> tuple[float, ...]:
    """The exact sleep (seconds) before each retry: capped exponential
    backoff with DETERMINISTIC jitter.

    Attempt a sleeps ``min(cap, base * 2^a) * (1 + jitter * u_a)`` with
    ``u_a`` in [-1, 1) hashed from ``(seed, a)`` — same seed, same schedule,
    on every process and platform (pinned by tests/test_resilience.py).
    Jitter decorrelates a fleet of workers retrying the same flaky endpoint
    without sacrificing reproducibility; ``jitter=0`` is the pure
    exponential."""
    out = []
    for a in range(max_retries):
        delay = min(cap, base * (2.0 ** a))
        if jitter:
            u = 2.0 * noise_lib.unit_hash(seed, a) - 1.0
            delay *= 1.0 + jitter * u
        out.append(delay)
    return tuple(out)


def resilient_step(step_fn: Callable, max_retries: int = 2,
                   on_retry: Callable[[int, Exception], None] | None = None,
                   *, base_delay: float = 0.05, max_delay: float = 2.0,
                   jitter: float = 0.5, seed: int = 0,
                   sleep: Callable[[float], None] = time.sleep):
    """Wrap a compiled step function with bounded retry of TRANSIENT
    failures (`is_transient`); terminal errors propagate immediately.

    Sleeps between attempts follow `backoff_schedule(max_retries,
    base_delay, max_delay, jitter, seed)` — capped exponential with
    deterministic jitter, replacing the old linear 0.5s*(attempt+1) ramp
    (which synchronized retry storms and burned half a second on the first
    flake). ``sleep`` is injectable so tests pin the schedule without
    waiting it out."""
    delays = backoff_schedule(max_retries, base_delay, max_delay, jitter, seed)

    def wrapped(*args, **kwargs):
        for attempt in range(max_retries + 1):
            try:
                return step_fn(*args, **kwargs)
            except TRANSIENT_ERRORS as e:
                if not is_transient(e) or attempt == max_retries:
                    raise
                if on_retry:
                    on_retry(attempt, e)
                sleep(delays[attempt])
        raise AssertionError("unreachable")

    return wrapped


class StragglerMonitor:
    """EWMA step-time tracker with a slow-step callback.

    The EWMA baseline is seeded from the MEDIAN of the first ``warmup``
    samples, not the first sample alone: a slow first step would both
    escape detection (nothing to compare against) and poison the baseline
    so steps 2..warmup could never be flagged. Samples buffer until the
    warmup window fills; flagging starts on the first post-seed sample.

    Windows the caller KNOWS are legitimately slow — a hot-reprogram /
    recalibration chunk in the serve loop — are recorded with
    ``exempt=True``: they are never flagged (recovery must not trip the
    straggler callback) and never enter the EWMA or the warmup buffer (a
    recal chunk would inflate the baseline and mask real stragglers
    afterwards). Exempted samples are kept in ``self.exempted``."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup: int = 3, on_straggler=None):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = max(warmup, 1)
        self.on_straggler = on_straggler
        self.ewma = None
        self.count = 0
        self._warmup_buf: list[float] = []
        self.flagged: list[tuple[int, float, float]] = []
        self.exempted: list[tuple[int, float]] = []

    def record(self, step: int, dt: float, exempt: bool = False) -> bool:
        """Record one step time; returns True if flagged as straggler."""
        self.count += 1
        if exempt:
            self.exempted.append((step, dt))
            return False
        if self.ewma is None:
            self._warmup_buf.append(dt)
            if len(self._warmup_buf) < self.warmup:
                return False
            self.ewma = statistics.median(self._warmup_buf)
            self._warmup_buf.clear()
            return False
        is_slow = dt > self.threshold * self.ewma
        if is_slow:
            self.flagged.append((step, dt, self.ewma))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        else:
            # stragglers do not poison the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_slow


class Heartbeat:
    """Progress file for external liveness/restart supervision."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int, **info):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time(), **info}, f)
        os.replace(tmp, self.path)

    def read(self) -> dict | None:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None


def elastic_mesh_shapes(n_devices: int, model_parallel: int):
    """Valid (data, model) meshes for whatever device count survives: the
    re-mesh table the supervisor consults when restarting smaller."""
    shapes = []
    mp = model_parallel
    while mp >= 1:
        if n_devices % mp == 0:
            shapes.append((n_devices // mp, mp))
        mp //= 2
    return shapes
