"""Request admission, slot allocation and per-request accounting for the
continuous-batching engine (`runtime.engine`); a copy of
`repro/runtime/batcher.py`, which imports no framework.

The serving regime is the paper's weights-stationary deployment (§IV-B,
Fig. 4): the crossbars are programmed once, then token vectors stream
through queue/process/dequeue forever. At that point the interesting system
is the REQUEST layer — ragged prompts arriving at random times, each wanting
its own number of new tokens — and this module holds its host-side state:

  * `Request`        — what a client submits (id, prompt, max_new, arrival).
  * `Batcher`        — the admission queue: requests ordered by an admission
    policy (fifo / sjf), popped when their arrival time has passed and a
    decode slot is free.
  * `SlotAllocator`  — the fixed-shape decode batch's free-list. Slots are
    the engine's unit of residency: a request owns one slot from prefill
    insertion to retirement (EOS / length), then the slot is refilled.
  * `RequestRecord`  — per-request ledger: token-vector counts (the CM_*
    accounting unit), TTFT and completion latency. `request_ledgers` /
    `reconcile` turn vector counts into CM_* instruction totals that sum
    EXACTLY to `program.mvm_counts().scaled(total_vectors)` — the engine's
    books against the `AimcProgram`'s static accounting.
  * trace builders   — `poisson_trace` (staggered synthetic load) and
    `synchronized_trace` (the legacy static-batch arrival pattern).
  * per-core views   — `request_core_ledgers` / `aggregate_core_ledgers`
    split each request's books across a `core.schedule.CoreSchedule`'s
    virtual cores; `reconcile_cores` closes the shard-aggregated sum
    against the schedule totals (sharded serving, DESIGN.md §11).

Invariants: `reconcile` and `reconcile_cores` compare two INDEPENDENT
countings (per-request records vs the device loop's observed vectors) and
must close EXACTLY — approximate agreement is a bookkeeping bug. All
admission orders are deterministic (stable w.r.t. rid) so traces replay.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request. ``arrival`` is in engine-clock seconds;
    ``max_new`` counts generated tokens INCLUDING the prefill's first one
    (``max_new=1`` retires at prefill, never occupying a decode slot)."""
    rid: int
    prompt: tuple[int, ...]
    max_new: int = 8
    arrival: float = 0.0

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")


@dataclasses.dataclass
class RequestRecord:
    """The engine's per-request books (filled in as the request moves
    through admitted -> prefilled -> decoding -> retired)."""
    request: Request
    t_admit: float = 0.0           # engine clock when popped from the queue
    t_first: float = 0.0           # first token emitted (prefill done)
    t_done: float = 0.0            # retirement
    tokens: list[int] = dataclasses.field(default_factory=list)
    prefill_vectors: int = 0       # useful prompt token vectors (== len)
    decode_vectors: int = 0        # decode steps this request rode in
    pad_vectors: int = 0           # prompt-padding lanes it wasted
    finish_reason: str = ""        # "length" | "eos" | "cap"

    @property
    def vectors(self) -> int:
        """Useful token vectors this request pushed through the program."""
        return self.prefill_vectors + self.decode_vectors

    @property
    def ttft(self) -> float:
        return self.t_first - self.request.arrival

    @property
    def latency(self) -> float:
        return self.t_done - self.request.arrival


class SlotAllocator:
    """Free-list over the fixed decode batch: slot i <-> batch row i."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))   # pop() -> slot 0 first
        self.occupant: dict[int, int] = {}              # slot -> rid

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_busy(self) -> int:
        return self.n_slots - len(self._free)

    def alloc(self, rid: int) -> int:
        slot = self._free.pop()
        self.occupant[slot] = rid
        return slot

    def release(self, slot: int) -> int:
        rid = self.occupant.pop(slot)
        self._free.append(slot)
        return rid


class Batcher:
    """Admission queue: holds not-yet-admitted requests, releases them when
    their arrival time has passed AND the caller has a free slot.

    ``policy``: "fifo" admits in arrival order; "sjf" (shortest job first,
    by ``max_new``) is the classic latency-percentile lever — both are
    stable w.r.t. rid so traces replay deterministically.
    """

    def __init__(self, requests: Sequence[Request], policy: str = "fifo"):
        if policy not in ("fifo", "sjf"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.policy = policy
        # plain list: every pop re-scans the READY subset anyway (readiness
        # depends on `now`, which a static heap order cannot encode). sjf
        # orders the ready set by decode budget (arrival only breaks ties) —
        # budget-first is what makes it shortest-job-first under staggered
        # arrivals; arrival-first would degenerate to fifo.
        self._pending = list(requests)

    def _prio(self, r: Request):
        return ((r.max_new, r.arrival, r.rid) if self.policy == "sjf"
                else (r.arrival, r.rid))

    def __len__(self) -> int:
        return len(self._pending)

    def next_arrival(self) -> float | None:
        """Arrival time of the earliest still-queued request."""
        if not self._pending:
            return None
        return min(r.arrival for r in self._pending)

    def has_ready(self, now: float) -> bool:
        """Whether any queued request's arrival has passed (non-popping —
        the multi-tenant server asks every tenant queue before picking)."""
        return any(r.arrival <= now for r in self._pending)

    def peek_ready(self, now: float) -> Request | None:
        """The request `pop_ready` WOULD return, without removing it.

        Paged admission asks the page allocator whether the next request
        fits BEFORE committing to pop it (runtime.engine.can_admit) — a
        popped-but-unadmittable request would either be dropped or jump
        the deterministic admission order."""
        ready = [r for r in self._pending if r.arrival <= now]
        return min(ready, key=self._prio) if ready else None

    def pop_ready(self, now: float) -> Request | None:
        """Pop the highest-priority request whose arrival has passed."""
        best = self.peek_ready(now)
        if best is not None:
            self._pending.remove(best)
        return best


# ---------------------------------------------------------------------------
# CM_* ledger reconciliation (against core.program.AimcProgram)
# ---------------------------------------------------------------------------

def request_ledgers(program, records: dict[int, RequestRecord]) -> dict:
    """rid -> CM_* counts for that request's useful token vectors."""
    per_vec = program.mvm_counts()
    return {rid: per_vec.scaled(rec.vectors) for rid, rec in records.items()}

def reconcile(program, records: dict[int, RequestRecord],
              observed_vectors: int | None = None):
    """(sum of per-request ledgers, the program's static total).

    ``observed_vectors`` should be the engine's INDEPENDENT count from the
    device loop (`ServeReport.observed_vectors`: prompt lengths at each
    prefill call + busy lanes at each decode call). The left side comes
    from per-request `RequestRecord` bookkeeping; with an observed total
    the two countings can genuinely disagree — a double- or under-counted
    vector on either path breaks the equality. Without it the check
    degrades to the linearity tautology (both sides scale the same record
    counts)."""
    if observed_vectors is None:
        observed_vectors = sum(rec.vectors for rec in records.values())
    ledger_sum = program.mvm_counts().scaled(0)
    for cm in request_ledgers(program, records).values():
        ledger_sum = ledger_sum + cm
    static = program.mvm_counts().scaled(observed_vectors)
    return ledger_sum, static


# ---------------------------------------------------------------------------
# per-core ledger aggregation (against core.schedule.CoreSchedule)
# ---------------------------------------------------------------------------

def request_core_ledgers(schedule, records: dict[int, RequestRecord]) -> dict:
    """rid -> {core -> CM_* counts} under a multi-core schedule.

    Each request's useful vectors ride through EVERY core the schedule
    places shards on, so its ledger splits per core by the schedule's
    per-vector `CoreLedger`s (column-split cores each queue the full
    vector; dequeue partitions exactly — core.schedule semantics)."""
    per_core = {led.core: led.cm for led in schedule.ledgers()}
    return {rid: {c: cm.scaled(rec.vectors) for c, cm in per_core.items()}
            for rid, rec in records.items()}


def aggregate_core_ledgers(schedule,
                           records: dict[int, RequestRecord]) -> dict:
    """core -> CM_* counts summed over all requests (the shard-aggregated
    view of `request_ledgers`)."""
    agg: dict[int, object] = {}
    for cores in request_core_ledgers(schedule, records).values():
        for c, cm in cores.items():
            agg[c] = cm if c not in agg else agg[c] + cm
    return agg


def reconcile_cores(schedule, records: dict[int, RequestRecord],
                    observed_vectors: int | None = None):
    """(sum over cores of the aggregated per-core ledgers, the schedule's
    static per-core totals scaled by ``observed_vectors``).

    The multi-core twin of `reconcile`: the left side flows through
    per-request, per-core bookkeeping; the right is
    ``schedule.ledger_totals().scaled(observed)``. For layer-per-core
    schedules (no column splits — `CoreSchedule.from_program`) the right
    side ALSO equals ``program.mvm_counts().scaled(observed)``, so the
    sharded engine's books close against the single-core program exactly."""
    if observed_vectors is None:
        observed_vectors = sum(rec.vectors for rec in records.values())
    agg = aggregate_core_ledgers(schedule, records)
    total = None
    for cm in agg.values():
        total = cm if total is None else total + cm
    if total is None:
        total = schedule.ledger_totals().scaled(0)
    return total, schedule.ledger_totals().scaled(observed_vectors)


# ---------------------------------------------------------------------------
# synthetic arrival traces
# ---------------------------------------------------------------------------

def poisson_trace(n: int, rate: float, seed: int = 0,
                  prompt_len: tuple[int, int] = (4, 16),
                  max_new: tuple[int, int] = (2, 12),
                  vocab: int = 128) -> list[Request]:
    """Staggered synthetic load: exponential inter-arrivals at ``rate``
    requests/second, ragged prompt lengths and per-request ``max_new``."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = random.Random(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += -math.log(1.0 - rng.random()) / rate
        p_len = rng.randint(*prompt_len)
        out.append(Request(
            rid=i,
            prompt=tuple(rng.randint(1, vocab - 1) for _ in range(p_len)),
            max_new=rng.randint(*max_new),
            arrival=t))
    return out


def synchronized_trace(n: int, prompt_len: int = 8, max_new: int = 8,
                       seed: int = 0, vocab: int = 128) -> list[Request]:
    """The legacy static-batch arrival pattern: everyone at t=0, one prompt
    length, one decode budget — the shape the bit-equality test serves both
    ways."""
    rng = random.Random(seed)
    return [Request(
        rid=i,
        prompt=tuple(rng.randint(1, vocab - 1) for _ in range(prompt_len)),
        max_new=max_new, arrival=0.0) for i in range(n)]


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (q in [0, 100]) — no numpy needed."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    pos = (len(s) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))
