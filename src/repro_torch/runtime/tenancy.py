"""Per-tenant policy for the multi-tenant model server (`runtime.server`);
PyTorch port of `repro/runtime/tenancy.py`, host-only and nearly verbatim.

ALPINE's premise is a FLEXIBLE accelerator pool — AIMC tiles tightly
integrated with general-purpose cores serve whatever mix of models the
host schedules onto them, not one hard-coded dataflow. Once several models
are co-programmed on one crossbar budget (`core.program.TilePool`), the
interesting system is the TENANT layer: who may use which model, in what
order, with what share of the decode slots, against what latency target.
This module holds that policy, fully host-side:

  * `TenantPolicy`   — one tenant's contract: the model id its requests
    route to, a fair-share ``weight`` for decode slots, a per-tenant
    admission order (fifo / sjf), optional SLO targets (p99 TTFT and p99
    per-output-token latency).
  * `pick_tenant`    — the quota scheduler's single decision: among tenants
    with a ready request for a model with a free slot, admit the one using
    the smallest fraction of its entitlement (weighted deficit, stable
    tie-break). Work-conserving: a lone candidate may borrow beyond its
    share, but whenever a below-share tenant is waiting it goes first — so
    under saturation every tenant's slot share converges to
    ``weight_i / sum(weights)`` and nobody starves.
  * `fair_shares`    — the per-model slot entitlement those picks converge
    to (the denominator of the fairness checks).
  * `TenantStats` / `tenant_stats` — per-tenant SLO accounting from the
    engine's `RequestRecord`s: p50/p99 TTFT, completion latency,
    per-output-token latency (TPOT), tok/s, SLO verdicts.
  * `jains_index`    — the quota-fairness metric the benchmark reports
    (1.0 = perfectly fair, 1/n = one tenant took everything).
  * `tenant_ledgers` / `reconcile_tenants` — per-tenant CM_* books riding
    the per-request ledgers; summed across a model's tenants they must
    close EXACTLY against ``program.mvm_counts()`` (the multi-tenant twin
    of `batcher.reconcile`).
  * `mixed_poisson_trace` — interleaved multi-tenant synthetic load: one
    Poisson arrival process, each arrival assigned a tenant
    weight-proportionally, prompts drawn from that tenant's model vocab.

Invariants: all picks and traces are deterministic (stable w.r.t. tenant
name / rid) so multi-tenant runs replay; ledger reconciliation is exact,
never approximate.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Mapping, Sequence

from repro_torch.runtime.batcher import Request, RequestRecord, percentile

ADMISSION_POLICIES = ("fifo", "sjf")


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """One tenant's serving contract (hashable, declarative).

    ``weight`` is the fair-share weight for decode slots on ``model``
    (entitlement = weight / sum of co-tenant weights); ``admission`` orders
    the tenant's OWN queue; the SLO targets are report-time verdicts, not
    enforcement (the quota is the enforcement lever). ``max_pages`` caps
    the tenant's NEWLY-allocated KV pages on a paged engine (shared prefix
    pages are unbilled — `runtime.engine.pages_needed`); None = unlimited,
    and it is simply ignored on a dense engine."""
    name: str
    model: str
    weight: float = 1.0
    admission: str = "fifo"
    slo_ttft_s: float | None = None       # p99 time-to-first-token target
    slo_tpot_s: float | None = None       # p99 per-output-token target
    max_pages: int | None = None          # paged-engine KV page quota

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if not self.model:
            raise ValueError(f"tenant {self.name!r}: model must be non-empty")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.max_pages is not None and self.max_pages <= 0:
            raise ValueError(f"tenant {self.name!r}: max_pages must be > 0 "
                             f"(None = unlimited)")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"tenant {self.name!r}: unknown admission "
                             f"policy {self.admission!r} "
                             f"(known: {ADMISSION_POLICIES})")


@dataclasses.dataclass(frozen=True)
class TenantRequest:
    """A request tagged with the tenant that submitted it."""
    tenant: str
    request: Request


# ---------------------------------------------------------------------------
# quota scheduling
# ---------------------------------------------------------------------------

def fair_shares(policies: Sequence[TenantPolicy], model: str,
                n_slots: int) -> dict[str, float]:
    """tenant -> entitled decode slots of ``model`` (weighted share)."""
    tenants = [p for p in policies if p.model == model]
    wsum = sum(p.weight for p in tenants)
    return {p.name: n_slots * p.weight / wsum for p in tenants}


def pick_tenant(candidates: Sequence[str], in_flight: Mapping[str, int],
                policies: Mapping[str, TenantPolicy]) -> str:
    """The quota scheduler's admission pick: the candidate tenant holding
    the smallest ``in_flight / weight`` ratio goes first (weighted deficit;
    name-ordered tie-break for determinism). Candidates are tenants with a
    ready request for a model that has a free slot — the caller's job."""
    if not candidates:
        raise ValueError("pick_tenant needs at least one candidate")
    return min(candidates,
               key=lambda t: (in_flight.get(t, 0) / policies[t].weight, t))


def jains_index(xs: Sequence[float]) -> float:
    """Jain's fairness index over per-tenant allocations: 1.0 when all
    equal, 1/n when one tenant took everything. Empty/zero input -> 0.0."""
    xs = list(xs)
    if not xs or all(x == 0 for x in xs):
        return 0.0
    return sum(xs) ** 2 / (len(xs) * sum(x * x for x in xs))


# ---------------------------------------------------------------------------
# per-tenant SLO accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TenantStats:
    """One tenant's view of a serve run (built by `tenant_stats`)."""
    name: str
    model: str
    n_requests: int
    generated_tokens: int
    vectors: int                           # useful token vectors (CM_* unit)
    tok_s: float                           # generated tokens / makespan
    p50_ttft_s: float
    p99_ttft_s: float
    p50_latency_s: float
    p99_latency_s: float
    p50_tpot_s: float                      # per-output-token decode latency
    p99_tpot_s: float
    slo_ttft_ok: bool | None = None        # None: no target declared
    slo_tpot_ok: bool | None = None

    def row(self) -> str:
        def ms(x):
            return f"{x * 1e3:.0f}" if x == x else "-"      # NaN -> "-"

        slo = ""
        if self.slo_ttft_ok is not None or self.slo_tpot_ok is not None:
            verdict = {True: "ok", False: "VIOLATED", None: "-"}
            slo = (f"  slo[ttft={verdict[self.slo_ttft_ok]} "
                   f"tpot={verdict[self.slo_tpot_ok]}]")
        return (f"{self.name}@{self.model}: {self.n_requests} reqs, "
                f"{self.generated_tokens} toks ({self.tok_s:.1f} tok/s); "
                f"ttft p50/p99 {ms(self.p50_ttft_s)}/{ms(self.p99_ttft_s)}ms"
                f"  tpot p50/p99 {ms(self.p50_tpot_s)}/"
                f"{ms(self.p99_tpot_s)}ms{slo}")


def tenant_stats(policy: TenantPolicy,
                 records: Mapping[int, RequestRecord],
                 makespan_s: float) -> TenantStats:
    """Build one tenant's stats from ITS records (caller pre-filters by
    tenant — `runtime.server.ServerReport.tenant_records`)."""
    recs = list(records.values())
    ttfts = [r.ttft for r in recs]
    lats = [r.latency for r in recs]
    # TPOT only exists for requests that decoded at least one token beyond
    # the prefill's first; prefill-only requests have no decode latency
    tpots = [(r.latency - r.ttft) / r.decode_vectors
             for r in recs if r.decode_vectors > 0]
    toks = sum(len(r.tokens) for r in recs)
    p99_ttft = percentile(ttfts, 99)
    p99_tpot = percentile(tpots, 99)
    return TenantStats(
        name=policy.name, model=policy.model,
        n_requests=len(recs),
        generated_tokens=toks,
        vectors=sum(r.vectors for r in recs),
        tok_s=toks / max(makespan_s, 1e-9),
        p50_ttft_s=percentile(ttfts, 50), p99_ttft_s=p99_ttft,
        p50_latency_s=percentile(lats, 50), p99_latency_s=percentile(lats, 99),
        p50_tpot_s=percentile(tpots, 50), p99_tpot_s=p99_tpot,
        slo_ttft_ok=(None if policy.slo_ttft_s is None or not recs
                     else bool(p99_ttft <= policy.slo_ttft_s)),
        slo_tpot_ok=(None if policy.slo_tpot_s is None or not tpots
                     else bool(p99_tpot <= policy.slo_tpot_s)),
    )


# ---------------------------------------------------------------------------
# per-tenant CM_* ledgers (against core.program.AimcProgram)
# ---------------------------------------------------------------------------

def tenant_ledgers(program, records: Mapping[int, RequestRecord],
                   tenant_of: Mapping[int, str]) -> dict:
    """tenant -> CM_* counts for that tenant's useful vectors through ONE
    model's program (records are that model's; ``tenant_of`` maps rid ->
    tenant). Flows through per-request ledgers, not a single scale, so the
    sum genuinely re-derives the total."""
    per_vec = program.mvm_counts()
    out: dict[str, object] = {}
    for rid, rec in records.items():
        t = tenant_of[rid]
        cm = per_vec.scaled(rec.vectors)
        out[t] = cm if t not in out else out[t] + cm
    return out


def reconcile_tenants(program, records: Mapping[int, RequestRecord],
                      tenant_of: Mapping[int, str],
                      observed_vectors: int | None = None):
    """(sum of per-tenant ledgers, the program's static total) for one
    model. The multi-tenant twin of `batcher.reconcile`: the left side
    flows through per-request -> per-tenant bookkeeping, the right scales
    ``program.mvm_counts()`` by the device loop's independent vector count.
    Exact equality or it's a bookkeeping bug."""
    if observed_vectors is None:
        observed_vectors = sum(rec.vectors for rec in records.values())
    total = program.mvm_counts().scaled(0)
    for cm in tenant_ledgers(program, records, tenant_of).values():
        total = total + cm
    return total, program.mvm_counts().scaled(observed_vectors)


# ---------------------------------------------------------------------------
# mixed-traffic synthetic load
# ---------------------------------------------------------------------------

def mixed_poisson_trace(policies: Sequence[TenantPolicy], n: int, rate: float,
                        *, vocab_of: Mapping[str, int], seed: int = 0,
                        prompt_len: tuple[int, int] = (4, 12),
                        max_new: tuple[int, int] = (2, 12),
                        ) -> list[TenantRequest]:
    """One interleaved Poisson arrival stream across every tenant.

    Exponential inter-arrivals at ``rate`` req/s; each arrival is assigned
    a tenant weight-proportionally, with prompt tokens drawn from THAT
    tenant's model vocab (``vocab_of``: model id -> vocab size). Rids are
    globally unique and arrival-ordered, so multi-tenant runs replay."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    if not policies:
        raise ValueError("need at least one tenant policy")
    missing = {p.model for p in policies} - set(vocab_of)
    if missing:
        raise ValueError(f"vocab_of missing models: {sorted(missing)}")
    rng = random.Random(seed)
    weights = [p.weight for p in policies]
    t = 0.0
    out = []
    for i in range(n):
        t += -math.log(1.0 - rng.random()) / rate
        pol = rng.choices(policies, weights=weights)[0]
        vocab = vocab_of[pol.model]
        p_len = rng.randint(*prompt_len)
        out.append(TenantRequest(
            tenant=pol.name,
            request=Request(
                rid=i,
                prompt=tuple(rng.randint(1, vocab - 1)
                             for _ in range(p_len)),
                max_new=rng.randint(*max_new),
                arrival=t)))
    return out
