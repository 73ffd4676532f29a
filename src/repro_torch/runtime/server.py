"""Multi-tenant model server: co-programmed models, per-tenant SLOs, one
accelerator pool (PyTorch port of `repro/runtime/server.py`, DESIGN.md §12).

  model registry   ``{model id -> ServeEngine}``. AIMC models are
                   co-programmed against one shared `core.program.TilePool`
                   (capacity checked against the SUM of resident programs:
                   `CapacityError` instead of overlapping tiles); digital
                   models ride along on the same host.

  routing          every `tenancy.TenantRequest` routes by its tenant's
                   ``model`` id to that model's engine; the server drives
                   one `EngineSession` per model under ONE shared clock.

  tenant policy    per-tenant admission queues (fifo/sjf), weighted
                   fair-share decode-slot quotas (`tenancy.pick_tenant`:
                   weighted deficit, work-conserving) and per-tenant SLO
                   tracking (p50/p99 TTFT and per-output-token latency).

  accounting       per-tenant CM_* books ride the `RequestRecord` ledgers;
                   per model the summed per-tenant ledgers close EXACTLY
                   against ``program.mvm_counts()``
                   (`tenancy.reconcile_tenants`).

The loop is round-robin over models in registry order: admit tenant-fairly
into every model's free slots, then run one synchronous decode chunk
(`ServeEngine.step`) per model with busy lanes, advancing the shared clock
by measured wall time. Retirements and quota accounting land on chunk
boundaries.

Public surface: `ModelSpec`, `build_server`, `ModelServer` (`warmup`,
`serve(trace) -> ServerReport`, `reconcile`, `fair_shares`),
`ServerReport`. A rotating engine (`core.placement`) is refused;
``build_server(mesh=)`` builds every model's engine as a
`runtime.engine.ShardedServeEngine` on that `launch.mesh.Mesh`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.runtime.batcher import Batcher, RequestRecord
from repro_torch.runtime.engine import ServeEngine, ServeReport
from repro_torch.runtime.tenancy import (TenantPolicy, TenantRequest, TenantStats,
                                   fair_shares, jains_index, pick_tenant,
                                   reconcile_tenants, tenant_stats)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One model-registry entry for `build_server`."""
    name: str                      # registry id requests route by
    arch: str                      # configs.get_arch id
    exec_mode: str = "digital"     # "aimc" (co-programmed) | "digital"

    def __post_init__(self):
        if self.exec_mode not in ("aimc", "digital"):
            raise ValueError(f"model {self.name!r}: exec_mode must be "
                             f"'aimc' or 'digital', got {self.exec_mode!r}")


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServerReport:
    """Everything one `ModelServer.serve` run produced."""
    model_reports: dict[str, ServeReport]
    tenant_of: dict[int, str]              # rid -> tenant name
    policies: dict[str, TenantPolicy]
    makespan_s: float = 0.0

    def tenant_records(self, tenant: str) -> dict[int, RequestRecord]:
        """That tenant's records, across every model it touched."""
        out = {}
        for rep in self.model_reports.values():
            out.update({rid: rec for rid, rec in rep.records.items()
                        if self.tenant_of[rid] == tenant})
        return out

    def tenant_stats(self) -> dict[str, TenantStats]:
        return {name: tenant_stats(pol, self.tenant_records(name),
                                   self.makespan_s)
                for name, pol in self.policies.items()}

    def fairness(self, model: str) -> float:
        """Jain's index over weight-normalized tenant throughput on one
        model (1.0 = shares match weights exactly). Single-tenant models
        are trivially fair."""
        stats = self.tenant_stats()
        xs = [stats[p.name].generated_tokens / p.weight
              for p in self.policies.values() if p.model == model]
        return jains_index(xs)

    @property
    def generated_tokens(self) -> int:
        return sum(r.generated_tokens for r in self.model_reports.values())

    def summary(self) -> str:
        lines = [f"{sum(len(r.records) for r in self.model_reports.values())}"
                 f" requests, {self.generated_tokens} tokens in "
                 f"{self.makespan_s:.2f}s engine-time across "
                 f"{len(self.model_reports)} model(s)"]
        for name, st in sorted(self.tenant_stats().items()):
            lines.append("  " + st.row())
        models = {p.model for p in self.policies.values()}
        fair = ", ".join(f"{m}={self.fairness(m):.3f}"
                         for m in sorted(models))
        lines.append(f"  quota fairness (Jain, weight-normalized): {fair}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class ModelServer:
    """Routes a mixed-tenant request stream over co-resident model engines.

    ``engines``: model id -> warmed or warmable `ServeEngine` (the server
    only uses the session primitives). ``tenants``:
    every tenant's policy; each must route to a registered model. ``pool``:
    the shared `TilePool` the AIMC members were co-programmed against
    (capacity stats; optional).
    """

    def __init__(self, engines: Mapping[str, ServeEngine],
                 tenants: Sequence[TenantPolicy], *, pool=None):
        if not engines:
            raise ValueError("ModelServer needs at least one engine")
        if not tenants:
            raise ValueError("ModelServer needs at least one tenant")
        names = [p.name for p in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        self.engines = dict(engines)
        for m, eng in self.engines.items():
            if getattr(eng, "rotation", None) is not None:
                raise ValueError(
                    f"model {m!r} serves a capacity-overflow rotation plan "
                    f"(core.placement); the multi-tenant server interleaves "
                    f"engines under one clock, so a swap from one model's "
                    f"cadence would stall every tenant — serve rotation "
                    f"plans single-model via ServeEngine.serve")
        self.policies = {p.name: p for p in tenants}
        for p in tenants:
            if p.model not in self.engines:
                raise ValueError(
                    f"tenant {p.name!r} routes to unregistered model "
                    f"{p.model!r} (registered: {sorted(self.engines)})")
        self.pool = pool
        # model -> its tenants, in stable (name-sorted) order
        self._tenants_of = {
            m: sorted(p.name for p in tenants if p.model == m)
            for m in self.engines}

    # -- setup ---------------------------------------------------------------
    def warmup(self) -> dict[str, dict[str, int]]:
        """Warm every engine (compile outside the serving clock)."""
        return {m: eng.warmup() for m, eng in self.engines.items()}

    def compile_counts(self) -> dict[str, dict[str, int]]:
        return {m: eng.compile_counts() for m, eng in self.engines.items()}

    def fair_shares(self, model: str) -> dict[str, float]:
        """tenant -> entitled decode slots on ``model``."""
        return fair_shares(list(self.policies.values()), model,
                           self.engines[model].n_slots)

    # -- the serving loop ----------------------------------------------------
    def serve(self, trace: Sequence[TenantRequest],
              max_steps: int = 100_000, heartbeat=None) -> ServerReport:
        """Serve a mixed-tenant trace to completion under one shared clock.

        The clock starts at 0 and advances by the measured wall time of
        every device call (models serialize on the host — honest for a
        single-host pool); when everything is idle it jumps to the next
        arrival. Admission is tenant-fair per model (`tenancy.pick_tenant`)
        with each tenant's own queue order; decode is round-robin, one
        dense step per model with busy lanes per pass.

        ``heartbeat`` (a `fault_tolerance.Heartbeat`) is beaten once per
        decode pass with slot occupancy per model and the wall timestamp
        of the last completed chunk — the liveness probe an external
        supervisor watches to distinguish a wedged loop from a slow one."""
        for tr in trace:
            if tr.tenant not in self.policies:
                raise ValueError(f"request {tr.request.rid}: unknown tenant "
                                 f"{tr.tenant!r}")
        rids = [tr.request.rid for tr in trace]
        if len(set(rids)) != len(rids):
            raise ValueError("request rids must be globally unique")

        tenant_of = {tr.request.rid: tr.tenant for tr in trace}
        queues = {
            name: Batcher([tr.request for tr in trace if tr.tenant == name],
                          policy=pol.admission)
            for name, pol in self.policies.items()}
        sessions = {m: eng.begin() for m, eng in self.engines.items()}
        in_flight = {name: 0 for name in self.policies}   # decode slots held
        capped: set[str] = set()                          # hit max_steps
        now = 0.0
        n_pass = 0

        def queued(m: str) -> int:
            return sum(len(queues[t]) for t in self._tenants_of[m])

        while True:
            # ---- tenant-fair admission + slot refill ----------------------
            for m, eng in self.engines.items():
                if m in capped:
                    continue
                sess = sessions[m]
                while sess.slots.n_free:
                    cands = [t for t in self._tenants_of[m]
                             if queues[t].has_ready(now)]
                    admitted = False
                    while cands:
                        t = pick_tenant(cands, in_flight, self.policies)
                        req = queues[t].peek_ready(now)
                        # paged engines gate admission on page supply and
                        # the tenant's page quota BEFORE popping: a blocked
                        # tenant is eliminated from this pass (its queue
                        # order is preserved; another tenant may use the
                        # slot — work-conserving), never dropped
                        pol = self.policies[t]
                        if pol.max_pages is not None:
                            held = eng.tenant_pages(sess, tenant_of)
                            if (held.get(t, 0) + eng.pages_needed(req)
                                    > pol.max_pages):
                                cands.remove(t)
                                continue
                        if not eng.can_admit(sess, req):
                            cands.remove(t)
                            continue
                        queues[t].pop_ready(now)
                        busy0 = sess.slots.n_busy
                        now = eng.admit(sess, req, now)
                        if sess.slots.n_busy > busy0:   # took a slot (not
                            in_flight[t] += 1           # prefill-only retired)
                        admitted = True
                        break
                    if not admitted:
                        break

            # ---- one decode chunk per busy model (quota accounting lands
            # on the chunk boundary: step() syncs every retirement) ----------
            stepped = False
            for m, eng in self.engines.items():
                sess = sessions[m]
                if not sess.slots.n_busy:
                    continue
                if sess.report.n_steps >= max_steps:
                    for rec in sess.slot_rec.values():
                        in_flight[tenant_of[rec.request.rid]] -= 1
                    eng.cancel_active(sess, now)
                    capped.add(m)
                    continue
                before = dict(sess.slot_rec)
                now = eng.step(sess, now)
                for slot in set(before) - set(sess.slot_rec):
                    in_flight[tenant_of[before[slot].request.rid]] -= 1
                stepped = True

            if stepped:
                n_pass += 1
                if heartbeat is not None:
                    import time
                    heartbeat.beat(
                        n_pass,
                        last_chunk_s=time.time(),
                        engine_clock_s=now,
                        slots={m: {"busy": sessions[m].slots.n_busy,
                                   "free": sessions[m].slots.n_free}
                               for m in self.engines},
                        n_steps={m: sessions[m].report.n_steps
                                 for m in self.engines},
                        n_recals={m: sessions[m].report.n_recals
                                  for m in self.engines})
                continue
            # ---- idle: jump to the next arrival, or done -------------------
            arrivals = [queues[t].next_arrival()
                        for m in self.engines if m not in capped
                        for t in self._tenants_of[m] if len(queues[t])]
            arrivals = [a for a in arrivals if a is not None]
            if not arrivals:
                break
            nxt = min(arrivals)
            if nxt <= now and any(queued(m) for m in self.engines
                                  if m not in capped):
                # ready requests exist but no model could admit them (all
                # slots busy is handled above; this is every model capped or
                # zero-slot progress) — nothing will ever change, stop
                break
            now = max(now, nxt)

        report = ServerReport(
            model_reports={m: self.engines[m].finish(sessions[m], now)
                           for m in self.engines},
            tenant_of=tenant_of,
            policies=dict(self.policies),
            makespan_s=now)
        return report

    # -- CM_* books ----------------------------------------------------------
    def reconcile(self, report: ServerReport) -> dict[str, bool | None]:
        """model -> whether its books close exactly (None: no program).

        Two checks per programmed model: the device loop's independent
        vector count equals the per-request books, and the summed
        per-tenant CM_* ledgers equal ``program.mvm_counts()`` scaled by
        that observed count (`tenancy.reconcile_tenants`)."""
        out: dict[str, bool | None] = {}
        for m, eng in self.engines.items():
            rep = report.model_reports[m]
            counts_agree = rep.observed_vectors == rep.useful_vectors
            if eng.program is None:
                out[m] = None if counts_agree else False
                continue
            led_sum, static = reconcile_tenants(
                eng.program, rep.records, report.tenant_of,
                rep.observed_vectors)
            out[m] = counts_agree and led_sum == static
        return out


# ---------------------------------------------------------------------------
# build_server — init + co-program + wrap
# ---------------------------------------------------------------------------

def build_server(specs: Sequence[ModelSpec],
                 tenants: Sequence[TenantPolicy] | None = None, *,
                 smoke: bool = True, n_slots: int = 4, prompt_pad: int = 12,
                 max_seq: int | None = None, n_contexts: int = 1,
                 tiles_per_context: int | None = None, aimc_cfg=None,
                 seed: int = 0, eos_id: int | None = None, mesh=None,
                 cache_dtype=None, decode_chunk: int = 1,
                 page_size: int = 0, n_pages: int = 0,
                 prefix_cache: bool = False, prefill_chunk: int = 0,
                 device="cuda") -> ModelServer:
    """Initialize every registered model on ``device``, co-program the
    AIMC members against ONE shared `TilePool`, and wrap the engines in a
    `ModelServer`.

    Model i draws its weights from ``PRNGKey(seed + i)`` and its
    programming noise from ``PRNGKey(seed + 100 + i)``, as the reference
    does. ``tenants=None`` is one tenant per model (weight 1, fifo). The
    default ``aimc_cfg`` fixes the DAC scale at 0.1 (programmed output
    does not depend on the batch). ``page_size`` / ``n_pages`` /
    ``prefix_cache`` / ``prefill_chunk`` configure the paged cache on
    every transformer engine (recurrent engines take the snapshot path).
    Raises `core.program.CapacityError` when the co-programmed models
    exceed ``tiles_per_context`` together."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.core.prng import PRNGKey
    from repro_torch.core.program import MappingPlan, TilePool, program_model
    from repro_torch.models.layers import Execution
    from repro_torch.runtime.engine import (RECURRENT_MODULES,
                                            ShardedServeEngine)

    if not specs:
        raise ValueError("build_server needs at least one ModelSpec")
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate model names: {names}")
    if tenants is None:
        tenants = [TenantPolicy(name=s.name, model=s.name) for s in specs]
    cache_dtype = cache_dtype or torch.float32
    max_seq = max_seq or prompt_pad + 16
    device = torch.device(device)

    pool = None
    if any(s.exec_mode == "aimc" for s in specs):
        aimc_cfg = aimc_cfg or AimcConfig(input_scale=0.1)
        pool = TilePool(aimc_cfg, n_contexts=n_contexts,
                        tiles_per_context=tiles_per_context)

    engines: dict[str, ServeEngine] = {}
    for i, spec in enumerate(specs):
        arch = get_arch(spec.arch)
        if arch.family == "audio":
            raise ValueError(f"model {spec.name!r}: the enc-dec audio "
                             f"family decodes via launch.steps, not the "
                             f"serving engine")
        cfg = arch.smoke_cfg if smoke else arch.model_cfg
        model = arch.model_module()
        params = model.init(PRNGKey(seed + i), cfg, device=device)
        program = None
        if spec.exec_mode == "aimc":
            exe = Execution(mode="aimc", aimc=aimc_cfg,
                            compute_dtype="float32", programmed=True)
            program = program_model(params, MappingPlan(), aimc_cfg,
                                    PRNGKey(seed + 100 + i),
                                    pool=pool, label=spec.name)
            params = program.install(params)
        else:
            exe = Execution(compute_dtype="float32")
        kw = dict(n_slots=n_slots, prompt_pad=prompt_pad, max_seq=max_seq,
                  cache_dtype=cache_dtype, family=arch.family,
                  module=arch.module, program=program, eos_id=eos_id,
                  decode_chunk=decode_chunk)
        if page_size > 0:
            # only modules with a paged path take the flags; the rest of a
            # mixed registry keeps the dense cache
            rec = arch.module in RECURRENT_MODULES
            legs_ok = (arch.family != "vlm"
                       and not getattr(cfg, "is_moe", False)
                       and cache_dtype == torch.float32)
            if arch.module == "transformer":
                kw.update(page_size=page_size, n_pages=n_pages)
                if legs_ok:
                    kw.update(prefix_cache=prefix_cache,
                              prefill_chunk=prefill_chunk)
            elif rec and legs_ok and (prefix_cache or prefill_chunk):
                kw.update(page_size=page_size, n_pages=n_pages,
                          prefix_cache=prefix_cache,
                          prefill_chunk=prefill_chunk)
        if mesh is not None:
            engines[spec.name] = ShardedServeEngine(model, cfg, exe, params,
                                                    mesh=mesh, **kw)
        else:
            engines[spec.name] = ServeEngine(model, cfg, exe, params, **kw)
    return ModelServer(engines, tenants, pool=pool)
