"""Online health monitoring and hot recalibration for drift-aware serving
(PyTorch port of `repro/runtime/health.py`).

PCM crossbars do not stay programmed: conductances decay along a power law
(`core.noise.NoiseModel.drift_gain_at`), cores vary, and whole cores die
mid-trace. `ServeEngine._resilience_tick` drives this module at decode
chunk boundaries:

  1. **Drift refresh** — `HealthMonitor.drifted_entries(t_now)` re-derives
     every installed state from the program's fresh codes with the current
     power-law gain (`AimcLinearState.with_gain`): same shapes, so the
     engine's closures see nothing new.
  2. **Probe** — `probe(entries, t_now)` pushes fixed probe vectors through
     the LIVE states and compares them with the fresh program's outputs,
     captured at build time through the same path. The reference probes
     with its plain version (``impl="ref"``); here references and probes
     both run the crossbar kernel on the states' device (K2 for a single
     matrix, one launch of K2's expert entry for an ``[L]`` layer stack),
     so a fresh or repaired program reads exactly 0.0. A pure drift gain g
     reads as 1 - g, a dead crossbar as 1.0.
  3. **Recalibrate** — past `HealthPolicy.threshold`, or on a core marked
     dead by the chaos harness, `recalibrate(cores, t_now)` reprograms the
     failing cores' matrices from the raw weights under their original
     programming keys (`Recalibrator`), bit-equal to the fresh program.
     Dead cores are first drained onto survivors
     (`AimcProgram.remap_context`). The CM_INITIALIZE bill goes to the
     serve report, never silently.

Invariants (held against the reference by tests/test_torch_resilience.py):
probe error 0.0 on a fresh program; reprogramming under the original key
is bit-exact; recalibration charges exactly
``program.reprogram_counts(names)``; MVM-count reconciliation is invariant
under remap.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import isa, prng
from repro_torch.core import noise as noise_lib
from repro_torch.core.aimc import (AimcConfig, AimcLinearState, aimc_apply,
                                   aimc_apply_experts, program_stacked)
from repro_torch.core.program import (AimcProgram, MappingPlan,
                                      iter_mapped_leaves)


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """When to probe and when to repair."""

    threshold: float = 0.05     # per-core relative probe error: recal
    probe_batch: int = 2        # probe vectors per matrix
    probe_interval_s: float = 0.0  # min seconds between probes; 0 = every tick
    seed: int = 0               # probe vectors + per-core drift-nu variation


@dataclasses.dataclass(frozen=True)
class RecalEvent:
    """One hot recalibration, as charged to the serve report."""

    t: float                    # serve-clock instant
    reason: str                 # "drift" | "dead_core" | "fault"
    cores: tuple[int, ...]      # failing cores repaired
    names: tuple[str, ...]      # matrices reprogrammed
    initialize: int             # CM_INITIALIZE device writes charged
    wall_s: float               # host+device wall spent repairing


@dataclasses.dataclass(frozen=True)
class ProbeSample:
    t: float
    errors: dict[int, float]    # core -> max relative probe error


def apply_state(st: AimcLinearState, x: torch.Tensor,
                cfg: AimcConfig) -> torch.Tensor:
    """Probe MVM x [B, K] through a programmed state: one K2 launch for a
    single matrix; a stack (layers, or layers x experts) flattened to
    ``[I]`` instances runs as ONE expert-entry launch with x broadcast to
    every instance -> [I, B, N] (the reference's `vmap` of `aimc_apply`)."""
    if not st.stack_shape:
        return aimc_apply(st, x, cfg)
    flat = AimcLinearState(w_q=st.w_q.reshape((-1,) + st.w_q.shape[-3:]),
                           s_w=st.s_w.reshape((-1,) + st.s_w.shape[-2:]),
                           k=st.k, n=st.n)
    return aimc_apply_experts(flat, x.expand(flat.instances, *x.shape), cfg)


def rel_err(y: torch.Tensor, y_ref: torch.Tensor) -> float:
    """||y - y_ref|| / ||y_ref|| (0.0 exactly when the bits agree)."""
    num = float(torch.linalg.vector_norm((y - y_ref).reshape(-1)))
    den = float(torch.linalg.vector_norm(y_ref.reshape(-1)))
    return num / (den + 1e-12)


class Recalibrator:
    """Raw weights + programming keys for bit-exact hot reprogramming.

    After `install` the raw weights leave the parameter tree, so a repair
    needs them captured up front. This replays `program_model`'s walk
    (`iter_mapped_leaves`) over the RAW tree: matrix i gets
    ``fold_in(key, i)``, the key it was programmed under, so
    `fresh_state(name)` reproduces the program's state bit for bit. The
    raw tensors are held, not copied."""

    def __init__(self, program: AimcProgram, params_raw,
                 plan: MappingPlan | None, key: torch.Tensor | None):
        self.cfg = program.cfg
        self.refs: dict[str, tuple[torch.Tensor, torch.Tensor | None]] = {}
        for pkey, w, idx in iter_mapped_leaves(params_raw, plan):
            if pkey in program:
                self.refs[pkey] = (w, prng.fold_in(key, idx)
                                   if key is not None else None)
        missing = set(program.names) - set(self.refs)
        if missing:
            raise ValueError(
                f"Recalibrator: raw params/plan do not cover program "
                f"matrices {sorted(missing)} (was the program built by "
                f"program_model with this plan?)")

    def fresh_state(self, name: str) -> AimcLinearState:
        w, key = self.refs[name]
        return program_stacked(w, self.cfg, key)

    def reference_weight(self, name: str) -> torch.Tensor:
        return self.refs[name][0]


class HealthMonitor:
    """Per-core online error tracking and the hot-recalibration authority.

    Owns the CURRENT program (updated on every repair; the engine mirrors
    it), a `Recalibrator`, and the drift model that ages the installed
    states. Build it with `build_health` from the raw params and plan."""

    def __init__(self, program: AimcProgram, recal: Recalibrator,
                 policy: HealthPolicy | None = None,
                 noise: noise_lib.NoiseModel | None = None):
        self.program = program
        self.recal = recal
        self.policy = policy or HealthPolicy()
        self.noise = program.cfg.noise if noise is None else noise
        self.dead: set[int] = set()
        self.history: list[ProbeSample] = []
        self.events: list[RecalEvent] = []
        self._last_probe_t: float | None = None
        self._applied_gains: dict[str, float] | None = None
        # probe kit: fixed vectors, the fresh program's outputs on them, and
        # each matrix's quantization floor (fresh analog vs float matmul)
        key = prng.PRNGKey(self.policy.seed)
        self._probes: dict[str, torch.Tensor] = {}
        self._refs: dict[str, torch.Tensor] = {}
        self.quant_floor: dict[str, float] = {}
        for i, (name, st) in enumerate(zip(program.names, program.states)):
            x = prng.normal(prng.fold_in(key, i),
                            (self.policy.probe_batch, st.k),
                            device=st.w_q.device)
            y_fresh = apply_state(st, x, program.cfg)
            self._probes[name] = x
            self._refs[name] = y_fresh
            w = recal.reference_weight(name).to(torch.float32)
            self.quant_floor[name] = rel_err(y_fresh, torch.matmul(x, w))

    # -- drift --------------------------------------------------------------
    @property
    def drift_active(self) -> bool:
        return self.noise.enabled and self.noise.drift_nu != 0.0

    def drifted_entries(self, t_now: float) -> dict[str, AimcLinearState]:
        """Decayed views of the current program at ``t_now``; {} when the
        gains have not moved since the last application. With
        ``drift_compensate`` each gain is multiplied by the age-based
        dequant correction (nominal exponent: the compensator cannot see
        per-core variation)."""
        if not self.drift_active:
            return {}
        gains = self.program.drift_gains(t_now, self.noise, self.policy.seed)
        if self.noise.drift_compensate:
            ages = self.program.ages(t_now)
            gains = {n: g * self.noise.compensation_gain_at(ages[n])
                     for n, g in gains.items()}
        if gains == self._applied_gains:
            return {}
        self._applied_gains = gains
        return self.program.gained_entries(gains)

    # -- probes -------------------------------------------------------------
    def due(self, t_now: float) -> bool:
        if self._last_probe_t is None or self.policy.probe_interval_s <= 0.0:
            return True
        return t_now - self._last_probe_t >= self.policy.probe_interval_s

    def probe(self, entries: dict[str, AimcLinearState],
              t_now: float) -> ProbeSample:
        """Per-core output error of the LIVE states (what serving traffic
        sees: drifted, corrupted or repaired) against the fresh program."""
        self._last_probe_t = t_now
        sample = ProbeSample(t=t_now, errors=self.measure(entries))
        self.history.append(sample)
        return sample

    def measure(self, entries: dict[str, AimcLinearState]) -> dict[int, float]:
        """core -> max relative probe error of ``entries`` (the matrices
        given; the others are skipped), without recording a sample."""
        errors: dict[int, float] = {}
        for name, ctx in zip(self.program.names, self.program.contexts):
            st = entries.get(name)
            if st is None:
                continue
            err = rel_err(apply_state(st, self._probes[name],
                                      self.program.cfg), self._refs[name])
            errors[ctx] = max(errors.get(ctx, 0.0), err)
        return errors

    def failing_cores(self, sample: ProbeSample) -> tuple[int, ...]:
        over = {c for c, e in sample.errors.items()
                if e > self.policy.threshold}
        return tuple(sorted(over | self.dead))

    # -- failure marking (the chaos harness's entry point) -------------------
    def mark_dead(self, core: int):
        self.dead.add(core)

    # -- repair --------------------------------------------------------------
    def recalibrate(self, cores, t_now: float):
        """Hot-reprogram every matrix on ``cores``; dead cores drain first.

        Returns ``(entries, names, cm)``: the freshly programmed states to
        `install_updates`, the matrices repaired, and the CM_INITIALIZE
        bill. Updates `self.program` (remapped contexts, reset ages); the
        caller mirrors it and charges ``cm``."""
        cores = set(cores)
        prog = self.program
        names = tuple(n for n, c in zip(prog.names, prog.contexts)
                      if c in cores)
        if not names:
            self.dead -= cores
            return {}, (), isa.CmCounts()
        for c in sorted(cores & self.dead):
            prog = prog.remap_context(c)
        entries = {n: self.recal.fresh_state(n) for n in names}
        cm = prog.reprogram_counts(names)
        self.program = prog.reprogrammed(entries, t_now)
        self.dead -= cores
        self._applied_gains = None  # reprogrammed ages restart the decay law
        return entries, names, cm


def build_health(program: AimcProgram, params_raw,
                 plan: MappingPlan | None, key: torch.Tensor | None,
                 policy: HealthPolicy | None = None,
                 noise: noise_lib.NoiseModel | None = None) -> HealthMonitor:
    """The front door: capture references off the RAW params (the tree
    before `install`) and stand up the monitor."""
    return HealthMonitor(program, Recalibrator(program, params_raw, plan, key),
                         policy=policy, noise=noise)


def reconcile_recal(program: AimcProgram, report) -> bool:
    """The recal books close exactly: every event's CM_INITIALIZE bill
    equals `reprogram_counts` recomputed from the program's shapes, and the
    report's total charge equals the per-event sum."""
    events = getattr(report, "recal_events", [])
    for ev in events:
        if ev.initialize != program.reprogram_counts(ev.names).initialize:
            return False
    return report.recal_initialize == sum(ev.initialize for ev in events)
