"""Cost-model-driven analog/digital auto-placement (PyTorch port of
`repro/core/placement.py`, DESIGN.md §16).

Given a parameter tree and a crossbar budget, every candidate layer is
priced both ways through the calibrated cost model (`costmodel.evaluate`),
and the placer picks the analog set that minimizes the predicted latency
per token vector under the capacity constraint:

  * `layer_costs`     — per mapped layer: t_digital, t_analog and the tiles
    the layer packs alone. Shapes only: meta or zero-stride tensors do.
  * `plan_placement`  — candidates with positive savings in density order
    (savings per tile); prefix m is feasible iff the running max of the
    packed context maxima over prefixes 1..m fits the budget, packing by
    `tile.pack_contexts` (the `ProgramBuilder`'s packing, simulated; the
    port's packer runs in linear time).
  * capacity overflow — a `RotationPlan`: a hot prefix stays programmed
    while the leftovers rotate through the freed headroom in groups, one
    rotation state per group; the engine swaps states at decode-chunk
    boundaries and bills each swap's incoming group as CM_INITIALIZE per
    `SwapEvent`, closed exactly by `reconcile_swaps`.
  * `PlacementRoofline` — the affine predicted-vs-measured law.

Everything here runs at setup time on the host over static shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.aimc import AimcConfig
from repro_torch.core.costmodel import (CALIB, HIGH_POWER, Workload,
                                  analog_mvm_stage, digital_mvm_stage,
                                  evaluate)
from repro_torch.core.program import MappingPlan, iter_mapped_leaves
from repro_torch.core.tile import pack_contexts


# ---------------------------------------------------------------------------
# Per-layer pricing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerCost:
    """One mapped layer priced both ways (one token vector)."""

    path: str
    k: int
    n: int
    instances: int
    fold_index: int        # programming-key index (iter_mapped_leaves order)
    t_digital: float       # modeled seconds/vector on the CPU
    t_analog: float        # modeled seconds/vector on the crossbar
    tiles_alone: int       # tiles this layer packs into an empty context

    @property
    def savings(self) -> float:
        return self.t_digital - self.t_analog

    @property
    def density(self) -> float:
        """Savings per tile the layer would claim standalone — the greedy
        order's key (capacity is the scarce resource)."""
        return self.savings / max(self.tiles_alone, 1)

    @property
    def item(self) -> tuple[str, int, int, int]:
        """The `tile.pack_contexts` row for this layer."""
        return (self.path, self.k, self.n, self.instances)


def _one_layer_time(stage, cfg: AimcConfig, sys, p, coupling: str) -> float:
    w = Workload(name="layer", phases=((stage,),), pipelined=False,
                 coupling=coupling, tile_rows=cfg.tile_rows)
    return evaluate(w, sys, p).time_s


def layer_costs(params, plan: MappingPlan | None, cfg: AimcConfig,
                sys=HIGH_POWER, p=CALIB,
                coupling: str = "tight") -> tuple[LayerCost, ...]:
    """Price every plan-selected layer both ways, in tree-walk order.

    Each side is evaluated as its own one-stage workload, so per-layer
    times SUM exactly to `evaluate()` on the combined `split_workload` —
    the consistency the bench gates at ratio 1.000."""
    out = []
    for path, w, idx in iter_mapped_leaves(params, plan):
        k, n = int(w.shape[-2]), int(w.shape[-1])
        instances = 1
        for d in w.shape[:-2]:
            instances *= int(d)
        t_d = _one_layer_time(digital_mvm_stage(k, n, instances),
                              cfg, sys, p, coupling)
        t_a = _one_layer_time(analog_mvm_stage(k, n, instances),
                              cfg, sys, p, coupling)
        tiles = sum(pack_contexts([(path, k, n, instances)], 1,
                                  cfg.tile_rows, cfg.tile_cols))
        out.append(LayerCost(path=path, k=k, n=n, instances=instances,
                             fold_index=idx, t_digital=t_d, t_analog=t_a,
                             tiles_alone=tiles))
    return tuple(out)


# ---------------------------------------------------------------------------
# Rotation plan (capacity overflow)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RotationPlan:
    """Time-multiplexed placement for a model exceeding the tile budget.

    ``hot`` layers stay programmed in every state; each ``groups[i]`` is a
    cold-layer set resident only in rotation state ``i`` (hot + group).
    ``digital`` lists positive-savings layers that cannot fit even alone
    alongside nothing — permanently digital. Every state's packing fits
    ``tiles_per_context`` by construction (verified again by
    `launch.serve --placement-verify`)."""

    hot: tuple[str, ...]
    groups: tuple[tuple[str, ...], ...]
    digital: tuple[str, ...]
    n_contexts: int
    tiles_per_context: int
    swap_every: int = 1

    def __post_init__(self):
        if self.swap_every < 1:
            raise ValueError("swap_every must be >= 1")

    @property
    def all_names(self) -> tuple[str, ...]:
        """Every layer that is analog in at least one state — the ONE
        uncapped program the engine serves from (`install_subset` carves
        the per-state trees, so a layer's programmed state is identical in
        every rotation state that carries it)."""
        return self.hot + tuple(n for g in self.groups for n in g)

    @property
    def n_states(self) -> int:
        return max(1, len(self.groups))

    def states(self) -> tuple[tuple[str, ...], ...]:
        """Per rotation state, the analog-resident layer names."""
        if not self.groups:
            return (self.hot,)
        return tuple(self.hot + g for g in self.groups)

    def incoming(self, state: int) -> tuple[str, ...]:
        """Matrices reprogrammed when switching INTO ``state`` — the
        CM_INITIALIZE bill of one swap."""
        if not self.groups:
            return ()
        return self.groups[state % len(self.groups)]

    def plan(self) -> MappingPlan:
        """The UNCAPPED MappingPlan for the backing program over
        `all_names` (states together exceed the budget on purpose; the
        per-state packing is what must fit)."""
        return MappingPlan.for_names(self.all_names,
                                     n_contexts=self.n_contexts)

    def summary(self) -> str:
        return (f"RotationPlan: {len(self.hot)} hot + "
                f"{sum(len(g) for g in self.groups)} rotating in "
                f"{len(self.groups)} group(s) (+{len(self.digital)} "
                f"permanently digital), cap {self.tiles_per_context} "
                f"tiles x {self.n_contexts} context(s), swap every "
                f"{self.swap_every} chunk(s)")


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    """One rotation swap, as charged to the serve report."""

    t: float                    # serve-clock instant
    chunk: int                  # lifetime chunk counter at the swap
    state: int                  # rotation state switched INTO
    incoming: tuple[str, ...]   # matrices reprogrammed onto the shared tiles
    initialize: int             # CM_INITIALIZE device writes charged
    wall_s: float               # host wall spent swapping


def reconcile_swaps(program, report) -> bool:
    """The swap books must close exactly: every event's CM_INITIALIZE bill
    equals `reprogram_counts` recomputed from the program's shapes for the
    incoming group, and the report's total equals the per-event sum —
    `runtime.health.reconcile_recal`'s discipline for rotation."""
    events = getattr(report, "swap_events", [])
    for ev in events:
        if ev.initialize != program.reprogram_counts(ev.incoming).initialize:
            return False
    return report.swap_initialize == sum(ev.initialize for ev in events)


# ---------------------------------------------------------------------------
# The placer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlacementResult:
    """The chosen split plus everything the tests/benches gate on."""

    costs: tuple[LayerCost, ...]          # every candidate, tree-walk order
    analog: tuple[str, ...]               # resident analog paths
    digital: tuple[str, ...]              # paths served digitally
    plan: MappingPlan                     # capped plan selecting `analog`
    n_contexts: int
    tiles_per_context: int | None
    predicted_s: float                    # chosen split, seconds/vector
    predicted_digital_s: float            # all-digital baseline
    predicted_analog_fit_s: float         # longest all-analog prefix that fits
    overflow: bool                        # positive-savings layers left out
    rotation: "RotationPlan | None" = None

    def predicted_for(self, analog_paths) -> float:
        """Predicted seconds/vector for an arbitrary analog subset — the
        per-layer sum the bench cross-checks against `evaluate()` on the
        matching `split_workload`."""
        analog_paths = set(analog_paths)
        return sum(c.t_analog if c.path in analog_paths else c.t_digital
                   for c in self.costs)

    def summary(self) -> str:
        cap = (f"{self.tiles_per_context} tiles/context"
               if self.tiles_per_context is not None else "uncapped")
        line = (f"auto-placement: {len(self.analog)}/{len(self.costs)} "
                f"layers analog under {cap} x {self.n_contexts}; predicted "
                f"{self.predicted_s * 1e6:.1f}us/vector (all-digital "
                f"{self.predicted_digital_s * 1e6:.1f}us, "
                f"{self.predicted_digital_s / max(self.predicted_s, 1e-12):.2f}x)")
        if self.rotation is not None:
            line += f"; {self.rotation.summary()}"
        return line


def _packmax(costs, chosen, n_contexts: int, cfg: AimcConfig) -> int:
    """Max per-context tile count of programming ``chosen`` — packed in
    TREE-WALK order (``costs`` order), exactly as `program_model` will."""
    chosen = set(chosen)
    items = [c.item for c in costs if c.path in chosen]
    per = pack_contexts(items, n_contexts, cfg.tile_rows, cfg.tile_cols)
    return max(per) if per else 0


def _feasible_prefix_len(costs, order, budget: int, n_contexts: int,
                         cfg: AimcConfig) -> int:
    """Longest m such that the RUNNING MAX of packmax over prefixes
    1..m fits ``budget``. The running max is nondecreasing in m, so
    feasible prefix lengths are downward-closed and monotone in the
    budget — the monotonicity theorem the property tests pin."""
    h = 0
    m = 0
    for j in range(1, len(order) + 1):
        h = max(h, _packmax(costs, {c.path for c in order[:j]},
                            n_contexts, cfg))
        if h > budget:
            break
        m = j
    return m


def plan_placement(params, plan: MappingPlan | None, cfg: AimcConfig, *,
                   tiles_per_context: int | None, n_contexts: int = 1,
                   sys=HIGH_POWER, p=CALIB, coupling: str = "tight",
                   swap_every: int = 1) -> PlacementResult:
    """Search the analog/digital split under a crossbar budget.

    ``plan`` scopes the CANDIDATE set (which leaves may map at all —
    default `MappingPlan` patterns); the search then decides, per
    candidate, where it actually runs. ``tiles_per_context=None`` is an
    uncapped pool: everything with positive predicted savings goes analog.

    Overflow: when positive-savings candidates do not all fit resident, the
    result carries a `RotationPlan` — the resident prefix is shrunk until
    every rotatable leftover fits alongside it (swap headroom), leftovers
    are grouped greedily (each group + hot fits the cap), and serving
    time-multiplexes the groups, paying CM_INITIALIZE per swap."""
    base_plan = dataclasses.replace(
        plan or MappingPlan(), n_contexts=n_contexts, tiles_per_context=None)
    costs = layer_costs(params, base_plan, cfg, sys, p, coupling)
    order = sorted(costs, key=lambda c: (-c.density, c.path))
    candidates = [c for c in order if c.savings > 0]

    if tiles_per_context is None:
        m_res = len(candidates)
        m_all = len(order)
    else:
        m_res = _feasible_prefix_len(costs, candidates, tiles_per_context,
                                     n_contexts, cfg)
        m_all = _feasible_prefix_len(costs, order, tiles_per_context,
                                     n_contexts, cfg)

    resident = candidates[:m_res]
    resident_set = {c.path for c in resident}
    analog = tuple(c.path for c in costs if c.path in resident_set)
    digital = tuple(c.path for c in costs if c.path not in resident_set)
    leftovers = candidates[m_res:]

    def predicted(chosen):
        chosen = set(chosen)
        return sum(c.t_analog if c.path in chosen else c.t_digital
                   for c in costs)

    predicted_s = predicted(resident_set)
    predicted_digital = predicted(())
    predicted_fit = predicted({c.path for c in order[:m_all]})

    rotation = None
    if leftovers and tiles_per_context is not None:
        rotation = _build_rotation(costs, candidates, m_res,
                                   tiles_per_context, n_contexts, cfg,
                                   swap_every)

    result_plan = MappingPlan.for_names(
        analog, n_contexts=n_contexts, tiles_per_context=tiles_per_context)
    return PlacementResult(
        costs=costs, analog=analog, digital=digital, plan=result_plan,
        n_contexts=n_contexts, tiles_per_context=tiles_per_context,
        predicted_s=predicted_s, predicted_digital_s=predicted_digital,
        predicted_analog_fit_s=predicted_fit,
        overflow=bool(leftovers), rotation=rotation)


def _build_rotation(costs, candidates, m_res: int,
                    budget: int, n_contexts: int, cfg: AimcConfig,
                    swap_every: int) -> RotationPlan:
    """Shrink the hot prefix for swap headroom, then group the rest.

    A candidate that does not fit even alone in an empty pool can never
    rotate in — it stays permanently digital. The hot prefix backs off
    from the resident choice until EVERY rotatable non-hot candidate fits
    beside it; candidates dropped from the prefix while shrinking re-enter
    the rotation pool (they still have positive savings), keeping their
    density rank. At m=0 the pool is exactly the fits-alone set, so the
    condition holds and the loop terminates. Groups then fill greedily in
    density order, each group + hot packing within the cap."""
    def fits_alone(g) -> bool:
        return _packmax(costs, {g.path}, n_contexts, cfg) <= budget

    m = m_res
    while True:
        hot_set = {c.path for c in candidates[:m]}
        pool = [g for g in candidates[m:] if fits_alone(g)]
        if all(_packmax(costs, hot_set | {g.path}, n_contexts, cfg)
               <= budget for g in pool):
            break
        m -= 1
    hot = tuple(c.path for c in costs if c.path in hot_set)
    permanent = tuple(g.path for g in candidates[m:] if not fits_alone(g))

    groups: list[tuple[str, ...]] = []
    cur: list[str] = []
    for g in pool:
        if _packmax(costs, hot_set | set(cur) | {g.path},
                    n_contexts, cfg) <= budget:
            cur.append(g.path)
        else:
            groups.append(tuple(cur))
            cur = [g.path]
    if cur:
        groups.append(tuple(cur))

    return RotationPlan(hot=hot, groups=tuple(groups), digital=permanent,
                        n_contexts=n_contexts, tiles_per_context=budget,
                        swap_every=swap_every)


# ---------------------------------------------------------------------------
# Predicted-vs-measured calibration (the OverlapRoofline idiom)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlacementRoofline:
    """Affine calibration between modeled and measured per-layer time:

        T_measured(layer) = t_fixed_s + scale * T_modeled(layer)

    The cost model prices an in-order A53-class system, not this host, so
    the absolute scale differs — but if the model RANKS layers correctly
    (what placement decisions need), measured wallclock is affine in the
    modeled time. `fit` recovers both constants by least squares over the
    per-layer (modeled, measured) pairs; `residuals` is what the bench
    gates (|predicted - measured| / measured per layer)."""

    t_fixed_s: float
    scale: float

    @classmethod
    def fit(cls, modeled, measured) -> "PlacementRoofline":
        """Least squares over the basis [1, t_modeled]. Needs >= 2 layers;
        negative constants clamp to 0 (time is not refundable)."""
        if len(modeled) != len(measured) or len(modeled) < 2:
            raise ValueError(
                f"PlacementRoofline.fit needs >= 2 (modeled, measured) "
                f"pairs, got {len(modeled)}/{len(measured)}")
        a_mat = np.array([[1.0, t] for t in modeled])
        y = np.array(list(measured))
        (fixed, scale), *_ = np.linalg.lstsq(a_mat, y, rcond=None)
        return cls(t_fixed_s=max(float(fixed), 0.0),
                   scale=max(float(scale), 0.0))

    def predict_s(self, modeled: float) -> float:
        return self.t_fixed_s + self.scale * modeled

    def residuals(self, modeled, measured):
        """Per-layer relative |predicted - measured| / measured."""
        return [abs(self.predict_s(tm) - tw) / tw
                for tm, tw in zip(modeled, measured)]
