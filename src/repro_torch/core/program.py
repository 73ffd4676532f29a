"""Program-once / apply-many: the model-level AIMC programming API
(PyTorch port of `repro/core/program.py`).

  * ``MappingPlan``    — which projections map to crossbars (name/path
    regexes, predicate, minimum size) and over how many contexts (cores).
  * ``program_model``  — walks a parameter tree (nested dicts of tensors),
    programs every selected weight (layer stacks included) and returns an
    ``AimcProgram``.
  * ``AimcProgram``    — path -> `AimcLinearState` registry.
    ``program.install(params)`` substitutes the states into the tree, after
    which every ``models.layers.linear`` call runs apply-only on the
    crossbar kernel. It carries the static CM_* accounting.
  * ``ProgramBuilder`` — the incremental surface underneath.

The tree walk visits leaves in JAX's flatten order (dict keys sorted), so
``names`` and the per-matrix fold indices equal the reference's; an int8
``{"q", "s"}`` pair is one leaf, programmed from its dequantized codes.

The program also keeps a program-age clock (``t_programmed``, one serve
clock stamp per matrix) with its drift views, hot reprogramming
(``reprogrammed``, ``install_updates``) and the drain of a dead context
onto the survivors (``remap_context``): the substrate of
`runtime.health`.

`TilePool` is one crossbar budget several co-programmed models draw from
(the multi-tenant server's capacity authority): ``program_model(...,
pool=, label=)`` packs into the pool's shared allocators under
label-prefixed matrix ids. ``install_subset`` installs only some of a
program's matrices (the rest stay digital): the substrate of
`core.placement`'s rotation states.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable

import torch

from repro_torch.core import isa, prng
from repro_torch.core import noise as noise_lib
from repro_torch.core.aimc import (AimcConfig, AimcLinearState,
                                   program_linear, program_stacked)
from repro_torch.core.tile import TileAllocator, TileMap


class CapacityError(RuntimeError):
    """A MappingPlan asked for more crossbar tiles than a context provides."""


class TilePool:
    """A shared multi-context crossbar budget several programs draw from.

    Every ``program_model(..., pool=..., label=...)`` call packs its
    matrices into THE SAME per-context `TileAllocator`s, so capacity is
    checked against everything programmed so far: two models that fit
    alone but not together raise `CapacityError` instead of overlapping
    tiles. Matrix ids are label-prefixed (``label/path``); re-using a label
    raises. A failed co-program leaves its partial placements charged to
    the pool (shelf packing has no rollback): rebuild the pool."""

    def __init__(self, cfg: AimcConfig, n_contexts: int = 1,
                 tiles_per_context: int | None = None):
        if n_contexts < 1:
            raise ValueError("n_contexts must be >= 1")
        self.cfg = cfg
        self.tiles_per_context = tiles_per_context
        self.allocators = [TileAllocator(cfg.tile_rows, cfg.tile_cols)
                           for _ in range(n_contexts)]
        self.labels: list[str] = []            # programs resident, in order

    @property
    def n_contexts(self) -> int:
        return len(self.allocators)

    @property
    def n_tiles(self) -> int:
        """Physical tiles opened across all contexts so far."""
        return sum(a.n_tiles for a in self.allocators)

    @property
    def capacity_tiles(self) -> int | None:
        return (None if self.tiles_per_context is None
                else self.tiles_per_context * self.n_contexts)

    @property
    def utilization(self) -> float:
        """Used crossbar cells / capacity cells (opened tiles if uncapped)."""
        used = sum(p.rows * p.cols for a in self.allocators
                   for p in a.placements)
        tiles = self.capacity_tiles or self.n_tiles
        total = tiles * self.cfg.tile_rows * self.cfg.tile_cols
        return used / total if total else 0.0

    def placements(self):
        """Every placement across the pool (for overlap/ownership audits)."""
        return tuple(p for a in self.allocators for p in a.placements)

    def claim(self, label: str):
        if label in self.labels:
            raise ValueError(f"program label {label!r} already resident in "
                             f"the pool (labels: {self.labels})")
        self.labels.append(label)

    def summary(self) -> str:
        cap = (f"/{self.capacity_tiles}" if self.capacity_tiles is not None
               else "")
        return (f"TilePool: {len(self.labels)} program(s) "
                f"({', '.join(self.labels) or 'none'}) on {self.n_tiles}"
                f"{cap} tiles across {self.n_contexts} context(s), "
                f"utilization {self.utilization:.0%}")


# Stationary-projection naming across the model zoo (the reference's
# DESIGN.md §4 applicability boundary: embeddings, the vocab matmul, norms,
# biases and gains stay digital; the MoE router is excluded explicitly).
DEFAULT_INCLUDE = (r"w[qkvo]", r"w_\w+", r"we_\w+", r"wd_\w+", r"c[qkvo]")
DEFAULT_EXCLUDE = (r"router", r"embed", r"unembed", r"conv_\w+", r"lam",
                   r"r_zifo", r"b_\w+")


@dataclasses.dataclass(frozen=True)
class MappingPlan:
    """Declarative crossbar mapping policy. ``include``/``exclude`` regexes
    full-match the leaf name, or the whole ``/``-joined path when the
    pattern contains a ``/``; ``predicate(path, shape)`` has the final
    word. ``n_contexts`` spreads matrices over per-core tile sets,
    least-loaded first; ``tiles_per_context`` caps each."""

    include: tuple[str, ...] = DEFAULT_INCLUDE
    exclude: tuple[str, ...] = DEFAULT_EXCLUDE
    predicate: Callable[[str, tuple[int, ...]], bool] | None = None
    min_features: int = 1
    n_contexts: int = 1
    tiles_per_context: int | None = None

    def __post_init__(self):
        if self.n_contexts < 1:
            raise ValueError("n_contexts must be >= 1")

    @staticmethod
    def for_names(names, *, n_contexts: int = 1,
                  tiles_per_context: int | None = None) -> "MappingPlan":
        """A plan selecting exactly the given tree paths (what
        `core.placement` emits): each path is an escaped include pattern
        full-matched against the whole path (a slash-free top-level path
        gets an optional-slash prefix so it is still matched as a path);
        nothing is excluded."""
        pats = tuple(re.escape(p) if "/" in p else "/?" + re.escape(p)
                     for p in names)
        return MappingPlan(include=pats, exclude=(), n_contexts=n_contexts,
                           tiles_per_context=tiles_per_context)

    @staticmethod
    def _matches(patterns, path: str, name: str) -> bool:
        return any(re.fullmatch(pat, path if "/" in pat else name)
                   for pat in patterns)

    def selects(self, path: str, shape: tuple[int, ...]) -> bool:
        """Should the float leaf at ``path`` (full stacked shape) be mapped?"""
        if len(shape) < 2:
            return False
        name = path.rsplit("/", 1)[-1]
        if not self._matches(self.include, path, name):
            return False
        if self._matches(self.exclude, path, name):
            return False
        if min(shape[-2], shape[-1]) < self.min_features:
            return False
        return self.predicate is None or bool(self.predicate(path, shape))


class ProgramBuilder:
    """Programs matrices one by one, packing tiles per context
    (least-loaded first; ``tiles_per_context`` is a hard capacity check).
    With ``pool`` (a `TilePool`) it packs into the pool's shared
    allocators under ``label`` (the pool's cap supersedes the builder's):
    allocator ids are ``label/name`` and the built program's tile maps
    hold only this program's placements."""

    def __init__(self, cfg: AimcConfig, n_contexts: int = 1,
                 tiles_per_context: int | None = None,
                 pool: TilePool | None = None, label: str = ""):
        self.cfg = cfg
        self.pool = pool
        self.label = label
        if pool is not None:
            if (pool.cfg.tile_rows, pool.cfg.tile_cols) != (cfg.tile_rows,
                                                            cfg.tile_cols):
                raise ValueError(
                    f"pool tiles {pool.cfg.tile_rows}x{pool.cfg.tile_cols} "
                    f"!= program tiles {cfg.tile_rows}x{cfg.tile_cols}")
            pool.claim(label or f"program{len(pool.labels)}")
            self.label = self.label or pool.labels[-1]
            self.tiles_per_context = pool.tiles_per_context
            self._allocs = pool.allocators
        else:
            self.tiles_per_context = tiles_per_context
            self._allocs = [TileAllocator(cfg.tile_rows, cfg.tile_cols)
                            for _ in range(n_contexts)]
        self._entries: dict[str, AimcLinearState] = {}
        self._context_of: dict[str, int] = {}

    def _matrix_id(self, name: str) -> str:
        """The allocator-facing id: label-prefixed when pooled."""
        return f"{self.label}/{name}" if self.pool is not None else name

    def _place(self, name: str, desc: str, place) -> int:
        """Run ``place(alloc)`` on the least-loaded context, then check its
        capacity: one placement policy for matrices and gate groups."""
        ctx = min(range(len(self._allocs)),
                  key=lambda i: self._allocs[i].n_tiles)
        alloc = self._allocs[ctx]
        place(alloc)
        if (self.tiles_per_context is not None
                and alloc.n_tiles > self.tiles_per_context):
            resident = (f" (co-resident programs: "
                        f"{', '.join(self.pool.labels)})"
                        if self.pool is not None and self.pool.labels else "")
            raise CapacityError(
                f"mapping {desc} overflows context {ctx}: {alloc.n_tiles} "
                f"tiles > cap {self.tiles_per_context}" + resident)
        self._context_of[name] = ctx
        return ctx

    def _allocate(self, name: str, k: int, n: int, instances: int) -> int:
        mid = self._matrix_id(name)

        def place(alloc):
            for i in range(instances):
                alloc.map_matrix(mid if instances == 1 else f"{mid}[{i}]",
                                 k, n)
        return self._place(name, f"{name!r} ({instances}x[{k}x{n}])", place)

    def add(self, name: str, w: torch.Tensor,
            key: torch.Tensor | None = None) -> AimcLinearState:
        """Program one (possibly stacked [..., K, N]) weight matrix."""
        if name in self._entries:
            raise ValueError(f"matrix {name!r} already mapped")
        if w.dim() < 2:
            raise ValueError(f"matrix {name!r} must be at least 2-D")
        instances = 1
        for d in w.shape[:-2]:
            instances *= d
        self._allocate(name, w.shape[-2], w.shape[-1], instances)
        state = program_stacked(w, self.cfg, key)
        self._entries[name] = state
        return state

    def add_gates(self, name: str, gates, key: torch.Tensor | None = None
                  ) -> AimcLinearState:
        """Place same-height gate matrices side by side: one queue and one
        CM_PROCESS serve all of them (the paper's LSTM trick, §VIII-D)."""
        if name in self._entries:
            raise ValueError(f"matrix {name!r} already mapped")
        rows = gates[0].shape[0]
        if any(g.shape[0] != rows for g in gates):
            raise ValueError("gate matrices must share in_features")
        cols = gates[0].shape[1]
        mid = self._matrix_id(name)
        self._place(
            name, f"gates {name!r} ({len(gates)}x[{rows}x{cols}])",
            lambda alloc: alloc.map_side_by_side(
                [f"{mid}.g{i}" for i in range(len(gates))], rows, cols))
        state = program_linear(torch.cat(list(gates), dim=1), self.cfg, key)
        self._entries[name] = state
        return state

    def _own_tile_maps(self) -> tuple[TileMap, ...]:
        """Per-context tile maps restricted to THIS program's placements
        (a pooled builder shares its allocators with co-resident
        programs), counting only the tiles this program touches."""
        prefix = f"{self.label}/"
        maps = []
        for alloc in self._allocs:
            own = tuple(p for p in alloc.placements
                        if p.matrix_id.startswith(prefix))
            maps.append(TileMap(
                tile_rows=self.cfg.tile_rows, tile_cols=self.cfg.tile_cols,
                placements=own, n_tiles=len({p.tile_id for p in own})))
        return tuple(maps)

    def build(self) -> "AimcProgram":
        names = tuple(sorted(self._entries))
        tile_maps = (self._own_tile_maps() if self.pool is not None
                     else tuple(a.finalize() for a in self._allocs))
        return AimcProgram(
            states=tuple(self._entries[n] for n in names), names=names,
            cfg=self.cfg, contexts=tuple(self._context_of[n] for n in names),
            tile_maps=tile_maps)


class AimcProgram:
    """Path -> programmed-state registry with its static CM_* accounting.
    ``t_programmed`` is each matrix's programming instant on the serve
    clock (seconds; all 0.0 for a fresh build): hot reprogramming stamps
    the recal instant, which restarts that matrix's drift law."""

    def __init__(self, states, names, cfg: AimcConfig, contexts, tile_maps,
                 t_programmed=None):
        self.states = tuple(states)
        self.names = tuple(names)
        self.cfg = cfg
        self.contexts = tuple(contexts)
        self.tile_maps: tuple[TileMap, ...] = tuple(tile_maps)
        self.t_programmed = (tuple(0.0 for _ in self.names)
                             if t_programmed is None else tuple(t_programmed))
        if len(self.t_programmed) != len(self.names):
            raise ValueError("t_programmed must have one entry per matrix")

    @property
    def entries(self) -> dict[str, AimcLinearState]:
        return dict(zip(self.names, self.states))

    def __contains__(self, path: str) -> bool:
        return path in self.names

    def __getitem__(self, path: str) -> AimcLinearState:
        try:
            return self.states[self.names.index(path)]
        except ValueError:
            raise KeyError(f"matrix {path!r} was never mapped") from None

    def __len__(self) -> int:
        return len(self.names)

    def install(self, params):
        """A new tree with every mapped leaf replaced by its programmed
        state; everything else is passed through (the same tensors). Drop
        the raw tree afterwards and its float weights are freed."""
        return self.install_subset(params, self.names)

    def install_shape(self, params_shape):
        """`install` over a tree of shapes (``meta`` tensors): each mapped
        leaf becomes a state of ``meta`` tensors shaped like its codes and
        scales (the step builders' abstract inputs; nothing is allocated)."""
        def meta(t):
            return torch.empty(t.shape, dtype=t.dtype, device="meta")

        entries = {n: AimcLinearState(w_q=meta(st.w_q), s_w=meta(st.s_w),
                                      k=st.k, n=st.n)
                   for n, st in zip(self.names, self.states)}
        return _map_leaves(params_shape,
                           lambda path, leaf: entries.get(path, leaf))

    def install_subset(self, params, names):
        """`install` restricted to ``names``: only those matrices' states
        replace their raw leaves, every other mapped weight stays digital.
        The rotation substrate (`core.placement`): one program holds every
        layer that is ever analog, and each rotation state installs its
        resident names, so a layer computes alike in every state that
        carries it. Unknown names raise (a skipped name would serve digital
        while the swap books bill analog reprogramming)."""
        names = set(names)
        unknown = names - set(self.names)
        if unknown:
            raise KeyError(f"install_subset: unmapped matrices "
                           f"{sorted(unknown)}")
        entries = {n: st for n, st in zip(self.names, self.states)
                   if n in names}

        def put(path, leaf):
            if isinstance(leaf, AimcLinearState):
                return leaf           # already installed: left as it is
            return entries.get(path, leaf)

        return _map_leaves(params, put)

    def install_updates(self, params, entries: dict[str, AimcLinearState]):
        """Substitute refreshed states (drift views, corruptions, repairs)
        into an already-installed tree, by their original path. Every
        update has the shapes of what it replaces. An entry whose path
        holds no installed state raises: a dropped update would serve stale
        states while the books charge for fresh ones."""
        unused = set(entries)

        def swap(path, leaf):
            if isinstance(leaf, AimcLinearState) and path in entries:
                unused.discard(path)
                return entries[path]
            return leaf

        out = _map_leaves(params, swap)
        if unused:
            raise KeyError(f"install_updates: no installed state at "
                           f"{sorted(unused)}")
        return out

    # -- program-age clock + drift views (runtime.health's substrate) -------
    def ages(self, t_now: float) -> dict[str, float]:
        """Seconds since each matrix was (re)programmed, on the serve clock."""
        return {n: t_now - t0 for n, t0 in zip(self.names, self.t_programmed)}

    def drift_gains(self, t_now: float,
                    nm: noise_lib.NoiseModel | None = None,
                    seed: int = 0) -> dict[str, float]:
        """Per-matrix conductance decay gain at serve time ``t_now``: the
        power law off each matrix's own program age, with the exponent
        drawn per core (`NoiseModel.per_core_nu`)."""
        nm = self.cfg.noise if nm is None else nm
        return {name: nm.drift_gain_at(t_now - t0, nm.per_core_nu(ctx, seed))
                for name, t0, ctx in zip(self.names, self.t_programmed,
                                         self.contexts)}

    def aged_entries(self, t_now: float,
                     nm: noise_lib.NoiseModel | None = None,
                     seed: int = 0) -> dict[str, AimcLinearState]:
        """Drift-decayed views of the states at ``t_now`` (`with_gain`:
        codes untouched), for `install_updates`; empty when nothing has
        drifted."""
        return self.gained_entries(self.drift_gains(t_now, nm, seed))

    def gained_entries(self, gains: dict[str, float]
                       ) -> dict[str, AimcLinearState]:
        """`with_gain` views of every state under its gain in ``gains``
        (name -> gain); empty when every gain is 1.0."""
        if all(g == 1.0 for g in gains.values()):
            return {}
        return {n: st.with_gain(gains[n])
                for n, st in zip(self.names, self.states)}

    def reprogrammed(self, entries: dict[str, AimcLinearState],
                     t_now: float) -> "AimcProgram":
        """Hot reprogram: freshly programmed states for ``entries``, their
        program age stamped ``t_now``. The CM_INITIALIZE bill is the
        caller's to charge (`runtime.health.Recalibrator`)."""
        unknown = set(entries) - set(self.names)
        if unknown:
            raise KeyError(
                f"reprogrammed: unmapped matrices {sorted(unknown)}")
        states = tuple(entries.get(n, st)
                       for n, st in zip(self.names, self.states))
        ages = tuple(t_now if n in entries else t0
                     for n, t0 in zip(self.names, self.t_programmed))
        return AimcProgram(states, self.names, self.cfg, self.contexts,
                           self.tile_maps, t_programmed=ages)

    def remap_context(self, dead: int) -> "AimcProgram":
        """Survivor placement after losing context (core) ``dead``: every
        matrix on it is packed onto the least-loaded surviving context on
        fresh spare tiles appended after that context's own (the dead
        crossbars are retired, not reused), and the dead context's tile map
        empties. States are unchanged (the caller reprograms the moved
        matrices); MVM counts are shape-only, so the ledgers are invariant.
        Packing runs the port's `TileAllocator`, which places like the
        reference's in linear time."""
        n_ctx = len(self.tile_maps)
        if not 0 <= dead < n_ctx:
            raise ValueError(f"context {dead} out of range 0..{n_ctx - 1}")
        if n_ctx < 2:
            raise CapacityError(
                "remap_context: no surviving context to drain onto")
        moved = [i for i, c in enumerate(self.contexts) if c == dead]
        if not moved:
            return self
        survivors = [c for c in range(n_ctx) if c != dead]
        extra = {c: TileAllocator(self.cfg.tile_rows, self.cfg.tile_cols)
                 for c in survivors}
        contexts = list(self.contexts)
        for i in moved:
            st = self.states[i]
            ctx = min(survivors, key=lambda c: (self.tile_maps[c].n_tiles
                                                + extra[c].n_tiles))
            for j in range(st.instances):
                extra[ctx].map_matrix(self.names[i] if st.instances == 1
                                      else f"{self.names[i]}[{j}]",
                                      st.k, st.n)
            contexts[i] = ctx
        tile_maps = []
        for c, tm in enumerate(self.tile_maps):
            if c == dead:
                tile_maps.append(dataclasses.replace(tm, placements=(),
                                                     n_tiles=0))
            elif c in extra and extra[c].n_tiles:
                new = extra[c].finalize()
                shifted = tuple(dataclasses.replace(
                    p, tile_id=p.tile_id + tm.n_tiles) for p in new.placements)
                tile_maps.append(dataclasses.replace(
                    tm, placements=tm.placements + shifted,
                    n_tiles=tm.n_tiles + new.n_tiles))
            else:
                tile_maps.append(tm)
        return AimcProgram(self.states, self.names, self.cfg, tuple(contexts),
                           tuple(tile_maps), t_programmed=self.t_programmed)

    def reprogram_counts(self, names) -> isa.CmCounts:
        """CM_INITIALIZE for reprogramming just ``names``: what a hot
        recalibration charges on top of `initialize_counts`."""
        names = set(names)
        return isa.total(
            isa.initialize_counts(st.k, st.n).scaled(st.instances)
            for n, st in zip(self.names, self.states) if n in names)

    # -- CM_* accounting (static: shapes fully determine the counts) --------
    def initialize_counts(self) -> isa.CmCounts:
        """CM_INITIALIZE for the whole program, paid once per session."""
        return isa.total(
            isa.initialize_counts(st.k, st.n).scaled(st.instances)
            for st in self.states)

    def mvm_counts(self, times: int = 1) -> isa.CmCounts:
        """Queue/process/dequeue counts for ``times`` token vectors pushed
        through the whole program."""
        return isa.total(
            isa.mvm_counts(st.k, st.n, self.cfg.tile_rows).scaled(st.instances)
            for st in self.states).scaled(times)

    # -- placement stats ----------------------------------------------------
    @property
    def n_matrices(self) -> int:
        return sum(st.instances for st in self.states)

    @property
    def n_tiles(self) -> int:
        return sum(tm.n_tiles for tm in self.tile_maps)

    @property
    def utilization(self) -> float:
        used = sum(p.rows * p.cols for tm in self.tile_maps
                   for p in tm.placements)
        total = self.n_tiles * self.cfg.tile_rows * self.cfg.tile_cols
        return used / total if total else 0.0

    def summary(self) -> str:
        init = self.initialize_counts()
        per_fwd = self.mvm_counts()
        return (f"AimcProgram: {len(self.names)} weights "
                f"({self.n_matrices} crossbar tenants) on {self.n_tiles} "
                f"tiles across {len(self.tile_maps)} context(s), "
                f"utilization {self.utilization:.0%}; "
                f"CM_INITIALIZE {init.initialize} (once), per token vector "
                f"queue/process/dequeue {per_fwd.queue}/{per_fwd.process}/"
                f"{per_fwd.dequeue}")

    def __repr__(self) -> str:
        return f"<{self.summary()}>"


def program_model(params, plan: MappingPlan | None, cfg: AimcConfig,
                  key: torch.Tensor | None = None, *,
                  pool: TilePool | None = None,
                  label: str = "") -> AimcProgram:
    """CM_INITIALIZE an entire model: program every plan-selected weight.
    Matrix i draws its programming noise from ``fold_in(key, i)``, i its
    fold index, as the reference does; ``key=None`` (or a disabled noise
    model) programs noise-free. Pair with ``program.install(params)``.
    ``pool`` co-programs the model into a shared `TilePool` under
    ``label``: the pool's contexts and cap supersede the plan's."""
    plan = plan or MappingPlan()
    builder = ProgramBuilder(cfg, n_contexts=plan.n_contexts,
                             tiles_per_context=plan.tiles_per_context,
                             pool=pool, label=label)
    for pkey, w, idx in iter_mapped_leaves(params, plan):
        builder.add(pkey, w,
                    prng.fold_in(key, idx) if key is not None else None)
    return builder.build()


def _is_quantized_leaf(x) -> bool:
    """The int8 serving format {"q": codes, "s": scales} is one leaf."""
    return isinstance(x, dict) and "q" in x and "s" in x


def _flatten(params, path=""):
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted, an int8
    {"q", "s"} pair one leaf."""
    if isinstance(params, dict) and not _is_quantized_leaf(params):
        for k in sorted(params):
            yield from _flatten(params[k], f"{path}/{k}" if path else str(k))
    else:
        yield path, params


def _map_leaves(params, fn, path=""):
    """A new tree with ``fn(path, leaf)`` at every leaf (int8 pairs and
    programmed states are leaves); the dicts' own key order is kept."""
    if isinstance(params, dict) and not _is_quantized_leaf(params):
        return {k: _map_leaves(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in params.items()}
    return fn(path, params)


def _as_matrix(leaf):
    """A float matrix view of a leaf (int8 codes dequantized in f32), or
    None when the leaf is not a weight."""
    if _is_quantized_leaf(leaf):
        return leaf["q"].to(torch.float32) * leaf["s"].to(torch.float32)
    if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2:
        return None
    return leaf if leaf.is_floating_point() else None


def installed_entries(params) -> dict[str, AimcLinearState]:
    """path -> installed state of an installed tree: the live states
    serving traffic (drifted, corrupted or repaired), what
    `runtime.health.HealthMonitor.probe` measures."""
    return {path: leaf for path, leaf in _flatten(params)
            if isinstance(leaf, AimcLinearState)}


def iter_mapped_leaves(params, plan: MappingPlan | None):
    """Yield ``(path, weight, fold_index)`` for every plan-selected float
    leaf of ndim >= 2, in the order `program_model` programs them. This is
    the key contract: matrix i is programmed under ``fold_in(key, i)``, so
    `runtime.health.Recalibrator` replays this walk over the raw tree to
    reprogram a matrix bit for bit."""
    plan = plan or MappingPlan()
    idx = 0
    for pkey, leaf in _flatten(params):
        w = _as_matrix(leaf)
        if w is None or not plan.selects(pkey, tuple(w.shape)):
            continue
        yield pkey, w, idx
        idx += 1

