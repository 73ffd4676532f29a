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
``names`` and the per-matrix fold indices equal the reference's. The
shared `TilePool`, program ages and drift views, context remapping and
`install_subset` are later slices.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable

import torch

from repro_torch.core import isa, prng
from repro_torch.core.aimc import (AimcConfig, AimcLinearState,
                                   program_linear, program_stacked)
from repro_torch.core.tile import TileAllocator, TileMap


class CapacityError(RuntimeError):
    """A MappingPlan asked for more crossbar tiles than a context provides."""


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
    (least-loaded first; ``tiles_per_context`` is a hard capacity check)."""

    def __init__(self, cfg: AimcConfig, n_contexts: int = 1,
                 tiles_per_context: int | None = None):
        self.cfg = cfg
        self.tiles_per_context = tiles_per_context
        self._allocs = [TileAllocator(cfg.tile_rows, cfg.tile_cols)
                        for _ in range(n_contexts)]
        self._entries: dict[str, AimcLinearState] = {}
        self._context_of: dict[str, int] = {}

    def _place(self, name: str, desc: str, place) -> int:
        """Run ``place(alloc)`` on the least-loaded context, then check its
        capacity: one placement policy for matrices and gate groups."""
        ctx = min(range(len(self._allocs)),
                  key=lambda i: self._allocs[i].n_tiles)
        alloc = self._allocs[ctx]
        place(alloc)
        if (self.tiles_per_context is not None
                and alloc.n_tiles > self.tiles_per_context):
            raise CapacityError(
                f"mapping {desc} overflows context {ctx}: {alloc.n_tiles} "
                f"tiles > cap {self.tiles_per_context}")
        self._context_of[name] = ctx
        return ctx

    def _allocate(self, name: str, k: int, n: int, instances: int) -> int:
        def place(alloc):
            for i in range(instances):
                alloc.map_matrix(name if instances == 1 else f"{name}[{i}]",
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
        self._place(
            name, f"gates {name!r} ({len(gates)}x[{rows}x{cols}])",
            lambda alloc: alloc.map_side_by_side(
                [f"{name}.g{i}" for i in range(len(gates))], rows, cols))
        state = program_linear(torch.cat(list(gates), dim=1), self.cfg, key)
        self._entries[name] = state
        return state

    def build(self) -> "AimcProgram":
        names = tuple(sorted(self._entries))
        return AimcProgram(
            states=tuple(self._entries[n] for n in names), names=names,
            cfg=self.cfg, contexts=tuple(self._context_of[n] for n in names),
            tile_maps=tuple(a.finalize() for a in self._allocs))


class AimcProgram:
    """Path -> programmed-state registry with its static CM_* accounting."""

    def __init__(self, states, names, cfg: AimcConfig, contexts, tile_maps):
        self.states = tuple(states)
        self.names = tuple(names)
        self.cfg = cfg
        self.contexts = tuple(contexts)
        self.tile_maps: tuple[TileMap, ...] = tuple(tile_maps)

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
        entries = self.entries

        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, f"{path}/{k}" if path else str(k))
                        for k, v in node.items()}
            return entries.get(path, node)

        return walk(params, "")

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
                  key: torch.Tensor | None = None) -> AimcProgram:
    """CM_INITIALIZE an entire model: program every plan-selected weight.
    Matrix i draws its programming noise from ``fold_in(key, i)``, i its
    fold index, as the reference does; ``key=None`` (or a disabled noise
    model) programs noise-free. Pair with ``program.install(params)``."""
    plan = plan or MappingPlan()
    builder = ProgramBuilder(cfg, n_contexts=plan.n_contexts,
                             tiles_per_context=plan.tiles_per_context)
    for pkey, w, idx in iter_mapped_leaves(params, plan):
        builder.add(pkey, w,
                    prng.fold_in(key, idx) if key is not None else None)
    return builder.build()


def _flatten(params, path=""):
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _flatten(params[k], f"{path}/{k}" if path else str(k))
    else:
        yield path, params


def iter_mapped_leaves(params, plan: MappingPlan | None):
    """Yield ``(path, weight, fold_index)`` for every plan-selected float
    leaf of ndim >= 2, in the order `program_model` programs them."""
    plan = plan or MappingPlan()
    idx = 0
    for pkey, leaf in _flatten(params):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2:
            continue
        if not leaf.is_floating_point():
            continue
        if not plan.selects(pkey, tuple(leaf.shape)):
            continue
        yield pkey, leaf, idx
        idx += 1

