"""AIMClib, the programmer-facing library (paper §IV-C, Fig. 4); PyTorch
port of `repro/core/aimclib.py`.

  * ``map_matrix(name, w)``     — program a weight matrix onto crossbars.
  * ``map_gates(name, [W...])`` — place same-height matrices side by side so
    ONE process call computes all of them (the paper's LSTM trick, §VIII-D).
  * ``map_gate_stack``          — the same gates as a `[G, ...]` stacked
    tenant for the gate-fused kernel K3.
  * ``queue_vector / process / dequeue_vector`` — the instruction-level data
    flow of Fig. 4.
  * ``linear(name, x)`` / ``linear_stack`` — the fused path every model
    layer uses (identical math, one kernel launch).

Every programming and every MVM takes the next key of a JAX-compatible key
chain (`_next_key`, `core/prng.py`): the same context key gives the same
programming noise and the same read-noise seeds as the reference. The
context is a thin shell over `core.program.ProgramBuilder`, so CM_* counts
flow through one accounting path.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import isa, prng
from repro_torch.core.aimc import (AimcConfig, AimcLinearState, aimc_apply,
                                   aimc_apply_stacked)
from repro_torch.core.program import AimcProgram, ProgramBuilder
from repro_torch.core.quant import dequantize, quantize
from repro_torch.core.tile import TileMap


class AimcContext:
    """One context ~ the set of AIMC tiles private to a core (paper Fig. 2).
    ``key`` defaults to ``PRNGKey(0)`` on the CPU, as in the reference."""

    def __init__(self, cfg: AimcConfig, key: torch.Tensor | None = None):
        self.cfg = cfg
        self._key = key if key is not None else prng.PRNGKey(0)
        self._builder = ProgramBuilder(cfg)
        self._counts: dict[str, isa.CmCounts] = {}
        self._pending: dict[str, torch.Tensor] = {}   # queued inputs

    def _next_key(self) -> torch.Tensor:
        self._key, sub = prng.split(self._key)
        return sub

    # -- programming (CM_INITIALIZE) ----------------------------------------
    def map_matrix(self, name: str, w: torch.Tensor) -> AimcLinearState:
        state = self._builder.add(name, w, self._next_key())
        self._counts[name] = isa.initialize_counts(state.k, state.n)
        return state

    def map_gates(self, name: str,
                  gates: Sequence[torch.Tensor]) -> AimcLinearState:
        """Concatenate same-height gate matrices column-wise and map them as
        one crossbar tenant: one queue + one process serves all gates."""
        state = self._builder.add_gates(name, gates, self._next_key())
        self._counts[name] = isa.initialize_counts(state.k, state.n)
        return state

    def map_gate_stack(self, name: str,
                       gates: Sequence[torch.Tensor]) -> AimcLinearState:
        """Program same-SHAPE gate matrices as a `[G, ...]` stacked tenant:
        `linear_stack` runs all G as one launch of kernel K3 with a per-gate
        epilogue. Same footprint and CM_* profile as `map_gates`."""
        state = self._builder.add(name, torch.stack(list(gates)),
                                  self._next_key())
        self._counts[name] = isa.initialize_counts(
            state.k, state.n).scaled(state.instances)
        return state

    # -- the Fig. 4 instruction-level flow -----------------------------------
    def queue_vector(self, name: str, x: torch.Tensor) -> None:
        st = self._state(name)
        self._counts[name] += isa.mvm_counts(st.k, st.n, self.cfg.tile_rows)
        self._pending[name] = x

    def process(self, name: str) -> None:
        if name not in self._pending:
            raise RuntimeError(f"CM_PROCESS before CM_QUEUE for {name!r}")

    def dequeue_vector(self, name: str) -> torch.Tensor:
        x = self._pending.pop(name, None)
        if x is None:
            raise RuntimeError(f"CM_DEQUEUE before CM_QUEUE for {name!r}")
        return aimc_apply(self._state(name), x, self.cfg, self._next_key())

    # -- fused path -----------------------------------------------------------
    def linear(self, name: str, x: torch.Tensor, bias=None,
               activation: str = "none") -> torch.Tensor:
        st = self._state(name)
        self._counts[name] += isa.mvm_counts(st.k, st.n, self.cfg.tile_rows)
        return aimc_apply(st, x, self.cfg, self._next_key(), bias=bias,
                          activation=activation)

    def linear_stack(self, name: str, x: torch.Tensor,
                     activations="none") -> torch.Tensor:
        """Apply a `map_gate_stack` tenant: one launch of K3, `[G, ..., N]`
        out. Accounted as the side-by-side mapping (shared queue, per-gate
        dequeue, the §VIII-D instruction profile)."""
        st = self._state(name)
        self._counts[name] += isa.mvm_counts(st.k, st.instances * st.n,
                                             self.cfg.tile_rows)
        return aimc_apply_stacked(st, x, self.cfg, self._next_key(),
                                  activations=activations)

    # -- bookkeeping ----------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._builder._entries

    def _state(self, name: str) -> AimcLinearState:
        try:
            return self._builder._entries[name]
        except KeyError:
            raise KeyError(f"matrix {name!r} was never mapped") from None

    def program(self) -> AimcProgram:
        """The registry built so far, as an `AimcProgram`."""
        return self._builder.build()

    def tile_map(self) -> TileMap:
        return self.program().tile_maps[0]

    def instruction_counts(self) -> isa.CmCounts:
        return isa.total(self._counts.values())


# -- digital helpers (run "on the CPU": the paper keeps these off the tile) --
def relu(x):
    return torch.clamp_min(x, 0)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def softmax(x, dim=-1):
    return torch.softmax(x, dim=dim)


def cast_to_int8(x, scale):
    return quantize(x, scale)


def cast_from_int8(q, scale):
    return dequantize(q, scale)
