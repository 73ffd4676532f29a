"""Multi-core AIMC scheduler, the executable twin of the cost model's phases
(PyTorch port of `repro/core/schedule.py`).

The paper's headline results come from *multi-core* mappings: the MLP/LSTM
explorations column-split layers across cores with mutex hand-offs between
phases (§VII-D, §VIII-D), and the CNN pipelines one conv layer per core at
position granularity (§IX-A). `core.workloads` describes those mappings
analytically; this module makes them run:

  * ``Shard``          — one (slice of a) programmed matrix assigned to one
    virtual core in one phase, with its dataflow edges (comm/load/store
    bytes) declared statically.
  * ``select_columns`` — exact column split of an `AimcLinearState`, on the
    state's device. ADC quantization, per-column scales and row-block
    accumulation are all column-independent, so the concatenated shard
    outputs equal the single-core apply bit for bit (noise off).
  * ``CoreSchedule``   — lowers an `AimcProgram` onto N virtual cores.
    ``apply(name, x)`` runs a matrix across all its shards, one launch of
    kernel K2 per shard on a CUDA tensor, interleaved on one device.
    ``ledgers()`` emits per-core CM_*/comm-byte accounts, and
    ``modeled_latency()`` prices them through the same
    `costmodel.aimc_mvm_time` the analytical model uses.
  * dataflow laws      — ``sequential_latency`` (sum over phases of the
    slowest core, the MLP/LSTM mutex chain) and ``pipelined_latency`` (the
    slowest stage, the CNN position pipeline), mirroring
    `costmodel.evaluate`'s treatment of `Workload.pipelined`.
  * ``OverlapRoofline`` — the serving-loop latency law T_step(k) =
    t_step_s + t_round_s / k, fitted from measured chunked-decode step
    times.

Builders for every paper multi-core case live at the bottom
(`mlp_schedule`, `lstm_schedule`, `cnn_schedule`), and `from_program` lowers
any `program_model` output using its MappingPlan contexts as cores. The
reference's mesh execution (`apply_sharded`, `mesh_placement`,
`device_ledgers`) belongs to the mesh slice of the port.

Invariants (pinned by tests/test_torch_schedule.py against the reference):
column splits are exact (noise off); unsplit per-core ledgers sum to
`program.mvm_counts()` while column splits partition dequeue/initialize and
duplicate queue/process by the split factor; `modeled_latency()` equals
`costmodel.evaluate()` on the matching Workload.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import isa, prng
from repro_torch.core.aimc import AimcLinearState, _pad_to, aimc_apply
from repro_torch.core.costmodel import (CALIB, HIGH_POWER, aimc_mvm_time,
                                        fused_epilogue_time)
from repro_torch.core.program import AimcProgram


# ---------------------------------------------------------------------------
# Exact column splitting
# ---------------------------------------------------------------------------

def _column_index(ranges: Sequence[tuple[int, int]]) -> np.ndarray:
    return np.concatenate([np.arange(a, b) for a, b in ranges])


def select_columns(state: AimcLinearState,
                   ranges: Sequence[tuple[int, int]]) -> AimcLinearState:
    """A new programmed state holding only the given logical column ranges,
    gathered on the state's device.

    The slice is exact: per-column weight scales, ADC codes and row-block
    accumulation never mix columns, so (noise off)

        aimc_apply(select_columns(st, R), x) == aimc_apply(st, x)[..., idx(R)]

    bit for bit. Non-contiguous ranges are allowed (the LSTM case-4 gate
    slices pick one stripe out of each of the four gate blocks). The column
    count pads to 128, the lane padding of `program_stacked`."""
    for a, b in ranges:
        if not (0 <= a < b <= state.n):
            raise ValueError(f"column range [{a}, {b}) outside n={state.n}")
    idx = _column_index(ranges)
    if len(np.unique(idx)) != idx.size:
        raise ValueError("overlapping column ranges")
    n_new = int(idx.size)
    pad = _pad_to(n_new, 128) - n_new
    cols = torch.from_numpy(idx).to(state.w_q.device)
    w_q = state.w_q.index_select(-1, cols)
    s_w = state.s_w.index_select(-1, cols)
    if pad:
        w_q = torch.nn.functional.pad(w_q, (0, pad))
        s_w = torch.nn.functional.pad(s_w, (0, pad))
    return AimcLinearState(w_q=w_q.contiguous(), s_w=s_w.contiguous(),
                           k=state.k, n=n_new)


# ---------------------------------------------------------------------------
# Shards and per-core ledgers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """One (slice of a) programmed matrix on one virtual core.

    ``cols=None`` assigns the whole matrix; otherwise a tuple of logical
    [start, stop) column ranges. ``count`` is the number of MVMs this shard
    fires per inference (conv output positions re-using the kernel).
    ``comm_in_bytes``/``comm_events`` are the activation bytes and mutex
    hand-offs this core pays before computing; ``comm_out_bytes`` what it
    forwards. ``digital_cycles`` prices the stage's CPU-side element-wise
    tail in core cycles. ``epilogue_fn``/``epilogue_elems`` instead declare
    an activation fused into the shard's dequeue loop, priced by
    `costmodel.fused_epilogue_time`; ``epilogue_elems`` is per firing."""

    name: str
    core: int
    phase: int
    cols: tuple[tuple[int, int], ...] | None = None
    count: int = 1
    comm_in_bytes: int = 0
    comm_out_bytes: int = 0
    comm_events: int = 0
    load_bytes: int = 0
    store_bytes: int = 0
    digital_cycles: float = 0.0
    epilogue_fn: str = ""
    epilogue_elems: int = 0

    def n_cols(self, state: AimcLinearState) -> int:
        if self.cols is None:
            return state.n
        return sum(b - a for a, b in self.cols)


@dataclasses.dataclass(frozen=True)
class CoreLedger:
    """Static per-core account of one inference, in the units the cost model
    prices (`isa.CmCounts` + comm/load/store bytes)."""

    core: int
    cm: isa.CmCounts
    comm_bytes: int = 0
    comm_events: int = 0
    load_bytes: int = 0
    store_bytes: int = 0

    def row(self) -> list:
        return [self.core, self.cm.queue, self.cm.process, self.cm.dequeue,
                self.comm_bytes, self.load_bytes + self.store_bytes]


# ---------------------------------------------------------------------------
# Dataflow latency laws (mirrors costmodel.evaluate's Workload.pipelined)
# ---------------------------------------------------------------------------

def sequential_latency(phase_times: Sequence[Sequence[float]]) -> float:
    """Mutex hand-off semantics (MLP/LSTM): stages inside a phase run in
    parallel on different cores, phases chain."""
    return sum(max(ph) if len(ph) else 0.0 for ph in phase_times)


def pipelined_latency(phase_times: Sequence[Sequence[float]]) -> float:
    """Position-level pipelining (CNN): at steady state every stage works on
    a different inference, so the slowest stage sets the latency."""
    return max((t for ph in phase_times for t in ph), default=0.0)


@dataclasses.dataclass(frozen=True)
class OverlapRoofline:
    """Calibrated host-overlap roofline for the chunked decode loop:

        T_step(k) = t_step_s + t_round_s / k

    ``t_step_s`` is the per-step device time, ``t_round_s`` the per-host-
    round overhead that a k-step chunk amortizes over k steps."""

    t_step_s: float
    t_round_s: float

    @classmethod
    def fit(cls, step_times: dict[int, float]) -> "OverlapRoofline":
        """Least-squares fit over the basis [1, 1/k] from ``step_times``
        (chunk size k -> measured seconds per decode step). Needs >= 2
        chunk sizes; negative constants clamp to 0."""
        ks = sorted(step_times)
        if len(ks) < 2:
            raise ValueError(
                f"OverlapRoofline.fit needs step times at >= 2 chunk "
                f"sizes, got {ks}")
        a_mat = np.array([[1.0, 1.0 / k] for k in ks])
        y = np.array([step_times[k] for k in ks])
        (t_step, t_round), *_ = np.linalg.lstsq(a_mat, y, rcond=None)
        return cls(t_step_s=max(float(t_step), 0.0),
                   t_round_s=max(float(t_round), 0.0))

    def predict_step_s(self, k: int) -> float:
        if k < 1:
            raise ValueError(f"chunk size must be >= 1, got {k}")
        return self.t_step_s + self.t_round_s / k

    def speedup(self, k_from: int = 1, k_to: int = 8) -> float:
        return self.predict_step_s(k_from) / self.predict_step_s(k_to)

    def residuals(self, step_times: dict[int, float]) -> dict[int, float]:
        return {k: abs(self.predict_step_s(k) - t) / t
                for k, t in step_times.items()}


# ---------------------------------------------------------------------------
# CoreSchedule
# ---------------------------------------------------------------------------

class CoreSchedule:
    """An `AimcProgram` lowered onto N virtual cores. Built once at setup
    (plain Python over static shapes); ``apply`` equals the single-core
    programmed path bit for bit (noise off)."""

    def __init__(self, program: AimcProgram, shards: Sequence[Shard],
                 pipelined: bool = False, name: str = ""):
        self.program = program
        self.cfg = program.cfg
        self.shards = tuple(shards)
        self.pipelined = pipelined
        self.name = name
        if not self.shards:
            raise ValueError("a schedule needs at least one shard")

        self._by_name: dict[str, tuple[Shard, ...]] = {}
        for sh in self.shards:
            if sh.name not in program:
                raise KeyError(f"shard references unmapped matrix {sh.name!r}")
            self._by_name.setdefault(sh.name, ())
            self._by_name[sh.name] += (sh,)

        # pre-slice states + the inverse column permutation per matrix, as
        # an index tensor on the states' device
        self._states: dict[tuple[str, int], AimcLinearState] = {}
        self._inv_perm: dict[str, torch.Tensor | None] = {}
        for mname, shs in self._by_name.items():
            st = program[mname]
            if len(shs) == 1 and shs[0].cols is None:
                self._inv_perm[mname] = None
                continue
            if any(sh.cols is None for sh in shs):
                raise ValueError(
                    f"matrix {mname!r}: mixing full and column-split shards")
            idx = np.concatenate([_column_index(sh.cols) for sh in shs])
            if not np.array_equal(np.sort(idx), np.arange(st.n)):
                raise ValueError(
                    f"matrix {mname!r}: shard columns are not a disjoint "
                    f"cover of 0..{st.n}")
            for i, sh in enumerate(shs):
                self._states[(mname, i)] = select_columns(st, sh.cols)
            self._inv_perm[mname] = torch.from_numpy(np.argsort(idx)).to(
                st.w_q.device)

    # -- shape stats ---------------------------------------------------------
    @property
    def n_cores(self) -> int:
        return max(sh.core for sh in self.shards) + 1

    @property
    def n_phases(self) -> int:
        return max(sh.phase for sh in self.shards) + 1

    def shards_of(self, name: str) -> tuple[Shard, ...]:
        return self._by_name[name]

    # -- execution: interleaved on one device --------------------------------
    def apply(self, name: str, x: torch.Tensor,
              key: torch.Tensor | None = None) -> torch.Tensor:
        """Run matrix ``name`` across all its shards and reassemble the full
        output: one `aimc_apply` (one K2 launch on the card) per shard. With
        one full shard this is the single-core path. Shard i draws its read
        noise from ``fold_in(key, i)``: each core owns physically distinct
        crossbar columns, so multi-core noise differs from single-core by
        design."""
        shs = self._by_name[name]
        inv = self._inv_perm[name]
        if inv is None:
            return aimc_apply(self.program[name], x, self.cfg, key)
        parts = []
        for i in range(len(shs)):
            sub_key = prng.fold_in(key, i) if key is not None else None
            parts.append(aimc_apply(self._states[(name, i)], x, self.cfg,
                                    sub_key))
        return torch.cat(parts, dim=-1).index_select(-1, inv)

    # -- static accounting (the cost model's units) ---------------------------
    def ledgers(self) -> tuple[CoreLedger, ...]:
        """Per-core CM_*/comm-byte accounts for one inference. Column-split
        cores each queue the full input vector (the paper's case-4
        semantics), so summed queue/process counts exceed the single-core
        program's by the split factor while dequeue/initialize partition
        exactly."""
        acc = {c: [isa.CmCounts(), 0, 0, 0, 0] for c in range(self.n_cores)}
        for sh in self.shards:
            st = self.program[sh.name]
            cm = isa.mvm_counts(st.k, sh.n_cols(st), self.cfg.tile_rows)
            a = acc[sh.core]
            a[0] = a[0] + cm.scaled(sh.count * st.instances)
            a[1] += sh.comm_in_bytes + sh.comm_out_bytes
            a[2] += sh.comm_events
            a[3] += sh.load_bytes
            a[4] += sh.store_bytes
        return tuple(CoreLedger(c, *acc[c]) for c in sorted(acc))

    def ledger_totals(self) -> isa.CmCounts:
        return isa.total(led.cm for led in self.ledgers())

    # -- predicted latency through the shared cost-model accounting -----------
    def shard_time(self, sh: Shard, sys=HIGH_POWER, p=CALIB,
                   coupling: str = "tight") -> float:
        """Modeled busy time of one shard: CM_* traffic priced by
        `costmodel.aimc_mvm_time` plus its comm/load/store edges."""
        st = self.program[sh.name]
        cm = isa.mvm_counts(st.k, sh.n_cols(st), self.cfg.tile_rows)
        t_q, t_p, t_d = aimc_mvm_time(cm, sys, p, coupling)
        reps = sh.count * st.instances
        t = (t_q + t_p + t_d) * reps
        if sh.epilogue_fn:
            t += fused_epilogue_time(
                sh.epilogue_elems * reps, sh.epilogue_fn,
                cm.dequeue * reps, sys, p)
        f = sys.freq_hz
        t += sh.comm_events * p.sync_s
        t += (sh.comm_in_bytes + sh.comm_out_bytes) * p.comm_cycles_per_byte / f
        t += sh.load_bytes * p.load_cycles_per_byte / f
        t += sh.store_bytes * p.store_cycles_per_byte / f
        t += sh.digital_cycles / f
        return t

    def phase_times(self, sys=HIGH_POWER, p=CALIB,
                    coupling: str = "tight") -> tuple[tuple[float, ...], ...]:
        """Per phase, the modeled busy time of each active core."""
        per: dict[tuple[int, int], float] = {}
        for sh in self.shards:
            key = (sh.phase, sh.core)
            per[key] = per.get(key, 0.0) + self.shard_time(sh, sys, p, coupling)
        return tuple(tuple(t for (p_, _c), t in sorted(per.items())
                           if p_ == ph)
                     for ph in range(self.n_phases))

    def modeled_latency(self, sys=HIGH_POWER, p=CALIB,
                        coupling: str = "tight") -> float:
        """Per-inference latency under this schedule's dataflow law."""
        times = self.phase_times(sys, p, coupling)
        law = pipelined_latency if self.pipelined else sequential_latency
        return law(times)

    def summary(self) -> str:
        law = "pipelined" if self.pipelined else "sequential"
        return (f"CoreSchedule[{self.name or 'anon'}]: {len(self.shards)} "
                f"shards of {len(self._by_name)} matrices on "
                f"{self.n_cores} core(s), {self.n_phases} phase(s), {law}; "
                f"modeled {self.modeled_latency() * 1e6:.1f}us/inf")

    def __repr__(self) -> str:
        return f"<{self.summary()}>"

    # -- lowering a whole-model program ---------------------------------------
    @classmethod
    def from_program(cls, program: AimcProgram,
                     pipelined: bool = False) -> "CoreSchedule":
        """Lower a `program_model` output onto its MappingPlan contexts: each
        context is a virtual core, each mapped matrix a phase in registry
        order, with an int8 activation hand-off (k bytes + one mutex)
        charged whenever consecutive matrices sit on different cores."""
        shards = []
        prev_core = None
        for i, name in enumerate(program.names):
            st = program[name]
            core = program.contexts[i]
            hand_off = prev_core is not None and core != prev_core
            shards.append(Shard(
                name=name, core=core, phase=i,
                comm_in_bytes=st.k if hand_off else 0,
                comm_events=1 if hand_off else 0))
            prev_core = core
        return cls(program, shards, pipelined=pipelined, name="from_program")


# ---------------------------------------------------------------------------
# Pipelined stream execution (position-level pipelining, measured view)
# ---------------------------------------------------------------------------

def pipeline_run(stage_fns: Sequence[Callable], inputs: Sequence):
    """Push a stream of inputs through chained stages, measuring per-stage
    wallclock (a stage on a CUDA tensor is synchronised with its device
    before its clock stops). Pipelining changes timing, not values: the
    outputs equal sequential execution."""
    times = [0.0] * len(stage_fns)
    outs = []
    for x in inputs:
        for i, fn in enumerate(stage_fns):
            t0 = time.perf_counter()
            x = fn(x)
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            times[i] += time.perf_counter() - t0
        outs.append(x)
    n = max(len(inputs), 1)
    return outs, tuple(t / n for t in times)


# ---------------------------------------------------------------------------
# Paper-case schedule builders (workloads.py's analytical twins, executable)
# ---------------------------------------------------------------------------

def mlp_schedule(program: AimcProgram, cores: int = 1,
                 p=CALIB, fuse_epilogue: bool = False) -> CoreSchedule:
    """The paper's MLP analog mappings (Fig. 6) over entries fc1/fc2.

    cores=1 -> case 1 (both layers one core); cores=2 -> case 3 (layer per
    core, mutex hand-off); cores=4 -> case 4 (each layer column-split over
    two cores, all-to-all half hand-offs). Comm edges and digital relu
    cycles mirror `workloads.mlp_workloads` op for op. ``fuse_epilogue``
    folds each layer's relu into its dequeue loop; the matching workloads
    carry `Op(..., epilogue="relu")`."""
    n_in, n1 = program["fc1"].k, program["fc1"].n
    n2 = program["fc2"].n
    relu = p.elem_cycles["relu"]

    def tail(elems):
        """Per-shard relu epilogue: fused into the dequeue or digital."""
        if fuse_epilogue:
            return {"epilogue_fn": "relu", "epilogue_elems": elems}
        return {"digital_cycles": elems * relu}

    if cores == 1:
        shards = [Shard("fc1", 0, 0, load_bytes=n_in, **tail(n1)),
                  Shard("fc2", 0, 1, store_bytes=n2, **tail(n2))]
    elif cores == 2:
        shards = [Shard("fc1", 0, 0, load_bytes=n_in, **tail(n1)),
                  Shard("fc2", 1, 1, comm_in_bytes=n1, comm_events=1,
                        store_bytes=n2, **tail(n2))]
    elif cores == 4:
        h1, h2 = n1 // 2, n2 // 2
        shards = [
            Shard("fc1", 0, 0, cols=((0, h1),), load_bytes=n_in, **tail(h1)),
            Shard("fc1", 1, 0, cols=((h1, n1),), comm_in_bytes=n_in,
                  comm_events=1, **tail(n1 - h1)),
            Shard("fc2", 2, 1, cols=((0, h2),), comm_in_bytes=n1,
                  comm_events=2, store_bytes=h2, **tail(h2)),
            Shard("fc2", 3, 1, cols=((h2, n2),), comm_in_bytes=n1,
                  comm_events=2, store_bytes=n2 - h2, **tail(n2 - h2)),
        ]
    else:
        raise ValueError(f"MLP mappings exist for 1/2/4 cores, not {cores}")
    suffix = "_fused" if fuse_epilogue else ""
    return CoreSchedule(program, shards, name=f"mlp_{cores}c{suffix}")


def _lstm_cell_cycles(nh: int, frac: float = 1.0, p=CALIB) -> float:
    """Digital cycles of the nine linear-complexity cell ops (§VIII-D),
    matching `workloads._lstm_cell_elemwise`."""
    m = int(nh * frac)
    ec = p.elem_cycles
    return (3 * m * ec["sigmoid"] + m * ec["tanh"] + 2 * m * ec["mul"]
            + m * ec["add"] + m * ec["tanh"] + m * ec["mul"])


def lstm_schedule(program: AimcProgram, cores: int, nh: int,
                  x_dim: int = 50, y_dim: int = 50,
                  p=CALIB) -> CoreSchedule:
    """The paper's LSTM analog mappings (Table II-B) over entries cell
    ([h,x] -> 4 gates side by side) and dense.

    cores=1 -> case 1/2 (everything one core); cores=2 -> case 3 (cell core
    + dense core); cores=5 -> case 4 (cell gate-sliced over four cores, each
    taking one column stripe of every gate and exchanging h stripes
    all-to-all for the recurrence, plus a dense core)."""
    soft = p.elem_cycles["softmax"] * y_dim
    if cores == 1:
        shards = [Shard("cell", 0, 0, load_bytes=x_dim,
                        digital_cycles=_lstm_cell_cycles(nh, p=p)),
                  Shard("dense", 0, 1, store_bytes=y_dim,
                        digital_cycles=soft)]
    elif cores == 2:
        shards = [Shard("cell", 0, 0, load_bytes=x_dim,
                        digital_cycles=_lstm_cell_cycles(nh, p=p)),
                  Shard("dense", 1, 1, comm_in_bytes=nh, comm_events=1,
                        store_bytes=y_dim, digital_cycles=soft)]
    elif cores == 5:
        q = 4
        if nh % q:
            raise ValueError(f"gate slicing needs nh % {q} == 0, got {nh}")
        sl = nh // q
        shards = [
            Shard("cell", j, 0,
                  cols=tuple((g * nh + j * sl, g * nh + (j + 1) * sl)
                             for g in range(4)),
                  load_bytes=x_dim,
                  comm_in_bytes=(q - 1) * sl,       # h stripes from peers
                  comm_out_bytes=sl,                # own h stripe broadcast
                  comm_events=q,                    # q-1 in + 1 out
                  digital_cycles=_lstm_cell_cycles(nh, 1 / q, p=p))
            for j in range(q)
        ]
        shards.append(Shard("dense", q, 1, comm_in_bytes=nh, comm_events=1,
                            store_bytes=y_dim, digital_cycles=soft))
    else:
        raise ValueError(f"LSTM mappings exist for 1/2/5 cores, not {cores}")
    return CoreSchedule(program, shards, name=f"lstm_{cores}c")


def cnn_schedule(program: AimcProgram, convs: Sequence[tuple],
                 img: int = 224, p=CALIB) -> CoreSchedule:
    """The paper's pipelined CNN mapping (§IX-A): conv layer i on core i as
    pipeline stage i, feature maps handed core to core. ``convs`` is the
    `models.paper_nets.CNN_SPECS` row: (cin, k, cout, stride, pad, lrn,
    pool) per layer; output-position counts derive from ``img``. The dense
    head stays digital (paper §IX-A) and is not part of this schedule."""
    shards = []
    ec = p.elem_cycles
    hw, c_prev = img, convs[0][0]
    for i, (_cin, k, cout, stride, pad, lrn, pool) in enumerate(convs):
        out_hw = (hw + 2 * pad - k) // stride + 1
        in_bytes = hw * hw * c_prev
        elems = out_hw * out_hw * cout
        cycles = elems * ec["relu"]
        if lrn:
            cycles += elems * ec["lrn"]
        if pool > 1:
            cycles += elems * ec["maxpool"]
        shards.append(Shard(
            f"conv{i}", core=i, phase=i, count=out_hw * out_hw,
            load_bytes=in_bytes if i == 0 else 0,
            comm_in_bytes=0 if i == 0 else in_bytes,
            comm_events=0 if i == 0 else 1,
            digital_cycles=cycles))
        hw, c_prev = out_hw // pool, cout
    return CoreSchedule(program, shards, pipelined=True,
                        name=f"cnn_{len(convs)}stage")
