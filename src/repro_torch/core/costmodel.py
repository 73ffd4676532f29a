"""Analytical full-system performance/energy model (the gem5-X role); a
copy of `repro/core/costmodel.py`, which imports no framework.

The paper characterizes whole applications — accelerated MVMs *plus* input
load, queue/dequeue, activation functions, core-to-core communication, cache
working-set effects — on two calibrated system models (paper Table I). This
module reimplements that characterization analytically:

  * `SystemConfig`   — Table I-(A)/(B): clocks, cache sizes, pJ/cycle figures.
  * `AimcTileSpec`   — Table I-(C): 100 ns CM_PROCESS, 4 GB/s tile SRAM I/O,
    12.8 TOp/s/W at 256x256 (re-scaled for tile size: crossbar + converters),
    power upscaling 5.3x / 2x to the 28 nm core node.
  * `CalibratedParams` — effective-throughput constants playing the role gem5's
    microarchitecture played. Four of them are *calibrated* against the paper's
    own headline results (see benchmarks/calibration notes in EXPERIMENTS.md);
    the rest are textbook in-order-A53 figures.
  * `evaluate()`     — timing + energy for a `Workload` (per-core stages of
    MVM / element-wise / load / store / comm ops), digital or AIMC-mapped,
    tight- or loose-coupled.

Execution-model notes derived from the paper's measurements:

  * CM_QUEUE/CM_DEQUEUE are *instruction-issue bound*, not 4 GB/s-bound: 4
    bytes move per instruction, and each custom instruction performs a
    CPU->tile transaction costing tens of cycles on the in-order pipeline.
    This is why "analog queue" is ~40% of the MLP run time (paper Fig. 8)
    even though 1 KB at 4 GB/s would take only 0.26 us, and why the paper
    stresses that queue/dequeue bandwidth is THE critical parameter (§VII-B).
  * The MLP/LSTM cases process a single inference stream with a sequential
    cross-core dependency chain (mutex hand-off), so multi-core mappings pay
    the full communication latency per inference (paper: MLP case 3/4 are
    20%/30% *slower* than single-core). `pipelined=False` sums stages.
  * The CNN applies fine-grained (position-level) pipelining across cores
    (paper §IX-A), so its per-inference time is the max stage time.
    `pipelined=True` takes the max.
  * The MinorCPU is in-order: compute, tile-I/O and memory-stall components
    add up within a stage (no overlap).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

from repro_torch.core import isa

# ---------------------------------------------------------------------------
# Table I — system configurations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    name: str
    freq_hz: float
    n_cores: int
    l1_bytes: int
    llc_bytes: int
    pj_idle: float           # per cycle
    pj_wfm: float            # per cycle (wait-for-memory)
    pj_active: float         # per cycle
    mem_io_power_w: float
    llc_leak_mw_per_256kb: float
    llc_read_pj_byte: float
    llc_write_pj_byte: float
    dram_pj_access: float    # per 64B access
    aimc_power_scale: float  # 14nm -> 28nm upscale (paper §VI-B)


HIGH_POWER = SystemConfig(
    name="high-power", freq_hz=2.3e9, n_cores=8,
    l1_bytes=64 * 1024, llc_bytes=1024 * 1024,
    pj_idle=126.03, pj_wfm=638.99, pj_active=845.39,
    mem_io_power_w=5.82, llc_leak_mw_per_256kb=874.08,
    llc_read_pj_byte=5.60, llc_write_pj_byte=5.02,
    dram_pj_access=120.0, aimc_power_scale=5.3,
)

LOW_POWER = SystemConfig(
    name="low-power", freq_hz=0.8e9, n_cores=8,
    l1_bytes=32 * 1024, llc_bytes=512 * 1024,
    pj_idle=10.72, pj_wfm=46.04, pj_active=60.92,
    mem_io_power_w=3.03, llc_leak_mw_per_256kb=271.62,
    llc_read_pj_byte=1.81, llc_write_pj_byte=1.63,
    dram_pj_access=120.0, aimc_power_scale=2.0,
)


@dataclasses.dataclass(frozen=True)
class AimcTileSpec:
    latency_s: float = 100e-9          # CM_PROCESS
    io_bw: float = 4e9                 # tile SRAM queue/dequeue, bytes/s
    tops_per_w_256: float = 12.8       # MVM efficiency at 256x256
    converter_energy_frac: float = 0.5 # share of tile energy in DAC/ADC

    def mvm_energy_j(self, k: int, n: int, scale: float) -> float:
        """Energy of one CM_PROCESS on a k x n tile region (paper: efficiency
        re-calculated for tile size: crossbar ~ k*n, converters ~ k + n)."""
        e_256 = (2 * 256 * 256) / (self.tops_per_w_256 * 1e12)
        e_xbar = e_256 * (1 - self.converter_energy_frac) * (k * n) / (256 * 256)
        e_conv = e_256 * self.converter_energy_frac * (k + n) / (256 + 256)
        return (e_xbar + e_conv) * scale


AIMC_TILE = AimcTileSpec()


def _default_elem_cycles():
    return {
        "relu": 1.0, "add": 1.0, "mul": 1.0, "copy": 0.5,
        "sigmoid": 33.0, "tanh": 33.0, "softmax": 40.0, "exp": 20.0,
        "maxpool": 3.0, "lrn": 10.0,
    }


@dataclasses.dataclass(frozen=True)
class CalibratedParams:
    """Microarchitectural effective-throughput constants.

    CALIBRATED against the paper's own results (provenance in EXPERIMENTS.md
    §Paper-calibration): `simd_macs_per_cycle`, `conv_macs_per_cycle`,
    `cm_queue_cycles`, `load_cycles_per_byte`, `loose_word_cycles`.
    All others are standard in-order Cortex-A53-class figures.
    """

    # dense/gemv int8 SIMD efficiency (NEON peak 16/cyc; Eigen gemv on an
    # in-order core achieves ~6 effective).
    simd_macs_per_cycle: float = 6.0
    # direct convolution efficiency (batch-1 edge inference: index arithmetic
    # + strided loads dominate; calibrated to the paper's CNN-S 20.5x).
    conv_macs_per_cycle: float = 0.44
    # custom-instruction issue cost: one CPU->tile transaction each.
    cm_queue_cycles: float = 90.0
    cm_dequeue_cycles: float = 45.0
    # input marshalling: load + int8 pack into argument registers.
    load_cycles_per_byte: float = 34.0
    store_cycles_per_byte: float = 8.0
    elem_cycles: dict = dataclasses.field(default_factory=_default_elem_cycles)
    llc_bytes_per_cycle: float = 8.0       # L1<->LLC fill path
    dram_bw_eff: float = 2.6e9             # 16-bit DDR4-2400, effective
    sync_s: float = 6.0e-6                 # mutex + futex wake per hand-off
    comm_cycles_per_byte: float = 12.0     # remote-line read + repack
    loose_word_cycles: float = 240.0       # extra I/O-bus cost per 32b word


CALIB = CalibratedParams()


# ---------------------------------------------------------------------------
# Workload IR
# ---------------------------------------------------------------------------

OpKind = Literal["mvm", "elemwise", "load", "store", "comm"]


@dataclasses.dataclass(frozen=True)
class Op:
    kind: OpKind
    # mvm
    k: int = 0
    n: int = 0
    count: int = 1            # e.g. conv output positions re-using the kernel
    aimc: bool = False
    conv: bool = False        # direct-conv (vs gemv) digital efficiency class
    # fused epilogue (aimc mvm only): activation applied inside the
    # CM_DEQUEUE loop instead of as a separate elemwise pass (kernel v2's
    # fused-epilogue contract in cost-model terms). "" = none.
    epilogue: str = ""
    # elemwise
    fn: str = "relu"
    elems: int = 0
    # load/store/comm
    bytes: int = 0


@dataclasses.dataclass(frozen=True)
class Stage:
    """Work mapped to one CPU core (plus its private AIMC tile, if any)."""
    ops: tuple[Op, ...]
    weights_bytes: int = 0    # digital weights this stage streams per inference
    act_bytes: int = 0        # activations this stage touches per inference


@dataclasses.dataclass(frozen=True)
class Workload:
    """``phases`` is a tuple of phases; each phase is a tuple of stages that
    run in PARALLEL on different cores (e.g. the two column-halves of an MLP
    layer in case 4). Phases execute sequentially for single-stream inference
    (MLP/LSTM: per-inference time = sum over phases of max-in-phase), unless
    ``pipelined`` (CNN fine-grained pipelining: max over every stage)."""

    name: str
    phases: tuple[tuple[Stage, ...], ...]
    pipelined: bool = False
    coupling: Literal["tight", "loose"] = "tight"
    tile_rows: int = 1024     # AIMC crossbar word lines (per-case, paper Fig. 6/9)

    @property
    def stages(self) -> tuple[Stage, ...]:
        return tuple(s for phase in self.phases for s in phase)


@dataclasses.dataclass(frozen=True)
class Result:
    time_s: float             # per inference
    energy_j: float           # per inference
    llc_mpi: float            # LLC-misses-per-instruction proxy
    breakdown: dict           # sub-ROI time shares (paper Fig. 8 / Fig. 11 style)
    stage_times: tuple
    dram_bytes: float = 0.0   # DRAM traffic per inference (memory intensity)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def aimc_mvm_time(counts: isa.CmCounts, sys: SystemConfig,
                  p: CalibratedParams = CALIB,
                  coupling: str = "tight") -> tuple[float, float, float]:
    """(t_queue, t_process, t_dequeue) for a CM_* instruction ledger.

    THE shared accounting: `evaluate()` prices every AIMC mvm op through
    this function, and `core.schedule` prices its per-core `CoreLedger`s
    through the same one — so a scheduled multi-core mapping and the
    analytical `Workload` of the same case can never drift apart. Queue and
    dequeue are each the max of the bandwidth view (tile SRAM I/O, Table I-C)
    and the instruction-issue view (custom-instruction cost per 32-bit word,
    the paper's actual bottleneck — §VII-B); loose coupling adds the I/O-bus
    transaction cost per word on top.
    """
    f = sys.freq_hz
    t_q = max(counts.queue_bytes / AIMC_TILE.io_bw,
              counts.queue * p.cm_queue_cycles / f)
    t_d = max(counts.dequeue_bytes / AIMC_TILE.io_bw,
              counts.dequeue * p.cm_dequeue_cycles / f)
    if coupling == "loose":
        t_q += counts.queue * p.loose_word_cycles / f
        t_d += counts.dequeue * p.loose_word_cycles / f
    t_p = counts.process * AIMC_TILE.latency_s
    return t_q, t_p, t_d


def fused_epilogue_time(elems: int, fn: str, dequeue_count: int,
                        sys: SystemConfig, p: CalibratedParams = CALIB) -> float:
    """Visible time of an activation folded into the CM_DEQUEUE loop.

    An unfused epilogue is a separate elemwise pass (a plain `Op(elemwise)`).
    Fused, the ALU work interleaves with the dequeue's CPU->tile
    transactions: the in-order core can hide up to `cm_dequeue_cycles` of
    arithmetic behind each transaction's latency, so only the excess shows.
    Cheap epilogues (relu at 1 cycle/elem, 4 elems/word vs a 45-cycle
    transaction) vanish entirely; transcendentals (sigmoid/tanh at 33
    cycles/elem) overflow the bubble and pay the remainder. THE shared
    accounting — `evaluate()` and `core.schedule.shard_time` both price
    fused epilogues through this one function.
    """
    cycles = elems * p.elem_cycles[fn]
    hidden = dequeue_count * p.cm_dequeue_cycles
    return max(0.0, cycles - hidden) / sys.freq_hz


def _stage_time(stage: Stage, sys: SystemConfig, p: CalibratedParams,
                coupling: str, tile_rows: int):
    """Returns (time_s, breakdown, aimc_energy_j, stall_s, instr_count)."""
    f = sys.freq_hz
    t_total = 0.0
    e_aimc = 0.0
    instrs = 0.0
    bd = {"mvm_digital": 0.0, "analog_queue": 0.0, "analog_process": 0.0,
          "analog_dequeue": 0.0, "digital_ops": 0.0, "input_load": 0.0,
          "output_store": 0.0, "comm": 0.0, "mem_stall": 0.0}

    for op in stage.ops:
        if op.kind == "mvm" and not op.aimc:
            eff = p.conv_macs_per_cycle if op.conv else p.simd_macs_per_cycle
            t = op.count * (op.k * op.n) / (eff * f)
            bd["mvm_digital"] += t
            instrs += op.count * op.k * op.n / 16
            t_total += t
        elif op.kind == "mvm" and op.aimc:
            counts = isa.mvm_counts(op.k, op.n, tile_rows)
            t_q, t_p, t_d = aimc_mvm_time(counts, sys, p, coupling)
            t_q, t_d, t_p = t_q * op.count, t_d * op.count, t_p * op.count
            if op.epilogue:
                t_d += fused_epilogue_time(op.count * op.n, op.epilogue,
                                           op.count * counts.dequeue, sys, p)
            bd["analog_queue"] += t_q
            bd["analog_dequeue"] += t_d
            bd["analog_process"] += t_p
            instrs += op.count * (counts.queue + counts.dequeue)
            e_aimc += op.count * AIMC_TILE.mvm_energy_j(
                min(op.k, tile_rows) * counts.process, op.n,
                sys.aimc_power_scale)
            t_total += t_q + t_d + t_p
        elif op.kind == "elemwise":
            t = op.elems * p.elem_cycles[op.fn] / f
            bd["digital_ops"] += t
            instrs += op.elems * p.elem_cycles[op.fn]
            t_total += t
        elif op.kind == "load":
            t = op.bytes * p.load_cycles_per_byte / f
            bd["input_load"] += t
            instrs += op.bytes * 1.5
            t_total += t
        elif op.kind == "store":
            t = op.bytes * p.store_cycles_per_byte / f
            bd["output_store"] += t
            instrs += op.bytes * 1.5
            t_total += t
        elif op.kind == "comm":
            t = p.sync_s + op.bytes * p.comm_cycles_per_byte / f
            bd["comm"] += t
            t_total += t

    # Working-set memory stalls: digital weights that exceed the cache levels
    # are re-streamed every inference (paper §VII-E working-set analysis).
    ws = stage.weights_bytes + stage.act_bytes
    stall = 0.0
    if stage.weights_bytes > 0:
        if ws > sys.llc_bytes:
            spill = min(1.0, (ws - sys.llc_bytes) / max(ws, 1))
            stall += stage.weights_bytes * spill / p.dram_bw_eff
            stall += stage.weights_bytes * (1 - spill) / (p.llc_bytes_per_cycle * f)
        elif ws > sys.l1_bytes:
            stall += stage.weights_bytes / (p.llc_bytes_per_cycle * f)
    bd["mem_stall"] = stall
    t_total += stall

    return t_total, bd, e_aimc, stall, instrs


def evaluate(w: Workload, sys: SystemConfig, p: CalibratedParams = CALIB) -> Result:
    per_stage = [_stage_time(s, sys, p, w.coupling, w.tile_rows) for s in w.stages]
    times = [t for (t, *_rest) in per_stage]
    if w.pipelined and len(times) > 1:
        t_inf = max(times)
    else:
        t_inf, i = 0.0, 0
        for phase in w.phases:
            t_inf += max(times[i: i + len(phase)]) if phase else 0.0
            i += len(phase)

    bd_total: dict[str, float] = {}
    for (_t, bd, _e, _stall, _i) in per_stage:
        for key, v in bd.items():
            bd_total[key] = bd_total.get(key, 0.0) + v

    # ---- energy -------------------------------------------------------------
    f = sys.freq_hz
    e = 0.0
    dram_bytes = 0.0
    llc_traffic = 0.0
    total_instrs = 0.0
    for (t_stage, _bd, e_aimc, stall, instrs) in per_stage:
        busy = max(0.0, t_stage - stall)
        e += busy * f * sys.pj_active * 1e-12
        e += stall * f * sys.pj_wfm * 1e-12
        e += max(0.0, t_inf - t_stage) * f * sys.pj_idle * 1e-12
        e += e_aimc
        total_instrs += instrs
    idle_cores = max(0, sys.n_cores - len(per_stage))
    e += idle_cores * t_inf * f * sys.pj_idle * 1e-12

    for s in w.stages:
        ws = s.weights_bytes + s.act_bytes
        if s.weights_bytes and ws > sys.llc_bytes:
            spill = min(1.0, (ws - sys.llc_bytes) / max(ws, 1))
            dram_bytes += s.weights_bytes * spill
            # digital direct conv re-streams its kernel weights once per
            # output ROW (weights far exceed L1); LLC-spilled fractions of
            # that traffic hit DRAM — the cache-thrashing the paper's
            # memory-intensity metric captures (§IX-B).
            for op in s.ops:
                if op.kind == "mvm" and op.conv and not op.aimc:
                    rows = max(int(math.sqrt(op.count)) - 1, 0)
                    dram_bytes += op.k * op.n * rows * spill
        llc_traffic += s.weights_bytes + 2 * s.act_bytes

    e += (dram_bytes / 64.0) * sys.dram_pj_access * 1e-12
    e += llc_traffic * sys.llc_read_pj_byte * 1e-12
    e += sys.mem_io_power_w * t_inf
    e += (sys.llc_leak_mw_per_256kb * 1e-3) * (sys.llc_bytes / (256 * 1024)) * t_inf

    mpi = (dram_bytes / 64.0) / max(total_instrs, 1.0)
    return Result(time_s=t_inf, energy_j=e, llc_mpi=mpi,
                  breakdown=bd_total, stage_times=tuple(times),
                  dram_bytes=dram_bytes)


def speedup(digital: Result, analog: Result) -> tuple[float, float]:
    """(perf gain, energy gain) of analog over digital — the paper's headline."""
    return digital.time_s / analog.time_s, digital.energy_j / analog.energy_j


# ---------------------------------------------------------------------------
# Per-layer stage builders (core.placement's pricing substrate)
# ---------------------------------------------------------------------------

def digital_mvm_stage(k: int, n: int, count: int = 1,
                      conv: bool = False) -> Stage:
    """One layer's digital MVM as a single-op stage: SIMD gemv time plus
    the working-set stall of streaming its float32 weights every
    inference. ``count`` is the instance multiplicity (stacked layers /
    experts), each firing once per token vector."""
    return Stage(ops=(Op(kind="mvm", k=k, n=n, count=count, conv=conv),),
                 weights_bytes=count * k * n * 4)


def analog_mvm_stage(k: int, n: int, count: int = 1,
                     epilogue: str = "") -> Stage:
    """One layer's AIMC MVM as a single-op stage: queue/process/dequeue
    traffic priced through `aimc_mvm_time` — weights are stationary on the
    crossbar, so no working-set bytes."""
    return Stage(ops=(Op(kind="mvm", k=k, n=n, count=count, aimc=True,
                         epilogue=epilogue),))


def split_workload(name: str, layers, analog, tile_rows: int = 1024,
                   coupling: str = "tight") -> Workload:
    """A sequential Workload for a mixed analog/digital layer split.

    ``layers`` is ``(path, k, n, instances)`` per layer in execution order;
    ``analog`` the set of paths mapped to crossbars. Each layer becomes its
    OWN one-stage phase, so `evaluate()`'s sequential law (sum over phases
    of max-in-phase) degenerates to the exact per-layer sum — the identity
    `core.placement` relies on: the placer's per-layer time sums equal the
    full-model evaluation at ratio 1.000 by construction (gated in
    benchmarks/bench_placement.py)."""
    analog = set(analog)
    phases = []
    for path, k, n, instances in layers:
        stage = (analog_mvm_stage(k, n, instances) if path in analog
                 else digital_mvm_stage(k, n, instances))
        phases.append((stage,))
    return Workload(name=name, phases=tuple(phases), pipelined=False,
                    coupling=coupling, tile_rows=tile_rows)
