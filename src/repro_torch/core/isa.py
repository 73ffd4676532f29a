"""CM_* instruction-level accounting (paper §IV-B, Fig. 3); a copy of
`repro/core/isa.py`, which imports no framework.

The four custom ARMv8 instructions and their static cost/count model. These
records never execute anything — they are the unit of account for the cost
model (`core.costmodel`) and the benchmarks, exactly like gem5's per-
instruction statistics were the unit of account for the paper.

Counts for a [K x N] MVM mapped on tiles of M rows:
  CM_QUEUE    ceil(K/4)            (4 int8 inputs packed per 32-bit register)
  CM_PROCESS  ceil(K/M)            (one per row-block tile activation)
  CM_DEQUEUE  ceil(N/4) * ceil(K/M) (ADC codes fetched per row block)
  CM_INITIALIZE one-off, K*N writes (outside the inference region of interest)

Data-movement *time*, however, is bandwidth-limited (4 GB/s tile SRAM I/O,
paper Table I-C), not instruction-count limited; both views are provided.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CmCounts:
    queue: int = 0
    process: int = 0
    dequeue: int = 0
    initialize: int = 0
    queue_bytes: int = 0
    dequeue_bytes: int = 0

    def __add__(self, other: "CmCounts") -> "CmCounts":
        return CmCounts(*(a + b for a, b in zip(dataclasses.astuple(self),
                                                dataclasses.astuple(other))))

    def scaled(self, times: int) -> "CmCounts":
        return CmCounts(*(v * times for v in dataclasses.astuple(self)))


def mvm_counts(k: int, n: int, tile_rows: int) -> CmCounts:
    """CM_* counts for one [K x N] AIMC MVM (inference-time instructions)."""
    row_blocks = math.ceil(k / tile_rows)
    return CmCounts(
        queue=math.ceil(k / 4),
        process=row_blocks,
        dequeue=math.ceil(n / 4) * row_blocks,
        initialize=0,
        queue_bytes=k,                      # int8 activations in
        dequeue_bytes=n * row_blocks,       # int8 ADC codes out, per row block
    )


def initialize_counts(k: int, n: int) -> CmCounts:
    return CmCounts(initialize=k * n)


def total(counts) -> CmCounts:
    """Sum an iterable of CmCounts (the per-matrix ledgers of a context)."""
    out = CmCounts()
    for c in counts:
        out = out + c
    return out
