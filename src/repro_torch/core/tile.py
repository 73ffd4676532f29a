"""Crossbar tile allocation — AIMClib's ``mapMatrix`` (paper §IV-C); a copy of
`repro/core/tile.py`, which imports no framework.

A physical AIMC tile is an ``M x N`` crossbar (M word lines = input rows,
N bit lines = output columns). AIMClib lets the programmer place *several*
weight matrices side by side in one crossbar at (row, col) offsets — e.g. the
four LSTM gate matrices are tiled next to each other so that a single
CM_PROCESS computes all four gate MVMs (paper §VIII-D, [37]).

This module provides:

  * ``split_matrix``      — grid-split an arbitrary (K x N_out) weight matrix
    into crossbar-sized blocks (a matrix larger than one tile spans several;
    row-direction blocks are ADC-quantized independently and accumulated
    digitally, which is the fidelity-relevant part simulated by the kernel).
  * ``TileAllocator``     — first-fit shelf packer assigning placements of many
    (possibly small) matrices into as few physical tiles as possible.
  * ``TileMap``           — the resulting placement table, with utilization and
    tile-count statistics consumed by the cost model (`core.costmodel`) and the
    benchmarks.

The allocator runs at *trace/setup time* (plain Python over static shapes), so
it never appears on the device path; the kernels see only the resulting
block structure.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Placement:
    """One rectangular weight block placed on one physical tile."""

    matrix_id: str
    tile_id: int
    row_off: int  # word-line offset within the tile
    col_off: int  # bit-line offset within the tile
    rows: int
    cols: int
    # position of this block inside its source matrix
    src_row: int
    src_col: int


@dataclasses.dataclass(frozen=True)
class TileMap:
    tile_rows: int
    tile_cols: int
    placements: tuple[Placement, ...]
    n_tiles: int

    @property
    def utilization(self) -> float:
        used = sum(p.rows * p.cols for p in self.placements)
        total = self.n_tiles * self.tile_rows * self.tile_cols
        return used / total if total else 0.0

    def devices_used(self) -> int:
        # a signed weight needs a PCM device *pair* (paper §III-B)
        return 2 * sum(p.rows * p.cols for p in self.placements)

    def blocks_for(self, matrix_id: str) -> tuple[Placement, ...]:
        return tuple(p for p in self.placements if p.matrix_id == matrix_id)


def split_matrix(rows: int, cols: int, tile_rows: int, tile_cols: int):
    """Yield (src_row, src_col, r, c) blocks of a rows x cols matrix that each
    fit within one tile. Row-direction splits imply digital accumulation."""
    for r0 in range(0, rows, tile_rows):
        for c0 in range(0, cols, tile_cols):
            yield (r0, c0, min(tile_rows, rows - r0), min(tile_cols, cols - c0))


def n_row_blocks(rows: int, tile_rows: int) -> int:
    return math.ceil(rows / tile_rows)


def n_col_blocks(cols: int, tile_cols: int) -> int:
    return math.ceil(cols / tile_cols)


class TileAllocator:
    """First-fit shelf packer for many matrices into M x N crossbars.

    Shelf packing: within a tile, blocks are placed left-to-right on "shelves"
    (horizontal bands). A new shelf opens when the current row is full; a new
    tile opens when no shelf fits. This is the same greedy policy AIMClib's
    offset-based ``mapMatrix`` encourages, and is within ~10% of optimal for
    the NN layer mixes we map (blocks are large relative to tiles).
    """

    def __init__(self, tile_rows: int, tile_cols: int):
        if tile_rows <= 0 or tile_cols <= 0:
            raise ValueError("tile dimensions must be positive")
        self.tile_rows = tile_rows
        self.tile_cols = tile_cols
        # per tile: list of shelves [row_off, shelf_height, col_cursor]
        self._tiles: list[list[list[int]]] = []
        self._placements: list[Placement] = []
        # indices of tiles that are not completely full, ascending. A full
        # tile rejects every block, so first fit over these places exactly
        # as first fit over all tiles — without rescanning the ~30k full
        # tiles a model like granite-8b opens.
        self._open: list[int] = []

    # -- internal -----------------------------------------------------------
    def _try_place_in_tile(self, tile_idx: int, r: int, c: int):
        shelves = self._tiles[tile_idx]
        # try existing shelves (first fit)
        for shelf in shelves:
            row_off, height, cursor = shelf
            if r <= height and cursor + c <= self.tile_cols:
                shelf[2] += c
                return row_off, cursor
        # open a new shelf
        used_rows = sum(s[1] for s in shelves)
        if used_rows + r <= self.tile_rows and c <= self.tile_cols:
            shelves.append([used_rows, r, c])
            return used_rows, 0
        return None

    def _is_full(self, tile_idx: int) -> bool:
        shelves = self._tiles[tile_idx]
        return (sum(s[1] for s in shelves) == self.tile_rows
                and all(s[2] == self.tile_cols for s in shelves))

    def _place_block(self, matrix_id: str, src_row: int, src_col: int, r: int, c: int):
        for tile_idx in self._open:
            pos = self._try_place_in_tile(tile_idx, r, c)
            if pos is not None:
                break
        else:
            self._tiles.append([])
            tile_idx = len(self._tiles) - 1
            self._open.append(tile_idx)
            pos = self._try_place_in_tile(tile_idx, r, c)
            assert pos is not None, "block exceeds tile dimensions after split"
        if self._is_full(tile_idx):
            self._open.remove(tile_idx)
        row_off, col_off = pos
        self._placements.append(
            Placement(matrix_id, tile_idx, row_off, col_off, r, c, src_row, src_col)
        )

    # -- public -------------------------------------------------------------
    @property
    def n_tiles(self) -> int:
        """Physical tiles opened so far (the capacity the packer consumed)."""
        return len(self._tiles)

    @property
    def placements(self) -> tuple[Placement, ...]:
        """Everything placed so far (finalize() is a snapshot of the same)."""
        return tuple(self._placements)

    def map_matrix(self, matrix_id: str, rows: int, cols: int) -> None:
        """AIMClib ``mapMatrix``: split to tile-sized blocks and pack them."""
        for (r0, c0, r, c) in split_matrix(rows, cols, self.tile_rows, self.tile_cols):
            self._place_block(matrix_id, r0, c0, r, c)

    def map_side_by_side(self, matrix_ids: Sequence[str], rows: int, cols_each: int) -> None:
        """Place several same-height matrices adjacently (the LSTM-gate trick):

        one input queue + one CM_PROCESS serves all of them, outputs read from
        consecutive column ranges (paper §VIII-D)."""
        total_cols = cols_each * len(matrix_ids)
        if rows <= self.tile_rows and total_cols <= self.tile_cols:
            # force contiguous placement on a fresh shelf set
            for i, mid in enumerate(matrix_ids):
                self._place_block(mid, 0, 0, rows, cols_each)
        else:
            for mid in matrix_ids:
                self.map_matrix(mid, rows, cols_each)

    def finalize(self) -> TileMap:
        return TileMap(
            tile_rows=self.tile_rows,
            tile_cols=self.tile_cols,
            placements=tuple(self._placements),
            n_tiles=len(self._tiles),
        )


def overlapping_placements(
        placements: Sequence[Placement]) -> list[tuple[Placement, Placement]]:
    """Pairs of placements claiming intersecting cell ranges of one physical
    tile — a packer-invariant violation. Must ALWAYS be empty; checked by
    the multi-program pool tests so co-programmed models can never silently
    share crossbar devices (each cell pair holds exactly one weight)."""
    by_tile: dict[int, list[Placement]] = {}
    for p in placements:
        by_tile.setdefault(p.tile_id, []).append(p)
    bad = []
    for group in by_tile.values():
        for i, a in enumerate(group):
            for b in group[i + 1:]:
                row_hit = (a.row_off < b.row_off + b.rows
                           and b.row_off < a.row_off + a.rows)
                col_hit = (a.col_off < b.col_off + b.cols
                           and b.col_off < a.col_off + a.cols)
                if row_hit and col_hit:
                    bad.append((a, b))
    return bad


def plan_linear(matrix_id: str, in_features: int, out_features: int,
                tile_rows: int, tile_cols: int) -> TileMap:
    """Convenience: a TileMap for a single dense weight matrix."""
    alloc = TileAllocator(tile_rows, tile_cols)
    alloc.map_matrix(matrix_id, in_features, out_features)
    return alloc.finalize()


def pack_contexts(items: Sequence[tuple[str, int, int, int]],
                  n_contexts: int, tile_rows: int,
                  tile_cols: int) -> tuple[int, ...]:
    """Per-context tile counts of packing ``items`` exactly the way
    `core.program.ProgramBuilder` would — the placer's feasibility oracle.

    ``items`` are ``(matrix_id, rows, cols, instances)`` in PROGRAMMING
    ORDER (the `iter_mapped_leaves` tree walk). The simulation reproduces
    the builder's policy bit-for-bit: each matrix goes to the least-loaded
    context (min `n_tiles`, lowest index on ties), each instance mapped as
    ``id`` / ``id[i]`` through the same first-fit shelf packer. Because the
    policies are identical (pinned by tests/test_placement.py against a
    real builder), a subset whose packed max fits `tiles_per_context` here
    is GUARANTEED to program without `CapacityError` there."""
    if n_contexts < 1:
        raise ValueError("n_contexts must be >= 1")
    allocs = [TileAllocator(tile_rows, tile_cols) for _ in range(n_contexts)]
    for mid, rows, cols, instances in items:
        ctx = min(range(n_contexts), key=lambda i: allocs[i].n_tiles)
        for i in range(instances):
            inst = mid if instances == 1 else f"{mid}[{i}]"
            allocs[ctx].map_matrix(inst, rows, cols)
    return tuple(a.n_tiles for a in allocs)
