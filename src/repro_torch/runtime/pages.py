"""Fixed-size page pool for the serving engine's paged KV cache (a copy of
`repro/runtime/pages.py`: numpy and hashlib only, so the port keeps its own).

The dense slot cache pays ``n_slots x max_seq`` up front whether or not any
request uses it, and identical system prompts re-prefill from scratch on
every admission. This module owns the digital-side fix (DESIGN.md §15):

  * `PageAllocator` — a pool of ``n_pages`` physical pages (page 0 is a
    reserved SCRATCH page that is never allocated: traced writes for
    inactive/frozen lanes route there, mirroring how the dense engine's
    `mask_batch_select` discards frozen-lane writes). Every other page is
    at any instant EXACTLY one of: on the free list, or held with a
    positive refcount under one producing owner — the same
    every-tile-accounted discipline `core.program.TilePool` applies to
    crossbar tiles, here applied to cache pages (`verify`).

  * `PrefixCache` — content-addressed index over FULL prompt pages.
    Page ``j`` of a prompt is keyed by a CHAINED hash (the hash of pages
    ``0..j``'s tokens), so one key uniquely identifies an entire prefix:
    transformer KV reuse asks for the longest consecutive run of present
    keys (it needs every physical page), recurrent snapshot reuse asks for
    the deepest present key alone (one snapshot page holds the whole
    state). The cache holds one reference per entry; an entry whose page
    has no other sharer (refcount 1) is evictable, LRU-first.

Billing contract (enforced by the engine; tests/test_torch_paged_engine.py):
the producer of a page pays its prefill vectors once; a prefix hit pays
only its continuation span. Hits are never double-billed and never free.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

SCRATCH = 0


def page_keys(prompt, page_size: int) -> list[bytes]:
    """Chained content hashes of a prompt's FULL pages.

    ``keys[j]`` = sha256 over (keys[j-1] || tokens of page j), so a single
    key commits to the entire token prefix ``[0, (j+1)*page_size)`` — two
    prompts share key ``j`` iff they agree on every token up to that
    boundary. Only full pages are hashable: a partial trailing page is
    never shared (its rows are still being written)."""
    keys = []
    h = b""
    for j in range(len(prompt) // page_size):
        page = np.asarray(prompt[j * page_size:(j + 1) * page_size],
                          np.int32)
        h = hashlib.sha256(h + page.tobytes()).digest()
        keys.append(h)
    return keys


class PageAllocator:
    """Exact-accounting allocator over ``n_pages`` physical pages.

    Page `SCRATCH` (0) is reserved and never handed out. ``alloc`` returns
    pages at refcount 1 under the given owner; ``retain``/``release`` move
    the refcount; a release to zero returns the page to the free list.
    `ledger()`/`verify()` prove the partition is exact at any time."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is scratch), "
                             f"got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO free list, low pages first on init (pop from the end)
        self._free = list(range(n_pages - 1, 0, -1))
        self._ref: dict[int, int] = {}     # pid -> refcount (>= 1)
        self._owner: dict[int, object] = {}  # pid -> producing owner tag

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_held(self) -> int:
        return len(self._ref)

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def owner(self, pid: int):
        return self._owner.get(pid)

    def alloc(self, n: int, owner) -> list[int] | None:
        """``n`` pages at refcount 1 under ``owner``, or None (shortage —
        the caller decides whether to evict and retry or defer admission).
        All-or-nothing: a partial grab is never left behind."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pids = [self._free.pop() for _ in range(n)]
        for pid in pids:
            self._ref[pid] = 1
            self._owner[pid] = owner
        return pids

    def retain(self, pid: int):
        if pid == SCRATCH or pid not in self._ref:
            raise ValueError(f"retain of unheld page {pid}")
        self._ref[pid] += 1

    def release(self, pid: int) -> bool:
        """Drop one reference; True when this freed the page."""
        if pid == SCRATCH or pid not in self._ref:
            raise ValueError(f"release of unheld page {pid} (double free?)")
        self._ref[pid] -= 1
        if self._ref[pid]:
            return False
        del self._ref[pid]
        del self._owner[pid]
        self._free.append(pid)
        return True

    def ledger(self) -> dict:
        """Point-in-time books: every page attributed exactly once."""
        by_owner: dict = {}
        for pid, owner in self._owner.items():
            by_owner.setdefault(owner, []).append(pid)
        return {"total": self.n_pages, "scratch": 1,
                "free": len(self._free), "held": len(self._ref),
                "refs": sum(self._ref.values()),
                "by_owner": {k: sorted(v) for k, v in by_owner.items()}}

    def verify(self) -> bool:
        """The exact-partition invariant: {scratch} ∪ free ∪ held is a
        disjoint cover of [0, n_pages), every held page has refcount >= 1
        and an owner, and no free/scratch page carries books."""
        free = set(self._free)
        held = set(self._ref)
        if SCRATCH in free or SCRATCH in held:
            return False
        if free & held:
            return False
        if len(free) != len(self._free):     # duplicate on the free list
            return False
        if free | held | {SCRATCH} != set(range(self.n_pages)):
            return False
        if any(r < 1 for r in self._ref.values()):
            return False
        return set(self._owner) == held


@dataclasses.dataclass
class _Entry:
    pid: int
    tick: int   # LRU clock at last touch


class PrefixCache:
    """Content hash -> resident page, refcounted through a `PageAllocator`.

    The cache itself holds ONE reference per entry (taken at `put`, via
    `retain` or by adopting the caller's reference), so a registered page
    survives its producer's retirement. An entry is evictable exactly when
    the cache is the last sharer (allocator refcount 1)."""

    def __init__(self, allocator: PageAllocator):
        self.alloc = allocator
        self._entries: dict[bytes, _Entry] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def lookup(self, keys: list[bytes], peek: bool = False) -> list:
        """Per-index resident pids (None where absent). Touches LRU and
        books hit/miss stats unless ``peek`` (admission feasibility checks
        must not perturb eviction order). The caller derives its own match
        shape: transformer KV needs the longest consecutive run from 0,
        recurrent snapshots need only the deepest present index."""
        out = []
        for key in keys:
            ent = self._entries.get(key)
            if ent is None:
                out.append(None)
                if not peek:
                    self.misses += 1
                continue
            out.append(ent.pid)
            if not peek:
                self._tick += 1
                ent.tick = self._tick
                self.hits += 1
        return out

    def put(self, key: bytes, pid: int, adopt: bool = False) -> bool:
        """Register ``key`` -> ``pid``. With ``adopt`` the cache takes over
        the caller's existing reference (recurrent snapshot pages exist
        only for the cache); otherwise it retains its own (+1 — transformer
        KV pages stay co-held by the producing request until it retires).
        A key that is already resident is left as-is (returns False): the
        first producer wins, the duplicate page stays request-owned."""
        if key in self._entries:
            return False
        if not adopt:
            self.alloc.retain(pid)
        self._tick += 1
        self._entries[key] = _Entry(pid=pid, tick=self._tick)
        return True

    def evictable(self, protect=()) -> int:
        """How many entries could be evicted right now (cache is the only
        sharer), excluding pids in ``protect`` — an admission about to
        retain its hit pages must not count them as reclaimable."""
        protect = set(protect)
        return sum(1 for e in self._entries.values()
                   if self.alloc.refcount(e.pid) == 1
                   and e.pid not in protect)

    def evict(self, n_pages: int, protect=()) -> int:
        """Free up to ``n_pages`` pages by dropping sole-sharer entries,
        least-recently-used first. Returns the number actually freed."""
        protect = set(protect)
        victims = sorted(
            (e.tick, key) for key, e in self._entries.items()
            if self.alloc.refcount(e.pid) == 1 and e.pid not in protect)
        freed = 0
        for _, key in victims:
            if freed >= n_pages:
                break
            ent = self._entries.pop(key)
            self.alloc.release(ent.pid)
            self.evictions += 1
            freed += 1
        return freed

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions}
