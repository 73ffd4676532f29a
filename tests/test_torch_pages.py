"""The port's page pool (`repro_torch/runtime/pages.py`, a numpy-only copy
of `repro/runtime/pages.py`) against the reference: chained page keys are
byte-equal, and seeded random operation sequences (alloc / retain /
release, prefix lookup / put / evict) leave identical traces: every return
value, the ledger, the verify() verdict, the LRU order and the cache
stats. Tolerance: exact equality."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import random

import pytest

from repro.runtime import pages as jpages
from repro_torch.runtime import pages as tpages


@pytest.mark.parametrize("page_size", [1, 3, 4])
def test_page_keys_equal(page_size):
    rng = random.Random(page_size)
    for n in (0, 1, 7, 16, 33):
        prompt = [rng.randint(0, 151000) for _ in range(n)]
        assert tpages.page_keys(prompt, page_size) == \
            jpages.page_keys(prompt, page_size)
    # chained: a key commits to the whole prefix, not just its page
    a = tpages.page_keys([1, 2, 3, 4], 2)
    b = tpages.page_keys([9, 9, 3, 4], 2)
    assert a[0] != b[0] and a[1] != b[1]


def _allocator_trace(mod, seed, n_ops=400):
    rng = random.Random(seed)
    alloc = mod.PageAllocator(17, 4)
    held, out = [], []
    for _ in range(n_ops):
        op = rng.choice(("alloc", "alloc", "retain", "release", "release"))
        if op == "alloc":
            got = alloc.alloc(rng.randint(0, 5), owner=rng.randint(0, 3))
            out.append(("alloc", got))
            held += got or []
        elif op == "retain" and held:
            pid = rng.choice(held)
            alloc.retain(pid)
            held.append(pid)
            out.append(("retain", pid, alloc.refcount(pid)))
        elif op == "release" and held:
            pid = held.pop(rng.randrange(len(held)))
            out.append(("release", pid, alloc.release(pid)))
        out.append(("books", alloc.n_free, alloc.n_held, alloc.verify()))
    for bad in (jpages.SCRATCH, 99):
        with pytest.raises(ValueError):
            alloc.release(bad)
    out.append(alloc.ledger())
    return out


@pytest.mark.parametrize("seed", range(4))
def test_allocator_trace_equals_reference(seed):
    t = _allocator_trace(tpages, seed)
    assert t == _allocator_trace(jpages, seed)
    assert all(step[3] for step in t[:-1] if step[0] == "books")


def _prefix_trace(mod, seed, n_ops=300):
    rng = random.Random(seed)
    alloc = mod.PageAllocator(12, 2)
    cache = mod.PrefixCache(alloc)
    prompts = [[rng.randint(1, 6) for _ in range(rng.randint(2, 10))]
               for _ in range(8)]
    owned, out = [], []
    for _ in range(n_ops):
        op = rng.choice(("put", "put", "lookup", "peek", "evict", "drop"))
        if op == "put":
            keys = mod.page_keys(rng.choice(prompts), 2)
            if not keys:
                continue
            pids = alloc.alloc(1, owner="req")
            if pids is None:
                out.append(("full", cache.evictable()))
                continue
            ok = cache.put(rng.choice(keys), pids[0],
                           adopt=rng.random() < 0.3)
            out.append(("put", pids[0], ok))
            if not ok or alloc.refcount(pids[0]) > 1:
                owned.append(pids[0])
        elif op in ("lookup", "peek"):
            keys = mod.page_keys(rng.choice(prompts), 2)
            out.append((op, cache.lookup(keys, peek=op == "peek")))
        elif op == "evict":
            protect = rng.sample(range(1, 12), 2)
            out.append(("evict", cache.evictable(protect),
                        cache.evict(rng.randint(0, 3), protect=protect)))
        elif op == "drop" and owned:
            pid = owned.pop(rng.randrange(len(owned)))
            out.append(("drop", pid, alloc.release(pid)))
        out.append((len(cache), alloc.n_free, alloc.verify(), cache.stats()))
    out.append(alloc.ledger())
    return out


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_trace_equals_reference(seed):
    t = _prefix_trace(tpages, seed)
    assert t == _prefix_trace(jpages, seed)
    assert any(step[0] == "evict" and step[2] for step in t
               if isinstance(step, tuple) and isinstance(step[0], str))
