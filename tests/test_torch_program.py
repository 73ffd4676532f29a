"""Parity of the port's program layer (`repro_torch/core/program.py`, with
its copies `core/isa.py`, `core/tile.py`, `runtime/batcher.py`) with the JAX
reference on the granite-8b smoke config's weights, carried across with
`repro_torch.convert.params_from_numpy`.

Tolerance: exact — the same names in the same order, bit-equal codes,
equal scales, equal tile counts and CM_* counts."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core import isa as jisa
from repro.core import program as jp
from repro.core import tile as jtile
from repro.runtime import batcher as jb
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import isa as tisa
from repro_torch.core import program as tp
from repro_torch.core import tile as ttile
from repro_torch.runtime import batcher as tb


@pytest.fixture(scope="module")
def smoke_params():
    spec = get_arch("granite-8b")
    jparams = spec.model_module().init(jax.random.PRNGKey(0), spec.smoke_cfg)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("n_contexts,rows", [(1, 512), (2, 64), (3, 32)])
def test_program_model_matches_reference(smoke_params, n_contexts, rows):
    jparams, tparams = smoke_params
    prog_j = jp.program_model(jparams, jp.MappingPlan(n_contexts=n_contexts),
                              ja.AimcConfig(tile_rows=rows, tile_cols=rows))
    prog_t = tp.program_model(tparams, tp.MappingPlan(n_contexts=n_contexts),
                              ta.AimcConfig(tile_rows=rows, tile_cols=rows))
    assert prog_t.names == prog_j.names
    assert prog_t.contexts == prog_j.contexts
    for st_t, st_j in zip(prog_t.states, prog_j.states):
        assert (st_t.k, st_t.n) == (st_j.k, st_j.n)
        np.testing.assert_array_equal(st_t.w_q.numpy(), np.asarray(st_j.w_q))
        np.testing.assert_array_equal(st_t.s_w.numpy(), np.asarray(st_j.s_w))
    assert prog_t.n_tiles == prog_j.n_tiles
    assert prog_t.n_matrices == prog_j.n_matrices
    assert prog_t.utilization == prog_j.utilization
    assert (dataclasses.astuple(prog_t.initialize_counts())
            == dataclasses.astuple(prog_j.initialize_counts()))
    assert (dataclasses.astuple(prog_t.mvm_counts(5))
            == dataclasses.astuple(prog_j.mvm_counts(5)))
    assert prog_t.summary() == prog_j.summary()


def test_walk_order_and_fold_indices_match(smoke_params):
    jparams, tparams = smoke_params
    plan_j, plan_t = jp.MappingPlan(), tp.MappingPlan()
    walk_j = [(p, i) for p, _, i in jp.iter_mapped_leaves(jparams, plan_j)]
    walk_t = [(p, i) for p, _, i in tp.iter_mapped_leaves(tparams, plan_t)]
    assert walk_t == walk_j
    assert [p for p, _ in walk_t] == [
        "blocks/w_down", "blocks/w_gate", "blocks/w_up", "blocks/wk",
        "blocks/wo", "blocks/wq", "blocks/wv"]


def test_install_replaces_only_mapped_leaves(smoke_params):
    _, tparams = smoke_params
    prog = tp.program_model(tparams, tp.MappingPlan(), ta.AimcConfig())
    inst = prog.install(tparams)
    for name in prog.names:
        blk, leaf = name.split("/")
        assert isinstance(inst[blk][leaf], ta.AimcLinearState)
    assert inst["embed"] is tparams["embed"]
    assert inst["blocks"]["ln1"] is tparams["blocks"]["ln1"]
    with pytest.raises(KeyError):
        prog["blocks/ln1"]


@pytest.mark.parametrize("path,shape", [
    ("blocks/wq", (2, 64, 64)), ("blocks/router", (2, 64, 8)),
    ("embed", (128, 64)), ("blocks/b_x", (2, 64, 64)), ("blocks/cq", (64, 64)),
    ("blocks/ln1", (2, 64)), ("blocks/we_up", (2, 4, 64, 160))])
def test_mapping_plan_selects_like_reference(path, shape):
    for kw in ({}, {"min_features": 100},
               {"predicate": lambda p, s: not p.endswith("up")}):
        assert (tp.MappingPlan(**kw).selects(path, shape)
                == jp.MappingPlan(**kw).selects(path, shape))


def test_capacity_error_like_reference(smoke_params):
    jparams, tparams = smoke_params
    with pytest.raises(jp.CapacityError):
        jp.program_model(jparams, jp.MappingPlan(tiles_per_context=1),
                         ja.AimcConfig(tile_rows=32, tile_cols=32))
    with pytest.raises(tp.CapacityError):
        tp.program_model(tparams, tp.MappingPlan(tiles_per_context=1),
                         ta.AimcConfig(tile_rows=32, tile_cols=32))


@pytest.mark.parametrize("k,n,rows", [(64, 64, 512), (4096, 14336, 512),
                                      (300, 7, 128)])
def test_isa_counts_equal(k, n, rows):
    assert (dataclasses.astuple(tisa.mvm_counts(k, n, rows))
            == dataclasses.astuple(jisa.mvm_counts(k, n, rows)))
    assert (dataclasses.astuple(tisa.initialize_counts(k, n))
            == dataclasses.astuple(jisa.initialize_counts(k, n)))


def test_tile_packing_equal():
    items = [("a", 300, 200, 2), ("b", 64, 64, 3), ("c", 700, 90, 1)]
    assert (ttile.pack_contexts(items, 2, 256, 256)
            == jtile.pack_contexts(items, 2, 256, 256))
    ta_, ja_ = ttile.TileAllocator(128, 128), jtile.TileAllocator(128, 128)
    for alloc in (ta_, ja_):
        alloc.map_side_by_side(["g0", "g1", "g2"], 64, 32)
        alloc.map_matrix("m", 200, 300)
    assert ([dataclasses.astuple(p) for p in ta_.finalize().placements]
            == [dataclasses.astuple(p) for p in ja_.finalize().placements])


@pytest.mark.parametrize("policy", ["fifo", "sjf"])
def test_batcher_traces_and_order_equal(policy):
    reqs = tb.poisson_trace(6, 50.0, seed=3)
    assert ([dataclasses.astuple(r) for r in reqs]
            == [dataclasses.astuple(r) for r in jb.poisson_trace(6, 50.0,
                                                                  seed=3)])
    qt, qj = tb.Batcher(reqs, policy), jb.Batcher(reqs, policy)
    order_t = [qt.pop_ready(1e9).rid for _ in range(6)]
    order_j = [qj.pop_ready(1e9).rid for _ in range(6)]
    assert order_t == order_j
    assert tb.percentile([3.0, 1.0, 2.0], 90) == jb.percentile([3.0, 1.0, 2.0],
                                                               90)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_open_tile_first_fit_places_like_reference(seed):
    """The port's packer skips full tiles (granite-8b opens ~30k of them);
    on random mixes of matrices and side-by-side gates it places every
    block exactly where the reference's full first-fit scan does."""
    import random
    rng = random.Random(seed)
    rows, cols = rng.choice([(8, 8), (16, 12), (32, 32), (5, 7)])
    allocs = (ttile.TileAllocator(rows, cols), jtile.TileAllocator(rows, cols))
    for i in range(40):
        if rng.random() < 0.2:
            ids = [f"g{i}.{j}" for j in range(rng.randint(1, 4))]
            r, c = rng.randint(1, 2 * rows), rng.randint(1, cols)
            for a in allocs:
                a.map_side_by_side(ids, r, c)
        else:
            r, c = rng.randint(1, 3 * rows), rng.randint(1, 3 * cols)
            for a in allocs:
                a.map_matrix(f"m{i}", r, c)
    got, want = (a.finalize() for a in allocs)
    assert got.n_tiles == want.n_tiles
    assert ([dataclasses.astuple(p) for p in got.placements]
            == [dataclasses.astuple(p) for p in want.placements])
