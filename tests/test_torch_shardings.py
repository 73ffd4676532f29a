"""The port's mesh and sharding rules against the JAX reference:
`repro_torch.launch.shardings` returns the reference's PartitionSpec for
every leaf of the same trees, compared as tuples.

The reference's spec functions read only ``mesh.shape`` and
``mesh.axis_names``, so they run on `jax.sharding.AbstractMesh`es of
(2, 4), (1, 1) and a ("pod", "data", "model") grid; the port runs on
`launch.mesh.make_mesh` meshes of the same shapes, every position on the
CPU. The trees are the port's, carried to the reference as
`ShapeDtypeStruct`s (programmed states as the reference's
`AimcLinearState`): every arch's smoke parameter tree raw, installed and
int8-packed, AdamW and Adafactor states, each family's cache and the
serving engine's slot trees. Also pinned: the placement helper
(`place` / `Placed.gather`) and the 128-aligned column-piece rule."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.core import aimc as ja
from repro.launch import mesh as jmesh
from repro.launch import shardings as js
from repro_torch.configs import get_arch
from repro_torch.core import aimc as ta
from repro_torch.core.prng import PRNGKey
from repro_torch.core.program import MappingPlan, program_model
from repro_torch.core.quant import quantize_params_int8
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as ts
from repro_torch.optim import adafactor, adamw
from repro_torch.runtime.engine import _batch_dim

ARCHS = ["granite-8b", "llama3.2-3b", "glm4-9b", "qwen1.5-110b",
         "internvl2-1b", "olmoe-1b-7b", "arctic-480b", "xlstm-350m",
         "recurrentgemma-9b", "seamless-m4t-large-v2"]
MESHES = [((2, 4), ("data", "model")), ((1, 1), ("data", "model")),
          ((2, 2, 4), ("pod", "data", "model"))]


def _meshes(i):
    shape, axes = MESHES[i]
    return (AbstractMesh(shape, axes),
            tmesh.make_mesh(shape, axes, ["cpu"]))


def _to_ref(tree):
    """The port's tree as the reference's: shapes only, programmed states
    as the reference's `AimcLinearState`, containers kept."""
    if isinstance(tree, dict):
        return {k: _to_ref(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_ref(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_ref(v) for v in tree)
    if isinstance(tree, ta.AimcLinearState):
        return ja.AimcLinearState(w_q=_to_ref(tree.w_q),
                                  s_w=_to_ref(tree.s_w), k=tree.k, n=tree.n)
    return jax.ShapeDtypeStruct(tuple(tree.shape), np.float32)


def _flat_ref(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(js._path_str(p)): tuple(s) for p, s in leaves}


def _flat_port(specs):
    return {"/".join(ts._path_str(p)): tuple(s) for p, s in
            ts._flatten_with_path(specs, is_leaf=ts._is_spec)}


def _same(ref_specs, port_specs):
    r, t = _flat_ref(ref_specs), _flat_port(port_specs)
    assert r, "no leaves compared"
    assert r == t


_TREES: dict = {}


def _trees(arch):
    """(raw, installed, int8) smoke trees of ``arch`` on the CPU."""
    if arch not in _TREES:
        spec = get_arch(arch)
        cfg = spec.smoke_cfg
        raw = spec.model_module().init(PRNGKey(0), cfg, device="cpu")
        prog = program_model(raw, MappingPlan(), ta.AimcConfig(),
                             PRNGKey(2))
        _TREES[arch] = (raw, prog.install(raw), quantize_params_int8(raw))
    return _TREES[arch]


@pytest.mark.parametrize("mi", range(len(MESHES)))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mi):
    jm, tm = _meshes(mi)
    for tree in _trees(arch):
        ref_tree = _to_ref(tree)
        _same(js.get_param_specs(ref_tree, jm), ts.get_param_specs(tree, tm))
        _same(js.serve_engine_param_specs(ref_tree, jm),
              ts.serve_engine_param_specs(tree, tm))
        rs = js.get_param_specs(ref_tree, jm)
        ps = ts.get_param_specs(tree, tm)
        _same(js.shard_aimc_states(rs, ref_tree, jm),
              ts.shard_aimc_states(ps, tree, tm))
        _same(js.strip_fsdp(rs, jm), ts.strip_fsdp(ps, tm))
        _same(js.fit_specs(rs, ref_tree, jm), ts.fit_specs(ps, tree, tm))
        _same(js.serve_engine_param_specs(ref_tree, jm, axis="pipe"),
              ts.serve_engine_param_specs(tree, tm, axis="pipe"))


@pytest.mark.parametrize("mi", range(len(MESHES)))
def test_opt_specs_equal_reference(mi):
    jm, tm = _meshes(mi)
    for arch in ("granite-8b", "olmoe-1b-7b", "xlstm-350m"):
        raw = _trees(arch)[0]
        for opt in (adamw.init(raw, adamw.AdamWConfig()),
                    adafactor.init(raw, adafactor.AdafactorConfig())):
            _same(js.get_opt_specs(_to_ref(opt), _to_ref(raw), jm),
                  ts.get_opt_specs(opt, raw, tm))


def _caches(arch):
    spec = get_arch(arch)
    cfg, model = spec.smoke_cfg, spec.model_module()
    if spec.family == "audio":
        yield model.init_cache(cfg, 4, 16, 24, device="cpu")
        return
    yield model.init_cache(cfg, 4, 16, torch.float32, "cpu")
    if spec.module == "transformer":
        yield model.init_paged_cache(cfg, 9, 4, torch.float32, "cpu")


@pytest.mark.parametrize("mi", range(len(MESHES)))
def test_cache_and_slot_specs_equal_reference(mi):
    jm, tm = _meshes(mi)
    for arch in ("granite-8b", "xlstm-350m", "recurrentgemma-9b",
                 "seamless-m4t-large-v2"):
        for cache in _caches(arch):
            _same(js.cache_specs(_to_ref(cache), jm),
                  ts.cache_specs(cache, tm))
            if "kp" in cache:
                axes = {n: (1 if n in ("kp", "vp") else 0) for n in cache}
            else:
                axes = {n: _batch_dim(n) for n in cache}
            _same(js.slot_cache_specs(_to_ref(cache), axes, jm),
                  ts.slot_cache_specs(cache, axes, tm))
    state = {"active": torch.zeros(4, dtype=torch.bool),
             "gen": torch.zeros(4), "pos": torch.zeros(4),
             "max_new": torch.zeros(4), "grid": torch.zeros(4, 2)}
    _same(js.slot_state_specs(_to_ref(state), jm),
          ts.slot_state_specs(state, tm))
    odd = {"active": torch.zeros(3), "gen": torch.zeros(3)}
    _same(js.slot_state_specs(_to_ref(odd), jm),
          ts.slot_state_specs(odd, tm))


@pytest.mark.parametrize("mi", range(len(MESHES)))
def test_batch_and_state_specs_equal_reference(mi):
    jm, tm = _meshes(mi)
    for kind in ("lm", "vlm", "encdec"):
        assert _flat_ref(js.batch_specs(jm, kind)) == \
            _flat_port(ts.batch_specs(tm, kind))
    with pytest.raises(ValueError):
        ts.batch_specs(tm, "audio")
    for nd in (2, 3, 4, 5):
        assert tuple(js.aimc_state_spec(nd)) == tuple(ts.aimc_state_spec(nd))
        assert tuple(js.aimc_state_spec(nd, "data")) == \
            tuple(ts.aimc_state_spec(nd, "data"))
    for names in ("data", ("pod", "data"), ("data", "model")):
        present = [n for n in ((names,) if isinstance(names, str) else names)
                   if n in tm.axis_names]
        if len(present) == len((names,) if isinstance(names, str)
                               else names):
            assert jmesh.axis_size(jm, names) == tmesh.axis_size(tm, names)
    assert jmesh.fsdp_axes(jm) == tmesh.fsdp_axes(tm)
    assert jmesh.dp_axes(jm) == tmesh.dp_axes(tm)


class _FakeMesh:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


@given(st.tuples(st.integers(1, 64), st.integers(1, 64), st.integers(1, 64)))
@settings(max_examples=60, deadline=None)
def test_fit_spec_always_divides_like_reference(shape):
    spec = (("pod", "data"), "model", None)
    fitted = ts.fit_spec(ts.P(*spec), shape, _FakeMesh())
    assert tuple(fitted) == tuple(js.fit_spec(JP(*spec), shape, _FakeMesh()))
    for d, entry in enumerate(fitted):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        assert shape[d] % int(np.prod([_FakeMesh.shape[a]
                                       for a in axes])) == 0


def test_fit_spec_keeps_dividing_prefix():
    m = _FakeMesh()
    assert ts.fit_spec(ts.P(("pod", "data")), (32,), m) == ts.P(("pod",
                                                                 "data"))
    assert ts.fit_spec(ts.P(("pod", "data")), (2,), m) == ts.P("pod")
    assert ts.fit_spec(ts.P(("pod", "data")), (3,), m) == ts.P()
    assert ts.fit_spec(ts.P("data", "model"), (896, 151655), m) == \
        ts.P("data")


def test_mesh_folds_positions_round_robin():
    m = tmesh.make_mesh((2, 2), ("data", "model"), ["cpu"])
    assert m.fold() == "4 positions on 1 device (cpu)"
    assert m.shape == {"data": 2, "model": 2}
    assert m.positions() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    two = tmesh.make_mesh((2, 2), ("data", "model"),
                          [torch.device("meta"), torch.device("cpu")])
    assert [str(d) for d in two.devices] == ["meta", "cpu", "meta", "cpu"]
    assert two.fold() == "4 positions on 2 devices (meta x2, cpu x2)"
    assert two.device_at((1, 1)) == torch.device("cpu")
    prod = tmesh.make_production_mesh(devices=["cpu"])
    assert prod.shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True,
                                      devices=["cpu"]).axis_names == \
        ("pod", "data", "model")
    with pytest.raises(ValueError):
        tmesh.Mesh((2,), ("data", "model"), (torch.device("cpu"),))


@pytest.mark.parametrize("spec", [(None, "data"), ("model", None),
                                  (("data", "model"), None), ("data", "model"),
                                  (None, None)])
def test_place_splits_and_gathers_back(spec):
    m = tmesh.make_mesh((2, 2), ("data", "model"), ["cpu"])
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    placed = ts.place(x.clone(), ts.P(*spec), m)
    assert torch.equal(placed.gather("cpu"), x)
    n_blocks = int(np.prod(placed.counts))
    assert len(placed.pieces) == n_blocks   # one device: no replica copies
    for pos in m.positions():
        piece = placed.piece(pos)
        assert piece.is_contiguous()
        sl = placed._slices(placed.block_of(pos))
        assert torch.equal(piece, x[sl])
    if spec == (None, None):               # replicated in place: no copy
        assert placed.piece((1, 1)) is placed.piece((0, 0))
    placed.write_(0, 5, torch.full((6,), -1.0))
    want = x.clone()
    want[5] = -1.0
    assert torch.equal(placed.gather("cpu"), want)
    placed.scatter_(x * 2)
    assert torch.equal(placed.gather("cpu"), x * 2)


@pytest.mark.parametrize("spec", [("data", None), (("data", "model"), None),
                                  (None, None)])
def test_placed_rows_read_and_write_by_global_index(spec):
    m = tmesh.make_mesh((2, 2), ("data", "model"), ["cpu"])
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    placed = ts.place(x.clone(), ts.P(*spec), m)
    idx = [6, 0, 3, 0, 7]
    assert torch.equal(placed.rows(0, idx, "cpu"), x[idx])
    placed.put_rows_(0, [5, 1], -x[[5, 1]])
    want = x.clone()
    want[[5, 1]] = -x[[5, 1]]
    assert torch.equal(placed.gather("cpu"), want)
    cols = ts.place(x.clone(), ts.P(None, "model"), m)
    with pytest.raises(ValueError, match="split"):
        cols.rows(0, [1], "cpu")


def test_column_pieces_follow_the_128_aligned_rule():
    m2 = tmesh.make_mesh((2, 2), ("data", "model"), ["cpu"])
    m4 = tmesh.make_mesh((1, 4), ("data", "model"), ["cpu"])
    w = torch.randn(2, 512, 640)
    st = ta.program_stacked(w, ta.AimcConfig())          # Np 640
    spec = ts.aimc_state_spec(st.w_q.dim())
    assert ts.state_splits(st, spec, m2) == 1           # 640 % 256
    w = torch.randn(2, 512, 1024)
    st = ta.program_stacked(w, ta.AimcConfig())          # Np 1024
    placed = ts.place_aimc_state(st, spec, m4)
    assert [(p.c0, p.c1) for p in placed.pieces] == [
        (0, 256), (256, 512), (512, 768), (768, 1024)]
    for p in placed.pieces:     # views of the whole's codes: stored once
        assert p.w_q.data_ptr() == st.w_q[..., p.c0:p.c1].data_ptr()
        assert p.s_w.data_ptr() == st.s_w[..., p.c0:p.c1].data_ptr()
        assert torch.equal(p.w_q, st.w_q[..., p.c0:p.c1])
    assert placed[1].pieces[2].w_q.shape == (1, 512, 256)
    # the reference's rule is Np % M: 640 splits over 2 there, stays whole
    # here (and a 384-wide state splits neither at model:4)
    assert tuple(js.fit_spec(JP(None, None, None, "model"), (2, 1, 512, 640),
                             AbstractMesh((2, 2), ("data", "model")))) == \
        (None, None, None, "model")
    with pytest.raises(ValueError, match="128-aligned"):
        ta.split_columns(st, [(0, 100), (100, 1024)], ["cpu", "cpu"])
    with pytest.raises(ValueError, match="cover"):
        ta.split_columns(st, [(0, 512)], ["cpu"])
