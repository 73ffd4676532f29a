"""The port's data pipeline (`repro_torch/data/pipeline.py`) and
checkpointing (`repro_torch/checkpoint/checkpoint.py`) against the JAX
reference, and the port's versions of `tests/test_substrate.py`'s data and
checkpoint tests.

Pinned: `host_batch` (synthetic and token-file backends) and a restarted
`DataIterator` equal the reference's bit for bit; a checkpoint directory
written by the JAX package's `checkpoint.save` (bf16 leaves stored as
uint16 views, an AdamW state's NamedTuple fields) restores in the port to
the same values and dtypes, the port's own directory carries the same
manifest names and restores in the JAX package; ``mesh=`` raises."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.data import pipeline as jdata
from repro.optim import make_optimizer as jmake
from repro_torch.checkpoint import checkpoint
from repro_torch.data import pipeline as tdata
from repro_torch.data.pipeline import DataConfig, DataIterator, host_batch
from repro_torch.optim import make_optimizer as tmake

CFG = DataConfig(vocab=1000, seq_len=64, global_batch=8)


@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (3, 1, 2),
                                                 (17, 3, 4)])
def test_host_batch_equals_reference(step, shard, n_shards):
    jcfg = jdata.DataConfig(vocab=1000, seq_len=64, global_batch=8, seed=5)
    tcfg = DataConfig(vocab=1000, seq_len=64, global_batch=8, seed=5)
    a = jdata.host_batch(jcfg, step, shard, n_shards)
    b = tdata.host_batch(tcfg, step, shard, n_shards)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


def test_tokenfile_batch_equals_reference(tmp_path):
    path = tmp_path / "toks.bin"
    np.random.default_rng(0).integers(0, 500, 10_000).astype(
        np.uint32).tofile(path)
    kw = dict(vocab=500, seq_len=32, global_batch=4, backend="tokenfile",
              path=str(path))
    a = jdata.host_batch(jdata.DataConfig(**kw), 2, 0, 1)
    b = tdata.host_batch(DataConfig(**kw), 2, 0, 1)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_iterator_restart_equals_reference():
    jit_ = jdata.DataIterator(jdata.DataConfig(vocab=1000, seq_len=64,
                                               global_batch=8), 2, 1)
    it = DataIterator(CFG, n_shards=2, shard=1)
    for _ in range(3):
        np.testing.assert_array_equal(next(jit_)["tokens"],
                                      next(it)["tokens"])
    it2 = DataIterator(CFG, n_shards=2, shard=1)
    it2.restore(it.state())
    np.testing.assert_array_equal(next(it2)["tokens"], next(jit_)["tokens"])


# the port's versions of tests/test_substrate.py's data tests

def test_data_deterministic():
    b1 = host_batch(CFG, step=3, shard=0, n_shards=2)
    b2 = host_batch(CFG, step=3, shard=0, n_shards=2)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])


def test_data_step_and_shard_vary():
    b0 = host_batch(CFG, 0, 0, 2)
    assert not np.array_equal(b0["tokens"], host_batch(CFG, 1, 0, 2)["tokens"])
    assert not np.array_equal(b0["tokens"], host_batch(CFG, 0, 1, 2)["tokens"])


def test_data_shapes_and_labels():
    b = host_batch(CFG, 0, 0, 2)
    assert b["tokens"].shape == (4, 64)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert b["tokens"].max() < CFG.vocab


def test_iterator_restart_exact():
    it = DataIterator(CFG, n_shards=2, shard=1)
    for _ in range(3):
        next(it)
    state = it.state()
    it2 = DataIterator(CFG, n_shards=2, shard=1)
    it2.restore(state)
    np.testing.assert_array_equal(next(it)["tokens"], next(it2)["tokens"])
    assert state == {"step": 3}


# checkpointing: the port's versions of tests/test_substrate.py's tests

def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16) * 1.5},
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    return [v for _, v in checkpoint._flatten_with_names(tree)]


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    checkpoint.save(str(tmp_path), 7, t, extra={"loss": 1.5})
    assert checkpoint.latest_step(str(tmp_path)) == 7
    restored, extra = checkpoint.restore(str(tmp_path), 7, t)
    assert extra == {"loss": 1.5}
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_checkpoint_atomic_no_partial(tmp_path):
    checkpoint.save(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert checkpoint.latest_step(str(tmp_path)) == 1


def test_checkpoint_gc_keeps_three(tmp_path):
    for s in range(5):
        checkpoint.save(str(tmp_path), s, _tree())
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000002", "step_00000003", "step_00000004"]
    assert checkpoint.latest_step(str(tmp_path)) == 4


def test_checkpoint_restore_latest_empty(tmp_path):
    step, tree, extra = checkpoint.restore_latest(str(tmp_path), _tree())
    assert step is None and tree is None and extra is None


def test_checkpoint_shape_mismatch_raises(tmp_path):
    t = _tree()
    checkpoint.save(str(tmp_path), 1, t)
    bad = {"params": {"w": torch.zeros((2, 2)), "b": t["params"]["b"]},
           "step": t["step"]}
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(str(tmp_path), 1, bad)


def test_checkpoint_save_async(tmp_path):
    t = _tree()
    th = checkpoint.save_async(str(tmp_path), 3, t)
    t["params"]["w"].add_(1.0)        # the snapshot was taken at the call
    th.join(timeout=30)
    assert checkpoint.latest_step(str(tmp_path)) == 3
    restored, _ = checkpoint.restore(str(tmp_path), 3, t)
    assert torch.equal(restored["params"]["w"],
                       torch.arange(12.0).reshape(3, 4))


def test_checkpoint_mesh_restore_raises(tmp_path):
    """Restoring onto a mesh raises where a leaf's shape differs from the
    target's, as a plain restore does; otherwise each leaf comes back
    placed by its spec (views of one whole tensor per leaf)."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import shardings as ts
    m = tmesh.make_mesh((2, 2), ("data", "model"), ["cpu"])
    tree = _tree()
    checkpoint.save(str(tmp_path), 1, tree)
    specs = ts.tree_map(lambda x: ts.P(*(["data"] + [None] * (x.dim() - 1))
                                       if x.dim() else ()), tree)
    bad = ts.tree_map(lambda x: torch.zeros(tuple(s + 1 for s in x.shape),
                                            dtype=x.dtype), tree)
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore_latest(str(tmp_path), bad, mesh=m, pspecs=specs)
    got, placed, _ = checkpoint.restore_latest(str(tmp_path), tree, mesh=m,
                                               pspecs=specs)
    assert got == 1
    ts.tree_map(lambda p, x: _same_placed(p, x), placed, tree,
                is_leaf=ts.is_placed)


def _same_placed(p, x):
    assert ts_is_views(p) and torch.equal(p.whole(), x)


def ts_is_views(p):
    return p.base is not None and all(
        t.untyped_storage().data_ptr() == p.base.untyped_storage().data_ptr()
        for t in p.pieces.values())


# across the two packages

def _state_pair(name):
    rng = np.random.default_rng(3)
    p = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
         "blocks": {"wq": rng.standard_normal((2, 4, 4)).astype(np.float32),
                    "ln1": np.ones((2, 4), np.float32)},
         "half": rng.standard_normal((5,)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p)
    jp["half"] = jp["half"].astype(jnp.bfloat16)
    jinit, jupd, _ = jmake(name)
    js = jinit(jp)
    g = jax.tree.map(lambda x: jnp.ones_like(x) * 0.1, jp)
    jp, js, _ = jupd(g, js, jp)
    tp = {"embed": torch.zeros((6, 4)),
          "blocks": {"wq": torch.zeros((2, 4, 4)),
                     "ln1": torch.zeros((2, 4))},
          "half": torch.zeros(5, dtype=torch.bfloat16)}
    return {"params": jp, "opt": js}, {"params": tp,
                                       "opt": tmake(name)[0](tp)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_reference_checkpoint_restores_in_port(tmp_path, name):
    jtree, target = _state_pair(name)
    jck.save(str(tmp_path), 4, jtree, extra={"loss": 2.0})
    step, tree, extra = checkpoint.restore_latest(str(tmp_path), target)
    assert step == 4 and extra == {"loss": 2.0}
    jflat = dict(zip(*jck._flatten_with_names(jtree)[:2]))
    tflat = dict(checkpoint._flatten_with_names(tree))
    assert sorted(jflat) == sorted(tflat)
    for name_, jleaf in jflat.items():
        t = tflat[name_]
        assert str(t.dtype).removeprefix("torch.") == str(jleaf.dtype), name_
        np.testing.assert_array_equal(
            t.to(torch.float32).numpy(), np.asarray(jleaf, np.float32),
            err_msg=name_)


def test_port_checkpoint_restores_in_reference(tmp_path):
    """The same manifest names, files and dtypes the other way round."""
    jtree, target = _state_pair("adamw")
    checkpoint.save(str(tmp_path), 2, target)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        names = [e["name"] for e in json.load(f)["leaves"]]
    assert names == jck._flatten_with_names(jtree)[0]
    restored, _ = jck.restore(str(tmp_path), 2, jtree)
    for jleaf, tleaf in zip(jax.tree.leaves(restored), _leaves(target)):
        assert str(jleaf.dtype) == str(tleaf.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(np.asarray(jleaf, np.float32),
                                      tleaf.to(torch.float32).numpy())
