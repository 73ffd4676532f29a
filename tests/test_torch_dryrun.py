"""The port's dry run (`repro_torch.launch.dryrun`) against bytes reckoned
from the JAX package's own cells.

For every (arch, shape) of `configs.all_cells` on the single production
mesh (16x16), two cells on the multi-pod mesh (2x16x16) and two int8
cells, the port's per-position argument bytes (and each input's share)
equal the bytes reckoned from the reference's `make_step` on a
`jax.sharding.AbstractMesh` of the same shape (no devices): its
``abstract_inputs`` (`jax.eval_shape` trees) laid out by its
``in_shardings`` (`get_param_specs` / `get_opt_specs` / `batch_specs` /
`cache_specs`, `fit_specs`, `strip_fsdp`), each leaf's shard shape times
its item size. A train cell's [2] key is replicated (``P()``) in both
bundles; the port holds its two uint32 words in int64, so its 16 bytes
are twice the reference's 8. The model FLOPs per position are
`modelstats`' over the positions. Every cell is counted
(`launch.stepstats`): FLOPs and bytes per position, temporary and output
bytes, a peak at least the arguments, collectives (a train cell's
gradient reduction), the roofline and the useful ratio are present and
non-negative. A cell that fails is recorded with ``ok: false`` and the
sweep goes on; the CLI then exits 1. `repro.launch.dryrun` is never
imported here: it sets XLA's host device count at import.

Tolerance: bytes equal (integers)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models.layers import Execution as JExe
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.modelstats import model_flops

NAMES = {"train": ("params", "opt_state", "batch", "rng"),
         "prefill": ("params", "batch"), "decode": ("params", "cache",
                                                    "tokens")}


def _ref_bytes(arch, shape, multi, int8=False):
    """{input: bytes per position} of the reference's cell."""
    sizes, axes = (((2, 16, 16), ("pod", "data", "model")) if multi
                   else ((16, 16), ("data", "model")))
    mesh = AbstractMesh(sizes, axes)
    cell = jconfigs.SHAPES[shape]
    bundle = jsteps.make_step(jconfigs.get_arch(arch), cell, mesh,
                              JExe(serve_int8=int8))
    dims = dict(zip(axes, sizes))
    out = {}
    for name, tree, specs in zip(NAMES[cell.kind], bundle.abstract_inputs,
                                 bundle.in_shardings):
        leaves = jax.tree_util.tree_leaves(tree)
        spec_leaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(leaves) == len(spec_leaves), (arch, shape, name)
        total = 0
        for x, s in zip(leaves, spec_leaves):
            shp = list(x.shape)
            for d, e in enumerate(s):
                if e is not None:
                    shp[d] //= math.prod(dims[a] for a in (
                        e if isinstance(e, tuple) else (e,)))
            total += math.prod(shp) * np.dtype(x.dtype).itemsize
        out[name] = total
    if "rng" in out:           # the port's key: two uint32 words in int64
        out["rng"] *= 2
    return out


def _counted(rec):
    """The counted fields of a record: present, non-negative, the peak at
    least the arguments and the sum of its parts; a train cell reduces its
    gradients."""
    m, r = rec["memory"], rec["roofline"]
    for k in ("output_bytes", "temp_bytes", "peak_bytes"):
        assert m[k] >= 0, (k, m)
    assert m["peak_bytes"] >= m["argument_bytes"]
    assert m["peak_bytes"] == pytest.approx(
        m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"])
    assert m["fits"] == (m["peak_bytes"] <= rec["card"]["memory_bytes"])
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["xla_flops_raw"] is None and rec["xla_bytes_raw"] is None
    assert rec["hlo_flops"] == pytest.approx(
        sum(rec["flops_by_class"].values()))
    assert 0 < rec["useful_ratio"] == pytest.approx(
        rec["model_flops_per_position"] / rec["hlo_flops"])
    coll = rec["collectives"]
    assert all(v >= 0 for v in coll.values())
    assert coll["total"] == pytest.approx(
        sum(v for k, v in coll.items() if k != "total"))
    if rec["kind"] == "train":
        assert coll["total"] > 0
    for k in ("compute_s", "memory_s", "collective_s", "step_s_bound",
              "roofline_fraction"):
        assert r[k] >= 0, (k, r)
    assert r["step_s_bound"] == max(r["compute_s"], r["memory_s"],
                                    r["collective_s"])


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = dryrun.main(["--all", "--out", str(out)])
    return {(r["arch"], r["shape"]): r for r in recs}, out


def test_every_cell_matches_reference_bytes(single):
    recs, out = single
    cells = tconfigs.all_cells()
    assert len(recs) == len(cells)
    for arch, shape in cells:
        spec = tconfigs.get_arch(arch)
        rec = recs[(spec.arch_id, shape)]
        assert rec["ok"] and rec["positions"] == 256, rec
        assert rec["fold"] == "256 positions on 1 device (meta)"
        want = _ref_bytes(spec.arch_id, shape, False)
        assert rec["memory"]["argument_parts"] == want, (arch, shape)
        assert rec["memory"]["argument_bytes"] == sum(want.values())
        assert rec["model_flops_per_position"] == model_flops(
            spec, tconfigs.SHAPES[shape]) / 256
        _counted(rec)
        saved = json.loads((out / f"{spec.arch_id}.{shape}.single.digital."
                            "baseline.json").read_text())
        assert saved["memory"] == rec["memory"]


@pytest.mark.parametrize("arch,shape,multi,exec_mode", [
    ("olmoe-1b-7b", "train_4k", True, "digital"),
    ("qwen1.5-110b", "decode_32k", True, "digital"),
    ("granite-8b", "decode_32k", False, "int8"),
    ("llama3.2-3b", "prefill_32k", False, "int8")])
def test_cells_match_reference_bytes(arch, shape, multi, exec_mode):
    rec = dryrun.run_cell(arch, shape, multi, exec_mode, save=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["positions"] == (512 if multi else 256)
    want = _ref_bytes(tconfigs.get_arch(arch).arch_id, shape, multi,
                      int8=exec_mode == "int8")
    assert rec["memory"]["argument_parts"] == want
    _counted(rec)


def test_failing_cell_is_recorded_and_cli_exits_1(monkeypatch, tmp_path):
    real = tsteps.make_step

    def broken(spec, cell, *a, **k):
        if cell.kind == "decode":
            raise RuntimeError("planted")
        return real(spec, cell, *a, **k)
    monkeypatch.setattr(tsteps, "make_step", broken)
    rec = dryrun.run_cell("granite-8b", "decode_32k", False, save=False)
    assert rec["ok"] is False and "planted" in rec["error"]
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "granite-8b", "--out", str(tmp_path)])
    assert exc.value.code == 1
    saved = json.loads((tmp_path / "granite_8b.train_4k.single.digital."
                        "baseline.json").read_text())
    assert saved["ok"]        # the sweep went on past the failure


def test_card_figures():
    """Without a card: the H100 SXM's figures from the table; with one,
    its own name and memory."""
    cd = dryrun.card()
    if torch.cuda.is_available():
        assert cd["source"] == "device"
        assert cd["name"] == torch.cuda.get_device_name(0)
        return
    assert cd["name"] == dryrun.DEFAULT_CARD and cd["source"] == "table"
    assert (cd["hbm_bytes_s"], cd["bf16_flops"], cd["int8_ops"],
            cd["memory_bytes"]) == (3.35e12, 989e12, 1979e12, 80e9)
