"""The port's sharded training on a mesh of positions, held to the JAX
package's own mesh code (`tests/torch_mesh_oracle.py`, one subprocess on 4
forced host-platform devices, meshes built with ``Auto`` axes):

  * `launch.steps.make_train_step` on a mesh against the reference's
    jitted `make_train_step` on the same numpy inputs (its seed-0 init, the
    seed-0 batch, rng [0, 0]): olmoe smoke digital on 2x2 (through
    `moe._moe_sharded`), olmoe and granite smoke noise-on on 1x2 and 2x2
    (K2 column pieces with read keys; the expert STE per position), arctic
    smoke with bf16 parameters and Adafactor on 2x2. Loss within 1e-5
    relative; every moment leaf (``mu``/``nu``, ``vr``/``vc``) and updated
    parameter within 1e-5 of its max|ref| (the f32 moments of a bf16
    parameter within BF16_MOMENT_TOL). Adam's first step moves a
    parameter by about lr x sign(g), so an entry whose gradient (``mu /
    (1 - b1)``) is under FLIP x its leaf's max may flip sign and is excused
    and counted (at most 0.1% of a leaf), as `test_torch_train.py` does. A
    bf16 parameter may differ by one bf16 ulp of its value where the f32
    values round apart. The noise-on steps run under the code replay
    (`torch_code_replay`), which must replay no DAC or programmed code:
    the draws are the reference's, so none rounds apart;
  * a 1x1 mesh equals ``mesh=None`` bit for bit;
  * `moe._moe_sharded` against the reference's `moe_ffn` under
    `use_mesh` on data:2,model:2 (outputs and aux within 1e-6 of max(1,
    max|y|)), with a capacity that overflows per shard;
  * `data.make_global_array` and `checkpoint.restore(mesh=, pspecs=)`
    block for block equal to the reference's shards;
  * column pieces are views of the codes; plain K2/K3/expert launches on a
    view piece with its column offset equal the whole's columns, noise on;
  * bf16 init is the f32 init rounded once;
  * ``train --mesh 2x2`` on the CPU resumes bit for bit.
"""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import collections
import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro_torch import compat
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import ShapeCell, get_arch
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core.noise import NoiseModel
from repro_torch.core.prng import PRNGKey
from repro_torch.data.pipeline import make_global_array
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import shardings as ts
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Execution
from repro_torch.optim.adamw import AdamWConfig
from torch_code_replay import replaying_in_port
from torch_mesh_oracle import MOE_CASES, SIGMA_READ, TRAIN_CASES

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
FLIP = 1e-5
# the f32 moments of a bf16 parameter (arctic's Adafactor vr/vc), of its
# max: the two frameworks' bf16 gradients differ by one bf16 ulp where
# their f32 matmul sums round apart. Worst reading 3.25e-5 (vc of wq);
# summing the bf16 embedding's scatter once in f32, where the reference
# adds it in bf16 per data shard, read 1.38e-4 on every leaf and 8.4e-3
# on vc of embed (CHANGES.md lists the planted faults it catches)
BF16_MOMENT_TOL = 1e-4


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_oracle")
    out, ck = tmp / "oracle.pkl", tmp / "ckpt"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_oracle.py"),
         "train", str(out), str(ck)], env=env, capture_output=True,
        text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0 and "ORACLE_OK" in proc.stdout, \
        proc.stderr[-3000:]
    with open(out, "rb") as f:
        res = pickle.load(f)
    res["ckpt"] = str(ck)
    return res


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), ["cpu"])


def _exe(mode):
    if mode == "noise":
        return Execution(mode="aimc", aimc=ta.AimcConfig(
            noise=NoiseModel(sigma_read=SIGMA_READ)), compute_dtype="float32")
    return Execution(compute_dtype="float32")


def _spec(arch):
    spec = get_arch(arch)
    return dataclasses.replace(spec, model_cfg=spec.smoke_cfg)


def _opt(fields):
    return opt_state_from_numpy(
        collections.namedtuple("State", list(fields))(**fields))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _f32(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32)


def _port_step(case, ref, mesh_shape=None):
    arch, mode, shape, gb, seq = TRAIN_CASES[case]
    spec = _spec(arch)
    cell = ShapeCell("t", seq_len=seq, global_batch=gb, kind="train")
    mesh = _mesh(mesh_shape or shape)
    step = tsteps.make_train_step(spec, cell, mesh, _exe(mode)).fn
    seen = {}
    ctx = (replaying_in_port(ref["log"], seen) if mode == "noise"
           else contextlib.nullcontext())
    with ctx:
        new_p, new_o, met = step(
            params_from_numpy(ref["params"]), _opt(ref["opt"]),
            {k: torch.from_numpy(v) for k, v in ref["batch"].items()},
            torch.tensor([0, 0], dtype=torch.int64))
    return ts.whole_tree(new_p), ts.whole_tree(new_o), met, seen


def _close(got, want, path, tol=TOL):
    """Within ``tol`` x max|want|."""
    want = _f32(want)
    lim = tol * max(float(np.abs(want).max()), 1e-30)
    err = np.abs(_f32(got) - want)
    assert (err <= lim).all(), (path, float(err.max()) / (lim / tol),
                                int((err > lim).sum()))


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_sharded_train_step_matches_reference_mesh_step(oracle, case):
    ref = oracle["train"][case]
    new_p, new_o, met, seen = _port_step(case, ref)
    ref["params_dtype"] = {p: v.dtype for p, v in _leaves(ref["params"])}
    assert float(met["loss"]) == pytest.approx(ref["loss"], rel=TOL)
    assert not any(seen.values()), seen
    opt = new_o._asdict()
    for field, tree in ref["new_opt"].items():
        if field == "step":
            assert int(_f32(opt["step"])) == int(tree) == 1
            continue
        got = dict(_leaves(opt[field]))
        for path, want in _leaves(tree):
            bf16 = str(ref["params_dtype"].get(path, "")) == "bfloat16"
            _close(got[path], want, f"{field}{path}",
                   BF16_MOMENT_TOL if bf16 else TOL)
    got = dict(_leaves(new_p))
    mu = dict(_leaves(ref["new_opt"].get("mu", {})))
    lr = AdamWConfig().lr
    for path, want in _leaves(ref["new_params"]):
        g, w = _f32(got[path]), _f32(want)
        bad = np.abs(g - w) > TOL * max(1.0, float(np.abs(w).max()))
        if str(want.dtype) == "bfloat16":        # one bf16 ulp of the value
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w),
                                                      1e-30))) - 7)
            bad &= np.abs(g - w) > ulp
        if path in mu:                           # Adam: excused sign flips
            m = np.abs(_f32(mu[path]))
            near0 = m < FLIP * m.max()
            assert not (bad & ~near0).any(), path
            assert np.abs(g - w)[bad].max(initial=0) <= 2.2 * lr, path
            assert bad.sum() <= max(1, bad.size // 1000), path
        else:
            assert not bad.any(), path
        assert got[path].dtype == getattr(torch, str(want.dtype)), path


def test_unit_mesh_step_equals_one_device_step(oracle):
    """A 1x1 mesh (the ambient mesh, the new trees placed by the specs)
    gives the trees of ``mesh=None`` bit for bit."""
    case = "olmoe-noise-1x2"
    ref = oracle["train"][case]
    arch, mode, _, gb, seq = TRAIN_CASES[case]
    spec = _spec(arch)
    cell = ShapeCell("t", seq_len=seq, global_batch=gb, kind="train")
    outs = []
    for mesh in (_mesh((1, 1)), None):
        step = tsteps.make_train_step(spec, cell, mesh, _exe(mode)).fn
        p, o, met = step(params_from_numpy(ref["params"]), _opt(ref["opt"]),
                         {k: torch.from_numpy(v)
                          for k, v in ref["batch"].items()},
                         torch.tensor([0, 0], dtype=torch.int64))
        outs.append((ts.whole_tree(p), ts.whole_tree(o), float(met["loss"])))
    (p1, o1, l1), (p0, o0, l0) = outs
    assert l1 == l0
    for (pa, a), (pb, b) in zip(_leaves([p1, list(o1)]),
                                _leaves([p0, list(o0)])):
        assert pa == pb and torch.equal(a, b), pa


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_sharded_matches_reference_under_mesh(oracle, case, monkeypatch):
    ref = oracle["moe"][case]
    ins = {k: torch.from_numpy(np.array(v)) for k, v in ref["inputs"].items()}
    calls = []
    real = tmoe._moe_sharded
    monkeypatch.setattr(tmoe, "_moe_sharded", lambda *a, **k: calls.append(
        1) or real(*a, **k))
    kw = dict(top_k=ref["top_k"], capacity_factor=MOE_CASES[case][1],
              exe=_exe("digital"))
    args = (ins["x"], ins["router_w"], ins["w_gate"], ins["w_up"],
            ins["w_down"])
    with compat.use_mesh(_mesh((2, 2))):
        y, aux = tmoe.moe_ffn(*args, **kw)
    tol = 1e-6 * max(1.0, float(np.abs(ref["y"]).max()))
    np.testing.assert_allclose(y.numpy(), ref["y"], rtol=0, atol=tol)
    assert float(aux) == pytest.approx(ref["aux"], abs=1e-6)
    assert calls
    y0, _ = tmoe.moe_ffn(*args, **kw)       # no mesh: global capacity
    if "overflow" in case:                  # per-shard capacity drops others
        assert not torch.allclose(y0, y)
    with compat.use_mesh(_mesh((1, 2))):    # one data position: unsharded
        y1, _ = tmoe.moe_ffn(*args, **kw)
    assert torch.equal(y1, y0)


def test_make_global_array_matches_reference(oracle):
    ref = oracle["placement"]
    mesh = _mesh((2, 2))
    glob = make_global_array(ref["batch"], mesh, ts.P(("data",), None))
    for k, shards in ref["global"].items():
        for pos, block in shards.items():
            assert np.array_equal(glob[k].piece(pos).numpy(), block), (k, pos)
        assert glob[k].base is not None


def test_restore_onto_mesh_matches_reference(oracle):
    ref = oracle["placement"]
    mesh = _mesh((2, 2))
    spec = get_arch("olmoe-1b-7b")
    target = {"params": spec.model_module().init(
        PRNGKey(0), spec.smoke_cfg, device="cpu")}
    pspecs = {"params": ts.fit_specs(
        ts.get_param_specs(target["params"], mesh), target["params"], mesh)}
    tree, _ = checkpoint.restore(oracle["ckpt"], 1, target, mesh, pspecs)
    leaves = {"embed": tree["params"]["embed"],
              "wq": tree["params"]["blocks"]["wq"],
              "we_down": tree["params"]["blocks"]["we_down"],
              "ln1": tree["params"]["blocks"]["ln1"]}
    for k, shards in ref["restored"].items():
        assert len({b.shape for b in shards.values()}) == 1
        for pos, block in shards.items():
            assert np.array_equal(leaves[k].piece(pos).numpy(), block), \
                (k, pos)


def test_column_pieces_are_views_of_the_codes():
    st = ta.program_stacked(torch.randn(2, 96, 512), ta.AimcConfig())
    split = ta.mesh_pieces(st, _mesh((2, 2)))
    assert [(p.c0, p.c1) for p in split.pieces] == [(0, 256), (256, 512)]
    for p in split.pieces:
        assert p.w_q.untyped_storage().data_ptr() == \
            st.w_q.untyped_storage().data_ptr()
        assert p.w_q.data_ptr() == st.w_q[..., p.c0:].data_ptr()
        assert p.s_w.data_ptr() == st.s_w[..., p.c0:].data_ptr()
    assert not ta.mesh_pieces(st, _mesh((2, 1))).pieces
    assert not ta.mesh_pieces(st, _mesh((1, 8))).pieces    # 512 % 1024


@pytest.mark.parametrize("source", ["counter", "hw"])
def test_plain_kernels_on_a_view_piece_equal_the_whole(source):
    """K2 (and K4 under "hw"), K3 and the expert entry on a column view
    with its offset: the whole launch's columns bit for bit, read noise
    on; each view launch also within 1e-5 x max(1, max|y|) of itself
    through the dispatch (`kernels.ops`)."""
    torch.manual_seed(0)
    st = ta.program_stacked(torch.randn(3, 700, 512), ta.AimcConfig())
    x = torch.randn(5, st.w_q.shape[-3] * st.w_q.shape[-2])
    s_x = (x.abs().max() / 127).reshape(1, 1)
    kw = dict(adc_step=ta.AimcConfig().adc_step, sigma=0.7)
    c0, c1 = 256, 512
    # "hw" has no CPU dispatch (the card's Philox); its plain version
    # takes the offset directly
    k2 = tops.aimc_matmul_v2 if source == "counter" else \
        tref.aimc_matmul_ref_v2
    whole = tref.aimc_matmul_ref_v2(x, st.w_q[0], st.s_w[0], s_x, 11,
                                    noise_source=source, **kw)
    piece = k2(x, st.w_q[0][..., c0:c1], st.s_w[0][..., c0:c1], s_x, 11,
               noise_source=source, col0=c0, nc=512, **kw)
    assert torch.equal(piece, whole[:, c0:c1])
    off = k2(x, st.w_q[0][..., c0:c1], st.s_w[0][..., c0:c1], s_x, 11,
             noise_source=source, **kw)
    assert not torch.equal(off, whole[:, c0:c1])    # no offset: other noise
    if source == "hw":
        return
    g_whole = tref.aimc_matmul_stacked_ref(x, st.w_q, st.s_w, s_x, 5, **kw)
    g_piece = tops.aimc_matmul_stacked(x, st.w_q[..., c0:c1],
                                       st.s_w[..., c0:c1], s_x, 5, col0=c0,
                                       nc=512, **kw)
    assert torch.equal(g_piece, g_whole[..., c0:c1])
    xe = torch.randn(3, 4, x.shape[1])
    sxe = xe.abs().amax(dim=(1, 2)) / 127
    e_whole = tref.aimc_matmul_experts_ref(xe, st.w_q, st.s_w, sxe,
                                           [1, 2, 3], **kw)
    e_piece = tops.aimc_matmul_experts(xe, st.w_q[..., c0:c1],
                                       st.s_w[..., c0:c1], sxe, [1, 2, 3],
                                       col0=c0, nc=512, **kw)
    assert torch.equal(e_piece, e_whole[..., c0:c1])


def test_bf16_init_is_the_f32_init_rounded_once():
    """arctic smoke in bf16: every leaf is the port's f32 init rounded to
    bf16 bit for bit (one matrix at a time, the whole f32 tree never
    built), and that f32 init is the reference's, so every bf16 leaf is the
    reference's f32 init ``astype(bfloat16)`` bit for bit."""
    spec = get_arch("arctic-480b")
    model = spec.model_module()
    p16 = model.init(PRNGKey(0), spec.smoke_cfg, dtype=torch.bfloat16,
                     device="cpu")
    p32 = model.init(PRNGKey(0), spec.smoke_cfg, device="cpu")
    j32 = jget("arctic-480b").model_module().init(jax.random.PRNGKey(0),
                                                  spec.smoke_cfg)
    j16 = jax.tree.map(lambda a: np.asarray(a.astype("bfloat16")), j32)
    j32 = dict(_leaves(jax.tree.map(np.asarray, j32)))
    got16, got32 = dict(_leaves(p16)), dict(_leaves(p32))
    for path, want in _leaves(j16):
        assert got16[path].dtype == torch.bfloat16, path
        assert torch.equal(got16[path], got32[path].to(torch.bfloat16)), path
        np.testing.assert_array_equal(_f32(got32[path]), j32[path],
                                      err_msg=path)
        np.testing.assert_array_equal(_f32(got16[path]),
                                      want.astype(np.float32), err_msg=path)


def test_bf16_embedding_gradient_is_the_reference_scatter():
    """A bf16 table's lookup gradient equals the reference's bit for bit
    (one device: the bf16 scatter-add in token order) on skewed tokens,
    one of them repeated over a hundred times."""
    from repro_torch.models.layers import embed_lookup
    rng = np.random.default_rng(1)
    v, d = 128, 56
    tab = np.asarray(jax.numpy.asarray(
        rng.standard_normal((v, d)) * 0.02, "bfloat16").astype("float32"))
    tok = rng.zipf(1.3, (8, 64)) % v
    ct = rng.standard_normal((8, 64, d)).astype(np.float32)
    assert np.bincount(tok.ravel()).max() > 100

    def f(t):
        return jax.numpy.sum(jax.numpy.take(t, tok, axis=0).astype(
            "float32") * ct)
    want = np.asarray(jax.grad(f)(jax.numpy.asarray(tab, "bfloat16"))
                      .astype("float32"))
    t = torch.tensor(tab).to(torch.bfloat16).requires_grad_(True)
    (embed_lookup(t, torch.tensor(tok), torch.float32)
     * torch.tensor(ct)).sum().backward()
    assert t.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.grad.float().numpy(), want)


def test_train_cli_on_2x2_resumes_bit_for_bit(tmp_path):
    base = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
            "--mesh", "2x2", "--global-batch", "16", "--log-every", "1"]
    full = ttrain.main(base + ["--steps", "4"])
    ck = str(tmp_path / "ck")
    first = ttrain.main(base + ["--steps", "2", "--ckpt-dir", ck])
    resumed = ttrain.main(base + ["--steps", "4", "--ckpt-dir", ck])
    assert resumed.start == 2
    assert [first.losses[s] for s in (0, 1)] == [full.losses[s]
                                                for s in (0, 1)]
    assert [resumed.losses[s] for s in (2, 3)] == [full.losses[s]
                                                  for s in (2, 3)]
    for (pa, a), (pb, b) in zip(_leaves(resumed.params),
                                _leaves(full.params)):
        assert pa == pb and torch.equal(a, b), pa
