"""The port's one-device train step (`launch.steps.make_train_step`) and
train CLI (`launch.train.main`) against the same step composed from the
JAX package's parts: ``key = fold_in(rng, i)`` per microbatch,
`jax.value_and_grad` of the per-microbatch loss (forward + `chunked_ce` +
0.01 x aux), f32 accumulation ``g_acc + g / n_micro`` and one
``opt_update``, as `repro/launch/steps.py:144-220` composes them (its own
jitted step asserts under this jax's explicit mesh, so it cannot be run).
JAX runs ``impl="ref"``, no mesh.

Tolerances: losses within 1e-5 relative; accumulated gradients per leaf
within GTOL x max|ref leaf| (GTOL = 1e-5). Parameters after an AdamW
step within 1e-5 x max(1, max|ref|), except where a gradient entry is
near zero: Adam's first step moves a parameter by about lr x sign(g), so
an entry whose reference gradient is under FLIP x max|g leaf| (FLIP =
1e-5, the gradients' agreement) may flip its sign and move by 2 x lr;
such entries are excused and counted (at most 0.1% of a leaf). The train
step test feeds each step the reference's parameters and optimizer state
(carried by `convert`), so every step is held on identical inputs; the
CLI runs free for 4 steps and its losses are held to the reference
loop's: the first within 1e-5 relative, the later ones within 1e-5
digitally and CLI_AIMC_RTOL = 1e-4 on the AIMC path. There a flipped
near-zero-gradient entry (2 x lr = 6e-4 away from the reference's) still
leaves the digital loss flat, but can move a programmed code (round(w /
s_w)) and with it the next steps' losses by ~1e-5 to 5e-5 relative."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core.noise import NoiseModel as JNM
from repro.data.pipeline import DataConfig, host_batch
from repro.launch.steps import chunked_ce as jce
from repro.models import transformer as jt
from repro.models.layers import Execution as JExe
from repro.optim import make_optimizer as jmake
from repro_torch.configs import ShapeCell
from repro_torch.configs import get_arch as tget
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import prng
from repro_torch.core.noise import NoiseModel as TNM
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.layers import Execution as TExe
from repro_torch.optim import make_optimizer as tmake
from repro_torch.optim.adamw import tree_leaves
from torch_code_replay import logging_reference, replaying_in_port

GTOL = 1e-5
FLIP = 1e-5
CLI_AIMC_RTOL = 1e-4


def _grad_fn(spec, exe):
    """jit(value_and_grad) of the reference's per-microbatch loss."""
    cfg = spec.smoke_cfg

    def micro_loss(p, mb, key):
        h, aux = jt.forward(p, mb["tokens"], cfg, exe, key,
                            return_hidden=True)
        ls, n = jce(h, jt.unembed_matrix(p, cfg), mb["labels"])
        loss = ls / jnp.maximum(n, 1.0)
        return loss + 0.01 * aux, loss

    return jax.jit(jax.value_and_grad(micro_loss, has_aux=True))


def _ref_step(grad_fn, opt_update, params, opt_state, batch, rng, n_micro):
    """The reference's train_step body, composed from its parts."""
    micro = jax.tree.map(
        lambda x: x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:]),
        batch)
    g_acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    loss_acc = 0.0
    for i in range(n_micro):
        mb = jax.tree.map(lambda x: x[i], micro)
        (_, loss), g = grad_fn(params, mb, jax.random.fold_in(rng, i))
        g_acc = jax.tree.map(lambda a, b: a + b.astype(jnp.float32) / n_micro,
                             g_acc, g)
        loss_acc = loss_acc + loss / n_micro
    new_p, new_s, _ = opt_update(g_acc, opt_state, params, 1.0)
    return new_p, new_s, float(loss_acc), g_acc


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@pytest.fixture(scope="module")
def olmoe_noisy():
    spec = get_arch("olmoe_1b_7b")
    jexe = JExe(mode="aimc", aimc=ja.AimcConfig(
        impl="ref", noise=JNM(sigma_read=0.002)), compute_dtype="float32")
    texe = TExe(mode="aimc", aimc=ta.AimcConfig(noise=TNM(sigma_read=0.002)),
                compute_dtype="float32")
    return spec, jexe, texe, _grad_fn(spec, jexe)


def test_train_step_matches_composed_reference(olmoe_noisy, monkeypatch):
    """olmoe-1b-7b smoke, AIMC noise on, global batch 8 at microbatch 4:
    n_micro = 2; two steps, each from the reference's state."""
    spec, jexe, texe, grad_fn = olmoe_noisy
    cfg = spec.smoke_cfg
    tspec = tget("olmoe_1b_7b")
    tspec = dataclasses.replace(tspec, model_cfg=tspec.smoke_cfg)
    cell = ShapeCell("t", seq_len=32, global_batch=8, kind="train")
    seen = {}
    real = tmake

    def spy(name, **kw):
        init, upd, c = real(name, **kw)

        def upd_spy(g, s, p, lr=1.0):
            seen["grads"] = g
            return upd(g, s, p, lr)
        return init, upd_spy, c

    monkeypatch.setattr(tsteps, "make_optimizer", spy)
    step_fn = tsteps.make_train_step(tspec, cell, None, texe).fn
    jinit, jupd, _ = jmake(spec.optimizer)
    jparams = jt.init(jax.random.PRNGKey(0), cfg)
    jstate = jinit(jparams)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
    flips = 0
    for step in range(2):
        batch = host_batch(dcfg, step, 0, 1)
        rng = jnp.asarray([0, step], jnp.uint32)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
        tstate = opt_state_from_numpy(jax.tree.map(np.asarray, jstate))
        jparams, jstate, jloss, jg = _ref_step(
            grad_fn, jupd, jparams, jstate,
            jax.tree.map(jnp.asarray, batch), rng, 2)
        tparams, tstate, metrics = step_fn(
            tparams, tstate, {k: torch.from_numpy(v) for k, v in
                              batch.items()},
            torch.tensor([0, step], dtype=torch.int64))
        assert float(metrics["loss"]) == pytest.approx(jloss, rel=1e-5)
        tg = dict(_leaves(seen["grads"]))
        for path, g in _leaves(jax.tree.map(np.asarray, jg)):
            np.testing.assert_allclose(
                _np(tg[path]), g, rtol=0,
                atol=GTOL * max(float(np.abs(g).max()), 1e-30), err_msg=path)
        tp = dict(_leaves(tparams))
        for path, jp in _leaves(jax.tree.map(np.asarray, jparams)):
            g = np.asarray(dict(_leaves(jg))[path])
            bad = np.abs(_np(tp[path]) - jp) > 1e-5 * max(1.0,
                                                          np.abs(jp).max())
            near0 = np.abs(g) < FLIP * np.abs(g).max()
            assert not (bad & ~near0).any(), path
            flips += int(bad.sum())
            assert bad.sum() <= max(1, bad.size // 1000), path
        assert int(tstate.step) == step + 1
    assert flips <= 50, f"{flips} excused sign flips"


def _ref_cli_losses(arch, exe, grad_fn, steps, gb=4, sl=32):
    """The reference CLI's loop (`repro/launch/train.py:115-155`) composed
    from its parts: data, rng [seed, step], lr_scale 1."""
    spec = get_arch(arch)
    cfg = spec.smoke_cfg
    n_micro = max(1, gb // spec.microbatch)
    jinit, jupd, _ = jmake(spec.optimizer)
    params = jt.init(jax.random.PRNGKey(0), cfg)
    state = jinit(params)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=sl, global_batch=gb, seed=0)
    losses = []
    for step in range(steps):
        batch = jax.tree.map(jnp.asarray, host_batch(dcfg, step, 0, 1))
        params, state, loss, _ = _ref_step(
            grad_fn, jupd, params, state, batch,
            jnp.asarray([0, step], jnp.uint32), n_micro)
        losses.append(loss)
    return losses


@pytest.fixture(scope="module")
def cli_refs():
    out = {}
    for arch, mode in (("olmoe_1b_7b", "aimc"), ("llama32_3b", "digital")):
        exe = (JExe(mode="aimc", aimc=ja.AimcConfig(impl="ref"),
                    compute_dtype="float32") if mode == "aimc"
               else JExe(compute_dtype="float32"))
        out[arch] = _ref_cli_losses(arch, exe, _grad_fn(get_arch(arch), exe),
                                    4)
    return out


@pytest.mark.parametrize("arch,flags", [
    ("olmoe-1b-7b", ["--exec", "aimc"]), ("llama3.2-3b", [])],
    ids=["olmoe-aimc", "llama-digital"])
def test_cli_losses_match_reference_loop(arch, flags, cli_refs, tmp_path):
    """`main([--smoke --device cpu --steps 4 ...])`: olmoe with --exec aimc
    (the reference CLI's noise-off AIMC, n_micro 1) and llama3.2-3b
    digitally (microbatch 1: n_micro 4); every step's loss against the
    reference loop's, and it learns (last < first)."""
    run = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "4", "--log-every", "1",
                       "--ckpt-dir", str(tmp_path), *flags])
    want = cli_refs[arch.replace("-", "_").replace(".", "")]
    got = [run.losses[s] for s in range(4)]
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    np.testing.assert_allclose(got[1:], want[1:],
                               rtol=CLI_AIMC_RTOL if flags else 1e-5)
    assert got[-1] < got[0]


def test_cli_resume_continues_from_checkpoint(tmp_path):
    """A run stopped after step 2 and resumed from --ckpt-dir gives steps
    3 and 4 the uninterrupted run's losses bit for bit (CPU), restores the
    saved trees exactly, and keeps the final save."""
    base = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
            "--exec", "aimc", "--ckpt-every", "2", "--log-every", "1"]
    full = ttrain.main(base + ["--steps", "4", "--ckpt-dir",
                               str(tmp_path / "a")])
    first = ttrain.main(base + ["--steps", "2", "--ckpt-dir",
                                str(tmp_path / "b")])
    second = ttrain.main(base + ["--steps", "4", "--ckpt-dir",
                                 str(tmp_path / "b")])
    assert second.start == 2 and sorted(second.losses) == [2, 3]
    assert [second.losses[s] for s in (2, 3)] == [full.losses[s]
                                                  for s in (2, 3)]
    assert [first.losses[s] for s in (0, 1)] == [full.losses[s]
                                                 for s in (0, 1)]
    for a, b in zip(_leaves(full.params), _leaves(second.params)):
        assert torch.equal(a[1], b[1]), a[0]
    from repro_torch.checkpoint import checkpoint
    assert checkpoint.latest_step(str(tmp_path / "b")) == 4


@pytest.mark.parametrize("argv", [
    ["--arch", "llama3.2-3b", "--mesh", "2x1"],
    ["--arch", "arctic-480b"]],
    ids=["mesh", "bf16-params"])
def test_cli_refuses_what_is_not_ported(argv):
    """What the CLI refused until sharded training was ported (a mesh
    other than 1x1, bf16 parameters) now trains one finite step; a mesh
    spelling the reference does not parse is still refused."""
    run = ttrain.main(argv + ["--smoke", "--device", "cpu", "--steps", "1"])
    assert np.isfinite(run.losses[0])
    with pytest.raises(SystemExit, match="DxM"):
        ttrain.main(argv[:2] + ["--mesh", "2x2x2x2", "--smoke", "--device",
                                "cpu", "--steps", "1"])


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "xlstm-350m",
                                  "recurrentgemma-9b"],
                         ids=["audio", "xlstm", "rglru"])
def test_cli_trains_recurrent_and_encdec(arch):
    """The families the CLI refused before this slice train at their smoke
    configs: 4 digital steps with finite losses, the last below the first
    (the reference CLI's bar), and 2 --exec aimc steps (noise off, as the
    reference CLI) with finite losses. The audio batch is the reference
    CLI's: zero frames and max(seq // 8, 64) target positions."""
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--log-every", "1"]
    run = ttrain.main(base + ["--steps", "4"])
    losses = [run.losses[s] for s in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    aimc = ttrain.main(base + ["--steps", "2", "--exec", "aimc"])
    assert all(np.isfinite([aimc.losses[s] for s in range(2)]))


@pytest.mark.parametrize("argv,match", [
    (["--arch", "seamless-m4t-large-v2", "--layers", "2"], "two stacks|stack"),
    (["--arch", "xlstm-350m", "--layers", "3"], "even")],
    ids=["audio", "xlstm-odd"])
def test_cli_layers_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        ttrain.main(argv + ["--smoke", "--device", "cpu", "--steps", "1"])


def _family_grad_fn(spec, exe):
    """jit(value_and_grad) of the reference's per-microbatch loss for any
    family (`repro/launch/steps.py:131-133`: the audio forward takes the
    whole batch)."""
    cfg, model = spec.smoke_cfg, spec.model_module()

    def micro_loss(p, mb, key):
        x = mb if spec.family == "audio" else mb["tokens"]
        h, aux = model.forward(p, x, cfg, exe, key, return_hidden=True)
        ls, n = jce(h, model.unembed_matrix(p, cfg), mb["labels"])
        loss = ls / jnp.maximum(n, 1.0)
        return loss + 0.01 * aux, loss

    return jax.jit(jax.value_and_grad(micro_loss, has_aux=True))


def _hold_micro(t_loss, j_loss, tg, jg, tparams):
    """A microbatch's loss within 1e-5 relative and every gradient leaf
    within GTOL x max|ref leaf|."""
    assert t_loss == pytest.approx(j_loss, rel=1e-5)
    got = dict(_leaves(tsteps._tree_with(tparams, list(tg))))
    for path, g in _leaves(jax.tree.map(np.asarray, jg)):
        err = float(np.abs(_np(got[path]) - g).max())
        tol = GTOL * max(float(np.abs(g).max()), 1e-30)
        assert err <= tol, (path, err, tol)


@pytest.mark.parametrize("arch", ["xlstm_350m", "recurrentgemma_9b",
                                  "seamless_m4t_large_v2"])
def test_train_step_matches_composed_reference_families(arch, monkeypatch):
    """One AIMC noise-on step (sigma_read 0.002) of xlstm, rglru and the
    enc-dec model at their smoke configs, global batch 2 at microbatch 1
    (n_micro 2, microbatch i under fold_in(rng, i)), from the reference's
    state. Per microbatch, the port's `make_micro_grad` against the
    reference's value_and_grad: the loss within 1e-5 relative and every
    gradient leaf within GTOL x max|ref leaf|. The reference runs first
    and logs the values its DAC and programming codes round from; the port
    replays the reference's codes (`tests/torch_code_replay.py`), so a
    code that the frameworks' f32 values (an ulp apart) round the other
    way at a tie takes the reference's value and is counted, and a code
    that differs away from a tie fails. Nothing is excused. (Here xlstm
    replays one programmed weight code, in microbatch 0's forward and
    again in its recompute; rglru and the enc-dec model replay none. The
    draws are the reference's bit for bit; the tie comes from the noise's
    arithmetic around them, which XLA fuses into multiply-adds under the
    reference's jit, ``sigma_min + (sigma_max - sigma_min) * level`` and
    ``codes + sigma * z``. Without the replay xlstm's microbatch 0 loss is
    1.0e-4 relative from the reference's.) Then the step, codes replayed alike: its loss the
    mean of the microbatches', its gradients their f32 accumulation
    g_acc + g / 2 bit for bit, the step counter advanced. The
    enc-dec batch carries its frames [2, 32, d] (drawn with numpy) through
    the microbatch split with 16 target tokens."""
    spec = get_arch(arch)
    cfg = spec.smoke_cfg
    tspec = tget(arch)
    tspec = dataclasses.replace(tspec, model_cfg=tspec.smoke_cfg)
    jexe = JExe(mode="aimc", aimc=ja.AimcConfig(
        impl="ref", noise=JNM(sigma_read=0.002)), compute_dtype="float32")
    texe = TExe(mode="aimc", aimc=ta.AimcConfig(noise=TNM(sigma_read=0.002)),
                compute_dtype="float32")
    batch = host_batch(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=2, seed=0), 0, 0, 1)
    if spec.family == "audio":
        batch = {"frames": np.random.default_rng(0).standard_normal(
                     (2, 32, cfg.d_model)).astype(np.float32),
                 "tokens": batch["tokens"][:, :16],
                 "labels": batch["labels"][:, :16]}
    jparams = spec.model_module().init(jax.random.PRNGKey(0), cfg)
    ref_log, replay = {}, {}
    jgrad = _family_grad_fn(spec, jexe)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    micro_grad = tsteps.make_micro_grad(tspec, texe)
    trng = torch.tensor([0, 0], dtype=torch.int64)
    t_losses, t_grads = [], []
    for i in range(2):
        mb = {k: v[i:i + 1] for k, v in batch.items()}
        with logging_reference(ref_log):
            (_, jl), jg = jgrad(jparams, jax.tree.map(jnp.asarray, mb),
                                jax.random.fold_in(
                                    jnp.asarray([0, 0], jnp.uint32), i))
            jax.effects_barrier()
        tmb = {k: torch.from_numpy(v) for k, v in mb.items()}
        key = prng.fold_in(trng, i)
        with replaying_in_port(ref_log, replay):
            tl_, tg = micro_grad(tparams, tmb, key)
        t_losses.append(tl_)
        t_grads.append(tg)
        assert replay["away"] == 0, replay
        _hold_micro(float(tl_), float(jl), tg, jg, tparams)
    seen = {}
    real = tmake

    def spy(name, **kw):
        init, upd, c = real(name, **kw)

        def upd_spy(g, s, p, lr=1.0):
            seen["grads"] = g
            return upd(g, s, p, lr)
        return init, upd_spy, c

    monkeypatch.setattr(tsteps, "make_optimizer", spy)
    cell = ShapeCell("t", seq_len=32, global_batch=2, kind="train")
    step_fn = tsteps.make_train_step(tspec, cell, None, texe).fn
    tstate = tmake(spec.optimizer)[0](tparams)
    with replaying_in_port(ref_log, replay):
        _, new_state, metrics = step_fn(
            tparams, tstate,
            {k: torch.from_numpy(v) for k, v in batch.items()}, trng)
    assert replay["away"] == 0, replay
    assert float(metrics["loss"]) == float(t_losses[0] / 2 + t_losses[1] / 2)
    for acc, g0, g1 in zip(tree_leaves(seen["grads"]), *t_grads):
        want = torch.zeros_like(acc)
        for g in (g0, g1):
            if g is not None:
                want = want + g / 2
        assert torch.equal(acc, want)
    assert int(new_state.step) == 1


def test_make_step_refuses_serving_cells_and_meshes():
    """A mesh now builds every cell kind (the serving cells since the
    sharded serving cells were ported; `tests/test_torch_mesh_cells.py`
    holds them to the reference's jitted cells): the prefill, decode and
    train bundles on data:2,model:1 carry the reference's in/out specs,
    leaf for leaf, as `make_step` builds them on an `AbstractMesh`; a
    one-device bundle carries none."""
    from jax.sharding import AbstractMesh
    from jax.sharding import PartitionSpec as JP

    from repro.configs import SHAPES
    from repro.launch import shardings as js
    from repro.launch import steps as jsteps
    from repro_torch.launch import shardings as ts
    from repro_torch.launch.mesh import make_mesh

    def flat_ref(t):
        leaves = jax.tree_util.tree_flatten_with_path(
            t, is_leaf=lambda x: isinstance(x, JP) or x is None)[0]
        return {"/".join(js._path_str(p)): None if s is None else tuple(s)
                for p, s in leaves}

    def flat_port(t):
        if t is None:
            return {"": None}
        return {"/".join(ts._path_str(p)): tuple(s) for p, s in
                ts._flatten_with_path(t, is_leaf=ts._is_spec)}

    spec, jspec = tget("llama3.2-3b"), get_arch("llama3.2-3b")
    mesh = make_mesh((2, 1), ("data", "model"), ["cpu"])
    jmesh = AbstractMesh((2, 1), ("data", "model"))
    for kind, shape in (("prefill", "prefill_32k"), ("decode", "decode_32k"),
                        ("train", "train_4k")):
        cell = ShapeCell(kind, 16, 2, kind)
        bundle = tsteps.make_step(spec, cell, mesh=mesh)
        assert callable(bundle.fn)
        want = jsteps.make_step(jspec, dataclasses.replace(
            SHAPES[shape], seq_len=16, global_batch=2), jmesh)
        got_in = bundle.in_specs
        want_in = want.in_shardings[:len(got_in)]   # the train rng's P()
        assert len(got_in) == len(bundle.abstract_inputs)
        for g, w in zip(got_in, want_in):
            assert flat_port(g) == flat_ref(w), kind
        for g, w in zip(bundle.out_specs, want.out_shardings):
            assert flat_port(g) == flat_ref(w), kind
        assert tsteps.make_step(spec, cell).in_specs is None
    assert tsteps.batch_kind(spec) == "lm"
    assert tsteps.batch_shapes(spec, ShapeCell("t", 16, 2, "train")) == {
        "tokens": ((2, 16), torch.int32), "labels": ((2, 16), torch.int32)}
