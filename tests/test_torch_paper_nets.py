"""Parity of the port's paper networks (`repro_torch/models/paper_nets.py`)
with the JAX reference (`repro/models/paper_nets.py`) on the CPU: MLP
n=256, the LSTM at n_h=64, T=4, B=2 in both gate layouts, and CNN-F at
64 px, B=2, with the same keys and the reference's weights carried across
(`convert.params_from_numpy`). The JAX side runs under `jax.jit`, but
for the inits held to the port's, which run op by op as the port's do.

Tolerances:
  * weights drawn from the same key: none, bit for bit (`prng.normal`);
  * digital fp32 outputs: 1e-5 * max(1, max|y|) (matmul summation order);
  * AIMC outputs, noise off and on (programming + counter read noise):
    1e-5 * max(1, max|y|), the f32 association of the row-block sum (codes,
    seeds and draws are equal);
  * the fused LSTM equals the side-by-side one bit for bit, noise off.
"""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.aimc import AimcConfig as JConfig
from repro.core.noise import NoiseModel as JNoise
from repro.models import paper_nets as jpn
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.core.aimc import AimcConfig as TConfig
from repro_torch.core.noise import NoiseModel as TNoise
from repro_torch.models import paper_nets as tpn

NH, T_STEPS, B = 64, 4, 2
NOISES = {"off": (JNoise(enabled=False), TNoise(enabled=False)),
          "on": (JNoise(sigma_read=0.003), TNoise(sigma_read=0.003))}


def _cfgs(noise: str, rows: int = 128):
    nm_j, nm_t = NOISES[noise]
    return (JConfig(tile_rows=rows, impl="ref", noise=nm_j),
            TConfig(tile_rows=rows, noise=nm_t))


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _close(y_t, y_j):
    y_j = np.asarray(y_j)
    assert tuple(y_t.shape) == y_j.shape
    scale = float(np.abs(y_j).max())
    d = np.abs(y_t.numpy() - y_j)
    assert not (d > 1e-5 * max(1.0, scale)).any(), f"max |err| {d.max()}"


@pytest.fixture(scope="module")
def nets():
    """The reference's weights for the three nets, and numpy inputs."""
    rng = np.random.default_rng(0)
    return {
        "mlp": (jpn.mlp_init(jax.random.PRNGKey(0), 256),
                rng.standard_normal((4, 256)).astype(np.float32)),
        "lstm": (jpn.lstm_init(jax.random.PRNGKey(1), NH),
                 rng.standard_normal((T_STEPS, B, 50)).astype(np.float32)),
        "cnn": (jax.jit(lambda k: jpn.cnn_init(k, "F", img=64))(
            jax.random.PRNGKey(2)),
                rng.standard_normal((B, 64, 64, 3)).astype(np.float32)),
    }


def test_init_matches_reference_keys(nets):
    """Every weight bit for bit with the reference's init on the same key,
    run op by op: the fixture's jitted CNN init is not the reference to
    hold draws to, since under `jax.jit` XLA folds ``sqrt(2)`` (the normal's
    factor) and the init's scale into one constant, which rounds 1 ulp
    apart from the two products on many of its weights."""
    mlp = tpn.mlp_init(prng.PRNGKey(0), 256, device="cpu")
    lstm = tpn.lstm_init(prng.PRNGKey(1), NH, device="cpu")
    cnn = tpn.cnn_init(prng.PRNGKey(2), "F", img=64, device="cpu")
    refs = {"mlp": nets["mlp"][0], "lstm": nets["lstm"][0],
            "cnn": jpn.cnn_init(jax.random.PRNGKey(2), "F", img=64)}
    for got, name in ((mlp, "mlp"), (lstm, "lstm"), (cnn, "cnn")):
        leaves_t = jax.tree_util.tree_leaves(
            jax.tree.map(lambda t: t.numpy(), got))
        leaves_j = jax.tree_util.tree_leaves(refs[name])
        assert len(leaves_t) == len(leaves_j)
        for a, b in zip(leaves_t, leaves_j):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, np.asarray(b))


def test_digital_matches_reference(nets):
    p, x = nets["mlp"]
    _close(tpn.mlp_forward_digital(_carry(p), torch.from_numpy(x)),
           jax.jit(jpn.mlp_forward_digital)(p, x))
    p, xs = nets["lstm"]
    _close(tpn.lstm_forward_digital(_carry(p), torch.from_numpy(xs), NH),
           jax.jit(lambda p, x: jpn.lstm_forward_digital(p, x, NH))(p, xs))
    p, x = nets["cnn"]
    y = tpn.cnn_forward(_carry(p), torch.from_numpy(x), "F")
    _close(y, jax.jit(lambda p, x: jpn.cnn_forward(p, x, "F"))(p, x))
    np.testing.assert_allclose(y.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("noise", ["off", "on"])
def test_mlp_aimc_matches_reference(nets, noise):
    cfg_j, cfg_t = _cfgs(noise)
    p, x = nets["mlp"]
    y_j = jax.jit(lambda p, x, k: jpn.mlp_forward_aimc(p, x, cfg_j, k)[0])(
        p, x, jax.random.PRNGKey(5))
    y_t, ctx = tpn.mlp_forward_aimc(_carry(p), torch.from_numpy(x), cfg_t,
                                    prng.PRNGKey(5))
    _close(y_t, y_j)
    again, _ = tpn.mlp_forward_aimc(_carry(p), torch.from_numpy(x), cfg_t,
                                    ctx=ctx)
    assert tuple(again.shape) == (4, 256)


@pytest.mark.parametrize("noise", ["off", "on"])
@pytest.mark.parametrize("fuse_gates", [False, True])
def test_lstm_aimc_matches_reference(nets, noise, fuse_gates):
    cfg_j, cfg_t = _cfgs(noise)
    p, xs = nets["lstm"]
    y_j = jax.jit(lambda p, x, k: jpn.lstm_forward_aimc(
        p, x, NH, cfg_j, k, fuse_gates=fuse_gates)[0])(
            p, xs, jax.random.PRNGKey(3))
    y_t, ctx = tpn.lstm_forward_aimc(_carry(p), torch.from_numpy(xs), NH,
                                     cfg_t, prng.PRNGKey(3),
                                     fuse_gates=fuse_gates)
    _close(y_t, y_j)
    with pytest.raises(ValueError):
        tpn.lstm_forward_aimc(_carry(p), torch.from_numpy(xs), NH, cfg_t,
                              ctx=ctx, fuse_gates=not fuse_gates)


@pytest.mark.parametrize("noise", ["off", "on"])
def test_cnn_aimc_matches_reference(nets, noise):
    cfg_j, cfg_t = _cfgs(noise)
    p, x = nets["cnn"]
    y_j = jax.jit(lambda p, x, k: jpn.cnn_forward(p, x, "F", cfg_j,
                                                  key=k)[0])(
        p, x, jax.random.PRNGKey(4))
    y_t, ctx = tpn.cnn_forward(_carry(p), torch.from_numpy(x), "F", cfg_t,
                               key=prng.PRNGKey(4))
    _close(y_t, y_j)
    assert ctx.program().names == ("conv0", "conv1", "conv2", "conv3",
                                   "conv4")


def test_fused_lstm_bit_equal_to_side_by_side_noise_off(nets):
    _, cfg_t = _cfgs("off", rows=512)
    p, xs = nets["lstm"]
    outs = [tpn.lstm_forward_aimc(_carry(p), torch.from_numpy(xs), NH, cfg_t,
                                  prng.PRNGKey(3), fuse_gates=f)
            for f in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert (dataclasses.astuple(outs[0][1].instruction_counts())
            == dataclasses.astuple(outs[1][1].instruction_counts()))


@pytest.mark.parametrize("net", ["mlp", "lstm", "cnn"])
def test_program_functions_match_reference(nets, net):
    cfg_j, cfg_t = _cfgs("on")
    p, _ = nets[net]
    fn_j = {"mlp": jpn.mlp_program, "lstm": jpn.lstm_program,
            "cnn": lambda p, c, k: jpn.cnn_program(p, "F", c, k)}[net]
    fn_t = {"mlp": tpn.mlp_program, "lstm": tpn.lstm_program,
            "cnn": lambda p, c, k: tpn.cnn_program(p, "F", c, k)}[net]
    prog_j = fn_j(p, cfg_j, jax.random.PRNGKey(8))
    prog_t = fn_t(_carry(p), cfg_t, prng.PRNGKey(8))
    assert prog_t.names == prog_j.names
    assert prog_t.n_tiles == prog_j.n_tiles
    for name in prog_j.names:
        diff = np.abs(prog_t[name].w_q.numpy().astype(np.int32)
                      - np.asarray(prog_j[name].w_q).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-5


def test_params_from_numpy_carries_lists_and_tuples(nets):
    p, _ = nets["cnn"]
    tree = {"convs": [np.asarray(w) for w in p["convs"]],
            "dense": tuple(np.asarray(w) for w in p["dense"])}
    got = params_from_numpy(tree)
    assert isinstance(got["convs"], list) and len(got["convs"]) == 5
    assert isinstance(got["dense"], tuple) and len(got["dense"]) == 3
    assert all(isinstance(t, torch.Tensor) for t in got["convs"])
    np.testing.assert_array_equal(got["dense"][2].numpy(), tree["dense"][2])


def test_bench_accuracy_settings_match_reference():
    """`benchmarks/bench_accuracy.py`'s own configuration (key 7 and its
    folds, the NOISY model on 512-row tiles, MLP 1024 B 16, LSTM n_h 256
    T 20 B 8, CNN-F at 64 px B 8) through both packages on the CPU: the
    three output SNRs agree within 0.05 dB, the LSTM and CNN top-1
    agreement is equal, and so is the CNN's flip-margin verdict. The
    reference functions are called directly, as the benchmark calls them."""
    noisy_j = JConfig(tile_rows=512, impl="ref",
                      noise=JNoise(sigma_read=0.003))
    noisy_t = TConfig(tile_rows=512, noise=TNoise(sigma_read=0.003))
    kj, kt = jax.random.PRNGKey(7), prng.PRNGKey(7)

    def fj(i):
        return jax.random.fold_in(kj, i)

    def ft(i):
        return prng.fold_in(kt, i)

    def snr(ref, test):
        ref, test = np.asarray(ref, np.float64), np.asarray(test, np.float64)
        return 20 * np.log10(np.linalg.norm(ref)
                             / max(np.linalg.norm(ref - test), 1e-12))

    def stats(y_dig, y_ana):
        y_dig, y_ana = np.asarray(y_dig), np.asarray(y_ana)
        agree = y_dig.argmax(-1) == y_ana.argmax(-1)
        if y_dig.ndim != 2:
            return snr(y_dig, y_ana), float(agree.mean())
        top2 = np.sort(y_dig, -1)[:, -2:]
        margins = top2[:, 1] - top2[:, 0]
        err = np.abs(y_ana - y_dig).max(-1)
        return (snr(y_dig, y_ana), float(agree.mean()),
                bool(np.all(agree | (margins < err))))

    out = {}
    p = jpn.mlp_init(kj)
    x = jax.random.normal(fj(1), (16, 1024))
    y = jax.jit(lambda p, x, k: jpn.mlp_forward_aimc(p, x, noisy_j, k)[0])(
        p, x, fj(2))
    pt = tpn.mlp_init(kt, device="cpu")
    xt = prng.normal(ft(1), (16, 1024))
    out["mlp"] = (stats(jpn.mlp_forward_digital(p, x), y)[0],
                  stats(tpn.mlp_forward_digital(pt, xt),
                        tpn.mlp_forward_aimc(pt, xt, noisy_t, ft(2))[0])[0])

    nh = 256
    p = jpn.lstm_init(fj(3), nh)
    xs = jax.random.normal(fj(4), (20, 8, 50))
    y = jax.jit(lambda p, x, k: jpn.lstm_forward_aimc(
        p, x, nh, noisy_j, k)[0])(p, xs, fj(5))
    pt = tpn.lstm_init(ft(3), nh, device="cpu")
    xst = prng.normal(ft(4), (20, 8, 50))
    out["lstm"] = (stats(jpn.lstm_forward_digital(p, xs, nh), y),
                   stats(tpn.lstm_forward_digital(pt, xst, nh),
                         tpn.lstm_forward_aimc(pt, xst, nh, noisy_t,
                                               ft(5))[0]))

    p = jpn.cnn_init(fj(6), "F", img=64)
    x = jax.random.normal(fj(7), (8, 64, 64, 3))
    y_dig = jax.jit(lambda p, x: jpn.cnn_forward(p, x, "F", None))(p, x)
    y = jax.jit(lambda p, x, k: jpn.cnn_forward(p, x, "F", noisy_j,
                                                key=k)[0])(p, x, fj(8))
    pt = tpn.cnn_init(ft(6), "F", img=64, device="cpu")
    xt = prng.normal(ft(7), (8, 64, 64, 3))
    out["cnn"] = (stats(y_dig, y),
                  stats(tpn.cnn_forward(pt, xt, "F"),
                        tpn.cnn_forward(pt, xt, "F", noisy_t,
                                        key=ft(8))[0]))
    (mj, mt), (lj, lt), (cj, ct) = out["mlp"], out["lstm"], out["cnn"]
    assert abs(mj - mt) <= 0.05, out
    assert abs(lj[0] - lt[0]) <= 0.05 and lj[1] == lt[1], out
    assert abs(cj[0] - ct[0]) <= 0.05 and cj[1:] == ct[1:], out
