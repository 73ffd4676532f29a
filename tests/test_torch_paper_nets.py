"""Parity of the port's paper networks (`repro_torch/models/paper_nets.py`)
with the JAX reference (`repro/models/paper_nets.py`) on the CPU: MLP
n=256, the LSTM at n_h=64, T=4, B=2 in both gate layouts, and CNN-F at
64 px, B=2, with the same keys and the reference's weights carried across
(`convert.params_from_numpy`). The JAX side runs under `jax.jit`.

Tolerances:
  * weights drawn from the same key: within 4 ulps (`prng.normal`);
  * digital fp32 outputs: 1e-5 * max(1, max|y|) (matmul summation order);
  * AIMC outputs, noise off: 1e-5 * max(1, max|y|), the f32 association of
    the row-block sum (codes and seeds are equal);
  * AIMC outputs, noise on (programming + counter read noise): the same
    bound for all but 0.5% of the elements, which may differ by up to 5% of
    max|y|. An ulp-level difference of a programming-noise draw can move a
    code across a rounding tie (tests/test_torch_aimc.py bounds those at
    1e-5 of the codes), and one code moves an ADC code and everything after
    it. None was seen on these inputs; the allowance is stated so a flip
    fails only when it is more than rare;
  * the fused LSTM equals the side-by-side one bit for bit, noise off.
"""

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


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _close(y_t, y_j, noise="off"):
    y_j = np.asarray(y_j)
    assert tuple(y_t.shape) == y_j.shape
    scale = float(np.abs(y_j).max())
    d = np.abs(y_t.numpy() - y_j)
    over = d > 1e-5 * max(1.0, scale)
    if noise == "off":
        assert not over.any(), f"max |err| {d.max()}"
    else:
        assert over.mean() <= 0.005 and d.max() <= 0.05 * scale


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
    mlp = tpn.mlp_init(prng.PRNGKey(0), 256, device="cpu")
    lstm = tpn.lstm_init(prng.PRNGKey(1), NH, device="cpu")
    cnn = tpn.cnn_init(prng.PRNGKey(2), "F", img=64, device="cpu")
    for got, name in ((mlp, "mlp"), (lstm, "lstm"), (cnn, "cnn")):
        want = nets[name][0]
        leaves_t = jax.tree_util.tree_leaves(
            jax.tree.map(lambda t: t.numpy(), got))
        leaves_j = jax.tree_util.tree_leaves(want)
        assert len(leaves_t) == len(leaves_j)
        for a, b in zip(leaves_t, leaves_j):
            assert a.shape == b.shape and _ulps(a, b).max() <= 4


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
    _close(y_t, y_j, noise)
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
    _close(y_t, y_j, noise)
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
    _close(y_t, y_j, noise)
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
