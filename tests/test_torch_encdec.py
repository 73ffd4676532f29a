"""Parity of the port's enc-dec training half (`repro_torch/models/encdec.py`,
`layers.layernorm`, `layers.gelu_mlp`) with the JAX reference at the
seamless-m4t-large-v2 smoke config (2 + 2 layers, d_model 32), digital and
AIMC on the fly with noise on (``NoiseModel(sigma_read=0.002)``,
programming noise at its defaults). Weights are the reference's (`init` on
seed 0, carried over with `convert.params_from_numpy`); frames, tokens and
labels are drawn with numpy. JAX runs as its own tests run it:
``impl="ref"``, functions driven directly, no mesh; one `value_and_grad`
per case (module-scoped).

Pinned: `init` key for key (every leaf bit for bit, the drawn ones
included); `layernorm` and `gelu_mlp`; `encode`,
`decode_train` and `forward`; the decoder's cross-attention keys as the
reference assigns them (``ck`` under ``cq``'s key, ``cv`` under none);
the loss and every gradient; all-zero frames (the train CLI's stub
frontend) through the AIMC encoder: the reference's DAC codes and scale
(all codes 0 at ``sym_scale``'s floor 1e-12 / 127), no NaN; at the
published encoder depth the same frames overflow the encoder's gradients
in both packages, entry for entry; the `params_from_numpy` round trip.

Tolerances: outputs and hidden states within ATOL x max(1, max|ref|)
(ATOL = 1e-5); `layernorm` within 1e-6 x max(1, max|ref|) (one f32 mean,
variance and rsqrt); the loss within 1e-5 relative; every gradient leaf
within GTOL x max|ref leaf| (GTOL = 1e-5; measured <= 1.7e-6)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core import quant as jq
from repro.core.noise import NoiseModel as JNM
from repro.launch.steps import chunked_ce as jce
from repro.models import encdec as je
from repro.models import layers as jl
from repro.models.layers import Execution as JExe
from repro_torch.configs import get_arch as tget
from repro_torch.convert import (flatten_to_numpy, load_npz,
                                 params_from_numpy)
from repro_torch.core import aimc as ta
from repro_torch.core import prng
from repro_torch.core import program as tp
from repro_torch.core.noise import NoiseModel as TNM
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.models import encdec as te
from repro_torch.models import layers as tl
from repro_torch.models.layers import Execution as TExe
from repro_torch.optim.adamw import tree_leaves

ATOL = 1e-5
GTOL = 1e-5
CFG = get_arch("seamless_m4t_large_v2").smoke_cfg
TCFG = tget("seamless-m4t-large-v2").smoke_cfg
S_SRC, S_TGT = 40, 24


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))


def _exes(mode):
    if mode == "digital":
        return JExe(compute_dtype="float32"), TExe(compute_dtype="float32")
    return (JExe(mode="aimc", aimc=ja.AimcConfig(
                impl="ref", noise=JNM(sigma_read=0.002)),
                 compute_dtype="float32"),
            TExe(mode="aimc", aimc=ta.AimcConfig(
                noise=TNM(sigma_read=0.002)), compute_dtype="float32"))


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): v for path, v in flat}


def _data(seed, zero_frames=False):
    rng = np.random.default_rng(seed)
    frames = (np.zeros((2, S_SRC, CFG.d_model), np.float32) if zero_frames
              else rng.standard_normal((2, S_SRC, CFG.d_model)).astype(
                  np.float32))
    toks = rng.integers(0, CFG.vocab, (2, S_TGT)).astype(np.int32)
    return frames, toks, np.roll(toks, -1, 1)


@pytest.mark.parametrize("seed", [0, 5])
def test_init_on_keys_matches_reference(seed):
    """Every leaf of `init` on ``PRNGKey(seed)``: the same tree, every
    leaf bit for bit, constant (norms, biases) and drawn."""
    jparams = je.init(jax.random.PRNGKey(seed), CFG)
    tparams = te.init(prng.PRNGKey(seed), TCFG, device="cpu")
    jlv = _leaves(jparams)
    tlv = dict(tp._flatten(tparams))
    assert sorted(tlv) == sorted(jlv)
    for path, t in tlv.items():
        j = np.asarray(jlv[path])
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), j, err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((3, 5, 64))).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    yj = jl.layernorm(jnp.asarray(x).astype(dtype), jnp.asarray(scale),
                      jnp.asarray(bias))
    yt = tl.layernorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(scale), torch.from_numpy(bias))
    assert str(yt.dtype) == f"torch.{dtype}"
    yj = np.asarray(yj.astype(jnp.float32))
    if dtype == "float32":
        _close(yt.numpy(), yj, atol=1e-6)
    else:  # one bf16 rounding of the same f32 value, at most 1 bf16 ulp
        _close(yt.float().numpy(), yj, atol=2.0 ** -7)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_gelu_mlp_matches_reference(mode):
    """gelu(x W_in + b_in) W_out + b_out, tanh GeLU, the two linears keyed
    by ``split(key)`` (AIMC: programming and read noise)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    w_in = (0.2 * rng.standard_normal((32, 64))).astype(np.float32)
    b_in = rng.standard_normal(64).astype(np.float32)
    w_out = (0.2 * rng.standard_normal((64, 32))).astype(np.float32)
    b_out = rng.standard_normal(32).astype(np.float32)
    jexe, texe = _exes(mode)
    args = (x, w_in, b_in, w_out, b_out)
    yj = jl.gelu_mlp(*map(jnp.asarray, args), jexe,
                     key=jax.random.PRNGKey(4))
    yt = tl.gelu_mlp(*map(torch.from_numpy, args), texe,
                     key=prng.PRNGKey(4))
    _close(yt.numpy(), yj)


@pytest.fixture(scope="module", params=["digital", "aimc"])
def case(request):
    mode = request.param
    jexe, texe = _exes(mode)
    frames, toks, labels = _data(3)
    jparams = je.init(jax.random.PRNGKey(0), CFG)
    key = jax.random.PRNGKey(7)
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}

    def loss(p):
        h, _ = je.forward(p, jbatch, CFG, jexe, key, return_hidden=True)
        ls, n = jce(h, je.unembed_matrix(p, CFG), jnp.asarray(labels))
        return ls / jnp.maximum(n, 1.0), h

    (plain, h), grads = jax.value_and_grad(loss, has_aux=True)(jparams)
    enc = je.encode(jparams, jbatch["frames"], CFG, jexe, key)
    dec, _ = je.decode_train(jparams, enc, jbatch["tokens"], CFG, jexe, key)
    ref = {"loss": float(plain), "h": np.asarray(h), "enc": np.asarray(enc),
           "dec": np.asarray(dec), "grads": jax.tree.map(np.asarray, grads)}
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    tkey = torch.tensor(np.asarray(key, np.int64))
    tbatch = {"frames": torch.from_numpy(frames),
              "tokens": torch.from_numpy(toks)}
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    p = tsteps._tree_with(params, live)
    ht, aux = te.forward(p, tbatch, TCFG, texe, tkey, return_hidden=True)
    ls, n = tsteps.chunked_ce(ht, te.unembed_matrix(p, TCFG),
                              torch.from_numpy(labels))
    tloss = ls / torch.clamp_min(n, 1.0)
    tgrads = torch.autograd.grad(tloss, live, allow_unused=True)
    with torch.no_grad():
        tenc = te.encode(params, tbatch["frames"], TCFG, texe, tkey)
        tdec, _ = te.decode_train(params, tenc, tbatch["tokens"], TCFG, texe,
                                  tkey)
    port = {"loss": float(tloss.detach()), "h": ht.detach().numpy(),
            "aux": aux, "enc": tenc.numpy(), "dec": tdec.numpy(),
            "grads": tsteps._tree_with(params, tgrads)}
    return params, ref, port


def test_encode_and_decode_train_match_reference(case):
    """`encode` (bidirectional, layer i under split(rng, 2)[i]) and
    `decode_train`'s logits (layer i under split(fold_in(rng, 1), 2)[i])."""
    _, ref, port = case
    _close(port["enc"], ref["enc"])
    _close(port["dec"], ref["dec"])


def test_forward_hidden_and_loss_match_reference(case):
    _, ref, port = case
    _close(port["h"], ref["h"])
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert port["aux"] == 0.0


def _walk(t, j, path=""):
    if isinstance(j, dict):
        for k in j:
            yield from _walk(t[k], j[k], f"{path}/{k}")
    else:
        yield path, t, j


def test_grads_match_reference(case):
    params, ref, port = case
    n = 0
    for path, t, j in _walk(port["grads"], ref["grads"]):
        t = np.zeros_like(j) if t is None else t.numpy()
        np.testing.assert_allclose(
            t, j, rtol=0, atol=GTOL * max(float(np.abs(j).max()), 1e-30),
            err_msg=path)
        n += 1
    assert n == len(tree_leaves(params))


def test_cross_attention_keys_follow_reference(monkeypatch):
    """In decoder layer i (``lk = split(fold_in(rng, 1), n_dec)[i]``,
    ``keys = split(lk, 7)``): wq, wk, wv, wo under keys[0..3], ``ck``
    under keys[4], ``cv`` under no key, ``cq`` under keys[4] again, ``co``
    under keys[5], and the FFN's two linears under ``split(keys[6])``;
    the encoder's 6 per layer likewise, without the cross projections."""
    log = []
    orig = tl.aimc_linear_ste

    def spy(x, w, key, acfg):
        log.append(None if key is None else tuple(key.tolist()))
        return orig(x, w, key, acfg)

    monkeypatch.setattr(tl, "aimc_linear_ste", spy)
    _, texe = _exes("aimc")
    params = te.init(prng.PRNGKey(0), TCFG, device="cpu")
    frames, toks, _ = _data(4)
    rng = jax.random.PRNGKey(9)
    with torch.no_grad():
        te.forward(params, {"frames": torch.from_numpy(frames),
                            "tokens": torch.from_numpy(toks)}, TCFG, texe,
                   torch.tensor(np.asarray(rng, np.int64)))

    def tup(k):
        return tuple(np.asarray(k).tolist())

    want = []
    for lk in jax.random.split(rng, CFG.n_enc_layers):
        ks = jax.random.split(lk, 7)
        want += [tup(k) for k in ks[:4]] + [
            tup(k) for k in jax.random.split(ks[6])]
    for lk in jax.random.split(jax.random.fold_in(rng, 1), CFG.n_dec_layers):
        ks = jax.random.split(lk, 7)
        want += ([tup(k) for k in ks[:4]] + [tup(ks[4]), None, tup(ks[4]),
                                              tup(ks[5])]
                 + [tup(k) for k in jax.random.split(ks[6])])
    assert log == want
    assert len(log) == 6 * CFG.n_enc_layers + 10 * CFG.n_dec_layers


def test_zero_frames_give_reference_codes(monkeypatch):
    """The train CLI's all-zero frames: the encoder's first DAC input is
    layernorm(0) = 0, its scale `sym_scale`'s floor and every code 0, as
    the reference quantizes it; the AIMC forward's hidden states, loss and
    gradients are finite and match the reference's."""
    calls = []
    orig = tops.aimc_matmul_v2

    def spy(x, w_q, s_w, s_x, *a, **k):
        calls.append((x.detach().clone(), s_x.detach().clone()))
        return orig(x, w_q, s_w, s_x, *a, **k)

    monkeypatch.setattr(tops, "aimc_matmul_v2", spy)
    jexe, texe = _exes("aimc")
    frames, toks, labels = _data(6, zero_frames=True)
    jparams = je.init(jax.random.PRNGKey(0), CFG)
    key = jax.random.PRNGKey(8)
    hn0 = jl.layernorm(jnp.asarray(frames), jparams["enc"]["ln1_s"][0],
                       jparams["enc"]["ln1_b"][0], CFG.norm_eps)
    s_ref = jq.sym_scale(hn0)
    codes_ref = np.asarray(jq.quantize(hn0, s_ref))
    h_ref, _ = je.forward(jparams, {"frames": jnp.asarray(frames),
                                    "tokens": jnp.asarray(toks)}, CFG, jexe,
                          key, return_hidden=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    p = tsteps._tree_with(params, live)
    h, _ = te.forward(p, {"frames": torch.from_numpy(frames),
                          "tokens": torch.from_numpy(toks)}, TCFG, texe,
                      torch.tensor(np.asarray(key, np.int64)),
                      return_hidden=True)
    ls, n = tsteps.chunked_ce(h, te.unembed_matrix(p, TCFG),
                              torch.from_numpy(labels))
    grads = torch.autograd.grad(ls / n, live)
    x0, s0 = calls[0]
    assert float(s0) == pytest.approx(float(s_ref), rel=0) and \
        float(s0) == pytest.approx(1e-12 / 127, rel=1e-6)
    codes = torch.round(x0 / s0).clamp(-127, 127)   # [B*S, K padded]
    np.testing.assert_array_equal(
        codes[:, :CFG.d_model].numpy().reshape(codes_ref.shape), codes_ref)
    assert not codes.any()
    _close(h.detach().numpy(), h_ref)
    assert all(torch.isfinite(g).all() for g in grads)


def test_params_from_numpy_round_trip(tmp_path):
    """The reference's tree carried across, flattened to numpy and through
    the flat npz archive `--weights` reads, comes back leaf for leaf."""
    jparams = je.init(jax.random.PRNGKey(1), CFG)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    flat = flatten_to_numpy(tparams)
    jlv = _leaves(jparams)
    assert sorted(flat) == sorted(jlv)
    for path, a in flat.items():
        np.testing.assert_array_equal(a, np.asarray(jlv[path]))
    np.savez(tmp_path / "w.npz", **flat)
    back = load_npz(tmp_path / "w.npz")
    for path, a in flatten_to_numpy(back).items():
        np.testing.assert_array_equal(a, flat[path])


def test_zero_frames_overflow_encoder_grads_like_reference():
    """At the published encoder depth (24 layers; smoke widths), the train
    CLI's all-zero frames overflow the encoder's gradients in both
    packages alike: layernorm(0)'s backward scales by 1/sqrt(eps) = 316 at
    every layer, so the reference's own CLI cannot train seamless at
    depth on its zero-frame batch. The port's non-finite entries are the
    reference's, leaf for leaf; its finite entries within GTOL x the
    leaf's finite max; every decoder, embedding and head leaf finite."""
    import dataclasses
    cfg = dataclasses.replace(CFG, n_enc_layers=24)
    tcfg = dataclasses.replace(TCFG, n_enc_layers=24)
    frames, toks, labels = _data(7, zero_frames=True)
    jparams = je.init(jax.random.PRNGKey(0), cfg)

    def loss(p):
        h, _ = je.forward(p, {"frames": jnp.asarray(frames),
                              "tokens": jnp.asarray(toks)}, cfg,
                          JExe(compute_dtype="float32"), None,
                          return_hidden=True)
        ls, n = jce(h, je.unembed_matrix(p, cfg), jnp.asarray(labels))
        return ls / jnp.maximum(n, 1.0)

    jg = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(jparams))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    p = tsteps._tree_with(params, live)
    h, _ = te.forward(p, {"frames": torch.from_numpy(frames),
                          "tokens": torch.from_numpy(toks)}, tcfg,
                      TExe(compute_dtype="float32"), None, return_hidden=True)
    ls, n = tsteps.chunked_ce(h, te.unembed_matrix(p, tcfg),
                              torch.from_numpy(labels))
    tg = tsteps._tree_with(params, torch.autograd.grad(ls / n, live))
    overflowed = 0
    for path, t, j in _walk(tg, jg):
        t = t.numpy()
        fin = np.isfinite(j)
        np.testing.assert_array_equal(np.isfinite(t), fin, err_msg=path)
        if not path.startswith("/enc/"):
            assert fin.all(), path
        overflowed += int((~fin).sum())
        if fin.any():
            np.testing.assert_allclose(
                t[fin], j[fin], rtol=0,
                atol=GTOL * max(float(np.abs(j[fin]).max()), 1e-30),
                err_msg=path)
    assert overflowed > 0
