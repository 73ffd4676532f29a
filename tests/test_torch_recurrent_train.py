"""Parity of the port's recurrent training forwards with the JAX
reference: xlstm's chunkwise-parallel mLSTM (`_mlstm_chunkwise`) and
`forward`, rglru's associative scan and `forward`, and the sliding window
of `layers.flash_attention`, at the xlstm-350m and recurrentgemma-9b smoke
configs (rglru: one unit and 2 tail blocks, so the tail keys are
covered), digital and AIMC on the fly with noise on
(``NoiseModel(sigma_read=0.002)``, programming noise at its defaults).
Weights are the reference's (`init` on seed 0, carried over with
`convert.params_from_numpy`); tokens, labels and kernel inputs are drawn
with numpy. JAX runs as its own tests run it: ``impl="ref"``, functions
driven directly, no mesh; one `value_and_grad` per model case
(module-scoped).

Tolerances: hidden states, chunkwise outputs and states and attention
outputs within ATOL x max(1, max|ref|) (ATOL = 1e-5); the loss within 1e-5
relative; every gradient leaf within GTOL x max|ref leaf| (GTOL = 1e-5: the
f32 op order of the norms and contractions), or, for an xlstm leaf where the
gradient itself is ill-conditioned, within COND = 4 times its spread
(rglru's leaves are held to GTOL alone): the largest change of the port's
own gradient when every parameter moves by one part in 2^23 (one f32 ulp,
the size of the frameworks' rounding differences), either way. At these
inputs xlstm's gradients are such leaves: a one-ulp change of the parameters
moves the port's embed gradient by 1.7e-4 of its max (digital), the
reference's scanned and op-by-op evaluations differ by 5.3e-4, and the port
is 2.0e-4 from the reference; the mLSTM normalizer ``num / max(|den|,
exp(-m))`` divides by small, cancelling sums. In the AIMC cases the
reference logs the values its DAC and programming codes round from and the
port would take the reference's code wherever one rounds the other way at
a tie (`tests/torch_code_replay.py`): at these inputs none may, since the
programming noise draws are the reference's bit for bit. The rglru scan equals
`jax.lax.associative_scan` bit for bit when JAX runs it op by op; under
`jax.jit` XLA fuses each ``a2 b1 + b2`` into one multiply-add, and the port
is within SCAN_ULPS = 8 ulps of the largest |r| of the scan (measured up to
5 at n = 4096 with every a near 1, where the roundings add up over the
log2(n) levels; <= 1 with a in [e^-0.8, 1]). The port's own forward equals
its own decode recurrence within the reference's atol 5e-3
(`tests/test_models_smoke.py:166-172`)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core.noise import NoiseModel as JNM
from repro.launch.steps import chunked_ce as jce
from repro.models import layers as jl
from repro.models import xlstm as jx
from repro.models.layers import Execution as JExe
from repro_torch.configs import get_arch as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import prng
from repro_torch.core.noise import NoiseModel as TNM
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tl
from repro_torch.models import rglru as tr
from repro_torch.models import xlstm as tx
from repro_torch.models.layers import Execution as TExe
from repro_torch.optim.adamw import tree_leaves
from torch_code_replay import logging_reference, replaying_in_port

ATOL = 1e-5
GTOL = 1e-5
COND = 4
SCAN_ULPS = 8
DECODE_ATOL = 5e-3
SEQ = 32
ARCHS = ("xlstm_350m", "recurrentgemma_9b")
CASES = [(a, m) for a in ARCHS for m in ("digital", "aimc")]


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# mLSTM chunkwise form
# ---------------------------------------------------------------------------

def _mlstm_inputs(rng, b, s, h, dh):
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32) / dh ** 0.5
    k = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    li = rng.standard_normal((b, s, h)).astype(np.float32)
    lf = np.log(1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, h)) - 3.0))
                ).astype(np.float32)
    return q, k, v, li, lf


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_mlstm_chunkwise_matches_reference(n_chunks, carried):
    """h and the final (C, n, m) from a fresh state (m = -1e30) or from a
    carried one (the state after a first pass), over 1, 2 and 4 chunks."""
    cfg = dataclasses.replace(get_arch("xlstm_350m").smoke_cfg, chunk=8)
    b, h, dh = 2, 2, 16
    rng = np.random.default_rng(n_chunks)
    args = _mlstm_inputs(rng, b, 8 * n_chunks, h, dh)
    jstate = tstate = None
    if carried:
        first = _mlstm_inputs(rng, b, 8, h, dh)
        _, jstate = jx._mlstm_chunkwise(*map(jnp.asarray, first), cfg)
        tstate = tuple(torch.from_numpy(np.asarray(t)) for t in jstate)
    ho, (C, n, m) = jx._mlstm_chunkwise(*map(jnp.asarray, args), cfg,
                                        jstate)
    to, (tC, tn, tm) = tx._mlstm_chunkwise(*map(torch.from_numpy, args), cfg,
                                           tstate)
    for got, want in ((to, ho), (tC, C), (tn, n), (tm, m)):
        _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# RG-LRU associative scan
# ---------------------------------------------------------------------------

def _combine(left, right):
    return left[0] * right[0], right[0] * left[1] + right[1]


@pytest.mark.parametrize("n", [1, 2, 7, 64, 4096])
def test_associative_scan_matches_reference(n):
    """a in RG-LRU's range near 1 (products stay normal floats: XLA:CPU
    flushes subnormals to zero, torch keeps them), b ~ N(0, 0.3^2): op by
    op bit for bit; jitted within SCAN_ULPS ulps of max|r|. The scan is
    the recurrence r_t = a_t r_{t-1} + b_t."""
    rng = np.random.default_rng(n)
    a = np.exp(-0.8 * rng.uniform(0.0, 1e-3, (2, n, 24))).astype(np.float32)
    b = (0.3 * rng.standard_normal((2, n, 24))).astype(np.float32)
    ja_, jb_ = jax.lax.associative_scan(_combine, (jnp.asarray(a),
                                                   jnp.asarray(b)), axis=1)
    ta_, tb_ = tr.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ta_.numpy(), np.asarray(ja_))
    np.testing.assert_array_equal(tb_.numpy(), np.asarray(jb_))
    jit_b = np.asarray(jax.jit(lambda x, y: jax.lax.associative_scan(
        _combine, (x, y), axis=1))(a, b)[1])
    ulp = np.spacing(np.abs(jit_b).max())
    assert np.abs(tb_.numpy() - jit_b).max() <= SCAN_ULPS * ulp
    r, seq = np.zeros((2, 24), np.float32), []
    for t in range(n):
        r = a[:, t] * r + b[:, t]
        seq.append(r)
    _close(tb_.numpy(), np.stack(seq, 1))


# ---------------------------------------------------------------------------
# sliding-window flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [8, 32, 64], ids=["below", "equal",
                                                      "above"])
def test_flash_attention_window_matches_reference(window):
    """MQA, seq 32 in chunks of 8: a window of 8 masks whole chunks out
    (they take the re-mask), 32 equals the sequence, 64 exceeds it."""
    rng = np.random.default_rng(window)
    q = rng.standard_normal((2, 32, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 32, 1, 8)).astype(np.float32)
    v = rng.standard_normal((2, 32, 1, 8)).astype(np.float32)
    oj = jl.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                            window=window, q_chunk=8, kv_chunk=8)
    ot = tl.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                            window=window, q_chunk=8, kv_chunk=8)
    assert np.isfinite(ot.numpy()).all()
    _close(ot.numpy(), oj)


# ---------------------------------------------------------------------------
# the training forwards: hidden states, loss and gradients
# ---------------------------------------------------------------------------

def _exes(mode):
    if mode == "digital":
        return JExe(compute_dtype="float32"), TExe(compute_dtype="float32")
    return (JExe(mode="aimc", aimc=ja.AimcConfig(
                impl="ref", noise=JNM(sigma_read=0.002)),
                 compute_dtype="float32"),
            TExe(mode="aimc", aimc=ta.AimcConfig(
                noise=TNM(sigma_read=0.002)), compute_dtype="float32"))


def _walk(t, j, path=""):
    """(path, (port leaf, reference leaf)) over the reference's tree."""
    if isinstance(j, dict):
        for k in j:
            yield from _walk(t[k], j[k], f"{path}/{k}")
    else:
        yield path, (t, j)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{m}" for a, m in CASES])
def case(request):
    arch, mode = request.param
    spec = get_arch(arch)
    cfg, jm = spec.smoke_cfg, spec.model_module()
    tcfg, tm = tget(arch).smoke_cfg, tget(arch).model_module()
    jexe, texe = _exes(mode)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab, (2, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    jparams = jm.init(jax.random.PRNGKey(0), cfg)
    key = jax.random.PRNGKey(7)

    def loss(p):
        h, _ = jm.forward(p, jnp.asarray(toks), cfg, jexe, key,
                          return_hidden=True)
        ls, n = jce(h, jm.unembed_matrix(p, cfg), jnp.asarray(labels))
        return ls / jnp.maximum(n, 1.0), h

    aimc = mode == "aimc"
    log, replay = {}, {}
    with logging_reference(log) if aimc else contextlib.nullcontext():
        (plain, h), grads = jax.value_and_grad(loss, has_aux=True)(jparams)
        jax.effects_barrier()
    ref = {"loss": float(plain), "h": np.asarray(h),
           "grads": jax.tree.map(np.asarray, grads)}
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    tkey = torch.tensor(np.asarray(key, np.int64))

    def port_run(scale=1.0, seen=None):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        p = tsteps._tree_with(params, [t * scale for t in live])
        with (replaying_in_port(log, {} if seen is None else seen) if aimc
              else contextlib.nullcontext()):
            ht, aux = tm.forward(p, torch.from_numpy(toks), tcfg, texe,
                                 tkey, return_hidden=True)
            ls, n = tsteps.chunked_ce(ht, tm.unembed_matrix(p, tcfg),
                                      torch.from_numpy(labels))
            tloss = ls / torch.clamp_min(n, 1.0)
            tgrads = torch.autograd.grad(tloss, live, allow_unused=True)
        return (float(tloss.detach()), ht.detach().numpy(), aux,
                dict(_walk(tsteps._tree_with(params, tgrads), ref["grads"])))

    loss_, h_, aux_, grads_ = port_run(seen=replay)
    assert not any(replay.values()), replay
    spread = {}

    def grad_spread():
        """Per leaf, the largest change of the port's gradient under a
        one-ulp relative move of every parameter, either way."""
        if not spread:
            for scale in (1.0 + 2.0 ** -23, 1.0 - 2.0 ** -23):
                for path, (t, _) in port_run(scale)[3].items():
                    d = float((t - grads_[path][0]).abs().max())
                    spread[path] = max(spread.get(path, 0.0), d)
        return spread

    port = {"loss": loss_, "h": h_, "aux": aux_, "grads": grads_,
            "spread": grad_spread, "replayed": replay,
            "cond": arch == "xlstm_350m"}
    return params, ref, port


def test_forward_hidden_and_loss_match_reference(case):
    _, ref, port = case
    _close(port["h"], ref["h"])
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert port["aux"] == 0.0


def test_grads_match_reference(case):
    """Every leaf within GTOL of its max, or, for xlstm, within COND x its
    spread where the gradient is ill-conditioned (see the module doc);
    every rglru leaf within GTOL."""
    params, ref, port = case
    for path, (t, j) in port["grads"].items():
        t = np.zeros_like(j) if t is None else t.numpy()
        err = float(np.abs(t - j).max())
        tol = GTOL * max(float(np.abs(j).max()), 1e-30)
        if err > tol and port["cond"]:
            tol = max(tol, COND * port["spread"]()[path])
        assert err <= tol, (path, err, tol)
    assert len(port["grads"]) == len(tree_leaves(params))


# ---------------------------------------------------------------------------
# keys: the reference's assignment, and the same keys in the recompute
# ---------------------------------------------------------------------------

def _ste_keys(ks, n):
    """The 8 block keys a block's ``split(key, 8)`` gives, first n."""
    return [tuple(np.asarray(k).tolist()) for k in
            jax.random.split(ks, 8)[:n]]


def _expected_keys(arch, cfg, rng):
    """Per checkpoint region, the keys of its projections in call order,
    as the reference assigns them."""
    if arch == "xlstm_350m":
        pk = jax.random.split(rng, 2 * cfg.n_pairs)
        # mLSTM: w_up, w_gate, w_q, w_k, w_v, w_if, w_down = keys[0..6];
        # sLSTM: w_zifo, w_ff_gate, w_ff_up, w_ff_down = keys[0..3]
        return [_ste_keys(pk[2 * i], 7) + _ste_keys(pk[2 * i + 1], 4)
                for i in range(cfg.n_pairs)]
    uk = jax.random.split(rng, 3 * cfg.n_units)
    tk = jax.random.split(jax.random.fold_in(rng, 7), cfg.n_tail)

    def rec(k):  # call order: w_gate, w_rnn_in, w_a, w_x, w_out, FFN
        ks = _ste_keys(k, 8)
        return [ks[2], ks[3], ks[0], ks[1], ks[4], ks[5], ks[6], ks[7]]

    def attn(k):  # wq, wk, wv, wo, FFN
        ks = _ste_keys(k, 8)
        return ks[:4] + ks[5:8]

    return ([rec(uk[3 * i]) + rec(uk[3 * i + 1]) + attn(uk[3 * i + 2])
             for i in range(cfg.n_units)] + [rec(k) for k in tk])


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_recompute_with_their_own_keys(arch, monkeypatch):
    """Every STE call of the forward carries the reference's key for its
    projection (11 per xlstm pair; 8 + 8 + 7 per rglru unit, 8 per tail
    block), and the backward recomputes each checkpoint region, last
    first, with the same keys in the same order (the same noise)."""
    spec = tget(arch)
    cfg, tm = spec.smoke_cfg, spec.model_module()
    _, texe = _exes("aimc")
    log = []
    orig = tl.aimc_linear_ste

    def spy(x, w, key, acfg):
        log.append(tuple(key.tolist()))
        return orig(x, w, key, acfg)

    monkeypatch.setattr(tl, "aimc_linear_ste", spy)
    params = tm.init(prng.PRNGKey(0), cfg, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 16)))
    rng = prng.PRNGKey(3)
    logits, _ = tm.forward(params, toks, cfg, texe, rng)
    n_fwd = len(log)
    logits.sum().backward()
    want = _expected_keys(spec.arch_id, get_arch(spec.arch_id).smoke_cfg,
                          jax.random.PRNGKey(3))
    assert log[:n_fwd] == [k for region in want for k in region]
    assert log[n_fwd:] == [k for region in reversed(want) for k in region]
    assert all(p.grad is not None for p in leaves)


# ---------------------------------------------------------------------------
# the port's forward == its own decode recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,s", [("xlstm_350m", 16),
                                    ("recurrentgemma_9b", 12)])
def test_forward_matches_decode_recurrence(arch, s):
    """The reference's own claim (`tests/test_models_smoke.py:166-172`) on
    the port: the last position's logits of `forward` against those of s
    `decode_step`s from a fresh cache, digital f32, at the atol the
    reference sets."""
    spec = tget(arch)
    cfg, tm = spec.smoke_cfg, spec.model_module()
    exe = TExe(compute_dtype="float32")
    params = tm.init(prng.PRNGKey(0), cfg, device="cpu")
    toks = (torch.arange(2 * s).reshape(2, s) * 7 + 1) % cfg.vocab
    with torch.no_grad():
        full, _ = tm.forward(params, toks, cfg, exe)
        cache = tm.init_cache(cfg, 2, s, torch.float32)
        for t in range(s):
            step, cache = tm.decode_step(params, cache, toks[:, t:t + 1],
                                         cfg, exe)
    np.testing.assert_allclose(step[:, -1].numpy(), full[:, -1].numpy(),
                               atol=DECODE_ATOL)
