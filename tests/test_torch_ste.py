"""Parity of the port's noise-aware training linear (`core.aimc`:
`aimc_linear_ste`, the expert-stack `aimc_linear_ste_experts`,
`aimc_apply_experts` with a read key per expert), of K2's expert entry with
a read seed per expert (`ops.aimc_matmul_experts`, the plain version on the
CPU) and of `moe_ffn` with a key, against the JAX reference (``impl="ref"``,
functions driven directly), on inputs drawn from a seed with numpy.

Tolerance: outputs and gradients within 1e-5 x max(1, max|ref|) (f32 op
order: the row-block sum, the backward matmuls, the router). Programming
noise: the threefry normals equal XLA's bit for bit (`prng.normal`), so
the programmed codes equal the reference's: none may differ, and one that
did would have to sit within TIE of a rounding tie (`_tie_columns`
checks)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aimc as ja
from repro.core import noise as jnoise
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.models.layers import Execution as JExe
from repro_torch.core import aimc as ta
from repro_torch.core import noise as tnoise
from repro_torch.core import prng
from repro_torch.core.quant import adc_step_lsb
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Execution as TExe

ATOL = 1e-5
TIE = 1e-4
NOISES = {"off": None, "read": 0.002}


def _cfgs(tile_rows, sigma_read):
    if sigma_read is None:
        return (ja.AimcConfig(tile_rows=tile_rows, impl="ref"),
                ta.AimcConfig(tile_rows=tile_rows))
    return (ja.AimcConfig(tile_rows=tile_rows, impl="ref",
                          noise=jnoise.NoiseModel(sigma_read=sigma_read)),
            ta.AimcConfig(tile_rows=tile_rows,
                          noise=tnoise.NoiseModel(sigma_read=sigma_read)))


def _tol(ref):
    return ATOL * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _tie_columns(w, jcfg, tcfg, key):
    """Output columns whose programmed codes differ between the packages
    (each must sit at a rounding tie of its pre-round value)."""
    kp = jax.random.split(key)[0] if key is not None else None
    js = ja.program_linear(jnp.asarray(w), jcfg, kp)
    ts = ta.program_linear(torch.from_numpy(w), tcfg,
                           None if key is None else prng.split(
                               torch.tensor(np.asarray(key, np.int64)))[0])
    cj, ct = np.asarray(js.w_q), ts.w_q.numpy()
    cols = set()
    if (cj != ct).any():
        kb, m, np_ = cj.shape
        wb = np.zeros((kb * m, np_), np.float32)
        wb[:w.shape[0], :w.shape[1]] = w
        codes = jnp.asarray(wb.reshape(kb, m, np_)) / js.s_w[:, None, :]
        if jcfg.noise.enabled and kp is not None:
            codes = codes + jnoise.programming_noise(kp, codes, jcfg.noise)
        frac = np.abs(np.asarray(codes)) % 1.0
        for idx in zip(*np.nonzero(cj != ct)):
            assert abs(frac[idx] - 0.5) < TIE, f"code {idx} moved off a tie"
            cols.add(int(idx[2]))
    return sorted(c for c in cols if c < w.shape[1])


def _tkey(jkey):
    return torch.tensor(np.asarray(jkey, np.int64))


@pytest.mark.parametrize("tile_rows", [64, 128])
@pytest.mark.parametrize("noise", list(NOISES))
def test_ste_forward_and_vjp_match_reference(tile_rows, noise):
    jcfg, tcfg = _cfgs(tile_rows, NOISES[noise])
    rng = np.random.default_rng(tile_rows)
    x = rng.standard_normal((6, 200)).astype(np.float32)
    w = (rng.standard_normal((200, 72)) * 0.1).astype(np.float32)
    g = rng.standard_normal((6, 72)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    yj, vjp = jax.vjp(lambda x_, w_: ja.aimc_linear_ste(x_, w_, key, jcfg),
                      jnp.asarray(x), jnp.asarray(w))
    dxj, dwj = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    yt = ta.aimc_linear_ste(xt, wt, _tkey(key), tcfg)
    dxt, dwt = torch.autograd.grad(yt, (xt, wt), torch.from_numpy(g))
    ties = _tie_columns(w, jcfg, tcfg, key)
    assert not ties, f"codes at rounding ties in columns {ties}"
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=0,
                               atol=_tol(yj))
    np.testing.assert_allclose(dxt.numpy(), np.asarray(dxj), rtol=0,
                               atol=_tol(dxj))
    np.testing.assert_allclose(dwt.numpy(), np.asarray(dwj), rtol=0,
                               atol=_tol(dwj))
    assert dxt.dtype == xt.dtype and dwt.dtype == wt.dtype


def test_ste_draws_fresh_noise_per_key_and_is_repeatable():
    """Same key, same forward (no global generator); another key, another
    programming and read draw; the key gets no gradient."""
    _, tcfg = _cfgs(64, 0.003)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    k = prng.PRNGKey(1)
    a = ta.aimc_linear_ste(x, w, k, tcfg)
    torch.manual_seed(123)
    assert torch.equal(a, ta.aimc_linear_ste(x, w, k, tcfg))
    assert not torch.equal(a, ta.aimc_linear_ste(x, w, prng.PRNGKey(2), tcfg))
    assert torch.equal(ta.aimc_linear(x, w, tcfg, k), a)


# the port's versions of tests/test_aimc.py's STE tests

def test_ste_gradients_are_dense():
    """Backward of the AIMC linear == backward of x @ W (straight-through)."""
    cfg = ta.AimcConfig(tile_rows=256, noise=tnoise.NoiseModel())
    key = prng.PRNGKey(0)
    w = (prng.normal(key, (256, 64)) * 0.05).requires_grad_(True)
    x = prng.normal(prng.PRNGKey(1), (8, 256)).requires_grad_(True)
    loss = (ta.aimc_linear_ste(x, w, key, cfg) ** 2).sum() * 0 + \
        ta.aimc_linear_ste(x, w, key, cfg).sum()
    gx, gw = torch.autograd.grad(loss, (x, w))
    np.testing.assert_allclose(gx.numpy(),
                               w.detach().sum(1)[None].repeat(8, 1).numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(),
                               x.detach().sum(0)[:, None].repeat(1, 64).numpy(),
                               rtol=1e-4, atol=1e-6)


def test_ste_trains_through_noise():
    """A tiny regression task reaches low loss with the noisy AIMC fwd."""
    cfg = ta.AimcConfig(tile_rows=64,
                        noise=tnoise.NoiseModel(sigma_read=0.002))
    key = prng.PRNGKey(0)
    w_true = prng.normal(key, (16, 4)) * 0.5
    x = prng.normal(prng.PRNGKey(1), (256, 16))
    y = x @ w_true
    w = torch.zeros((16, 4))
    for i in range(200):
        wv = w.clone().requires_grad_(True)
        pred = ta.aimc_linear_ste(x, wv, prng.fold_in(key, i), cfg)
        (gw,) = torch.autograd.grad(((pred - y) ** 2).mean(), (wv,))
        w = w - 0.05 * gw
    final = float(((ta.aimc_linear_ste(x, w, key, cfg) - y) ** 2).mean())
    base = float((y ** 2).mean())
    assert final < 0.05 * base, f"noise-aware training failed: {final}/{base}"


# the expert stack

def _expert_case(e=8, c=5, k=48, n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    x[3] = 0.0                          # an expert that got no token
    w = (rng.standard_normal((e, k, n)) * 0.2).astype(np.float32)
    g = rng.standard_normal((e, c, n)).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("noise", list(NOISES))
def test_expert_ste_matches_reference_vmap(noise):
    """Expert e programs under split(keys[e])[0] and reads under
    split(keys[e])[1] (the reference's `vmap` of the STE); one expert-entry
    call forward, a batched straight-through backward."""
    jcfg, tcfg = _cfgs(16, NOISES[noise])
    x, w, g = _expert_case()
    keys = jax.random.split(jax.random.PRNGKey(9), x.shape[0])

    def fj(x_, w_):
        return jax.vmap(lambda xi, wi, ki: ja.aimc_linear_ste(
            xi, wi, ki, jcfg))(x_, w_, keys)

    yj, vjp = jax.vjp(fj, jnp.asarray(x), jnp.asarray(w))
    dxj, dwj = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    yt = ta.aimc_linear_ste_experts(xt, wt, _tkey(keys), tcfg)
    dxt, dwt = torch.autograd.grad(yt, (xt, wt), torch.from_numpy(g))
    for i in range(x.shape[0]):
        ties = _tie_columns(w[i], jcfg, tcfg, keys[i])
        assert not ties, f"expert {i}: codes at rounding ties {ties}"
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=0,
                               atol=_tol(yj))
    assert not yt[3].any()
    np.testing.assert_allclose(dxt.numpy(), np.asarray(dxj), rtol=0,
                               atol=_tol(dxj))
    np.testing.assert_allclose(dwt.numpy(), np.asarray(dwj), rtol=0,
                               atol=_tol(dwj))


def test_apply_experts_reads_with_a_key_per_expert():
    """A programmed `[E]` stack with read keys equals E `aimc_apply` calls
    under their own keys bit for bit; equal keys would repeat draws, the
    reference's distinct keys do not."""
    _, tcfg = _cfgs(16, 0.003)
    x, w, _ = _expert_case()
    st = ta.program_stacked(torch.from_numpy(w), tcfg)
    keys = prng.split(prng.PRNGKey(4), x.shape[0])
    xt = torch.from_numpy(x)
    y = ta.aimc_apply_experts(st, xt, tcfg, keys)
    want = torch.stack([ta.aimc_apply(st[i], xt[i], tcfg, keys[i])
                        for i in range(x.shape[0])])
    assert torch.equal(y, want)
    assert not torch.equal(y, ta.aimc_apply_experts(st, xt, tcfg))


@pytest.mark.parametrize("sigma", [0.0, 57.5])
def test_expert_entry_seeds_equal_k2_calls_and_reference(sigma):
    """`ops.aimc_matmul_experts` (the plain version here) with E read seeds
    equals E `aimc_matmul_v2` calls with those seeds bit for bit, and the
    reference's `vmap` of its K2 (``impl="ref"``) within the bound; sigma >
    0 without seeds raises."""
    rng = np.random.default_rng(5)
    e, b, kb, m, np_ = 5, 3, 2, 128, 256
    x = rng.standard_normal((e, b, kb * m)).astype(np.float32)
    w_q = rng.integers(-127, 128, (e, kb, m, np_), dtype=np.int8)
    s_w = ((rng.random((e, kb, np_)) + 0.5) * 1e-3).astype(np.float32)
    s_x = (np.abs(x).reshape(e, -1).max(1) / 127).astype(np.float32)
    seeds = [int(s) for s in rng.integers(0, 2 ** 32, e, dtype=np.uint64)]
    step = adc_step_lsb(m, 1.0)
    xt, wt, st, sxt = map(torch.from_numpy, (x, w_q, s_w, s_x))
    y = tops.aimc_matmul_experts(xt, wt, st, sxt, seeds, adc_step=step,
                                 sigma=sigma)
    per = torch.stack([tops.aimc_matmul_v2(xt[i], wt[i], st[i],
                                           sxt[i].reshape(1, 1), seeds[i],
                                           adc_step=step, sigma=sigma)
                       for i in range(e)])
    assert torch.equal(y, per)
    yj = jax.vmap(lambda xi, wi, si, sxi, sd: jops.aimc_matmul_v2(
        xi, wi, si, sxi.reshape(1, 1), sd, adc_step=step, sigma=sigma,
        impl="ref"))(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(s_w),
                     jnp.asarray(s_x), jnp.asarray(seeds, jnp.uint32))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0,
                               atol=_tol(yj))
    if sigma:
        with pytest.raises(ValueError, match="seed"):
            tops.aimc_matmul_experts(xt, wt, st, sxt, adc_step=step,
                                     sigma=sigma)


@pytest.fixture(scope="module")
def moe_case():
    """The olmoe smoke config's MoE FFN widths (d 48, d_ff 32, 8 experts
    top-2) on 24 tokens, noise on, under `jax.value_and_grad`."""
    rng = np.random.default_rng(11)
    t, d, ff, e = 24, 48, 32, 8
    x = rng.standard_normal((t, d)).astype(np.float32)
    ws = {"router": (rng.standard_normal((d, e)) * 0.3).astype(np.float32),
          "we_gate": (rng.standard_normal((e, d, ff)) * 0.2).astype(np.float32),
          "we_up": (rng.standard_normal((e, d, ff)) * 0.2).astype(np.float32),
          "we_down": (rng.standard_normal((e, ff, d)) * 0.2).astype(np.float32)}
    r = rng.standard_normal((t, d)).astype(np.float32)
    jcfg, tcfg = _cfgs(512, 0.002)
    je = JExe(mode="aimc", aimc=jcfg, compute_dtype="float32")
    key = jax.random.PRNGKey(21)

    def lossj(x_, p):
        y, aux = jmoe.moe_ffn(x_, p["router"], p["we_gate"], p["we_up"],
                              p["we_down"], top_k=2, capacity_factor=1.25,
                              exe=je, key=key)
        return jnp.sum(y * r) + aux, (y, aux)

    (lj, (yj, auxj)), gj = jax.value_and_grad(lossj, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, ws))
    return x, ws, r, tcfg, key, (lj, yj, auxj, gj)


def test_moe_ffn_with_key_matches_reference(moe_case, monkeypatch):
    """`moe_ffn` with a key in aimc mode on raw expert stacks: the E x 3
    key split, the expert STE per projection (3 expert-entry calls), the
    differentiable aux loss and combine; outputs, aux and every gradient
    (x, router and the three expert stacks) within the bound."""
    x, ws, r, tcfg, key, (lj, yj, auxj, gj) = moe_case
    te = TExe(mode="aimc", aimc=tcfg, compute_dtype="float32")
    calls = []
    orig = ta.aimc_apply_experts

    def rec(state, x_, cfg, keys=None):
        calls.append(keys)
        return orig(state, x_, cfg, keys)

    monkeypatch.setattr(ta, "aimc_apply_experts", rec)
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in ws.items()}
    y, aux = tmoe.moe_ffn(xt, pt["router"], pt["we_gate"], pt["we_up"],
                          pt["we_down"], top_k=2, capacity_factor=1.25,
                          exe=te, key=_tkey(key))
    loss = (y * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, [xt] + list(pt.values()))
    assert len(calls) == 3 and all(len(k) == 8 for k in calls)
    seeds = {tnoise.derive_read_seed(k) for ks in calls for k in ks}
    assert len(seeds) == 24                 # E x 3 distinct read seeds
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), rtol=0,
                               atol=_tol(yj))
    assert float(aux.detach()) == pytest.approx(float(auxj), rel=1e-6)
    assert float(loss.detach()) == pytest.approx(float(lj), rel=1e-5)
    want = [gj[0]] + [gj[1][k] for k in pt]
    for name, a, b in zip(["x"] + list(pt), grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=_tol(b), err_msg=name)


def test_moe_ffn_digital_ignores_key(moe_case):
    """Digitally the key draws nothing: the same output with and without."""
    x, ws, _, _, key, _ = moe_case
    te = TExe(compute_dtype="float32")
    args = [torch.from_numpy(ws[k]) for k in ("router", "we_gate", "we_up",
                                              "we_down")]
    a, _ = tmoe.moe_ffn(torch.from_numpy(x), *args, top_k=2,
                        capacity_factor=1.25, exe=te, key=_tkey(key))
    b, _ = tmoe.moe_ffn(torch.from_numpy(x), *args, top_k=2,
                        capacity_factor=1.25, exe=te)
    assert torch.equal(a, b)


@pytest.mark.parametrize("group_elems", [1, 1 << 26])
def test_programming_groups_and_batched_normals_move_no_value(group_elems,
                                                              monkeypatch):
    """`prng.normal_batch` equals per-key `prng.normal` bit for bit (also
    across chunk edges), and programming a stack in groups of instances
    (one matrix per group, or all at once) gives the codes and scales of
    programming each instance alone under its own key."""
    keys = prng.split(prng.PRNGKey(6), 5)
    monkeypatch.setitem(prng.CHUNK, "cpu", 96)
    assert torch.equal(prng.normal_batch(keys, (7, 40)),
                       torch.stack([prng.normal(k, (7, 40)) for k in keys]))
    monkeypatch.setattr(ta, "PROGRAM_GROUP_ELEMS", group_elems)
    _, tcfg = _cfgs(16, 0.003)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, 40, 24)).astype(np.float32))
    st = ta.program_stacked(w, tcfg, keys=keys)
    for i in range(5):
        one = ta.program_linear(w[i], tcfg, keys[i])
        assert torch.equal(st.w_q[i], one.w_q)
        assert torch.equal(st.s_w[i], one.s_w)
    st2 = ta.program_stacked(w, tcfg, prng.PRNGKey(6))
    assert torch.equal(st2.w_q, st.w_q)     # split(key, 5)[i] == keys[i]
