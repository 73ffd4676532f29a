"""Parity of the port's RecurrentGemma / Griffin hybrid
(`repro_torch/models/rglru.py`) with the JAX reference on the
recurrentgemma-9b smoke config (1 (rec, rec, attn) unit + a 2-block tail,
d_model 48, window 16) and on a 6-layer variant with no tail, weights
carried across with `params_from_numpy`, digital and programmed (noise off;
b_a/b_x ride K2's bias epilogue on the port's plain version).

Pinned: `init` on JAX's keys (constant leaves exact, drawn leaves within 4
ulps, the tail's w_ff_down from ``fold_in(key, 99)``, the noise-free codes
equal); `decode_step` for 20 steps, past the 16-slot window so the ring
buffer wraps; ragged `prefill` (``valid_len``) and a `prefill_chunk` leg
from a carried state — logits and every cache leaf within ATOL.

Tolerance: ATOL * max(1, max|leaf|) with ATOL = 1e-5 (f32 op order; the
port's norms and attention sum in `layers.row_sum`'s fixed order, RG-LRU's
sqrt(1 - a^2) is taken in f64 and rounded once). A DAC input on a rounding
tie lands on either side of it by an ulp: programmed decode steps start
from the reference's state (teacher forcing), and a row may differ only on
a step where its own DAC met an input within 1e-4 code units of a tie (at
most one per rollout: the 6-layer programmed rollout meets one at step 2,
x / s_x = 71.49997 in the reference, 71.5 in the port)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core import program as jp
from repro.models.layers import Execution as JExe
from repro_torch.configs import get_arch as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import prng
from repro_torch.core import program as tp
from repro_torch.models.layers import Execution as TExe

ATOL = 1e-5
TIE = 1e-4      # DAC code units: an f32 ulp of |x / s_x| <= 127 is < 1e-5
ARCH = "recurrentgemma-9b"
JM = get_arch(ARCH).model_module()
TM = tget(ARCH).model_module()
SMOKE = get_arch(ARCH).smoke_cfg
MAX_SEQ = 24
# the smoke config (5 layers: 1 unit + 2 tail blocks) and one with no tail
LAYERS = (5, 6)


def _cfgs(n_layers):
    return (dataclasses.replace(SMOKE, n_layers=n_layers),
            dataclasses.replace(tget(ARCH).smoke_cfg, n_layers=n_layers))


_MODELS: dict = {}


def _models(n_layers, mode):
    if (n_layers, mode) in _MODELS:
        return _MODELS[n_layers, mode]
    cfg, _ = _cfgs(n_layers)
    jparams = JM.init(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    if mode == "digital":
        out = (JExe(compute_dtype="float32"), jparams,
               TExe(compute_dtype="float32"), tparams)
    else:
        jcfg, tcfg = ja.AimcConfig(impl="ref"), ta.AimcConfig()
        out = (JExe(mode="aimc", aimc=jcfg, compute_dtype="float32",
                    programmed=True),
               jp.program_model(jparams, jp.MappingPlan(),
                                jcfg).install(jparams),
               TExe(mode="aimc", aimc=tcfg, compute_dtype="float32",
                    programmed=True),
               tp.program_model(tparams, tp.MappingPlan(),
                                tcfg).install(tparams))
    _MODELS[n_layers, mode] = out
    return out


_JITS: dict = {}


def _jit(cfg, je):
    """The reference's decode_step / prefill / prefill_chunk, jitted once
    per (config, execution)."""
    key = (cfg, je.mode)
    if key not in _JITS:
        _JITS[key] = (
            jax.jit(lambda p, c, t: JM.decode_step(p, c, t, cfg, je)),
            jax.jit(lambda p, t, vl: JM.prefill(
                p, t, cfg, je, max_seq=MAX_SEQ, cache_dtype=jnp.float32,
                valid_len=vl)),
            jax.jit(lambda p, c, t, s: JM.prefill_chunk(p, c, t, cfg, je, s)))
    return _JITS[key]


def _teacher(cj):
    """The reference's cache as the port's input. Programmed steps start
    from it (teacher forcing): the two frameworks' f32 op orders differ by
    ulps, and where a DAC input sits on a rounding tie that ulp flips a
    code, which a free-running recurrence would carry into every later
    step. Digital steps run free."""
    return {k: torch.from_numpy(np.array(v)) for k, v in cj.items()}


def _tie_rows(monkeypatch, step):
    """Run ``step()`` (one programmed port step) recording every DAC input;
    returns (its output, the batch rows with an input within TIE code
    units of a rounding tie). Only there can an ulp of op order flip a DAC
    code (the MAC and the ADC are exact on integers)."""
    from repro_torch.models import layers as tl
    rows, orig = set(), tl.aimc_apply

    def rec(state, x, cfg, *a, **k):
        xf = x.reshape(x.shape[0], -1).to(torch.float32)
        s_x = (cfg.input_scale if cfg.input_scale > 0
               else float(xf.abs().max()) / 127.0)
        frac = (xf / s_x).abs() % 1.0
        rows.update(torch.nonzero((frac - 0.5).abs() < TIE)[:, 0].tolist())
        return orig(state, x, cfg, *a, **k)

    monkeypatch.setattr(tl, "aimc_apply", rec)
    out = step()
    monkeypatch.setattr(tl, "aimc_apply", orig)
    return out, rows


def _close_rows(lt, lj, ct, cj, skip):
    """`_close` and `_close_cache` on the batch rows not in ``skip``."""
    keep = [b for b in range(lt.shape[0]) if b not in skip]
    _close(lt[keep], np.asarray(lj)[keep])
    _close_cache({k: v.index_select(0 if k == "len" else 1,
                                    torch.tensor(keep))
                  for k, v in ct.items()},
                 {k: np.take(np.asarray(v), keep, axis=0 if k == "len"
                             else 1) for k, v in cj.items()})


def _close_cache(ct, cj):
    assert sorted(ct) == sorted(cj)
    for name in ct:
        j = np.asarray(cj[name])
        t = ct[name].numpy()
        assert t.shape == j.shape and t.dtype == j.dtype, name
        if name == "len":
            np.testing.assert_array_equal(t, j)
        else:
            tol = ATOL * max(1.0, float(np.abs(j).max()))
            np.testing.assert_allclose(t, j, rtol=0, atol=tol, err_msg=name)


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(j).max())))


def _tokens(b=3, s=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, SMOKE.vocab, (b, s)).astype(np.int32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): v
            for path, v in flat}


@pytest.mark.parametrize("n_layers", LAYERS)
@pytest.mark.parametrize("seed", [0, 5])
def test_init_on_keys_matches_reference(seed, n_layers):
    cfg, tcfg = _cfgs(n_layers)
    jparams = JM.init(jax.random.PRNGKey(seed), cfg)
    tparams = TM.init(prng.PRNGKey(seed), tcfg, device="cpu")
    assert ("tail" in tparams) == bool(cfg.n_tail)
    jl = _leaves(jparams)
    tl_ = dict(tp._flatten(tparams))
    assert sorted(tl_) == sorted(jl)
    for path, t in tl_.items():
        j = np.asarray(jl[path])
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
        if np.unique(j).size <= 2:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=path)
        else:
            assert _ulps(t.numpy(), j).max() <= 4, path
    pj = jp.program_model(jparams, jp.MappingPlan(), ja.AimcConfig(impl="ref"))
    pt = tp.program_model(tparams, tp.MappingPlan(), ta.AimcConfig())
    assert pt.names == pj.names
    assert not any("conv" in n or "lam" in n or "/b_" in n for n in pt.names)
    for name in pj.names:
        np.testing.assert_array_equal(pt[name].w_q.numpy(),
                                      np.asarray(pj[name].w_q), err_msg=name)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_decode_past_window_matches_reference(n_layers, mode,
                                               monkeypatch):
    """20 decode steps against a 16-slot ring buffer (max_seq 24): slots
    0..3 are overwritten, and the attention masks nothing once full."""
    cfg, tcfg = _cfgs(n_layers)
    je, jparams, te, tparams = _models(n_layers, mode)
    toks = _tokens(s=20, seed=1)
    cj = JM.init_cache(cfg, 3, MAX_SEQ, jnp.float32)
    jdec = _jit(cfg, je)[0]
    ct = TM.init_cache(tcfg, 3, MAX_SEQ, torch.float32)
    assert ct["k"].shape[2] == cfg.window == 16
    skipped = []
    for t in range(toks.shape[1]):
        tok = toks[:, t:t + 1]
        if mode == "aimc":
            ct = _teacher(cj)
        lj, cj = jdec(jparams, cj, jnp.asarray(tok))
        (lt, ct2), ties = _tie_rows(monkeypatch, lambda: TM.decode_step(
            tparams, ct, torch.from_numpy(tok), tcfg, te))
        # a row may differ only where its own DAC met a tie this step
        skip = {b for b in ties if mode == "aimc"
                and not np.allclose(lt[b].numpy(), np.asarray(lj)[b],
                                    rtol=0, atol=1e-3)}
        skipped += [(t, b) for b in skip]
        _close_rows(lt, lj, ct2, cj, skip)
        assert not torch.equal(ct2["r_a"], ct["r_a"])   # input untouched
        ct = ct2
    assert len(skipped) <= 1, f"DAC tie flips at (step, row) {skipped}"
    assert int(ct["len"][0]) == 20


@pytest.mark.parametrize("mode", ["digital", "aimc"])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_ragged_prefill_matches_reference(n_layers, mode):
    cfg, tcfg = _cfgs(n_layers)
    je, jparams, te, tparams = _models(n_layers, mode)
    toks, vl = _tokens(), np.array([8, 5, 3], np.int32)
    lj, cj = _jit(cfg, je)[1](jparams, jnp.asarray(toks), jnp.asarray(vl))
    lt, ct = TM.prefill(tparams, torch.from_numpy(toks), tcfg, te,
                        max_seq=MAX_SEQ, cache_dtype=torch.float32,
                        valid_len=torch.from_numpy(vl))
    _close(lt, lj)
    _close_cache(ct, cj)
    np.testing.assert_array_equal(ct["len"].numpy(), vl)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_prefill_leg_from_carried_state_matches_reference(mode):
    cfg, tcfg = _cfgs(5)
    je, jparams, te, tparams = _models(5, mode)
    toks = _tokens(b=1, s=9, seed=2)
    _, jpre, jleg = _jit(cfg, je)
    _, cj = jpre(jparams, jnp.asarray(toks[:, :5]),
                 jnp.full((1,), 5, jnp.int32))
    _, ct = TM.prefill(tparams, torch.from_numpy(toks[:, :5]), tcfg, te,
                       max_seq=MAX_SEQ, cache_dtype=torch.float32)
    leg = toks[:, 5:9].copy()
    leg[:, 3] = 0
    lj, cj = jleg(jparams, cj, jnp.asarray(leg), jnp.int32(3))
    lt, ct = TM.prefill_chunk(tparams, ct, torch.from_numpy(leg), tcfg, te, 3)
    _close(lt, lj)
    _close_cache(ct, cj)
    assert int(ct["len"][0]) == 8


def test_ring_write_matches_reference_signed_zeros():
    """The ring write is the reference's one-hot blend, bit for bit, signed
    zeros included: writing -0.0 over 1.5 stores +0.0 (1.5 * 0 + -0.0), and
    an untouched -0.0 becomes +0.0 when the row writes +4.0 elsewhere
    (-0.0 * 1 + 0 * 4.0); an index_copy would keep both -0.0."""
    kc = torch.tensor([[[[1.5]], [[-0.0]], [[2.0]]],
                       [[[1.0]], [[3.0]], [[-0.0]]]])         # [2, 3, 1, 1]
    k = torch.tensor([[[[-0.0]]], [[[4.0]]]])
    pos = torch.tensor([3, 4], dtype=torch.int32)            # slots 0 and 1
    out = TM._ring_write(kc, k, pos)
    joh = jax.nn.one_hot(jnp.asarray(pos) % 3, 3, dtype=jnp.float32)
    joh = joh[..., None, None]
    jout = jnp.asarray(kc.numpy()) * (1 - joh) + joh * jnp.asarray(k.numpy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(torch.signbit(out).numpy(),
                                  np.signbit(np.asarray(jout)))
    assert torch.signbit(out).flatten().tolist() == [False, True, False,
                                                     False, False, False]
    assert out.flatten().tolist() == [0.0, 0.0, 2.0, 1.0, 4.0, 0.0]


@pytest.mark.parametrize("n_layers", LAYERS)
def test_params_from_numpy_carries_tree(n_layers, tmp_path):
    """`convert.params_from_numpy` carries the reference's nested tree
    across (raw and installed: programmed states by duck typing), and the
    flat npz archive `--weights` reads round-trips it."""
    from repro_torch.convert import flatten_to_numpy, load_npz
    from repro_torch.core.aimc import AimcLinearState
    for mode in ("digital", "aimc"):
        _, jparams, _, tparams = _models(n_layers, mode)
        jl = _leaves(jparams)
        tl_ = {}
        for path, leaf in tp._flatten(tparams):
            if isinstance(leaf, AimcLinearState):
                tl_[path + "/w_q"], tl_[path + "/s_w"] = leaf.w_q, leaf.s_w
            else:
                tl_[path] = leaf
        assert sorted(tl_) == sorted(jl), mode
        for path, t in tl_.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jl[path]))
    _, jparams, _, tparams = _models(n_layers, "digital")
    path = tmp_path / "w.npz"
    np.savez(path, **flatten_to_numpy(jax.tree.map(np.asarray, jparams)))
    back = load_npz(path)
    assert dict(tp._flatten(back)).keys() == dict(tp._flatten(tparams)).keys()
    for (p, a), (_, b) in zip(tp._flatten(back), tp._flatten(tparams)):
        assert torch.equal(a, b), p
