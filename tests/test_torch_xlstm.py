"""Parity of the port's xLSTM (`repro_torch/models/xlstm.py`) with the JAX
reference on the xlstm-350m smoke config (2 mLSTM/sLSTM pairs, d_model 32),
weights carried across with `params_from_numpy`, digital and programmed
(noise off; the reference's plain `impl="ref"` kernel oracle vs the port's
plain versions on the CPU).

Pinned: `init` on JAX's keys (constant leaves exact, drawn leaves within 4
ulps, the noise-free programmed codes equal); `decode_step` over several
steps, ragged `prefill` (``valid_len``) and a `prefill_chunk` leg from a
carried state — logits and every cache leaf within ATOL; inside the port,
`fuse_gate_stacks` rewrites the reference's keys and is bit-equal to the
unfused path.

Tolerance: ATOL * max(1, max|y|) with ATOL = 1e-5, on logits and every
state leaf (the mLSTM matrix memory grows past 1 over the steps). The two
frameworks sum in different f32 orders (the port's norms and contractions
use `layers.row_sum`'s fixed order), so a DAC input on a rounding tie can
land on either side: programmed decode steps start from the reference's
state (teacher forcing), and a row may differ only on a step where its own
DAC met an input within 1e-4 code units of a tie (at most one such row
per rollout; none at these seeds)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

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
ARCH = "xlstm-350m"
CFG = get_arch(ARCH).smoke_cfg
JM = get_arch(ARCH).model_module()
TCFG = tget(ARCH).smoke_cfg
TM = tget(ARCH).model_module()
MAX_SEQ = 16


def _install(jparams, tparams):
    jcfg, tcfg = ja.AimcConfig(impl="ref"), ta.AimcConfig()
    return (JExe(mode="aimc", aimc=jcfg, compute_dtype="float32",
                 programmed=True),
            jp.program_model(jparams, jp.MappingPlan(), jcfg).install(jparams),
            TExe(mode="aimc", aimc=tcfg, compute_dtype="float32",
                 programmed=True),
            tp.program_model(tparams, tp.MappingPlan(), tcfg).install(tparams))


@pytest.fixture(scope="module")
def models():
    jparams = JM.init(jax.random.PRNGKey(0), CFG)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return {"digital": (JExe(compute_dtype="float32"), jparams,
                        TExe(compute_dtype="float32"), tparams),
            "aimc": _install(jparams, tparams)}


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
    return rng.integers(1, CFG.vocab, (b, s)).astype(np.int32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): v
            for path, v in flat}


@pytest.mark.parametrize("seed", [0, 5])
def test_init_on_keys_matches_reference(seed):
    """Constant leaves (norms, biases, b_if) exact; drawn leaves within 4
    ulps; programmed noise-free, the int8 codes are equal."""
    jparams = JM.init(jax.random.PRNGKey(seed), CFG)
    tparams = TM.init(prng.PRNGKey(seed), TCFG, device="cpu")
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
    assert "pairs/slstm/r_zifo" not in pt.names
    for name in pj.names:
        np.testing.assert_array_equal(pt[name].w_q.numpy(),
                                      np.asarray(pj[name].w_q), err_msg=name)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_decode_steps_match_reference(models, mode, monkeypatch):
    je, jparams, te, tparams = models[mode]
    toks = _tokens()
    cj = JM.init_cache(CFG, 3, MAX_SEQ, jnp.float32)
    jdec = _jit(CFG, je)[0]
    ct = TM.init_cache(TCFG, 3, MAX_SEQ, torch.float32)
    skipped = []
    for t in range(toks.shape[1]):
        tok = toks[:, t:t + 1]
        if mode == "aimc":
            ct = _teacher(cj)
        lj, cj = jdec(jparams, cj, jnp.asarray(tok))
        (lt, ct2), ties = _tie_rows(monkeypatch, lambda: TM.decode_step(
            tparams, ct, torch.from_numpy(tok), TCFG, te))
        assert tuple(lt.shape) == (3, 1, CFG.vocab)
        # a row may differ only where its own DAC met a tie this step
        skip = {b for b in ties if mode == "aimc"
                and not np.allclose(lt[b].numpy(), np.asarray(lj)[b],
                                    rtol=0, atol=1e-3)}
        skipped += [(t, b) for b in skip]
        _close_rows(lt, lj, ct2, cj, skip)
        assert not torch.equal(ct2["m_C"], ct["m_C"])   # input untouched
        ct = ct2
    assert len(skipped) <= 1, f"DAC tie flips at (step, row) {skipped}"


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_ragged_prefill_matches_reference(models, mode):
    je, jparams, te, tparams = models[mode]
    toks, vl = _tokens(), np.array([8, 5, 3], np.int32)
    lj, cj = _jit(CFG, je)[1](jparams, jnp.asarray(toks), jnp.asarray(vl))
    lt, ct = TM.prefill(tparams, torch.from_numpy(toks), TCFG, te,
                        max_seq=MAX_SEQ, cache_dtype=torch.float32,
                        valid_len=torch.from_numpy(vl))
    _close(lt, lj)
    _close_cache(ct, cj)
    np.testing.assert_array_equal(ct["len"].numpy(), vl)


@pytest.mark.parametrize("mode", ["digital", "aimc"])
def test_prefill_leg_from_carried_state_matches_reference(models, mode):
    """A 4-token leg (span 3: one padded row) from the state a 5-token
    prefill left, as the engine's recurrent legs carry it."""
    je, jparams, te, tparams = models[mode]
    toks = _tokens(b=1, s=9, seed=2)
    _, jpre, jleg = _jit(CFG, je)
    _, cj = jpre(jparams, jnp.asarray(toks[:, :5]),
                 jnp.full((1,), 5, jnp.int32))
    _, ct = TM.prefill(tparams, torch.from_numpy(toks[:, :5]), TCFG, te,
                       max_seq=MAX_SEQ, cache_dtype=torch.float32)
    leg = toks[:, 5:9].copy()
    leg[:, 3] = 0
    lj, cj = jleg(jparams, cj, jnp.asarray(leg), jnp.int32(3))
    lt, ct = TM.prefill_chunk(tparams, ct, torch.from_numpy(leg), TCFG, te, 3)
    _close(lt, lj)
    _close_cache(ct, cj)
    assert int(ct["len"][0]) == 8


def test_fuse_gate_stacks_keys_and_bit_equal(models):
    je, jparams, te, tparams = models["aimc"]
    fused = TM.fuse_gate_stacks(tparams)
    fused_j = JM.fuse_gate_stacks(jparams)
    for blk in ("mlstm", "slstm"):
        assert sorted(fused["pairs"][blk]) == sorted(fused_j["pairs"][blk])
    m = fused["pairs"]["mlstm"]
    assert m["w_qkv"].stack_shape == (CFG.n_layers // 2, 3)
    assert m["w_ug"].stack_shape == (CFG.n_layers // 2, 2)
    assert fused["pairs"]["slstm"]["w_ff_gu"].stack_shape == \
        (CFG.n_layers // 2, 2)
    toks, vl = _tokens(), torch.tensor([8, 5, 3], dtype=torch.int32)
    outs = [TM.prefill(p, torch.from_numpy(toks), TCFG, te, max_seq=MAX_SEQ,
                       cache_dtype=torch.float32, valid_len=vl)
            for p in (tparams, fused)]
    assert torch.equal(outs[0][0], outs[1][0])
    nxt = torch.tensor([[5], [7], [9]], dtype=torch.int32)
    d0, c0 = TM.decode_step(tparams, outs[0][1], nxt, TCFG, te)
    d1, c1 = TM.decode_step(fused, outs[1][1], nxt, TCFG, te)
    assert torch.equal(d0, d1)
    assert all(torch.equal(c0[k], c1[k]) for k in c0)


def test_fuse_gate_stacks_is_noop_on_digital(models):
    _, _, _, tparams = models["digital"]
    fused = TM.fuse_gate_stacks(tparams)
    for blk in ("mlstm", "slstm"):
        assert fused["pairs"][blk].keys() == tparams["pairs"][blk].keys()


def test_params_from_numpy_carries_tree(models, tmp_path):
    """`convert.params_from_numpy` carries the reference's nested tree
    across (raw and installed: programmed states by duck typing), and the
    flat npz archive `--weights` reads round-trips it."""
    from repro_torch.convert import flatten_to_numpy, load_npz
    from repro_torch.core.aimc import AimcLinearState
    for mode in ("digital", "aimc"):
        _, jparams, _, tparams = models[mode]
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
    _, jparams, _, tparams = models["digital"]
    path = tmp_path / "w.npz"
    np.savez(path, **flatten_to_numpy(jax.tree.map(np.asarray, jparams)))
    back = load_npz(path)
    assert dict(tp._flatten(back)).keys() == dict(tp._flatten(tparams)).keys()
    for (p, a), (_, b) in zip(tp._flatten(back), tp._flatten(tparams)):
        assert torch.equal(a, b), p
