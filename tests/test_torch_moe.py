"""Parity of the port's MoE FFN (`repro_torch/models/moe.py`), its expert
kernel entry (`ops.aimc_matmul_experts`, the plain version on the CPU) and
the MoE transformer (olmoe-1b-7b and arctic-480b smoke configs) with the
JAX reference, on inputs drawn from a seed with numpy.

Pinned: routing (`gate_idx`, the sort dispatch's ``slot_o`` and expert
buffers) exact; aux within 1e-6; the digital FFN within ATOL; sort ==
einsum dispatch; cases where the capacity drops assignments and where an
expert gets no token (its DAC scale is the floor 1e-12 / 127); programmed
experts against the reference's `vmap` over its ``impl="ref"`` path; the
expert entry against `jax.vmap(aimc_matmul_pallas_v2)` in interpret mode;
MoE init key for key; prefill and decode logits, digital and programmed.

Tolerance: ATOL * max(1, max|y|) with ATOL = 1e-5 (f32 op order in the
router, the norms and the row-block sum). A DAC input on a rounding tie
lands on either side of it by an ulp of op order; a token may differ only
where an expert row it was routed to met a DAC input within TIE code units
of a tie (none do at these seeds)."""

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
from repro.kernels import ops as jops
from repro.kernels.aimc_mvm import aimc_matmul_pallas_v2
from repro.models import moe as jmoe
from repro.models.layers import Execution as JExe
from repro_torch.configs import get_arch as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import prng
from repro_torch.core import program as tp
from repro_torch.core.quant import adc_step_lsb
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Execution as TExe

assert jops  # imported first: repro.kernels.aimc_mvm needs ops loaded

ATOL = 1e-5
TIE = 1e-4
ARCHS = ("olmoe_1b_7b", "arctic_480b")
J32, T32 = JExe(compute_dtype="float32"), TExe(compute_dtype="float32")

# name -> (T tokens, d, E experts, top_k, skew): "drop" sends every token
# to experts 0 and 1 (cap 5 < 8 assignments each); "empty" routes 2 tokens
# over 8 experts (cap 1), so at least 4 experts get no token
CASES = {"plain": (12, 16, 8, 2, 0.0), "drop": (8, 16, 4, 2, 4.0),
         "empty": (2, 16, 8, 2, 0.0), "top8": (6, 24, 16, 8, 0.0)}


def _case(name, ff=24, seed=0):
    t, d, e, k, skew = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    if skew:
        x[:, 0] = skew
        router[0, :2] = (3.0, 2.5)
        router[0, 2:] = 0.0
    w = {n: (rng.standard_normal(shape) * 0.3).astype(np.float32)
         for n, shape in (("we_gate", (e, d, ff)), ("we_up", (e, d, ff)),
                          ("we_down", (e, ff, d)))}
    return x, router, w, k, e


def _cap(t, k, e):
    return max(1, int(t * k / e * 1.25))


def _ref_route(x, router, k):
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    vals, idx = jax.lax.top_k(probs, k)
    return np.asarray(vals / vals.sum(-1, keepdims=True)), np.asarray(idx)


@pytest.mark.parametrize("name", list(CASES))
def test_route_and_sort_dispatch_match_reference(name):
    x, router, _, k, e = _case(name)
    t = x.shape[0]
    cap = _cap(t, k, e)
    assert tmoe.capacity(t, k, e, 1.25) == cap
    vals_j, idx_j = _ref_route(x, router, k)
    vals_t, idx_t, aux_t = tmoe.route(torch.from_numpy(x),
                                      torch.from_numpy(router), k)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_allclose(vals_t.numpy(), vals_j, rtol=0, atol=1e-6)
    _, aux_j = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(router),
                            *(jnp.zeros((e, x.shape[1], 4)),) * 2,
                            jnp.zeros((e, 4, x.shape[1])), top_k=k,
                            capacity_factor=1.25, exe=J32)
    assert abs(float(aux_t) - float(aux_j)) <= 1e-6
    xe_j, slot_j = jmoe._dispatch_sort(jnp.asarray(x), jnp.asarray(idx_j),
                                       e, cap, k)
    xe_t, slot_t = tmoe._dispatch_sort(torch.from_numpy(x), idx_t, e, cap, k)
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(xe_t.numpy(), np.asarray(xe_j))
    counts = np.bincount(idx_j.ravel(), minlength=e)
    dropped = int((slot_t == e * cap).sum())
    assert dropped == int(np.maximum(counts - cap, 0).sum())
    if name == "drop":
        assert dropped > 0
    if name == "empty":
        assert (counts == 0).sum() >= 4


def test_top_k_ties_keep_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe.top_k_stable(probs, 2)
    vj, ij = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ij).tolist() == [[1, 2], [0, 1]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vj))


def _tol(y):
    return ATOL * max(1.0, float(np.abs(np.asarray(y)).max()))


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_digital_matches_reference(name):
    x, router, w, k, _ = _case(name)
    yj, auxj = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(router),
                            *(jnp.asarray(w[n]) for n in
                              ("we_gate", "we_up", "we_down")),
                            top_k=k, capacity_factor=1.25, exe=J32)
    yt, auxt = tmoe.moe_ffn(torch.from_numpy(x), torch.from_numpy(router),
                            *(torch.from_numpy(w[n]) for n in
                              ("we_gate", "we_up", "we_down")),
                            top_k=k, capacity_factor=1.25, exe=T32)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=_tol(yj))
    assert abs(float(auxt) - float(auxj)) <= 1e-6


@pytest.mark.parametrize("name", ["plain", "drop"])
def test_sort_dispatch_equals_einsum_dispatch(name, monkeypatch):
    """The reference's baseline (``REPRO_MOE_EINSUM=1``) in both packages:
    the same expert buffers as the sort dispatch and the same output to
    the f32 association of the combine."""
    x, router, w, k, _ = _case(name)
    args_t = [torch.from_numpy(a) for a in
              (x, router, w["we_gate"], w["we_up"], w["we_down"])]
    args_j = [jnp.asarray(a.numpy()) for a in args_t]
    y_sort, _ = tmoe.moe_ffn(*args_t, top_k=k, capacity_factor=1.25,
                             exe=T32)
    monkeypatch.setenv("REPRO_MOE_EINSUM", "1")
    y_ein, _ = tmoe.moe_ffn(*args_t, top_k=k, capacity_factor=1.25, exe=T32)
    yj_ein, _ = jmoe.moe_ffn(*args_j, top_k=k, capacity_factor=1.25,
                             exe=J32)
    tol = 1e-6 * max(1.0, float(y_sort.abs().max()))
    torch.testing.assert_close(y_ein, y_sort, rtol=0, atol=tol)
    np.testing.assert_allclose(y_ein.numpy(), np.asarray(yj_ein), rtol=0,
                               atol=_tol(yj_ein))
    _, idx, _ = tmoe.route(args_t[0], args_t[1], k)
    e, cap = router.shape[1], _cap(x.shape[0], k, router.shape[1])
    xe_e, _ = tmoe._dispatch_einsum(args_t[0], idx, idx.float(), e, cap, k)
    xe_s, _ = tmoe._dispatch_sort(args_t[0], idx, e, cap, k)
    assert torch.equal(xe_e, xe_s)


def _tie_rows(monkeypatch, fn):
    """Run ``fn()`` recording every expert-stack DAC input; returns (its
    output, the (expert, slot) rows with an input within TIE code units of
    a rounding tie)."""
    from repro_torch.models import layers as tl
    rows, orig = set(), tl.aimc_apply_experts

    def rec(state, x, cfg, *a, **k):
        e = x.shape[0]
        xf = x.reshape(e, x.shape[1], -1).to(torch.float32)
        s_x = xf.abs().amax(dim=(1, 2)).clamp_min(1e-12) / 127.0
        frac = (xf / s_x[:, None, None]).abs() % 1.0
        hit = ((frac - 0.5).abs() < TIE).any(-1)
        rows.update(map(tuple, torch.nonzero(hit).tolist()))
        return orig(state, x, cfg, *a, **k)

    monkeypatch.setattr(tl, "aimc_apply_experts", rec)
    out = fn()
    monkeypatch.setattr(tl, "aimc_apply_experts", orig)
    return out, rows


@pytest.mark.parametrize("name", list(CASES))
def test_programmed_experts_match_reference_vmap(name, monkeypatch):
    """Programmed expert stacks: the port's one-launch entry (plain version
    here) against the reference's `vmap` of `linear` over its programmed
    states (``impl="ref"``); the codes are equal, each expert takes its own
    DAC scale, and an expert with no token returns zeros."""
    x, router, w, k, e = _case(name)
    jcfg, tcfg = ja.AimcConfig(impl="ref"), ta.AimcConfig()
    js = {n: ja.program_stacked(jnp.asarray(a), jcfg) for n, a in w.items()}
    ts = {n: ta.program_stacked(torch.from_numpy(a), tcfg)
          for n, a in w.items()}
    for n in w:
        np.testing.assert_array_equal(ts[n].w_q.numpy(),
                                      np.asarray(js[n].w_q))
    je = JExe(mode="aimc", aimc=jcfg, compute_dtype="float32",
              programmed=True)
    te = TExe(mode="aimc", aimc=tcfg, compute_dtype="float32",
              programmed=True)
    yj, _ = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(router), js["we_gate"],
                         js["we_up"], js["we_down"], top_k=k,
                         capacity_factor=1.25, exe=je)
    (yt, _), tie_rows = _tie_rows(monkeypatch, lambda: tmoe.moe_ffn(
        torch.from_numpy(x), torch.from_numpy(router), ts["we_gate"],
        ts["we_up"], ts["we_down"], top_k=k, capacity_factor=1.25, exe=te))
    _, idx, _ = tmoe.route(torch.from_numpy(x), torch.from_numpy(router), k)
    cap = _cap(x.shape[0], k, e)
    _, slot_o = tmoe._dispatch_sort(torch.from_numpy(x), idx, e, cap, k)
    tie_slots = {ee * cap + c for ee, c in tie_rows}
    skip = {t for t in range(x.shape[0])
            if tie_slots & set(slot_o[t].tolist())}
    keep = [t for t in range(x.shape[0]) if t not in skip]
    assert len(skip) <= 1, f"DAC tie flips at tokens {sorted(skip)}"
    np.testing.assert_allclose(yt.numpy()[keep], np.asarray(yj)[keep],
                               rtol=0, atol=_tol(yj))
    if name == "empty":
        xe, _ = tmoe._dispatch_sort(torch.from_numpy(x), idx, e, cap, k)
        empty = [ee for ee in range(e) if not xe[ee].any()]
        assert empty
        g = ta.aimc_apply_experts(ts["we_gate"], xe, tcfg)
        assert not g[empty].any()


def _expert_operands(e=4, b=2, kb=2, m=128, np_=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, b, kb * m)).astype(np.float32)
    x[2] = 0.0                               # an expert that got no token
    w_q = rng.integers(-127, 128, (e, kb, m, np_), dtype=np.int8)
    s_w = ((rng.random((e, kb, np_)) + 0.5) * 1e-3).astype(np.float32)
    return x, w_q, s_w


def test_expert_entry_matches_vmapped_pallas_interpret():
    """E 4, B 2, KB 2: `ops.aimc_matmul_experts` (one call) against
    `jax.vmap(aimc_matmul_pallas_v2)` in interpret mode, each expert on its
    own DAC scale (expert 2 all zeros: scale 1e-12 / 127)."""
    x, w_q, s_w = _expert_operands()
    e, m = x.shape[0], w_q.shape[2]
    step = adc_step_lsb(m, 1.0)
    s_x = np.stack([max(float(np.abs(x[i]).max()), 1e-12) / 127.0
                    for i in range(e)]).astype(np.float32)
    yj = jax.vmap(lambda xx, ww, ss, sx: aimc_matmul_pallas_v2(
        xx, ww, ss, sx.reshape(1, 1), adc_step=step, block_b=8,
        block_n=128, interpret=True))(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(s_w), jnp.asarray(s_x))
    yt = tops.aimc_matmul_experts(*(torch.from_numpy(a) for a in
                                    (x, w_q, s_w, s_x)), adc_step=step)
    assert tuple(yt.shape) == (e, x.shape[1], w_q.shape[-1])
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=_tol(yj))
    assert not yt[2].any()


@pytest.mark.parametrize("input_scale", [0.0, 0.05])
def test_apply_experts_equals_per_expert_apply(input_scale):
    """`aimc_apply_experts` (one call) equals E `aimc_apply` calls bit for
    bit, dynamic and fixed DAC scale; read noise on experts (a noise model
    with a key, sigma > 0, a read key to `moe_ffn`) raises."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((5, 40, 24)).astype(np.float32))
    cfg = ta.AimcConfig(tile_rows=16, input_scale=input_scale)
    st = ta.program_stacked(w, cfg)
    x = torch.from_numpy(rng.standard_normal((5, 3, 40)).astype(np.float32))
    x[1] = 0.0
    y = ta.aimc_apply_experts(st, x, cfg)
    want = torch.stack([ta.aimc_apply(st[i], x[i], cfg) for i in range(5)])
    assert torch.equal(y, want)
    from repro_torch.core.noise import NoiseModel
    noisy = dataclasses.replace(cfg, noise=NoiseModel(sigma_read=0.003))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ta.aimc_apply_experts(st, x, noisy, prng.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.aimc_matmul_experts(x, st.w_q, st.s_w, torch.ones(5),
                                 adc_step=1.0, sigma=1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmoe.moe_ffn(x[0], torch.zeros(40, 5), st, st, st, top_k=1,
                     capacity_factor=1.25, exe=T32, key=prng.PRNGKey(0))


# ---------------------------------------------------------------------------
# the MoE transformer: olmoe-1b-7b and arctic-480b smoke configs
# ---------------------------------------------------------------------------

def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_on_keys_matches_reference(arch):
    """Router from ks[5], expert stacks from ks[6..8] (expert j of layer i
    from ``split(split(ks[6], L)[i], E)[j]``), arctic's dense residual from
    ks[9..11]: every leaf within 4 ulps, norms exact; programmed, the codes
    and the program's names, tenants, tiles and CM_* counts equal."""
    js, ts = get_arch(arch), tget(arch)
    jparams = js.model_module().init(jax.random.PRNGKey(0), js.smoke_cfg)
    tparams = ts.model_module().init(prng.PRNGKey(0), ts.smoke_cfg,
                                     device="cpu")
    jleaves = {"/".join(str(getattr(k, "key", k)) for k in path): v
               for path, v in jax.tree_util.tree_flatten_with_path(
                   jparams)[0]}
    tleaves = dict(tp._flatten(tparams))
    assert sorted(tleaves) == sorted(jleaves)
    assert ("wd_gate" in tparams["blocks"]) == (arch == "arctic_480b")
    for path, t in tleaves.items():
        j = np.asarray(jleaves[path])
        assert tuple(t.shape) == j.shape, path
        if "ln" in path or "norm" in path:
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            assert _ulps(t.numpy(), j).max() <= 4, path
    pj = jp.program_model(jparams, jp.MappingPlan(),
                          ja.AimcConfig(impl="ref"))
    pt = tp.program_model(tparams, tp.MappingPlan(), ta.AimcConfig())
    assert pt.names == pj.names and "blocks/router" not in pt.names
    assert pt.n_matrices == pj.n_matrices and pt.n_tiles == pj.n_tiles
    assert dataclasses.astuple(pt.initialize_counts()) == \
        dataclasses.astuple(pj.initialize_counts())
    assert dataclasses.astuple(pt.mvm_counts()) == \
        dataclasses.astuple(pj.mvm_counts())
    for name in pj.names:
        np.testing.assert_array_equal(pt[name].w_q.numpy(),
                                      np.asarray(pj[name].w_q))
    cfg = ts.smoke_cfg
    assert pt["blocks/we_gate"].stack_shape == (cfg.n_layers, cfg.n_experts)


_MODELS: dict = {}


def _models(arch, mode):
    if (arch, mode) in _MODELS:
        return _MODELS[arch, mode]
    cfg = get_arch(arch).smoke_cfg
    jparams = get_arch(arch).model_module().init(jax.random.PRNGKey(1), cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    if mode == "digital":
        out = (J32, jparams, T32, tparams)
    else:
        jcfg, tcfg = ja.AimcConfig(impl="ref"), ta.AimcConfig()
        out = (JExe(mode="aimc", aimc=jcfg, compute_dtype="float32",
                    programmed=True),
               jp.program_model(jparams, jp.MappingPlan(), jcfg)
               .install(jparams),
               TExe(mode="aimc", aimc=tcfg, compute_dtype="float32",
                    programmed=True),
               tp.program_model(tparams, tp.MappingPlan(), tcfg)
               .install(tparams))
    _MODELS[arch, mode] = out
    return out


@pytest.mark.parametrize("mode", ["digital", "aimc"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_decode_match_reference(arch, mode):
    """Ragged prefill (T = 3 x 12 routed positions, padding included) and
    two ragged decode steps (T = 3), logits and caches within ATOL of the
    reference; programmed experts run one expert-entry call per
    projection."""
    jm, tm = get_arch(arch).model_module(), tget(arch).model_module()
    cfg, tcfg = get_arch(arch).smoke_cfg, tget(arch).smoke_cfg
    je, jparams, te, tparams = _models(arch, mode)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab, (3, 12)).astype(np.int32)
    vl = np.array([12, 9, 10], np.int32)
    lj, cj = jm.prefill(jparams, jnp.asarray(toks), cfg, je, max_seq=16,
                        cache_dtype=jnp.float32, valid_len=jnp.asarray(vl))
    lt, ct = tm.prefill(tparams, torch.from_numpy(toks), tcfg, te,
                        max_seq=16, cache_dtype=torch.float32,
                        valid_len=torch.from_numpy(vl))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=_tol(lj))
    np.testing.assert_allclose(ct["v"].numpy(), np.asarray(cj["v"]), rtol=0,
                               atol=_tol(cj["v"]))
    nxt = np.array([[5], [7], [9]], np.int32)
    for _ in range(2):
        lj, cj = jm.decode_step(jparams, cj, jnp.asarray(nxt), cfg, je,
                                ragged=True)
        lt, ct = tm.decode_step(tparams, ct, torch.from_numpy(nxt), tcfg, te,
                                ragged=True)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=_tol(lj))


def test_moe_fuse_gate_stacks():
    """olmoe is MHA: wq/wk/wv fuse to one G=3 stack and the fused prefill
    and decode are bit-equal to the unfused ones; expert stacks never fuse.
    arctic (GQA) fuses nothing."""
    tm = tget("olmoe_1b_7b").model_module()
    cfg = tget("olmoe_1b_7b").smoke_cfg
    _, _, te, tparams = _models("olmoe_1b_7b", "aimc")
    fused = tm.fuse_gate_stacks(tparams)
    blocks = fused["blocks"]
    assert blocks["wqkv"].stack_shape == (cfg.n_layers, 3)
    assert {"we_gate", "we_up", "we_down"} <= set(blocks)
    assert "wq" not in blocks and "w_gu" not in blocks
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, (2, 8)).astype(np.int32))
    outs = [tm.prefill(p, toks, cfg, te, max_seq=10) for p in
            (tparams, fused)]
    assert torch.equal(outs[0][0], outs[1][0])
    nxt = torch.tensor([[5], [7]], dtype=torch.int32)
    d = [tm.decode_step(p, o[1], nxt, cfg, te, ragged=True)[0]
         for p, o in zip((tparams, fused), outs)]
    assert torch.equal(d[0], d[1])
    _, _, _, aparams = _models("arctic_480b", "aimc")
    assert tget("arctic_480b").model_module().fuse_gate_stacks(
        aparams)["blocks"].keys() == aparams["blocks"].keys()


def test_npz_round_trip_carries_the_moe_tree(tmp_path):
    """`convert.load_npz` (``--weights``) rebuilds arctic's router, expert
    stacks and dense residual leaf for leaf."""
    from repro_torch.convert import flatten_to_numpy, load_npz
    spec = get_arch("arctic_480b")
    jparams = jax.tree.map(np.asarray, spec.model_module().init(
        jax.random.PRNGKey(2), spec.smoke_cfg))
    flat = flatten_to_numpy(jparams)
    np.savez(tmp_path / "w.npz", **flat)
    got = flatten_to_numpy(load_npz(tmp_path / "w.npz"))
    assert sorted(got) == sorted(flat)
    assert {"blocks/router", "blocks/we_gate", "blocks/wd_down"} <= set(got)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v)
