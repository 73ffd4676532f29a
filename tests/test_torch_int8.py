"""int8-native serving and the small serve flags of the port against the
JAX reference: `core.quant.quantize_weight_int8` / `quantize_params_int8`,
`models.layers.as_weight`, the int8 granite-8b and olmoe-1b-7b forwards,
`--int8 --exec aimc` programming from the codes, and the CLI's `--int8`,
`--arrivals`, `--eos`, `--tile-rows` and `--adc-alpha`.

Tolerances: codes, scales, bf16 casts and programmed states are equal bit
for bit; forwards agree within 1e-5 x max(1, max|y|) (f32 op order);
CLI tokens are equal."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core import program as jp
from repro.core.quant import quantize_params_int8 as j_qparams
from repro.core.quant import quantize_weight_int8 as j_qweight
from repro.launch import serve as jserve
from repro.launch.shardings import EXPERT_IN, EXPERT_OUT, IN_PROJ, OUT_PROJ
from repro.models.layers import Execution as JExe
from repro.models.layers import as_weight as j_as_weight
from repro_torch.configs import get_arch as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import program as tp
from repro_torch.core import quant as tq
from repro_torch.core.prng import PRNGKey
from repro_torch.launch import serve as tserve
from repro_torch.models.layers import Execution as TExe
from repro_torch.models.layers import as_weight as t_as_weight
from repro_torch.runtime.engine import ServeEngine as TEngine

J_QUANTIZABLE = IN_PROJ | OUT_PROJ | EXPERT_IN | EXPERT_OUT | {"unembed"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tol(y):
    return 1e-5 * max(1.0, float(np.abs(y).max()))


def _leaves(tree, prefix=""):
    """{path: numpy array} of a nested dict of tensors (bf16 read as f32)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out |= _leaves(v, path)
        else:
            out[path] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def test_name_sets_are_the_references():
    assert tq.IN_PROJ == IN_PROJ and tq.OUT_PROJ == OUT_PROJ
    assert tq.EXPERT_IN == EXPERT_IN and tq.EXPERT_OUT == EXPERT_OUT
    assert tq.QUANTIZABLE == J_QUANTIZABLE


@pytest.mark.parametrize("shape", [(64, 32), (3, 40, 24), (2, 2, 16, 8)])
def test_codes_scales_and_as_weight_bit_equal(shape):
    w = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32) * 0.1
    w[..., 0, 0] = 0.0
    jq = j_qweight(jnp.asarray(w))
    tqw = tq.quantize_weight_int8(torch.from_numpy(w))
    assert tqw["q"].dtype == torch.int8
    assert tuple(tqw["s"].shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(tqw["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(tqw["s"].numpy(), np.asarray(jq["s"]))
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(j_as_weight(jq, jd).astype(jnp.float32))
        got = t_as_weight(tqw, td).float().numpy()
        np.testing.assert_array_equal(got, want)
    # per-channel symmetric int8: error <= scale / 2 element-wise
    err = np.abs(t_as_weight(tqw, torch.float32).numpy() - w)
    assert (err <= tqw["s"].numpy() * 0.5 + 1e-7).all()


def _to_jax(tree):
    """The reference's tree of a port tree (weights drawn by the port on
    JAX's keys, carried across through numpy)."""
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v.numpy())
            for k, v in tree.items()}


def _j_qparams(params):
    # eager, as the reference CLI calls it: under jit XLA turns the scale's
    # division by 127 into a multiply by its reciprocal (1 ulp off at times)
    return j_qparams(params, J_QUANTIZABLE)


@pytest.fixture(scope="module")
def granite():
    spec = get_arch("granite-8b")
    cfg = spec.smoke_cfg
    tparams = tget("granite-8b").model_module().init(PRNGKey(0), cfg,
                                                     device="cpu")
    params = _to_jax(tparams)
    return spec, cfg, params, _j_qparams(params), tq.quantize_params_int8(
        tparams)


def test_quantize_params_tree_bit_equal(granite):
    _, _, params, jq, tqp = granite
    want = {"/".join(str(p.key) for p in path):
            np.asarray(leaf.astype(jnp.float32)
                       if leaf.dtype == jnp.bfloat16 else leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jq)[0]}
    got = _leaves(tqp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tqp["embed"].dtype == torch.bfloat16           # skipped, cast
    assert tqp["blocks"]["wq"]["q"].dtype == torch.int8
    assert set(tqp["unembed"]) == {"q", "s"}

    def nbytes(tree):
        return sum(v.numel() * v.element_size() for v in _tensors(tree))

    # the reference's bar
    assert nbytes(tqp) < 0.45 * nbytes(params_from_numpy(_np(params)))


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


def test_int8_granite_prefill_and_decode_match(granite):
    spec, cfg, _, jq, tqp = granite
    toks = (np.arange(2 * 12).reshape(2, 12) * 3 + 1) % cfg.vocab
    jm, tm = spec.model_module(), tget("granite-8b").model_module()
    jexe, texe = (JExe(compute_dtype="float32", serve_int8=True),
                  TExe(compute_dtype="float32", serve_int8=True))
    jl, jc = jm.prefill(jq, jnp.asarray(toks, jnp.int32), cfg, jexe,
                        max_seq=16, cache_dtype=jnp.float32)
    tl, tc = tm.prefill(tqp, torch.from_numpy(toks).to(torch.int32), cfg,
                        texe, max_seq=16, cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=_tol(np.asarray(jl)))
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl2, _ = jm.decode_step(jq, jc, jnp.asarray(nxt), cfg, jexe)
    tl2, _ = tm.decode_step(tqp, tc, torch.from_numpy(nxt), cfg, texe)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=0,
                               atol=_tol(np.asarray(jl2)))


def test_int8_olmoe_prefill_matches():
    """olmoe's experts through `as_weight`. The reference cannot serve an
    int8 router ("router" is in its IN_PROJ set and `moe_ffn` reads
    ``router_w.shape``); the port dequantizes it, so the reference here
    gets the dequantized router as an f32 leaf, the port the int8 pair."""
    spec = get_arch("olmoe-1b-7b")
    cfg = spec.smoke_cfg
    tparams = tget("olmoe-1b-7b").model_module().init(PRNGKey(1), cfg,
                                                      device="cpu")
    jq = _j_qparams(_to_jax(tparams))
    with pytest.raises(AttributeError):
        spec.model_module().prefill(jq, jnp.ones((1, 4), jnp.int32), cfg,
                                    JExe(compute_dtype="float32"))
    jq["blocks"]["router"] = j_as_weight(jq["blocks"]["router"], jnp.float32)
    tqp = tq.quantize_params_int8(tparams)
    assert set(tqp["blocks"]["router"]) == {"q", "s"}
    assert set(tqp["blocks"]["we_gate"]) == {"q", "s"}
    toks = (np.arange(10)[None] * 7 + 2) % cfg.vocab
    jl, _ = spec.model_module().prefill(
        jq, jnp.asarray(toks, jnp.int32), cfg, JExe(compute_dtype="float32"),
        max_seq=12, cache_dtype=jnp.float32)
    tl, _ = tget("olmoe-1b-7b").model_module().prefill(
        tqp, torch.from_numpy(toks).to(torch.int32), cfg,
        TExe(compute_dtype="float32"), max_seq=12,
        cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=_tol(np.asarray(jl)))


def test_int8_aimc_programs_equal(granite):
    """`--int8 --exec aimc`: the crossbars are programmed from the int8
    codes (the {"q", "s"} pair is one leaf of the walk)."""
    _, _, _, jq, tqp = granite
    jprog = jp.program_model(jq, jp.MappingPlan(n_contexts=2),
                             ja.AimcConfig(impl="ref"))
    tprog = tp.program_model(tqp, tp.MappingPlan(n_contexts=2),
                             ta.AimcConfig())
    assert tprog.names == jprog.names and tprog.contexts == jprog.contexts
    assert "blocks/wq" in tprog.names and "unembed" not in tprog.names
    for tst, jst in zip(tprog.states, jprog.states):
        np.testing.assert_array_equal(tst.w_q.numpy(), np.asarray(jst.w_q))
        np.testing.assert_array_equal(tst.s_w.numpy(), np.asarray(jst.s_w))
    inst = tprog.install(tqp)
    assert isinstance(inst["blocks"]["wq"], ta.AimcLinearState)
    assert set(inst["unembed"]) == {"q", "s"}             # digital, int8


# The CLI check runs recurrentgemma-9b's smoke config: under jax 0.9 the
# reference CLI cannot serve the transformer family (its `shard_act`
# asserts under the CLI's explicit mesh); its rglru path serves all four
# flags.
CLI_ARCH = "recurrentgemma-9b"


def _cli(main, extra):
    return main(["--arch", CLI_ARCH, "--smoke", "--requests", "4",
                 "--prompt-len", "8", "--gen", "6", "--slots", "4",
                 "--seed", "0", *extra])


def _tokens(report):
    return {rid: list(rec.tokens) for rid, rec in report.records.items()}


def test_cli_flags_match_reference():
    """--exec aimc with --arrivals, --tile-rows, --adc-alpha and an --eos
    taken from the EOS-free run's tokens: the JAX CLI's tokens and
    retirements."""
    flags = ["--exec", "aimc", "--arrivals",
             "0,0.0001,0.0002,0.0003", "--tile-rows", "32", "--adc-alpha",
             "0.5"]
    eos = _cli(tserve.main, flags + ["--device", "cpu"]).report.tokens(0)[1]
    want = _cli(jserve.main, flags + ["--eos", str(eos)])
    run = _cli(tserve.main, flags + ["--eos", str(eos), "--device", "cpu"])
    assert _tokens(run.report) == _tokens(want)
    reasons = {rid: rec.finish_reason
               for rid, rec in run.report.records.items()}
    assert reasons == {rid: rec.finish_reason
                       for rid, rec in want.records.items()}
    assert reasons[0] == "eos"
    assert [r.arrival for r in run.requests] == [0.0, 0.0001, 0.0002, 0.0003]
    cfg = run.engine.exe.aimc
    assert (cfg.tile_rows, cfg.adc_alpha) == (32, 0.5)
    assert run.program.states[0].w_q.shape[-2] == 32


def test_cli_int8_digital_serves_the_packed_tree():
    """--int8 on the digital path: the CLI packs its weights and serves the
    tokens of the engine over `quantize_params_int8` of the same init."""
    run = tserve.main(["--arch", "granite-8b", "--smoke", "--requests", "3",
                       "--prompt-len", "8", "--gen", "5", "--int8",
                       "--device", "cpu"])
    assert run.engine.exe.serve_int8 and run.program is None
    assert set(run.engine.params["blocks"]["w_down"]) == {"q", "s"}
    tm = tget("granite-8b")
    params = tq.quantize_params_int8(tm.model_module().init(
        PRNGKey(0), tm.smoke_cfg, device="cpu"))
    eng = TEngine(tm.model_module(), tm.smoke_cfg, run.engine.exe, params,
                  n_slots=3, prompt_pad=8, max_seq=13)
    assert _tokens(eng.serve(run.requests)) == _tokens(run.report)


@pytest.mark.parametrize("argv", [
    ["--trace", "poisson:10", "--arrivals", "0,0,0,0"],
    ["--tile-rows", "-1"], ["--adc-alpha", "-0.5"],
    ["--static", "--arrivals", "0,0,0,0"]])
def test_cli_refuses_what_the_reference_refuses(argv):
    with pytest.raises(SystemExit):
        jserve.parse_args(argv)
    with pytest.raises(SystemExit):
        tserve.parse_args(argv)


def test_cli_arrivals_count_must_match():
    with pytest.raises(SystemExit):
        _cli(tserve.main, ["--arrivals", "0,0", "--device", "cpu"])
