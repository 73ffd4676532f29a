"""The MoE expert entry's choice of body (`kernels.aimc_mvm.expert_body`), a
pure function of the shape and the card's SM count, at every expert shape
the port's paths run on an H100 (132 SMs): olmoe-1b-7b's and arctic-480b's
serving stacks at decode and prefill capacity, granite-8b's [36] health
probe stacks at B 2 (`csrc/aimc_mvm.cu`'s body, "mma"), and olmoe-1b-7b's
training projections whole (E 64) and per data:2,model:2 position (E 32)
at microbatches of 4 and 8 sequences of 2048 ("wide",
`csrc/aimc_experts.cu`). Capacities come from the configs through
`models.moe.capacity`, as the MoE FFN computes them. Both bodies give the
same bits (`tests/test_torch_kernels_cuda.py`, on the card); what these
tests hold is which one a shape gets, with no card and no kernel build.

The wide body's ADC divides by Markstein's correction from the rounded
reciprocal in place of the IEEE division (`div_fast` in
`csrc/aimc_experts.cuh`): q0 = RN(a r), rem = RN(a - q0 s) (one fused
multiply-add), q = RN(q0 + rem r) (another), r = RN(1 / s). No theorem is
relied on: on the card, `aimc_mvm.check_fast_paths` compares it with the
IEEE division on every float |a| <= 2^25 at the launch's own step before
the wrapper lets the body take it (`aimc_mvm.fast_epilogue`). The tests
here check the same arithmetic with no card, emulating those three
roundings exactly in float64 (each product of two float32 is exact there;
the last sum's second rounding is resolved from its exact error term) and
holding the quotient to numpy's IEEE float32 division bit for bit: at every
integer accumulator |a| <= 2^24 (a crossbar of up to 1040 rows) under the
ADC steps of the configurations, and at sampled noisy accumulators
acc + sigma z across read noises 2^-20 .. 2^20. Tolerance: none (bits)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import numpy as np
import pytest

from repro_torch.configs import get_arch
from repro_torch.core.quant import adc_step_lsb
from repro_torch.kernels import aimc_mvm
from repro_torch.models.moe import capacity

H100_SMS = 132
SLOTS, PROMPT = 4, 16            # chip_smoke's decode slots and prompt pad


def _cap(arch: str, tokens: int) -> int:
    cfg = get_arch(arch).model_cfg
    return capacity(tokens, cfg.top_k, cfg.n_experts, cfg.capacity_factor)


def _expert_projections(arch: str):
    """(name, K, N) of the expert stacks: we_gate and we_up share a
    shape."""
    cfg = get_arch(arch).model_cfg
    return (("we_gate", cfg.d_model, cfg.d_ff),
            ("we_down", cfg.d_ff, cfg.d_model))


def _padded(k: int, n: int, rows: int = 512):
    """(KB, M, Np) of a programmed [K, N] state on rows-row tiles."""
    kb = -(-k // rows)
    return kb, rows, -(-n // 128) * 128


def _path_shapes():
    """(label, E, C, K, N, body) at every expert shape the paths run."""
    out = []
    for arch in ("olmoe-1b-7b", "arctic-480b"):
        e = get_arch(arch).model_cfg.n_experts
        for leg, tokens in (("decode", SLOTS), ("prefill", PROMPT)):
            for name, k, n in _expert_projections(arch):
                out.append((f"{arch} serve {leg} {name}", e,
                            _cap(arch, tokens), k, n, "mma"))
    granite = get_arch("granite-8b").model_cfg
    d, ff = granite.d_model, granite.d_ff
    kv = granite.n_kv_heads * granite.hd
    for name, k, n in (("wq", d, d), ("wk", d, kv), ("wo", d, d),
                       ("w_gate", d, ff), ("w_down", ff, d)):
        out.append((f"granite-8b probe {name}", granite.n_layers, 2, k, n,
                    "mma"))
    olmoe = get_arch("olmoe-1b-7b").model_cfg
    for micro in (4, 8):
        c = _cap("olmoe-1b-7b", micro * 2048)
        for e, where in ((olmoe.n_experts, "whole"),
                         (olmoe.n_experts // 2, "data:2,model:2 position")):
            for name, k, n in _expert_projections("olmoe-1b-7b"):
                out.append((f"olmoe-1b-7b train microbatch {micro} {where} "
                            f"{name}", e, c, k, n, "wide"))
    return out


PATH_SHAPES = _path_shapes()


def test_path_capacities():
    """The capacities the paths give: 1-2 rows per expert serving, 1280 and
    2560 training (olmoe's capacity factor 1.25, top-8 of 64)."""
    caps = {label: c for label, _, c, _, _, _ in PATH_SHAPES}
    assert {c for label, c in caps.items() if "serve" in label} <= {1, 2}
    assert {c for label, c in caps.items() if "train" in label} == {1280,
                                                                    2560}


@pytest.mark.parametrize("label,e,c,k,n,body", PATH_SHAPES,
                         ids=[s[0] for s in PATH_SHAPES])
def test_expert_body_at_path_shapes(label, e, c, k, n, body):
    kb, m, np_ = _padded(k, n)
    assert aimc_mvm.expert_body(c, kb, m, np_, e, H100_SMS) == body


@pytest.mark.parametrize("b,np_,e,sms,body", [
    (31, 1024, 64, 132, "mma"),       # under a quarter tile of rows
    (32, 1024, 64, 132, "wide"),      # 8 x 1 x 64 = 512 tiles
    (16, 2048, 64, 132, "mma"),
    (128, 128, 131, 132, "mma"),      # 131 tiles: one SM idle
    (128, 128, 132, 132, "wide"),
    (2560, 1024, 1, 160, "wide"),     # 8 x 20 = 160 tiles on 160 SMs
    (2560, 1024, 1, 161, "mma"),      # ... but not on 161
    (333, 1024, 8, 132, "wide"),      # ragged: 3 row tiles, 192 tiles
    (64, 1024, 8, 132, "mma")])       # 64 tiles
def test_expert_body_rule(b, np_, e, sms, body):
    """The rule: "wide" once an expert fills a quarter of a 128-row tile
    and the tiles (128 columns x 128 rows x experts) cover every SM."""
    assert aimc_mvm.expert_body(b, 4, 512, np_, e, sms) == body


def test_expert_body_names_the_bodies():
    assert aimc_mvm.EXPERT_BODIES == ("mma", "wide")
    assert aimc_mvm.WIDE_ROWS == 128


def _two_sum_err(a, b, s):
    """The exact error of the float64 sum s = RN(a + b) (Knuth's TwoSum)."""
    bb = s - a
    return (a - (s - bb)) + (b - bb)


def _round_f32(s64, err):
    """RN32 of the exact value s64 + err, where |err| <= ulp64(s64) / 2: s64
    rounded, except that an s64 on a float32 midpoint rounds toward err."""
    q = s64.astype(np.float32)
    q64 = q.astype(np.float64)
    toward = np.where(s64 > q64, np.float32(np.inf), np.float32(-np.inf))
    other = np.nextafter(q, toward)
    mid = (q64 != s64) & ((q64 + other.astype(np.float64)) / 2 == s64)
    up = np.where(err > 0, np.maximum(q, other), np.minimum(q, other))
    return np.where(mid & (err != 0), up, q)


def div_fast(a, s):
    """The body's quotient of float32 ``a`` by the ADC step ``s``,
    emulated exactly."""
    s = np.float32(s)
    r = np.float32(1.0) / s                      # RN(1 / s), the host's
    a64 = a.astype(np.float64)
    q0 = (a64 * np.float64(r)).astype(np.float32)           # exact product
    p = q0.astype(np.float64) * np.float64(s)
    rem64 = a64 - p
    assert not _two_sum_err(a64, -p, rem64).any()           # a - q0 s exact
    rem = rem64.astype(np.float32)
    t = rem.astype(np.float64) * np.float64(r)
    s64 = q0.astype(np.float64) + t
    return _round_f32(s64, _two_sum_err(q0.astype(np.float64), t, s64))


def _bits_equal(a, s):
    want = (a / np.float32(s)).astype(np.float32)
    return np.array_equal(div_fast(a, s).view(np.uint32), want.view(np.uint32))


STEPS = {"512 rows": adc_step_lsb(512, 1.0),
         "512 rows alpha 0.5": adc_step_lsb(512, 0.5),
         "256 rows": adc_step_lsb(256, 1.0),
         "700 rows": adc_step_lsb(700, 1.0),
         "1024 rows alpha 2": adc_step_lsb(1024, 2.0)}


@pytest.mark.parametrize("name", list(STEPS))
def test_div_fast_equals_ieee_on_every_integer_sum(name):
    s = STEPS[name]
    for lo in range(-(1 << 24), 1 << 24, 1 << 22):
        a = np.arange(lo, lo + (1 << 22), dtype=np.int64).astype(np.float32)
        assert _bits_equal(a, s), (name, lo)


@pytest.mark.parametrize("sigma", [2.0 ** -20, 1e-3, 57.5, 2.0 ** 20])
def test_div_fast_equals_ieee_on_noisy_sums(sigma):
    """acc + sigma z (float32, as the kernel adds them) for uniform integer
    sums and normal draws, the zero sum among them; the smallest nonzero
    sums the noise can give (sigma times the least |z|) too."""
    rng = np.random.default_rng(int(sigma * 1e6) % 1000)
    acc = rng.integers(-(512 * 127 ** 2), 512 * 127 ** 2 + 1, 1 << 21)
    acc[:1 << 16] = 0
    z = rng.standard_normal(1 << 21).astype(np.float32)
    z[:64] = np.float32(3.4e-4) * np.logspace(-10, 0, 64, dtype=np.float32)
    a = acc.astype(np.float32) + np.float32(sigma) * z
    for s in STEPS.values():
        assert _bits_equal(a, s), s
