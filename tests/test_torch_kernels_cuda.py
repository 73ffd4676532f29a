"""Card-only checks of the Hopper AIMC kernels K1-K4 (`repro_torch/kernels/
csrc/aimc_mvm.cu`, `philox.cuh`) against their plain PyTorch versions on the
same CUDA tensors. Without a CUDA device every test here skips; run them on the card
with ``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.

This file imports no JAX (the card's machine has none); the CPU parity of
the plain versions with the JAX reference is `test_torch_aimc_mvm.py`.

The launcher tiles by batch (16 or 64 rows per block) and splits narrow
grids over row blocks (a scratch and a row-block sum kernel);
`test_k2_tilings_match_plain` runs every mode and ragged edge, and a split
grid's rows equal an unsplit grid's bit for bit.

Tolerance: the kernel adds each row block's dequantized contribution in
turn (the Pallas kernel's association) while the plain version sums the
codes times s_w first and scales once, so outputs agree to f32 rounding of
a KB-term sum: |err| <= 1e-5 * max(1, max|y|). ADC and DAC codes are equal,
and a stacked gate is bit-equal to its single-gate launch, under either
noise source. K4's raw Philox draws are held to the moments of N(0, 1):
mean within 4 sigma/sqrt(n), std within 1%, |lag-1 and gate-to-gate
correlation| < 0.01 over 2^21 draws.

The serving path on the card: K2's bias epilogue at qwen1.5-110b's decode
shapes (d_model 8192, 64/8 heads) equals the plain version within the
same bound, and a paged decode step serves the dense engine's tokens at
smoke size (tokens equal). The MoE expert entry (`aimc_mvm_experts`, K2
over an [E] stack with a per-expert input and DAC scale) equals E K2
launches bit for bit at olmoe's and arctic's shapes and past 16 experts,
and olmoe's smoke config on the card matches the CPU. The health probe of
a layer stack (one expert-entry launch) equals L K2 launches bit for bit,
and a dead crossbar (`with_gain(0.0)`) reaches K2 as an all-zero scale.
Placement and rotation: each rotation state's `install_subset` tree on the
card installs exactly its resident leaves (the rest stay the raw CUDA
weights), its analog leaves run K2 within the bound above, and a rotating
engine's K2 launches per pass follow the state in force.

The expert entry's second body (`csrc/aimc_experts.cu`, "wide", chosen
for large capacities) equals E seeded K2 launches bit for bit at
olmoe-1b-7b's training projections cut in E only (E 8, C 2560), at a
ragged C, past 16 experts, at KB 1, at M 300 and on a column piece, noise
off and on, and its plain version within the bound above; its branch-free
epilogue equals cprng.cuh's radius and cosine, the counter draw and the
IEEE division on every argument a draw or a sum can give
(`aimc_mvm.check_fast_paths`), and a read noise whose sums pass what that
check covers takes the library calls.

The draws (`aimc_mvm.draws`, csrc/cprng.cuh through csrc/f32math.cuh)
equal their plain versions on the card bit for bit: the counter draws of
2^24 counters, Box-Muller's radius and cosine of every 24-bit word, and
log1p of -u^2 over the 2^23 uniforms of `prng.normal`; so do K2 (counter
noise) and K4 ("hw") at zero weights, where every output is a draw's code.

Sharded serving: K2, K3 and the expert entry launched over column pieces
(`core.aimc.split_columns`, one launch per piece with the whole x's DAC
scale) concatenate to the whole launch bit for bit at three shapes each,
one of them with pieces in another grid mode than the whole. The pieces
are views of the whole's codes (the kernels read them at the whole's row
stride); with a read key they draw the whole launch's noise (counter and
"hw"), a contiguous copy of a piece too.
"""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import numpy as np
import pytest
import torch

from repro_torch.core.quant import adc_step_lsb, sym_scale
from repro_torch.kernels import aimc_mvm, cprng, ops, ref


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _operands(b, kb, m, np_, g=None, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    lead = () if g is None else (g,)
    x = rng.standard_normal((b, kb * m)).astype(np.float32)
    w_q = rng.integers(-127, 128, lead + (kb, m, np_), dtype=np.int8)
    s_w = (rng.random(lead + (kb, np_), dtype=np.float32) + 0.5) * 1e-3
    bias = rng.standard_normal(lead + (np_,)).astype(np.float32)
    t = [torch.from_numpy(a).to(device) for a in (x, w_q, s_w, bias)]
    s_x = sym_scale(t[0]).reshape(1, 1)
    return t[0], t[1], t[2], s_x, t[3]


def _close(y, want):
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    err = float((y - want).abs().max())
    assert err <= tol, f"max |err| {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("b,kb,m,np_", [
    (4, 8, 512, 4096), (16, 1, 512, 1024), (5, 3, 64, 384), (1, 2, 96, 128),
    (33, 2, 128, 256)])
@pytest.mark.parametrize("sigma", [0.0, 57.5])
def test_k2_matches_plain(dev, b, kb, m, np_, sigma):
    x, w_q, s_w, s_x, _ = _operands(b, kb, m, np_, device=dev)
    step = adc_step_lsb(m, 1.0)
    y = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, 0xC0FFEE, adc_step=step,
                             sigma=sigma)
    want = ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, 0xC0FFEE, adc_step=step,
                                  sigma=sigma)
    torch.cuda.synchronize()
    _close(y, want)


def _device_operands(dev, b, kb, np_, seed, m=512):
    """K2 operands made on the card (the largest case holds 58.8M x values)."""
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((b, kb * m), generator=gen, device=dev)
    w_q = torch.randint(-127, 128, (kb, m, np_), generator=gen, device=dev,
                        dtype=torch.int8)
    s_w = (torch.rand((kb, np_), generator=gen, device=dev) + 0.5) * 1e-3
    bias = torch.randn((np_,), generator=gen, device=dev)
    return x, w_q, s_w, bias


def _splits(x, w_q):
    """Whether the launcher splits this K2 call over row blocks."""
    return aimc_mvm.launch_plan(x.device, x.shape[0], *w_q.shape)["split"]


@pytest.mark.cuda
@pytest.mark.parametrize("b,kb,np_,g,rows,split", [
    (4, 8, 1024, 1, 16, True),        # granite wk at decode
    (16, 28, 4096, 1, 16, True),      # granite w_down, prompt pad
    (4, 8, 14336, 2, 16, True),       # granite w_gu stack (K3)
    (8, 2, 750 + 18, 4, 16, True),    # LSTM gate stack, Np padded
    (1352, 5, 256, 1, 16, False),     # CNN-F conv2-4
    (23328, 5, 256, 1, 64, False),    # CNN-M conv1
    (4, 1, 1024, 1, 16, False)])      # one row block: nothing to split
def test_launch_plan(dev, b, kb, np_, g, rows, split):
    """The launcher's tiling and split choice at the main paths' shapes
    (as on a 132-SM H100) and the workspace it asks the wrapper for."""
    np_ = -(-np_ // 128) * 128
    plan = aimc_mvm.launch_plan(dev, b, kb, 512, np_, g)
    assert plan["rows_per_block"] == rows and plan["split"] == split
    assert plan["kernels_per_call"] == (3 if split else 2)
    codes = b * kb * 512
    assert plan["workspace_bytes"] == -(-codes // 256) * 256 + (
        g * kb * b * np_ * 4 if split else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("np_", [128, 1024])
@pytest.mark.parametrize("kb", [1, 3, 28])
@pytest.mark.parametrize("b", [1, 3, 4, 5, 15, 16, 17, 100, 4099])
@pytest.mark.parametrize("sigma", [0.0, 57.5])
def test_k2_tilings_match_plain(dev, b, kb, np_, sigma):
    """Both row tilings (16 and 64 rows), split and unsplit grids and every
    ragged batch edge, noise off and on."""
    x, w_q, s_w, bias = _device_operands(dev, b, kb, np_, seed=b * 131 + kb)
    s_x = sym_scale(x).reshape(1, 1)
    step = adc_step_lsb(512, 1.0)
    kw = dict(adc_step=step, sigma=sigma, activation="relu")
    y = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, 0xC0FFEE, bias, **kw)
    want = ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, 0xC0FFEE, bias, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    _close(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kb,np_", [(3, 1024), (8, 4096), (28, 128)])
@pytest.mark.parametrize("noise_source", ["off", "hw"])
def test_split_rows_bit_equal_to_unsplit(dev, kb, np_, noise_source):
    """With s_x fixed, a row's output does not depend on B (noise off, or
    Philox noise, which is addressed by the logical element): x[:4] runs
    on a split grid and the same rows padded to B = 4099 on an unsplit
    one, and the two agree bit for bit."""
    x, w_q, s_w, bias = _device_operands(dev, 4099, kb, np_, seed=kb)
    s_x = sym_scale(x).reshape(1, 1)
    kw = dict(adc_step=adc_step_lsb(512, 1.0), activation="tanh",
              sigma=0.0 if noise_source == "off" else 57.5,
              noise_source="counter" if noise_source == "off" else "hw")
    assert _splits(x[:4], w_q) and not _splits(x, w_q)
    small = aimc_mvm.aimc_mvm_v2(x[:4].contiguous(), w_q, s_w, s_x, 5, bias,
                                 **kw)
    big = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, 5, bias, **kw)
    torch.cuda.synchronize()
    assert torch.equal(small, big[:4])
    _close(big, ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, 5, bias, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "relu", "sigmoid", "tanh"])
def test_k2_epilogues_with_bias(dev, act):
    x, w_q, s_w, s_x, bias = _operands(6, 2, 128, 256, device=dev)
    step = adc_step_lsb(128, 1.0)
    y = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, 7, bias, adc_step=step,
                             sigma=20.0, activation=act)
    want = ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, 7, bias, adc_step=step,
                                  sigma=20.0, activation=act)
    _close(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.0, 40.0])
def test_k3_bit_equal_to_per_gate_k2(dev, sigma):
    x, w_q, s_w, s_x, bias = _operands(7, 2, 128, 384, g=3, device=dev)
    step = adc_step_lsb(128, 1.0)
    acts = ("sigmoid", "tanh", "relu")
    y = aimc_mvm.aimc_mvm_stacked(x, w_q, s_w, s_x, 99, bias, adc_step=step,
                                  sigma=sigma, activations=acts)
    for g in range(3):
        yg = aimc_mvm.aimc_mvm_v2(x, w_q[g], s_w[g], s_x,
                                  cprng.stack_seed(99, g), bias[g],
                                  adc_step=step, sigma=sigma,
                                  activation=acts[g])
        assert torch.equal(y[g], yg)
    want = ref.aimc_matmul_stacked_ref(x, w_q, s_w, s_x, 99, bias,
                                       adc_step=step, sigma=sigma,
                                       activations=acts)
    _close(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,kb,m,np_", [
    (16, 2, 512, 1024), (8, 2, 512, 3072), (8, 2, 512, 128), (5, 3, 64, 384),
    (1000, 1, 512, 128)])
def test_k1_matches_plain(dev, b, kb, m, np_):
    x, w_q, s_w, s_x, _ = _operands(b, kb, m, np_, device=dev)
    noise = 57.5 * torch.randn((kb, b, np_), device=dev,
                               generator=torch.Generator(dev).manual_seed(1))
    step = adc_step_lsb(m, 1.0)
    y = aimc_mvm.aimc_mvm_v1(x, w_q, s_w, s_x, noise, adc_step=step)
    want = ref.aimc_matmul_ref(x, w_q, s_w, s_x, noise, adc_step=step)
    torch.cuda.synchronize()
    _close(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,kb,m,np_", [
    (4, 8, 512, 4096), (16, 2, 512, 1024), (5, 3, 64, 384), (33, 2, 128, 256)])
def test_k4_matches_plain_philox(dev, b, kb, m, np_):
    x, w_q, s_w, s_x, bias = _operands(b, kb, m, np_, device=dev)
    step = adc_step_lsb(m, 1.0)
    y = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, 0xC0FFEE, bias, adc_step=step,
                             sigma=57.5, activation="relu",
                             noise_source="hw")
    want = ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, 0xC0FFEE, bias,
                                  adc_step=step, sigma=57.5,
                                  activation="relu", noise_source="hw")
    torch.cuda.synchronize()
    _close(y, want)
    again = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, 0xC0FFEE, bias,
                                 adc_step=step, sigma=57.5, activation="relu",
                                 noise_source="hw")
    other = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, 0xC0FFEF, bias,
                                 adc_step=step, sigma=57.5, activation="relu",
                                 noise_source="hw")
    assert torch.equal(y, again) and not torch.equal(y, other)


def _raw_noise(dev, seed, noise_source, g=1, b=512, np_=4096):
    """The kernel's raw standard-normal draws, [g, b, np_]: with zero
    weights, unit scales and a unit ADC step, each output is the ADC code
    rint(16 * z) of its draw z (|16 z| < 127 for every draw here)."""
    x = torch.ones((b, 64), device=dev)
    w_q = torch.zeros((g, 1, 64, np_), dtype=torch.int8, device=dev)
    s_w = torch.ones((g, 1, np_), device=dev)
    s_x = torch.ones((1, 1), device=dev)
    y = aimc_mvm.aimc_mvm_stacked(x, w_q, s_w, s_x, seed, adc_step=1.0,
                                  sigma=16.0, noise_source=noise_source)
    return y.double() / 16.0


@pytest.mark.cuda
def test_k4_raw_draw_moments(dev):
    z = _raw_noise(dev, 0x5EED, "hw", g=2)
    flat = z[0].flatten()
    n = flat.numel()
    assert abs(float(flat.mean())) < 4.0 / n ** 0.5
    assert abs(float(flat.std()) - 1.0) < 0.01
    lag1 = float(torch.corrcoef(torch.stack([flat[:-1], flat[1:]]))[0, 1])
    gates = float(torch.corrcoef(torch.stack([flat, z[1].flatten()]))[0, 1])
    assert abs(lag1) < 0.01 and abs(gates) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("noise_source", ["counter", "hw"])
def test_k3_gate_bit_equal_to_k2_per_noise_source(dev, noise_source):
    x, w_q, s_w, s_x, bias = _operands(8, 2, 512, 768, g=4, device=dev)
    step = adc_step_lsb(512, 1.0)
    acts = ("sigmoid", "sigmoid", "tanh", "sigmoid")
    y = aimc_mvm.aimc_mvm_stacked(x, w_q, s_w, s_x, 77, bias, adc_step=step,
                                  sigma=57.5, activations=acts,
                                  noise_source=noise_source)
    for g in range(4):
        yg = aimc_mvm.aimc_mvm_v2(x, w_q[g], s_w[g], s_x,
                                  cprng.stack_seed(77, g), bias[g],
                                  adc_step=step, sigma=57.5,
                                  activation=acts[g],
                                  noise_source=noise_source)
        assert torch.equal(y[g], yg)
    want = ref.aimc_matmul_stacked_ref(x, w_q, s_w, s_x, 77, bias,
                                       adc_step=step, sigma=57.5,
                                       activations=acts,
                                       noise_source=noise_source)
    _close(y, want)


@pytest.mark.cuda
def test_dispatch_counts_launches_and_never_falls_back(dev):
    x, w_q, s_w, s_x, _ = _operands(4, 1, 64, 128, device=dev)
    aimc_mvm.reset_counts()
    ops.aimc_matmul_v2(x, w_q, s_w, s_x, adc_step=8.0)
    ops.aimc_matmul_stacked(x, w_q[None], s_w[None], s_x, adc_step=8.0)
    ops.aimc_matmul(x, w_q, s_w, s_x, torch.zeros((1, 4, 128), device=dev),
                    adc_step=8.0)
    ops.aimc_matmul_v2(x, w_q, s_w, s_x, 3, adc_step=8.0, sigma=1.0,
                       noise_source="hw")
    ops.aimc_matmul_stacked(x, w_q[None], s_w[None], s_x, 3, adc_step=8.0,
                            sigma=1.0, noise_source="hw")
    ops.aimc_matmul_experts(x[None], w_q[None], s_w[None], s_x.reshape(1),
                            adc_step=8.0)
    assert aimc_mvm.LAUNCHES == {
        "aimc_mvm_v1": 1, "aimc_mvm_v2": 1, "aimc_mvm_stacked": 1,
        "aimc_mvm_v2_hw": 1, "aimc_mvm_stacked_hw": 1,
        "aimc_mvm_experts": 1}
    with pytest.raises(ValueError):
        ops.aimc_matmul_v2(x, w_q.cpu(), s_w, s_x, adc_step=8.0)
    assert aimc_mvm.LAUNCHES["aimc_mvm_v2"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("np_", [512, 640])
@pytest.mark.parametrize("m", [700, 1024])
@pytest.mark.parametrize("kb", [1, 2, 3])
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("sigma", [0.0, 57.5])
def test_k2_multicore_shapes_match_plain(dev, b, kb, m, np_, sigma):
    """The multi-core mappings' row heights (M 1024: MLP/CNN tiles; M 700:
    the LSTM at n_h 600, whose codes rows pad to 768 and whose weight rows
    end mid-tile), B 1 and 16, and the 512/640-column shards of a split."""
    x, w_q, s_w, bias = _device_operands(dev, b, kb, np_,
                                         seed=m * 7 + kb * 3 + b, m=m)
    s_x = sym_scale(x).reshape(1, 1)
    step = adc_step_lsb(m, 1.0)
    kw = dict(adc_step=step, sigma=sigma, activation="relu")
    y = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, 0xBEEF, bias, **kw)
    want = ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, 0xBEEF, bias, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    _close(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cores", [2, 4])
def test_column_split_mlp_bit_equal_to_one_core_on_card(dev, cores):
    """The MLP case-3/case-4 mappings on the card (one K2 launch per shard)
    equal the 1-core run bit for bit, noise off, at the reference's
    multi-core configuration (n 1024, 1024-row tiles, B 1)."""
    from repro_torch.core import prng
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.models import paper_nets as pn
    cfg = AimcConfig(tile_rows=1024, tile_cols=1024)
    key = prng.PRNGKey(0)
    p = pn.mlp_init(key, 1024, device=dev)
    x = prng.normal(prng.fold_in(key, 1), (1, 1024), device=dev)
    y1, _ = pn.mlp_forward_multicore(p, x, cfg, 1)
    aimc_mvm.reset_counts()
    ym, sched = pn.mlp_forward_multicore(p, x, cfg, cores)
    torch.cuda.synchronize()
    assert aimc_mvm.LAUNCHES["aimc_mvm_v2"] == len(sched.shards)
    assert torch.equal(ym, y1)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w_q, s_w, s_x, _ = _operands(2, 1, 64, 128)
    with pytest.raises(ValueError, match="CUDA"):
        aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, adc_step=8.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 1024], ids=["wq", "wk"])
def test_k2_bias_epilogue_at_qwen_decode_shapes(dev, n):
    """qwen's QKV projections at decode (B 4 slots, K 8192 = 16 row blocks
    of 512): the bias rides the fused epilogue and equals the plain
    version; it also equals the kernel without bias plus the bias."""
    x, w_q, s_w, s_x, bias = _operands(4, 16, 512, n, seed=3, device=dev)
    step = adc_step_lsb(512, 1.0)
    y = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, None, bias, adc_step=step)
    want = ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, None, bias,
                                  adc_step=step)
    _close(y, want)
    plain = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, None, None, adc_step=step)
    _close(y, plain + bias)


@pytest.mark.cuda
def test_paged_decode_on_card_equals_dense(dev):
    """The llama3.2-3b smoke config programmed on the card: the paged
    engine (page_size 4) and the legged prefix-cache engine (fixed DAC
    scale) emit the dense engine's tokens, every projection on K2."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.core.program import MappingPlan, program_model
    from repro_torch.models.layers import Execution
    from repro_torch.runtime.batcher import Request, synchronized_trace
    from repro_torch.runtime.engine import ServeEngine

    spec = get_arch("llama3.2-3b")
    cfg, model = spec.smoke_cfg, spec.model_module()
    params = model.init(prng.PRNGKey(0), cfg, device=dev)
    acfg = AimcConfig(input_scale=0.1)
    prog = program_model(params, MappingPlan(), acfg, prng.PRNGKey(2))
    inst = prog.install(params)
    exe = Execution(mode="aimc", aimc=acfg, compute_dtype="float32",
                    programmed=True)
    shared = tuple(range(1, 9))
    reqs = [dataclasses.replace(r, prompt=shared + r.prompt[8:])
            for r in synchronized_trace(4, prompt_len=11, max_new=5,
                                        seed=1, vocab=cfg.vocab)]
    assert all(isinstance(r, Request) for r in reqs)
    kw = dict(n_slots=4, prompt_pad=12, max_seq=20, program=prog,
              family=spec.family, module=spec.module)
    outs = []
    for extra in ({}, {"page_size": 4},
                  {"page_size": 4, "prefix_cache": True,
                   "prefill_chunk": 4}):
        eng = ServeEngine(model, cfg, exe, inst, **kw, **extra)
        counts = eng.warmup()
        aimc_mvm.reset_counts()
        rep = eng.serve(list(reqs))
        outs.append([rep.tokens(r.rid) for r in reqs])
        assert eng.compile_counts() == counts
        assert aimc_mvm.LAUNCHES["aimc_mvm_v2"] > 0
        assert rep.page_ledger_exact
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.cuda
@pytest.mark.parametrize("kb,np_", [(4, 128), (1, 1408), (3, 1024)],
                         ids=["w_if n8", "w_ff_gate n1365", "w_ff_down k1365"])
def test_k2_at_xlstm_decode_shapes(dev, kb, np_):
    """xlstm-350m's new K2 shapes at decode (B 4): w_if (2048 -> 8, padded
    to 128 lanes), the sLSTM FFN (1024 -> 1365, 1408 lanes) and its down
    projection (K 1365 in 3 row blocks, the last one partial: x is zero
    past 1365)."""
    x, w_q, s_w, s_x, _ = _operands(4, kb, 512, np_, seed=5, device=dev)
    if kb == 3:
        x[:, 1365:] = 0.0
    step = adc_step_lsb(512, 1.0)
    y = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, adc_step=step)
    want = ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, adc_step=step)
    _close(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("g,kb,np_", [(3, 4, 2048), (2, 2, 2048),
                                      (2, 2, 1408)],
                         ids=["w_qkv G3", "w_ug G2", "w_ff_gu G2"])
def test_k3_at_xlstm_gate_stacks(dev, g, kb, np_):
    """xlstm's fused stacks at decode (B 4): w_qkv is K3's first G=3 stack
    on a serving path; each gate is bit-equal to its K2 launch and the
    stack is within the bound of its plain version."""
    x, w_q, s_w, s_x, _ = _operands(4, kb, 512, np_, g=g, seed=6, device=dev)
    step = adc_step_lsb(512, 1.0)
    y = aimc_mvm.aimc_mvm_stacked(x, w_q, s_w, s_x, adc_step=step)
    for i in range(g):
        assert torch.equal(y[i], aimc_mvm.aimc_mvm_v2(x, w_q[i], s_w[i], s_x,
                                                      adc_step=step))
    _close(y, ref.aimc_matmul_stacked_ref(x, w_q, s_w, s_x, adc_step=step))


@pytest.mark.cuda
def test_k2_bias_epilogue_at_rglru_gates(dev):
    """recurrentgemma-9b's RG-LRU gates w_a / w_x at decode (B 4, 4096 ->
    4096) with b_a / b_x in the fused epilogue."""
    x, w_q, s_w, s_x, bias = _operands(4, 8, 512, 4096, seed=7, device=dev)
    step = adc_step_lsb(512, 1.0)
    y = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, None, bias, adc_step=step)
    _close(y, ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, None, bias,
                                     adc_step=step))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-350m", "recurrentgemma-9b"])
def test_recurrent_serving_on_card_equals_static(dev, arch):
    """The recurrent smoke configs programmed on the card with a fixed DAC
    scale: the engine, the snapshot-paged engine and `static_generate`
    emit the same tokens; xlstm's fused stacks too."""
    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.core.program import MappingPlan, program_model
    from repro_torch.models.layers import Execution
    from repro_torch.runtime.batcher import synchronized_trace
    from repro_torch.runtime.engine import ServeEngine, static_generate

    spec = get_arch(arch)
    cfg, model = spec.smoke_cfg, spec.model_module()
    params = model.init(prng.PRNGKey(0), cfg, device=dev)
    acfg = AimcConfig(input_scale=0.05)
    prog = program_model(params, MappingPlan(), acfg, prng.PRNGKey(2))
    inst = prog.install(params)
    exe = Execution(mode="aimc", aimc=acfg, compute_dtype="float32",
                    programmed=True)
    reqs = synchronized_trace(3, prompt_len=8, max_new=5, seed=1,
                              vocab=cfg.vocab)
    prompts = torch.tensor([r.prompt for r in reqs], dtype=torch.int32,
                           device=dev)
    want = static_generate(model, cfg, exe, inst, prompts, 5,
                           max_seq=16)[0].tolist()
    trees = [inst] + ([model.fuse_gate_stacks(inst)]
                      if hasattr(model, "fuse_gate_stacks") else [])
    for params_, extra in [(t, {}) for t in trees] + [
            (inst, {"page_size": 2, "prefix_cache": True})]:
        eng = ServeEngine(model, cfg, exe, params_, n_slots=3, prompt_pad=8,
                          max_seq=16, program=prog, family=spec.family,
                          module=spec.module, **extra)
        counts = eng.warmup()
        rep = eng.serve(list(reqs))
        assert [rep.tokens(r.rid) for r in reqs] == want
        assert eng.compile_counts() == counts


def _expert_operands(e, b, kb, np_, seed, device, m=512):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        rng.standard_normal((e, b, kb * m)).astype(np.float32)).to(device)
    x[1] = 0.0                               # an expert that got no token
    w_q = torch.from_numpy(rng.integers(-127, 128, (e, kb, m, np_),
                                        dtype=np.int8)).to(device)
    s_w = torch.from_numpy(
        (rng.random((e, kb, np_), dtype=np.float32) + 0.5) * 1e-3).to(device)
    s_x = sym_scale(x.reshape(e, -1), dim=1).reshape(e)
    return x, w_q, s_w, s_x


@pytest.mark.cuda
@pytest.mark.parametrize("e,b,kb,np_", [
    (64, 1, 4, 1024), (64, 2, 2, 2048), (128, 1, 14, 4864), (128, 1, 10, 7168),
    (20, 3, 3, 384)],
    ids=["olmoe we_gate decode", "olmoe we_down prefill",
         "arctic we_gate decode", "arctic we_down decode", "E 20 > 16 gates"])
def test_expert_entry_bit_equal_to_per_expert_k2(dev, e, b, kb, np_):
    """`aimc_mvm_experts` (one launch over E experts, each on its own x[e]
    and s_x[e]) equals E K2 launches bit for bit, and its plain version
    within the bound; E is not capped at K3's 16 gates; sigma > 0 without
    read seeds raises."""
    x, w_q, s_w, s_x = _expert_operands(e, b, kb, np_, e + b, dev)
    step = adc_step_lsb(512, 1.0)
    y = aimc_mvm.aimc_mvm_experts(x, w_q, s_w, s_x, adc_step=step)
    for i in range(e):
        assert torch.equal(y[i], aimc_mvm.aimc_mvm_v2(
            x[i], w_q[i], s_w[i], s_x[i:i + 1], adc_step=step)), i
    _close(y, ref.aimc_matmul_experts_ref(x, w_q, s_w, s_x, adc_step=step))
    assert not y[1].any()
    with pytest.raises(ValueError, match="seed"):
        aimc_mvm.aimc_mvm_experts(x, w_q, s_w, s_x, adc_step=step, sigma=1.0)


@pytest.mark.cuda
def test_moe_smoke_on_card_matches_cpu(dev):
    """olmoe's smoke config programmed on the card: prefill logits within
    1e-4 of the same codes on the CPU (plain versions), one expert launch
    per expert projection and layer per pass, fused == unfused."""
    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.core.program import MappingPlan, program_model
    from repro_torch.models.layers import Execution

    spec = get_arch("olmoe-1b-7b")
    cfg, model = spec.smoke_cfg, spec.model_module()
    params = model.init(prng.PRNGKey(0), cfg, device="cpu")
    acfg = AimcConfig()
    inst = program_model(params, MappingPlan(), acfg).install(params)
    exe = Execution(mode="aimc", aimc=acfg, compute_dtype="float32",
                    programmed=True)

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if hasattr(tree, "w_q"):
            return type(tree)(w_q=tree.w_q.to(device), s_w=tree.s_w.to(device),
                              k=tree.k, n=tree.n)
        return tree.to(device)

    toks = torch.randint(1, cfg.vocab, (1, 12), generator=torch.Generator()
                         .manual_seed(0)).to(torch.int32)
    want = model.prefill(inst, toks, cfg, exe)[0]
    card = to(inst, dev)
    aimc_mvm.reset_counts()
    got = model.prefill(card, toks.to(dev), cfg, exe)[0]
    assert aimc_mvm.LAUNCHES["aimc_mvm_experts"] == 3 * cfg.n_layers
    assert aimc_mvm.LAUNCHES["aimc_mvm_v2"] == 4 * cfg.n_layers
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    fused = model.fuse_gate_stacks(card)
    assert torch.equal(model.prefill(fused, toks.to(dev), cfg, exe)[0], got)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.0, 0.1], ids=["dynamic", "fixed 0.1"])
def test_stacked_probe_equals_per_layer_k2(dev, scale):
    """The health probe of an [L] layer stack (`runtime.health.apply_state`:
    x broadcast to [L, B, K], ONE expert-entry launch) equals L K2 launches
    bit for bit, so probe references and live probes agree exactly, and is
    within 1e-5 x max(1, max|y|) of the same probe's plain version on the
    CPU."""
    from repro_torch.core.aimc import (AimcConfig, AimcLinearState,
                                       aimc_apply, program_stacked)
    from repro_torch.runtime.health import apply_state

    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((6, 1100, 300)).astype(
        np.float32) * 0.05).to(dev)
    cfg = AimcConfig(input_scale=scale)
    st = program_stacked(w, cfg)
    x = torch.from_numpy(rng.standard_normal((2, 1100)).astype(
        np.float32)).to(dev)
    aimc_mvm.reset_counts()
    y = apply_state(st, x, cfg)
    assert aimc_mvm.LAUNCHES["aimc_mvm_experts"] == 1
    assert aimc_mvm.LAUNCHES["aimc_mvm_v2"] == 0
    assert tuple(y.shape) == (6, 2, 300)
    for i in range(6):
        assert torch.equal(y[i], aimc_apply(st[i], x, cfg)), i
    st_cpu = AimcLinearState(w_q=st.w_q.cpu(), s_w=st.s_w.cpu(), k=st.k,
                             n=st.n)
    _close(y.cpu(), apply_state(st_cpu, x.cpu(), cfg))


@pytest.mark.cuda
def test_zero_gain_reaches_k2_as_zero_scale(dev):
    """A dead crossbar (`with_gain(0.0)`, what a chaos kill installs) runs
    K2 on an all-zero scale and reads an all-zero output, so the probe
    reads it as relative error 1.0."""
    from repro_torch.core.aimc import AimcConfig, aimc_apply, program_linear
    from repro_torch.runtime.health import rel_err

    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((700, 260)).astype(
        np.float32)).to(dev)
    cfg = AimcConfig()
    st = program_linear(w, cfg)
    dead = st.with_gain(0.0)
    assert not dead.s_w.any() and torch.equal(dead.w_q, st.w_q)
    x = torch.from_numpy(rng.standard_normal((3, 700)).astype(
        np.float32)).to(dev)
    aimc_mvm.reset_counts()
    y = aimc_apply(dead, x, cfg)
    assert aimc_mvm.LAUNCHES["aimc_mvm_v2"] == 1
    assert not y.any()
    assert rel_err(y, aimc_apply(st, x, cfg)) == pytest.approx(1.0, abs=1e-9)


def _rotation_fixture(dev):
    """granite-8b's smoke config on the card under the reference's locked
    placement smoke (64-row tiles, budget 2): plan, program, state trees."""
    from repro_torch.configs import get_arch
    from repro_torch.core import prng
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.core.placement import plan_placement
    from repro_torch.core.program import MappingPlan, program_model

    spec = get_arch("granite-8b")
    cfg, model = spec.smoke_cfg, spec.model_module()
    params = model.init(prng.PRNGKey(89), cfg, device=dev)
    acfg = AimcConfig(adc_alpha=0.5, tile_rows=64, input_scale=0.1)
    rot = plan_placement(params, MappingPlan(), acfg,
                         tiles_per_context=2).rotation
    prog = program_model(params, rot.plan(), acfg, prng.PRNGKey(91))
    trees = [prog.install_subset(params, ns) for ns in rot.states()]
    return spec, model, params, acfg, rot, prog, trees


@pytest.mark.cuda
def test_rotation_state_leaves_on_card(dev):
    """Every rotation state's tree installs exactly its resident leaves on
    the card (the others are the raw CUDA weights, served digitally), and
    each installed leaf's K2 output on layer 0's codes is within the bound
    of its plain version."""
    from repro_torch.core.aimc import AimcLinearState, aimc_apply

    spec, model, params, acfg, rot, prog, trees = _rotation_fixture(dev)
    assert rot.n_states >= 2
    rng = np.random.default_rng(11)
    for ns, tree in zip(rot.states(), trees):
        for name, leaf in tree["blocks"].items():
            path = f"blocks/{name}"
            if path in ns:
                assert isinstance(leaf, AimcLinearState)
                st = AimcLinearState(w_q=leaf.w_q[0], s_w=leaf.s_w[0],
                                     k=leaf.k, n=leaf.n)
                x = torch.from_numpy(rng.standard_normal(
                    (4, st.k)).astype(np.float32)).to(dev)
                aimc_mvm.reset_counts()
                y = aimc_apply(st, x, acfg)
                assert aimc_mvm.LAUNCHES["aimc_mvm_v2"] == 1
                st_cpu = AimcLinearState(w_q=st.w_q.cpu(), s_w=st.s_w.cpu(),
                                         k=st.k, n=st.n)
                _close(y.cpu(), aimc_apply(st_cpu, x.cpu(), acfg))
            else:
                assert leaf is params["blocks"][name] and leaf.is_cuda


@pytest.mark.cuda
def test_rotating_engine_launches_follow_the_state_on_card(dev):
    """A rotating engine on the card: every decode pass launches K2 once
    per resident layer stack instance of the state in force, the swap
    books close, and each state equals a plain engine on its own tree."""
    import dataclasses

    from repro_torch.core.placement import reconcile_swaps
    from repro_torch.models.layers import Execution
    from repro_torch.runtime.batcher import synchronized_trace
    from repro_torch.runtime.engine import ServeEngine

    spec, model, params, acfg, rot, prog, trees = _rotation_fixture(dev)
    cfg = spec.smoke_cfg
    exe = Execution(mode="aimc", aimc=acfg, compute_dtype="float32",
                    programmed=True)
    kw = dict(n_slots=4, prompt_pad=8, max_seq=14, program=prog,
              family=spec.family, module=spec.module)
    eng = ServeEngine(model, cfg, exe, trees[0], rotation=rot,
                      rotation_params=trees, **kw)
    eng.warmup()
    reqs = synchronized_trace(4, prompt_len=8, max_new=6, seed=89,
                              vocab=cfg.vocab)
    per_state = {}
    sess, now = eng.begin(), 0.0
    for r in reqs:
        now = eng.admit(sess, r, now)
    while sess.slots.n_busy:
        aimc_mvm.reset_counts()
        p0 = eng.forward_passes
        now = eng.step(sess, now)
        # the tick at the top of step() may have advanced the state
        per_state.setdefault(eng.rotation_state, set()).add(
            aimc_mvm.LAUNCHES["aimc_mvm_v2"] // (eng.forward_passes - p0))
    rep = eng.finish(sess, now)
    for state, got in per_state.items():
        want = cfg.n_layers * len(rot.states()[state])
        assert got == {want}, (state, got)
    assert rep.n_swaps > 0 and reconcile_swaps(prog, rep)
    for i, tree in enumerate(trees):
        still = ServeEngine(model, cfg, exe, tree, **kw)
        order = trees[i:] + trees[:i]
        r_eng = ServeEngine(model, cfg, exe, order[0],
                            rotation=dataclasses.replace(rot,
                                                         swap_every=10 ** 6),
                            rotation_params=order, **kw)
        a, b = still.serve(reqs), r_eng.serve(reqs)
        assert all(a.tokens(r.rid) == b.tokens(r.rid) for r in reqs)


@pytest.mark.cuda
@pytest.mark.parametrize("e,b,kb,np_", [
    (64, 1280, 4, 1024), (64, 1280, 2, 2048), (8, 5, 1, 128), (20, 3, 3, 384)],
    ids=["olmoe we_gate train", "olmoe we_down train", "smoke", "E 20"])
def test_expert_entry_with_seeds_equals_seeded_k2(dev, e, b, kb, np_):
    """`aimc_mvm_experts` with a read seed per expert (sigma > 0) is one
    launch, equal bit for bit to E K2 launches each with its own seed, and
    within 1e-5 x max(1, max|y|) of its plain version; it differs from
    the sigma = 0 output."""
    x, w_q, s_w, s_x = _expert_operands(e, b, kb, np_, e + b + 7, dev)
    step = adc_step_lsb(512, 1.0)
    sigma = 57.5
    seeds = [int(s) for s in np.random.default_rng(e).integers(
        0, 2 ** 32, e, dtype=np.uint64)]
    aimc_mvm.reset_counts()
    y = aimc_mvm.aimc_mvm_experts(x, w_q, s_w, s_x, seeds, adc_step=step,
                                  sigma=sigma)
    assert aimc_mvm.LAUNCHES["aimc_mvm_experts"] == 1
    for i in range(e):
        assert torch.equal(y[i], aimc_mvm.aimc_mvm_v2(
            x[i], w_q[i], s_w[i], s_x[i:i + 1], seeds[i], adc_step=step,
            sigma=sigma)), i
    _close(y, ref.aimc_matmul_experts_ref(x, w_q, s_w, s_x, seeds,
                                          adc_step=step, sigma=sigma))
    assert not torch.equal(y, aimc_mvm.aimc_mvm_experts(
        x, w_q, s_w, s_x, adc_step=step))


# (E, C, K, N, M, col0, ld): olmoe-1b-7b's training projections cut in E
# only, ragged C, more than 16 experts, KB 1, M off the 128-code stage, a
# column piece of a wider state (read at row stride ld, noise of the
# whole's columns col0..); each with the tiles (one per SM at least) that
# `expert_body` wants for the wide body
WIDE_CASES = {
    "olmoe we_gate train E 8": (8, 2560, 2048, 1024, 512, 0, None),
    "olmoe we_down train E 8": (8, 2560, 1024, 2048, 512, 0, None),
    "ragged C 333": (64, 333, 1024, 1024, 512, 0, None),
    "E 20 > 16": (20, 128, 1536, 4096, 512, 0, None),
    "KB 1": (16, 256, 512, 4096, 512, 0, None),
    "M 300": (40, 128, 600, 2048, 300, 0, None),
    "column piece col0 128": (96, 384, 1024, 256, 512, 128, 512)}


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.0, 57.5])
@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_expert_body_bit_equal_to_seeded_k2(dev, case, sigma):
    """The large-capacity expert body (`csrc/aimc_experts.cu`, chosen by
    `expert_body` for these shapes) equals E K2 launches, each on its own
    x[e], s_x[e] and seed, bit for bit, and its plain version within
    1e-5 x max(1, max|y|); expert 1 got no token; read noise moves the
    output. One wrapper call counts one launch."""
    e, c, k, n, m, col0, ld = WIDE_CASES[case]
    kb = -(-k // m)
    rng = np.random.default_rng(e + c + n)
    x, w_q, s_w, s_x = _expert_operands(e, c, kb, ld or n, e + c, dev, m=m)
    w_q, s_w = w_q[..., col0:col0 + n], s_w[..., col0:col0 + n]
    cols = {} if ld is None else {"col0": col0, "nc": ld}
    step = adc_step_lsb(512, 1.0)
    seeds = [int(v) for v in rng.integers(0, 2 ** 32, e, dtype=np.uint64)]
    plan = aimc_mvm.launch_plan(dev, c, kb, m, n, e, experts=True)
    assert plan["body"] == "wide" and plan["kernels_per_call"] == 2, plan
    aimc_mvm.reset_counts()
    y = aimc_mvm.aimc_mvm_experts(x, w_q, s_w, s_x, seeds, adc_step=step,
                                  sigma=sigma, **cols)
    assert aimc_mvm.LAUNCHES["aimc_mvm_experts"] == 1
    for i in range(e):
        assert torch.equal(y[i], aimc_mvm.aimc_mvm_v2(
            x[i], w_q[i], s_w[i], s_x[i:i + 1], seeds[i], adc_step=step,
            sigma=sigma, **cols)), i
    _close(y, ref.aimc_matmul_experts_ref(x, w_q, s_w, s_x, seeds,
                                          adc_step=step, sigma=sigma,
                                          **cols))
    assert not y[1].any()          # |sigma z| never reaches half an ADC step
    if sigma > 0.0:
        assert not torch.equal(y, aimc_mvm.aimc_mvm_experts(
            x, w_q, s_w, s_x, adc_step=step, **cols))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rows", [64, 512, 4096])
def test_wide_body_fast_paths_equal_library_calls(dev, tile_rows):
    """The wide body's branch-free epilogue (`aimc_mvm.check_fast_paths`):
    its Box-Muller radius equals cprng.cuh's on all 2^24 words, its draw
    the counter draw, and its division the IEEE one on every
    float |a| <= 2^25 at the ADC steps of three tile heights; so the
    wrapper takes it there (`fast_epilogue`)."""
    step = adc_step_lsb(tile_rows, 1.0)
    got = aimc_mvm.check_fast_paths(dev, step)
    assert got["min_abs_cos"] > 0.0, got
    assert {k: v for k, v in got.items() if k != "min_abs_cos"} == {
        "radius_mismatches": 0, "div_mismatches": 0,
        "draw_mismatches": 0}, got
    assert aimc_mvm.fast_epilogue(dev.index or 0, step)


@pytest.mark.cuda
@pytest.mark.parametrize("what,seed", [("gauss", 0), ("gauss", 0xC0FFEE),
                                       ("radius", 0), ("cos", 0),
                                       ("log1p", 0)])
def test_draws_equal_plain_bit_for_bit(dev, what, seed):
    """The kernels' draws alone (`aimc_mvm.draws`) equal their plain
    versions on the card (`ref.draws_ref`) bit for bit: 2^24 counters or
    words, or log1p of -u^2 over `prng.normal`'s 2^23 uniforms."""
    from repro_torch.core import prng
    if what == "log1p":
        k = torch.arange(1 << 23, dtype=torch.int64, device=dev)
        u = prng._uniform_fn(prng._NEXT_M1, 1.0, dev)(k << 9)
        kw = {"x": -u * u}
    else:
        kw = {"seed": seed, "device": dev}
    got = aimc_mvm.draws(what, **kw)
    want = ref.draws_ref(what, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("noise_source", ["counter", "hw"])
def test_noise_at_zero_weights_equals_plain(dev, noise_source):
    """K2 (counter) and K4 ("hw") at zero weights, unit scales and ADC
    step, sigma 16: every output is rint(16 z) of one draw, and equals the
    plain version's (in value: a code that rounds to zero from below is -0
    in the kernel's float code, 0 in the plain version's int code)."""
    b, np_ = 512, 4096
    x = torch.ones((b, 64), device=dev)
    w_q = torch.zeros((1, 64, np_), dtype=torch.int8, device=dev)
    s_w = torch.ones((1, np_), device=dev)
    s_x = torch.ones((1, 1), device=dev)
    kw = dict(adc_step=1.0, sigma=16.0, noise_source=noise_source)
    y = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, 0x5EED, **kw)
    want = ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, 0x5EED, **kw)
    assert torch.equal(y, want)
    assert y.abs().max() > 16.0


@pytest.mark.cuda
def test_wide_body_exact_division_outside_fast_domain(dev):
    """A read noise whose sums may pass 2^25, beyond what the check covers
    (M 127^2 + 6 sigma > 2^25), runs the wide body with the library calls:
    still E seeded K2 launches bit for bit."""
    e, c, kb, n = 16, 256, 1, 4096
    x, w_q, s_w, s_x = _expert_operands(e, c, kb, n, 3, dev)
    step, sigma = adc_step_lsb(512, 1.0), 5.0e6
    assert 512 * 127 ** 2 + 6 * sigma > 2 ** 25
    seeds = list(range(101, 101 + e))
    assert aimc_mvm.launch_plan(dev, c, kb, 512, n, e,
                                experts=True)["body"] == "wide"
    y = aimc_mvm.aimc_mvm_experts(x, w_q, s_w, s_x, seeds, adc_step=step,
                                  sigma=sigma)
    for i in range(e):
        assert torch.equal(y[i], aimc_mvm.aimc_mvm_v2(
            x[i], w_q[i], s_w[i], s_x[i:i + 1], seeds[i], adc_step=step,
            sigma=sigma)), i


@pytest.mark.cuda
def test_ste_forward_backward_on_card_matches_cpu(dev):
    """One STE call and one expert-STE call with programming and read
    noise on the card (K2 and the seeded expert entry) against the same
    calls on the CPU (plain versions): outputs within the bound (the
    programming normals are equal, the row-block sums associate apart),
    gradients equal to the straight-through matmuls within it."""
    from repro_torch.core import aimc as ta
    from repro_torch.core import prng
    from repro_torch.core.noise import NoiseModel

    cfg = ta.AimcConfig(noise=NoiseModel(sigma_read=0.003))
    rng = np.random.default_rng(8)
    cases = (((16, 700), (700, 300), ta.aimc_linear_ste, prng.PRNGKey(1)),
             ((6, 9, 700), (6, 700, 260), ta.aimc_linear_ste_experts,
              prng.split(prng.PRNGKey(2), 6)))
    for xs, ws, fn, key in cases:
        x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal(ws) * 0.05).astype(
            np.float32))
        g = torch.from_numpy(rng.standard_normal(
            xs[:-1] + ws[-1:]).astype(np.float32))
        outs = []
        for d in ("cpu", dev):
            xd = x.to(d).requires_grad_(True)
            wd = w.to(d).requires_grad_(True)
            aimc_mvm.reset_counts()
            y = fn(xd, wd, key, cfg)
            launched = sum(aimc_mvm.LAUNCHES.values())
            outs.append((y.detach().cpu(), *(t.cpu() for t in
                                             torch.autograd.grad(
                                                 y, (xd, wd), g.to(d))),
                         launched))
        (yc, dxc, dwc, n_cpu), (yg, dxg, dwg, n_card) = outs
        assert n_cpu == 0 and n_card == 1
        _close(yg, yc)
        _close(dxg, dxc)
        _close(dwg, dwc)


def _piece_state(dev, lead, kb, np_, pieces, seed, m=512):
    """A programmed state of random codes on the card, and the same state
    split into ``pieces`` equal column pieces (`core.aimc.split_columns`)."""
    from repro_torch.core import aimc as ta
    gen = torch.Generator(dev).manual_seed(seed)
    w_q = torch.randint(-127, 128, lead + (kb, m, np_), generator=gen,
                        device=dev, dtype=torch.int8)
    s_w = (torch.rand(lead + (kb, np_), generator=gen, device=dev)
           + 0.5) * 1e-3
    whole = ta.AimcLinearState(w_q=w_q, s_w=s_w, k=kb * m, n=np_)
    w = np_ // pieces
    return whole, ta.split_columns(
        whole, [(i * w, (i + 1) * w) for i in range(pieces)], [dev] * pieces)


def _plans(dev, b, st, g=1, experts=False):
    """(whole, piece) launch plans: whether each splits over row blocks
    and its rows per block."""
    kb, m, np_ = st.w_q.shape[-3:]
    out = []
    for n in (np_, st.pieces[0].c1 - st.pieces[0].c0):
        p = aimc_mvm.launch_plan(dev, b, kb, m, n, g, experts)
        out.append((p["split"], p["rows_per_block"]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,kb,np_,pieces,modes_differ", [
    (4, 8, 14336, 2, False),     # granite w_gate at decode, model:2
    (4, 8, 38400, 2, True),      # whole unsplit, pieces split over rows
    (32, 8, 17920, 4, True)])    # 64-row whole tiles, 16-row piece tiles
def test_k2_column_pieces_equal_whole_launch(dev, b, kb, np_, pieces,
                                             modes_differ):
    """`aimc_apply` over column pieces (one K2 launch each, the one DAC
    scale of the whole x, the bias cut per piece) concatenates to the
    whole launch bit for bit, including where a piece runs another grid
    mode than the whole (the row-block split, `_plan`)."""
    from repro_torch.core import aimc as ta
    whole, split = _piece_state(dev, (), kb, np_, pieces, seed=b)
    cfg = ta.AimcConfig()
    gen = torch.Generator(dev).manual_seed(7)
    x = torch.randn((b, kb * 512), generator=gen, device=dev)
    bias = torch.randn((np_,), generator=gen, device=dev)
    modes = _plans(dev, b, split)
    assert (modes[0] != modes[1]) == modes_differ
    want = ta.aimc_apply(whole, x, cfg, bias=bias, activation="relu")
    aimc_mvm.reset_counts()
    got = ta.aimc_apply(split, x, cfg, bias=bias, activation="relu")
    assert aimc_mvm.LAUNCHES["aimc_mvm_v2"] == pieces
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,kb,np_,g,pieces,modes_differ", [
    (4, 8, 14336, 2, 2, False),  # granite w_gu stack (K3), model:2
    (4, 8, 20480, 2, 2, True),   # whole unsplit, pieces split
    (16, 28, 4096, 3, 4, False)])
def test_k3_column_pieces_equal_whole_launch(dev, b, kb, np_, g, pieces,
                                             modes_differ):
    from repro_torch.core import aimc as ta
    whole, split = _piece_state(dev, (g,), kb, np_, pieces, seed=g)
    cfg = ta.AimcConfig()
    gen = torch.Generator(dev).manual_seed(8)
    x = torch.randn((b, kb * 512), generator=gen, device=dev)
    biases = torch.randn((g, np_), generator=gen, device=dev)
    modes = _plans(dev, b, split, g)
    assert (modes[0] != modes[1]) == modes_differ
    want = ta.aimc_apply_stacked(whole, x, cfg, biases=biases,
                                 activations="relu")
    aimc_mvm.reset_counts()
    got = ta.aimc_apply_stacked(split, x, cfg, biases=biases,
                                activations="relu")
    assert aimc_mvm.LAUNCHES["aimc_mvm_stacked"] == pieces
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,kb,np_,pieces,modes_differ", [
    (64, 4, 4, 1024, 2, True),   # olmoe expert stack at decode, model:2
    (2, 4, 8, 19200, 2, True),   # whole unsplit, pieces split
    (8, 16, 2, 2048, 4, False)])
def test_expert_entry_column_pieces_equal_whole_launch(dev, e, c, kb, np_,
                                                      pieces, modes_differ):
    from repro_torch.core import aimc as ta
    whole, split = _piece_state(dev, (e,), kb, np_, pieces, seed=e)
    cfg = ta.AimcConfig()
    gen = torch.Generator(dev).manual_seed(9)
    x = torch.randn((e, c, kb * 512), generator=gen, device=dev)
    x[0] = 0.0                                  # an expert with no token
    modes = _plans(dev, c, split, e, experts=True)
    assert (modes[0] != modes[1]) == modes_differ
    want = ta.aimc_apply_experts(whole, x, cfg)
    aimc_mvm.reset_counts()
    got = ta.aimc_apply_experts(split, x, cfg)
    assert aimc_mvm.LAUNCHES["aimc_mvm_experts"] == pieces
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("noise_source", ["counter", "hw"])
@pytest.mark.parametrize("b,kb,np_,pieces", [
    (4, 8, 14336, 2),            # a split grid at decode
    (8192, 4, 2048, 2)])         # olmoe's training projection
def test_noisy_view_pieces_draw_the_whole_launch_noise(dev, b, kb, np_,
                                                       pieces, noise_source):
    """Column pieces that are views of the whole's codes (row stride = the
    whole's Np, no copy) with a read key: each piece draws the whole
    launch's noise for its columns (counter and "hw"), so the pieces
    concatenate to the whole launch bit for bit; a contiguous copy of a
    piece, given the same column offset, does too."""
    import dataclasses

    from repro_torch.core import aimc as ta
    from repro_torch.core.noise import NoiseModel
    from repro_torch.core.prng import PRNGKey
    whole, split = _piece_state(dev, (), kb, np_, pieces, seed=b)
    for p in split.pieces:
        assert p.w_q.untyped_storage().data_ptr() == \
            whole.w_q.untyped_storage().data_ptr()
    cfg = ta.AimcConfig(noise=NoiseModel(sigma_read=0.01),
                        noise_source=noise_source)
    x = torch.randn((b, kb * 512), generator=torch.Generator(dev)
                    .manual_seed(10), device=dev)
    want = ta.aimc_apply(whole, x, cfg, PRNGKey(3))
    assert not torch.equal(want, ta.aimc_apply(whole, x, cfg))
    aimc_mvm.reset_counts()
    got = ta.aimc_apply(split, x, cfg, PRNGKey(3))
    name = "aimc_mvm_v2" + ("_hw" if noise_source == "hw" else "")
    assert aimc_mvm.LAUNCHES[name] == pieces
    assert torch.equal(got, want)
    p = split.pieces[-1]
    copy = ta.ColumnPiece(p.c0, p.c1, p.w_q.contiguous(),
                          p.s_w.contiguous())
    cp = ta.aimc_apply(dataclasses.replace(split, pieces=(
        *split.pieces[:-1], copy)), x, cfg, PRNGKey(3))
    assert torch.equal(cp, want)
