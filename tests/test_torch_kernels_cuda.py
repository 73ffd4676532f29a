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
"""

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
    assert aimc_mvm.LAUNCHES == {
        "aimc_mvm_v1": 1, "aimc_mvm_v2": 1, "aimc_mvm_stacked": 1,
        "aimc_mvm_v2_hw": 1, "aimc_mvm_stacked_hw": 1}
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
