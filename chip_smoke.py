#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: serve granite-8b at its published
width on programmed AIMC crossbars, and run the paper's MLP, LSTM and
CNN-F/M/S at theirs with read noise on, single-core and in the paper's
multi-core mappings, through the hand-written Hopper kernels K1-K4.

    python3 chip_smoke.py        # one CUDA card; exits non-zero without one

Phases (any failure exits non-zero; nothing falls back to a plain version):
  1. build — nvcc builds the kernel library from src/repro_torch/kernels/csrc
     (sm_90a); the compiler's register/spill report is printed, and
     `cuobjdump -sass` must show tensor-core (IMMA/HMMA) instructions in the
     MVM kernel (`aimc_mvm_mma_kernel`).
  2. kernels — K2 (`aimc_mvm_v2`) and K3 (`aimc_mvm_stacked`) at every
     granite-8b projection shape, at the decode slot count and the prompt
     pad, noise off and on, every epilogue with a bias: each held against
     its plain PyTorch version (`kernels/ref.py`) on the same CUDA tensors
     within |err| <= 1e-5 * max(1, max|y|) (f32 association of the
     row-block sum), and timed with CUDA events, L2 flushed per launch.
     Then the launcher's three grid modes at granite wk (split over row
     blocks at B 4; unsplit with 16 rows per block at B 1000 and with 64 at
     B 4099), each timed and held to its plain version; with s_x fixed,
     x[:4] on the split grid equals the first 4 rows of the unsplit B 4099
     launch bit for bit, noise off and under "hw" noise.
  3. small model — the granite smoke config served on the card (kernels);
     its prefill logits within 1e-4 of the same programmed weights run on
     the CPU (plain versions).
  4. serve — `repro_torch.launch.serve.main` on the published granite-8b
     config (36 layers, d_model 4096, 32/8 heads, d_ff 14336, vocab 49152),
     --exec aimc --cores 4, 4 Poisson requests, prompt 16, gen 8, 4 slots,
     weights from --seed on JAX's keys (init seconds printed). Launch
     counts are zeroed just before and read just after: K2 must have run
     7 x 36 x forward passes; the CM_* ledgers must reconcile exactly and
     the 4 per-core ledgers sum to the program's per-token counts.
     init (after phase 5) — granite's layer-0 w_gate key drawn at its shape
     on the card and on the CPU: threefry bits equal, normals within 4 ulps.
  5. stacked — `fuse_gate_stacks` on the installed parameters: prefill
     logits and served tokens (all requests at t=0, so both runs decode the
     same batches) bit-equal to the unfused run; K3 runs 36 x passes.
  6. fused serve — the phase-4 command with --fuse-gates, launch counts
     zeroed just before and read just after: K3 36 x passes, K2 5 x 36 x
     passes, ledgers reconcile. K3's launch count in the record is this
     run's; K2's is phase 4's.
  7. v1/hw kernels (after phase 2) — K1 (`aimc_mvm_v1`, explicit noise
     operand), K2 with counter noise and K4 (K2/K3 with "hw" Philox noise)
     at every MVM shape of the paper nets at their published widths, K1
     also at the granite decode shapes: each held to its plain version
     within 1e-5 * max(1, max|y|) and timed as in phase 2. Where B > 16,
     `torch._int_mm` on the int8 codes is timed beside K2 as a yardstick
     for the int8 MAC alone (not the same function; the port never calls
     it). K4's raw draws
     are held to N(0, 1) moments; same seed, same output; K3 hw gates equal
     K2 hw launches bit for bit.
  8. staged — the MLP through the v1 staged entry `ops.aimc_matmul` with a
     bulk `noise.read_noise` operand: 2 K1 launches per forward, counts
     zeroed just before and read just after. K1's launch count in the
     record is this run's.
  9. paper nets — MLP (1024, B 16), the PTB-char LSTM (n_h 750, x = y = 50,
     T 20, B 8) side by side and gate-fused, CNN-F/M/S (224 px, B 8, 1000
     classes) through `AimcContext` and the `paper_nets` entry points,
     noise off and with bench_accuracy's NOISY read noise under both noise
     sources. Launch counts zeroed before and read after each apply-only
     forward: MLP 2 K2, LSTM T x 2 K2 or T x (K3 + K2), CNN 5 K2, the same
     as "hw" launches under "hw" (K4's count in the record is their sum).
     Fidelity against the digital fp32 path (output SNR, LSTM top-1, the
     CNN flip-margin rule), hw's SNR within 1 dB of counter's for every
     net; noise off, the fused LSTM equals the side-by-side one bit for bit,
     and every net is held to the same programmed net on the CPU (plain
     versions): each MVM and each digital part (fed the card's MVM outputs)
     within its bound, every DAC code that differs at a rounding tie, top-1
     equal, and the MLP's and LSTM's outputs within 1e-4.
 10. multi-core — `core.schedule` mappings through the paper_nets
     `*_forward_multicore` / `cnn_pipeline_stages` entry points, at the
     reference's configurations (bench_pipeline: MLP 1024 on 1024-row tiles
     B 1 cores 1/2/4, LSTM n_h 600 on 700-row tiles cores 1/2/5, CNN-F 224
     px B 1 pipeline) and at phase 9's (512-row tiles: MLP B 16 cores 1/2/4,
     LSTM n_h 750 B 8 cores 1/2, CNN-F/M/S B 8 pipelines). Column splits
     equal 1 core bit for bit, the CNN pipeline equals the multi-core
     forward and the ctx path; with programming and counter read noise each
     forward is within 1e-5 * max(1, max|y|) of the same schedules on the
     plain versions; one K2 launch per shard per apply (counts zeroed just
     before, read just after each forward); ledgers partition the program
     totals; modelled latency (the paper's Table I-A system, not a chip
     measurement) equals `costmodel.evaluate` within 1%; K2 at every new
     (B, KB, M, Np) held to its plain version and timed; `tight_forward`
     equals `loose_forward` at MLP 1024 B 1 and CNN-F conv1 B 8, both timed
     with their modelled global-memory bytes. Per-forward ms, a profiled
     forward's idle share and per-stage pipeline times are recorded.

The last two lines are the card's nvidia-smi name/power limit and the
contract line {"ok": true, "device": {...}}; the line before them is the
per-kernel JSON record (K2/K3 timed per granite layer at decode, K1/K4 per
MLP forward). Each phase's seconds are printed as it ends. Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

ARCH = "granite-8b"
N_REQ, PROMPT, GEN, SLOTS, RATE, SEED = 4, 16, 8, 4, 20.0, 0
SERVE_CORES = 4
NOISE_SEED, NOISE_SIGMA = 0xC0FFEE, 57.5     # sigma: read_sigma_lsb(512)
KERNEL_REPS = 20
# the paper nets at their published widths (bench_accuracy's networks,
# which cut the LSTM to n_h 256 and the CNN to 64 px for CPU time)
MLP_N, MLP_B = 1024, 16
LSTM_NH, LSTM_X, LSTM_T, LSTM_B = 750, 50, 20, 8
CNN_IMG, CNN_B, CNN_CLASSES = 224, 8, 1000
# the reference's multi-core configurations (benchmarks/bench_pipeline.py)
MC_MLP_N, MC_LSTM_NH = 1024, 600
# published dense peaks of the card (data sheets): bytes/s, int8 ops/s
PEAKS = {"H200": (4.8e12, 1979e12), "H100 PCIe": (2.0e12, 1513e12),
         "H100": (3.35e12, 1979e12)}


def paper_noise():
    """bench_accuracy's NOISY read noise (programming noise at its
    defaults)."""
    from repro_torch.core.noise import NoiseModel
    return NoiseModel(sigma_read=0.003)


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if all(part in name for part in key.split()):
            return val
    fail(f"no published peaks for card {name!r}")


def flush_buffer(dev):
    """The L2 flush of `time_ms`: reading 256 MB evicts the 50 MB L2 and
    keeps the card busy ~80 us, longer than the host takes to enqueue one
    wrapper call (checks, allocations, a ctypes call issuing up to three
    kernels), so the events bracket device time, not the host's enqueue."""
    import torch
    return torch.empty(256 << 20, dtype=torch.uint8, device=dev)


def time_ms(fn, flush, reps: int) -> float:
    """Mean device time of ``fn`` with the L2 cache flushed before each
    launch (decode reads each weight panel once per step, cold). The flush
    READS its buffer: a write would leave dirty lines whose write-back the
    timed kernel would pay."""
    import torch
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    fn()
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / reps


def bound_ms(b, kb, m, np_, g, peaks, bias: bool, noise_bytes: int = 0):
    """Least time for the same work on x [B, KB*M] and w_q [G, KB, M, Np]:
    bytes moved once (x, w_q, s_w, s_x, bias, K1's noise operand, out) over
    the memory rate vs int8 MACs over the int8 rate."""
    k_pad = kb * m
    nbytes = (b * k_pad * 4 + g * (k_pad * np_ + kb * np_ * 4)
              + g * b * np_ * 4 + 4 + (g * np_ * 4 if bias else 0)
              + noise_bytes)
    ops = 2 * g * b * k_pad * np_
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, ops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_report(lib: Path, report: str) -> dict:
    """Per CUDA kernel of the library: registers, stack and spill bytes from
    the ptxas report, and the tensor-core instructions (IMMA/HMMA class) in
    its SASS (`cuobjdump -sass`). Fails if the MVM kernel has none."""
    import re

    from repro_torch.kernels import aimc_mvm

    def short(mangled):
        m = re.search(r"(aimc_(?:dac|mvm_mma|rowblock_sum)_kernel)"
                      r"(?:I((?:Li\d+E)+)E)?", mangled)
        if m is None:
            return mangled
        args = re.findall(r"Li(\d+)E", m.group(2) or "")
        return m.group(1) + (f"<{', '.join(args)}>" if args else "")

    kernels: dict = {}
    cur = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = kernels.setdefault(short(m.group(1)), {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    cuobjdump = Path(aimc_mvm._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300).stdout
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernels.setdefault(short(m.group(1)), {})
            cur["tensor_core_instructions"] = {}
        m = re.search(r"\b([IH]MMA\.\S+)", line)
        if m and cur is not None:
            ops = cur["tensor_core_instructions"]
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    for name, info in kernels.items():
        print(f"[build] {name}: {info.get('registers')} registers, "
              f"{info.get('spill_store_bytes')} bytes spill stores, "
              f"{info.get('spill_load_bytes')} bytes spill loads; tensor-core "
              f"SASS {info.get('tensor_core_instructions')}", flush=True)
    mma = [v for k, v in kernels.items() if k.startswith("aimc_mvm_mma")]
    check(bool(mma) and all(v.get("tensor_core_instructions") for v in mma),
          "the MVM kernel has no IMMA/HMMA instruction in its SASS")
    return kernels


def kernel_phase(dev, peaks, slots: int, prompt_pad: int):
    import torch

    from repro_torch.core.aimc import AimcConfig, program_stacked
    from repro_torch.core.quant import sym_scale
    from repro_torch.kernels import aimc_mvm, cprng, ref

    cfg = AimcConfig()
    step = cfg.adc_step
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = flush_buffer(dev)
    # (name, K, N, G) at granite-8b width: wq/wo, wk/wv, w_gate/w_up,
    # w_down on K2 and the fused w_gu stack on K3
    shapes = [("wq", 4096, 4096, 1), ("wk", 4096, 1024, 1),
              ("w_gate", 4096, 14336, 1), ("w_down", 14336, 4096, 1),
              ("w_gu", 4096, 14336, 2)]
    rows, worst = [], {"aimc_mvm_v2": 0.0, "aimc_mvm_stacked": 0.0}
    for name, k, n, g in shapes:
        w = torch.randn((g, k, n), generator=gen, device=dev)
        st = program_stacked(w * (2.0 / (k + n)) ** 0.5, cfg)
        del w
        w_q, s_w = (st.w_q, st.s_w) if g > 1 else (st.w_q[0], st.s_w[0])
        kb, m, np_ = st.w_q.shape[-3:]
        bias = torch.randn((g, np_), generator=gen, device=dev)
        kname = "aimc_mvm_stacked" if g > 1 else "aimc_mvm_v2"
        for b in (slots, prompt_pad):
            x = torch.randn((b, k), generator=gen, device=dev)
            s_x = sym_scale(x).reshape(1, 1)
            for sigma in (0.0, NOISE_SIGMA):
                if g > 1:
                    acts = ("sigmoid", "tanh")
                    kern = lambda: aimc_mvm.aimc_mvm_stacked(  # noqa: E731
                        x, w_q, s_w, s_x, NOISE_SEED, bias, adc_step=step,
                        sigma=sigma, activations=acts)
                    plain = lambda: ref.aimc_matmul_stacked_ref(  # noqa: E731
                        x, w_q, s_w, s_x, NOISE_SEED, bias, adc_step=step,
                        sigma=sigma, activations=acts)
                else:
                    kern = lambda: aimc_mvm.aimc_mvm_v2(  # noqa: E731
                        x, w_q, s_w, s_x, NOISE_SEED, bias[0], adc_step=step,
                        sigma=sigma, activation="relu")
                    plain = lambda: ref.aimc_matmul_ref_v2(  # noqa: E731
                        x, w_q, s_w, s_x, NOISE_SEED, bias[0], adc_step=step,
                        sigma=sigma, activation="relu")
                y, want = kern(), plain()
                torch.cuda.synchronize()
                err = float((y - want).abs().max())
                tol = 1e-5 * max(1.0, float(want.abs().max()))
                check(err <= tol, f"{kname} {name} B={b} sigma={sigma}: "
                      f"max |err| {err} > {tol}")
                worst[kname] = max(worst[kname], err)
                row = {"kernel": kname, "proj": name, "K": k, "N": n, "G": g,
                       "B": b, "sigma": sigma, "max_abs_err": err, "tol": tol,
                       "plan": aimc_mvm.launch_plan(dev, b, kb, m, np_, g)}
                if sigma == 0.0:
                    row["ms"] = time_ms(kern, flush, KERNEL_REPS)
                    row["plain_ms"] = time_ms(plain, flush, 3)
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        b, kb, m, np_, g, peaks, bias=True)
                rows.append(row)
                print(f"[kernels] {kname} {name} [{b}x{k}]x[{k}x{n}]"
                      f"{f' G={g}' if g > 1 else ''} sigma={sigma} "
                      f"({plan_str(row['plan'])}): max|err| "
                      f"{err:.3g} (tol {tol:.3g})"
                      + (f"; kernel {row['ms']:.4f} ms, plain "
                         f"{row['plain_ms']:.4f} ms, bound "
                         f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                         if "ms" in row else ""), flush=True)
        del st, w_q, s_w
    # every epilogue, with a bias and noise, on a small K2 shape and as
    # per-gate activations of K3 (bit-equal to per-gate K2 launches)
    st = program_stacked(torch.randn((4, 1024, 512), generator=gen,
                                     device=dev) * 0.03, cfg)
    x = torch.randn((5, 1024), generator=gen, device=dev)
    s_x = sym_scale(x).reshape(1, 1)
    bias = torch.randn((4, 512), generator=gen, device=dev)
    acts = ("none", "relu", "sigmoid", "tanh")
    y3 = aimc_mvm.aimc_mvm_stacked(x, st.w_q, st.s_w, s_x, 7, bias,
                                   adc_step=step, sigma=NOISE_SIGMA,
                                   activations=acts)
    for i, act in enumerate(acts):
        y = aimc_mvm.aimc_mvm_v2(x, st.w_q[i], st.s_w[i], s_x,
                                 cprng.stack_seed(7, i), bias[i],
                                 adc_step=step, sigma=NOISE_SIGMA,
                                 activation=act)
        want = ref.aimc_matmul_ref_v2(x, st.w_q[i], st.s_w[i], s_x,
                                      cprng.stack_seed(7, i), bias[i],
                                      adc_step=step, sigma=NOISE_SIGMA,
                                      activation=act)
        torch.cuda.synchronize()
        err = float((y - want).abs().max())
        check(err <= 1e-5 * max(1.0, float(want.abs().max())),
              f"epilogue {act}: max |err| {err}")
        check(torch.equal(y3[i], y), f"K3 gate {i} ({act}) != K2")
        worst["aimc_mvm_v2"] = max(worst["aimc_mvm_v2"], err)
        print(f"[kernels] epilogue {act} with bias, noise on: max|err| "
              f"{err:.3g}; K3 gate bit-equal to K2", flush=True)
    del st
    rows += grid_mode_checks(dev, peaks, flush, gen)
    return rows, worst


def plan_str(plan) -> str:
    return (f"{plan['rows_per_block']} rows/block, "
            f"{'split' if plan['split'] else 'unsplit'}, "
            f"{plan['kernels_per_call']} kernels/call")


def host_us_per_call(fn, calls: int = 100) -> float:
    """Host-clock us to enqueue one wrapper call (checks, allocations, the
    ctypes call and its kernel launches), over ``calls`` calls issued
    without a synchronise in between."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / calls * 1e6


def grid_mode_checks(dev, peaks, flush, gen):
    """The launcher's grid modes at granite wk (K 4096, Np 1024, relu, a
    bias): split over row blocks at B = 4 (16 rows per block), unsplit at
    B = 1000 (16 rows) and at B = 4099 (64 rows), each timed (device, and
    the host's enqueue per call) and held to its
    plain version; and with s_x fixed, x[:4] on the split grid bit-equal to
    the first 4 rows of the unsplit B = 4099 launch, noise off and under
    Philox ("hw") noise, whose draws do not depend on B."""
    import torch

    from repro_torch.core.aimc import AimcConfig, program_stacked
    from repro_torch.kernels import aimc_mvm, ref

    k, n = 4096, 1024
    step = AimcConfig().adc_step
    st = program_stacked(torch.randn((1, k, n), generator=gen, device=dev)
                         * (2.0 / (k + n)) ** 0.5, AimcConfig())
    w_q, s_w = st.w_q[0], st.s_w[0]
    kb, m, _ = w_q.shape
    bias = torch.randn((n,), generator=gen, device=dev)
    x = torch.randn((4099, k), generator=gen, device=dev)
    s_x = (x.abs().max() / 127).reshape(1, 1)
    rows, modes = [], set()
    for b in (4, 1000, 4099):
        plan = aimc_mvm.launch_plan(dev, b, kb, m, n)
        modes.add((plan["rows_per_block"], plan["split"]))
        xb = x[:b]
        kern = functools.partial(aimc_mvm.aimc_mvm_v2, xb, w_q, s_w, s_x,
                                 None, bias, adc_step=step, activation="relu")
        plain = functools.partial(ref.aimc_matmul_ref_v2, xb, w_q, s_w, s_x,
                                  None, bias, adc_step=step,
                                  activation="relu")
        y, want = kern(), plain()
        torch.cuda.synchronize()
        err = float((y - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        check(err <= tol, f"grid mode B={b}: max |err| {err} > {tol}")
        row = {"kernel": "aimc_mvm_v2", "proj": "wk grid mode", "K": k,
               "N": n, "G": 1, "B": b, "sigma": 0.0, "max_abs_err": err,
               "tol": tol, "plan": plan,
               "ms": time_ms(kern, flush, KERNEL_REPS),
               "plain_ms": time_ms(plain, flush, 3)}
        row["bound_ms"], row["bound_by"] = bound_ms(b, kb, m, n, 1, peaks,
                                                    bias=True)
        row["host_us_per_call"] = host_us_per_call(kern)
        rows.append(row)
        print(f"[grid] wk [{b}x{k}]x[{k}x{n}] ({plan_str(plan)}): max|err| "
              f"{err:.3g}; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); host enqueue "
              f"{row['host_us_per_call']:.1f} us per call", flush=True)
    check(modes == {(16, True), (16, False), (64, False)},
          f"grid modes covered: {modes}")
    for src, sigma in (("counter", 0.0), ("hw", 57.5)):
        kw = dict(adc_step=step, sigma=sigma, noise_source=src,
                  activation="tanh")
        small = aimc_mvm.aimc_mvm_v2(x[:4], w_q, s_w, s_x, 5, bias, **kw)
        big = aimc_mvm.aimc_mvm_v2(x, w_q, s_w, s_x, 5, bias, **kw)
        torch.cuda.synchronize()
        check(torch.equal(small, big[:4]),
              f"split rows differ from unsplit rows (sigma {sigma})")
    print("[grid] x[:4] on the split grid bit-equal to the first 4 rows of "
          "the unsplit B=4099 launch, noise off and under hw noise",
          flush=True)
    return rows


def small_model_phase(dev):
    """The smoke config served on the card (kernels); its prefill logits
    held against the same programmed weights on the CPU (plain versions)."""
    import torch

    from repro_torch.launch import serve

    card = serve.main(["--arch", ARCH, "--smoke", "--exec", "aimc",
                       "--requests", "4", "--prompt-len", "8", "--gen", "6",
                       "--slots", "4", "--seed", str(SEED), "--device",
                       str(dev)])
    eng = card.engine
    params_cpu = _to(eng.params, "cpu")
    worst = 0.0
    for req in card.requests:
        toks = torch.tensor([req.prompt], dtype=torch.int32)
        vl = torch.tensor([len(req.prompt)], dtype=torch.int32)
        want, _ = eng.model.prefill(params_cpu, toks, eng.cfg, eng.exe,
                                    valid_len=vl)
        got, _ = eng.model.prefill(eng.params, toks.to(dev), eng.cfg,
                                   eng.exe, valid_len=vl.to(dev))
        check(bool(torch.isfinite(got).all()), "non-finite smoke logits")
        check(tuple(got.shape) == (1, 1, eng.cfg.vocab),
              f"smoke logits shape {tuple(got.shape)}")
        worst = max(worst, float((got.cpu() - want).abs().max()))
    check(worst <= 1e-4, f"smoke prefill logits card vs CPU: {worst}")
    print(f"[small] card (kernels) vs CPU (plain) prefill logits max|err| "
          f"{worst:.3g} <= 1e-4", flush=True)
    return worst


def _to(tree, device):
    from repro_torch.core.aimc import AimcLinearState
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, AimcLinearState):
        return dataclasses.replace(tree, w_q=tree.w_q.to(device),
                                   s_w=tree.s_w.to(device))
    return tree.to(device)


def timed(fn, dev, reps=5):
    """Mean host-clock ms of ``fn`` over ``reps`` synchronised calls, after
    one warm-up call; returns (ms, last output)."""
    import torch
    fn()
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t) / reps * 1e3, out


def device_profile(fn, dev):
    """One synchronised call of ``fn`` under torch.profiler: its host-clock
    ms, device-busy ms (union of kernel intervals), idle share and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t) * 1e6
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            a, b = ev.time_range.start, ev.time_range.end
            spans.append((a, b))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a)
    busy_us, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"profiled_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if spans else None,
            "device_idle_share": 1.0 - busy_us / wall_us if spans else None,
            "top_kernels_ms": {n[:100]: v / 1e3 for n, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:8]}}


def print_profile(tag, prof):
    if prof["device_busy_ms"] is None:
        print(f"[{tag}]   device busy: not measured (profiler saw no device "
              f"events)", flush=True)
        return
    print(f"[{tag}]   profiled {prof['profiled_ms']:.2f} ms, device busy "
          f"{prof['device_busy_ms']:.2f} ms (idle share "
          f"{prof['device_idle_share']:.2f})", flush=True)
    for n, v in prof["top_kernels_ms"].items():
        print(f"[{tag}]   {v:8.3f} ms  {n}", flush=True)


def step_times(eng, prompt):
    """Host-clock times of one synchronised [1 x prompt_pad] prefill and one
    decode step with every slot busy, and a torch.profiler trace of that
    decode step."""
    dev = eng.device
    tokens, vl = eng._pad_prompt(prompt)
    prefill_ms, (tok1, cache1) = timed(lambda: eng._prefill_fn(tokens, vl),
                                       dev)
    sess = eng.begin()
    for slot in range(eng.n_slots):
        eng._insert(sess, cache1, tok1, slot, int(vl[0]), GEN)

    def step():
        return eng._decode_fn(sess.cache, sess.tok_buf, sess.state, 1)

    decode_ms, _ = timed(step, dev)
    prof = device_profile(step, dev)
    out = {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
           "decode_tok_s": eng.n_slots / decode_ms * 1e3,
           "profiled_step_ms": prof.pop("profiled_ms"), **prof}
    print(f"[times] prefill [1x{len(tokens[0])}] {prefill_ms:.2f} ms; decode "
          f"step [{eng.n_slots} slots] {decode_ms:.2f} ms "
          f"({out['decode_tok_s']:.1f} tok/s)", flush=True)
    print_profile("times", dict(out, profiled_ms=out["profiled_step_ms"]))
    return out


def serve_phase(dev):
    import torch

    from repro_torch.kernels import aimc_mvm
    from repro_torch.launch import serve
    from repro_torch.runtime.batcher import reconcile

    args = ["--arch", ARCH, "--exec", "aimc", "--requests", str(N_REQ),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--slots",
            str(SLOTS), "--trace", f"poisson:{RATE:g}", "--seed", str(SEED),
            "--cores", str(SERVE_CORES), "--device", str(dev)]
    print(f"[serve] python -m repro_torch.launch.serve {' '.join(args)}",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    aimc_mvm.reset_counts()
    t0 = time.perf_counter()
    run = serve.main(args)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = dict(aimc_mvm.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    eng, rep, prog = run.engine, run.report, run.program
    layers = eng.cfg.n_layers
    passes = eng.forward_passes
    print(f"[serve] main path: {wall:.1f}s wall, {passes} forward passes "
          f"(warmup included), launches {counts}, peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    check(layers == 36 and eng.cfg.d_model == 4096 and eng.cfg.d_ff == 14336
          and eng.cfg.vocab == 49152, "not the published granite-8b width")
    check(counts["aimc_mvm_v2"] == 7 * layers * passes,
          f"K2 launches {counts['aimc_mvm_v2']} != 7 x {layers} x {passes}")
    check(counts["aimc_mvm_stacked"] == 0, "K3 ran on the unfused path")
    led, static = reconcile(prog, rep.records, rep.observed_vectors)
    check(led == static, "CM_* ledgers do not reconcile")
    sched = run.schedule
    check(sched.n_cores == SERVE_CORES
          and sched.ledger_totals() == prog.mvm_counts(),
          f"per-core ledgers of {sched.n_cores} cores sum to "
          f"{sched.ledger_totals()}, the program's per-token counts are "
          f"{prog.mvm_counts()}")
    print(f"[serve] {sched.n_cores} per-core ledgers sum to the program's "
          f"per-token counts; modeled {sched.modeled_latency() * 1e6:.1f} "
          f"us per token vector (modelled ALPINE system, Table I-A, not "
          f"measured on any chip)", flush=True)
    check(len(rep.records) == N_REQ, "requests lost")
    for rec in rep.records.values():
        check(1 <= len(rec.tokens) <= rec.request.max_new
              and all(0 <= t < eng.cfg.vocab for t in rec.tokens),
              f"bad tokens for request {rec.request.rid}: {rec.tokens}")
    times = step_times(eng, run.requests[0].prompt)
    tokens, vl = eng._pad_prompt(run.requests[0].prompt)
    logits, _ = eng.model.prefill(eng.params, tokens, eng.cfg, eng.exe,
                                  max_seq=eng.max_seq, valid_len=vl)
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (1, 1, 49152), "bad granite logits")
    stats = {"wall_s": wall, "forward_passes": passes, "launches": counts,
             "peak_gb": peak_gb, "init_s": run.init_s,
             "core_ledgers": [led.row() for led in sched.ledgers()],
             "modeled_us_per_vector": sched.modeled_latency() * 1e6,
             **times,
             "served_tok_s": rep.generated_tokens
             / max(rep.wall_prefill_s + rep.wall_decode_s, 1e-9),
             "report": rep.summary(), "program": prog.summary()}
    print(f"[serve] served {stats['served_tok_s']:.1f} tok/s over the trace; "
          f"ledgers reconcile", flush=True)
    return run, stats


def stacked_phase(run):
    import torch

    from repro_torch.kernels import aimc_mvm
    from repro_torch.runtime.engine import ServeEngine

    eng = run.engine
    model = eng.model
    fused = model.fuse_gate_stacks(eng.params)
    check("w_gu" in fused["blocks"], "fuse_gate_stacks built no w_gu stack")
    for req in run.requests:
        tokens, vl = eng._pad_prompt(req.prompt)
        outs = [model.prefill(p, tokens, eng.cfg, eng.exe,
                              max_seq=eng.max_seq, valid_len=vl)[0]
                for p in (eng.params, fused)]
        check(torch.equal(outs[0], outs[1]),
              f"fused prefill logits differ (request {req.rid})")
    sync = [dataclasses.replace(r, arrival=0.0) for r in run.requests]
    reports, counts, engines = {}, {}, {}
    for name, params in (("unfused", eng.params), ("fused", fused)):
        e = ServeEngine(model, eng.cfg, eng.exe, params, n_slots=eng.n_slots,
                        prompt_pad=eng.prompt_pad, max_seq=eng.max_seq,
                        program=eng.program)
        aimc_mvm.reset_counts()
        reports[name] = e.serve(sync)
        torch.cuda.synchronize()
        counts[name] = (dict(aimc_mvm.LAUNCHES), e.forward_passes)
        engines[name] = e
    layers = eng.cfg.n_layers
    (cu, pu), (cf, pf) = counts["unfused"], counts["fused"]
    check(cu["aimc_mvm_v2"] == 7 * layers * pu and cu["aimc_mvm_stacked"] == 0,
          f"unfused launches {cu} for {pu} passes")
    check(cf["aimc_mvm_stacked"] == layers * pf
          and cf["aimc_mvm_v2"] == 5 * layers * pf,
          f"fused launches {cf} for {pf} passes")
    for r in sync:
        check(reports["fused"].tokens(r.rid) == reports["unfused"].tokens(r.rid),
              f"fused tokens differ for request {r.rid}")
    print(f"[stacked] fused path bit-equal to unfused: prefill logits of "
          f"{len(sync)} prompts, {reports['fused'].generated_tokens} tokens; "
          f"launches per pass: unfused K2 {cu['aimc_mvm_v2'] // pu}, fused "
          f"K2 {cf['aimc_mvm_v2'] // pf} + K3 "
          f"{cf['aimc_mvm_stacked'] // pf}", flush=True)
    # the two paths timed in turns within this call: fused, unfused, fused
    times = {"fused": [step_times(engines["fused"], sync[0].prompt)],
             "unfused": [step_times(engines["unfused"], sync[0].prompt)]}
    times["fused"].append(step_times(engines["fused"], sync[0].prompt))
    return {"unfused": {"launches": cu, "passes": pu,
                        "times": times["unfused"]},
            "fused": {"launches": cf, "passes": pf, "times": times["fused"]}}


def fused_serve_phase(dev):
    """The main path again through the CLI entry point with
    --fuse-gates: K3 runs w_gate + w_up once per layer and pass, K2 the
    other five projections; the CM_* books are unchanged by fusion."""
    import torch

    from repro_torch.kernels import aimc_mvm
    from repro_torch.launch import serve
    from repro_torch.runtime.batcher import reconcile

    args = ["--arch", ARCH, "--exec", "aimc", "--fuse-gates", "--requests",
            str(N_REQ), "--prompt-len", str(PROMPT), "--gen", str(GEN),
            "--slots", str(SLOTS), "--trace", f"poisson:{RATE:g}", "--seed",
            str(SEED), "--device", str(dev)]
    print(f"[fused] python -m repro_torch.launch.serve {' '.join(args)}",
          flush=True)
    aimc_mvm.reset_counts()
    run = serve.main(args)
    torch.cuda.synchronize(dev)
    counts = dict(aimc_mvm.LAUNCHES)
    eng, rep = run.engine, run.report
    layers, passes = eng.cfg.n_layers, eng.forward_passes
    check(counts["aimc_mvm_stacked"] == layers * passes
          and counts["aimc_mvm_v2"] == 5 * layers * passes,
          f"fused main path launches {counts} for {passes} passes")
    led, static = reconcile(run.program, rep.records, rep.observed_vectors)
    check(led == static, "fused CM_* ledgers do not reconcile")
    print(f"[fused] main path: {passes} forward passes, launches {counts}; "
          f"ledgers reconcile", flush=True)
    return {"launches": counts, "passes": passes, "report": rep.summary()}


def paper_shapes():
    """(name, B, K, N, G) of every crossbar MVM the paper nets run at the
    published widths: the MLP layers, the LSTM cell (side by side, and the
    fused [4, ...] stack) and head, and the conv layers of CNN-F/M/S (im2col
    rows = batch x output positions). Repeated shapes appear once."""
    from repro_torch.models.paper_nets import CNN_SPECS
    shapes = [("mlp fc", MLP_B, MLP_N, MLP_N, 1),
              ("lstm cell", LSTM_B, LSTM_NH + LSTM_X, 4 * LSTM_NH, 1),
              ("lstm cell G=4", LSTM_B, LSTM_NH + LSTM_X, LSTM_NH, 4),
              ("lstm dense", LSTM_B, LSTM_NH, LSTM_X, 1)]
    for v, spec in CNN_SPECS.items():
        hw = CNN_IMG
        for i, (cin, k, cout, stride, pad, _lrn, pool) in enumerate(spec):
            ho = (hw + 2 * pad - k) // stride + 1
            shapes.append((f"cnn-{v} conv{i}", CNN_B * ho * ho,
                           k * k * cin, cout, 1))
            hw = ho // pool
    out, seen = [], set()
    for row in shapes:
        if row[1:] not in seen:
            seen.add(row[1:])
            out.append(row)
    return out


def v1_hw_kernel_phase(dev, peaks):
    """K1 (`aimc_mvm_v1`, explicit noise operand from `noise.read_noise`),
    K2 with counter noise and K4 (K2/K3 with "hw" Philox noise) at every
    paper-net MVM shape, K1 also at the granite decode shapes: each held to
    its plain version on the same CUDA tensors within
    1e-5 * max(1, max|y|) and timed (CUDA events, L2 flushed)."""
    import functools

    import torch

    from repro_torch.core import noise as noise_lib
    from repro_torch.core import prng
    from repro_torch.core.aimc import AimcConfig, program_stacked
    from repro_torch.core.quant import sym_scale
    from repro_torch.kernels import aimc_mvm, ref
    from repro_torch.models.paper_nets import LSTM_GATE_ACTS

    cfg = AimcConfig(noise=paper_noise())
    step = cfg.adc_step
    sigma = noise_lib.read_sigma_lsb(cfg.tile_rows, cfg.noise)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    flush = flush_buffer(dev)
    granite = [(f"granite {p}", SLOTS, k, n, 1) for p, k, n in
               (("wq", 4096, 4096), ("wk", 4096, 1024),
                ("w_gate", 4096, 14336), ("w_down", 14336, 4096))]
    rows = []
    worst = {"aimc_mvm_v1": 0.0, "aimc_mvm_hw": 0.0}
    for idx, (name, b, k, n, g) in enumerate(paper_shapes() + granite):
        w = torch.randn((g, k, n), generator=gen, device=dev)
        st = program_stacked(w * (2.0 / (k + n)) ** 0.5, cfg)
        del w
        kb, m, np_ = st.w_q.shape[-3:]
        x = torch.nn.functional.pad(
            torch.randn((b, k), generator=gen, device=dev), (0, kb * m - k))
        s_x = sym_scale(x).reshape(1, 1)
        runs = []
        if g == 1:
            w_q, s_w = st.w_q[0], st.s_w[0]
            noise = noise_lib.read_noise(
                prng.fold_in(prng.PRNGKey(SEED), idx), (kb, b, np_), m,
                cfg.noise, device=dev)
            runs.append(("aimc_mvm_v1",
                         functools.partial(aimc_mvm.aimc_mvm_v1, x, w_q, s_w,
                                           s_x, noise, adc_step=step),
                         functools.partial(ref.aimc_matmul_ref, x, w_q, s_w,
                                           s_x, noise, adc_step=step),
                         kb * b * np_ * 4))
            kern_fn, plain_fn = aimc_mvm.aimc_mvm_v2, ref.aimc_matmul_ref_v2
            args, acts = (x, w_q, s_w, s_x, NOISE_SEED), {}
        else:
            kern_fn = aimc_mvm.aimc_mvm_stacked
            plain_fn = ref.aimc_matmul_stacked_ref
            args = (x, st.w_q, st.s_w, s_x, NOISE_SEED)
            acts = {"activations": LSTM_GATE_ACTS}
        if not name.startswith("granite"):
            for src in ("counter", "hw"):
                kw = dict(adc_step=step, sigma=sigma, noise_source=src,
                          **acts)
                runs.append((f"{kern_fn.__name__} {src}",
                             functools.partial(kern_fn, *args, **kw),
                             functools.partial(plain_fn, *args, **kw), 0))
        for kname, kern, plain, noise_bytes in runs:
            y, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((y - want).abs().max())
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            check(bool(torch.isfinite(y).all()) and err <= tol,
                  f"{kname} {name}: max |err| {err} > {tol}")
            wkey = ("aimc_mvm_v1" if kname == "aimc_mvm_v1" else
                    "aimc_mvm_hw" if kname.endswith("hw") else None)
            if wkey:
                worst[wkey] = max(worst[wkey], err)
            row = {"kernel": kname, "shape": name, "B": b, "K": k, "N": n,
                   "G": g, "max_abs_err": err, "tol": tol,
                   "ms": time_ms(kern, flush, KERNEL_REPS),
                   "plain_ms": time_ms(plain, flush, 3)}
            row["bound_ms"], row["bound_by"] = bound_ms(
                b, kb, m, np_, g, peaks, bias=False,
                noise_bytes=noise_bytes)
            row["plan"] = aimc_mvm.launch_plan(dev, b, kb, m, np_, g)
            if kname == "aimc_mvm_v2 counter" and b > 16:
                row["int_mm_ms"] = int_mm_yardstick(x, w_q, s_x, flush)
            rows.append(row)
            print(f"[v1/hw] {kname} {name} [{b}x{k}]x[{k}x{n}]"
                  f"{f' G={g}' if g > 1 else ''} ({plan_str(row['plan'])}): "
                  f"max|err| {err:.3g} (tol "
                  f"{tol:.3g}); kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})"
                  + (f"; torch._int_mm on the int8 codes (the MAC alone, "
                     f"not the same function) {row['int_mm_ms']:.4f} ms"
                     if row.get("int_mm_ms") is not None else ""),
                  flush=True)
        del st, x, runs
    return rows, worst


def int_mm_yardstick(x, w_q, s_x, flush):
    """Device ms of `torch._int_mm` on the DAC codes of x and the programmed
    panel as one [K, Np] int8 matrix: a yardstick for the int8 MAC alone
    (no DAC, noise, per-row-block ADC or dequant; not the same function,
    and the port never calls it). None where cuBLAS refuses the shapes."""
    import torch

    from repro_torch.core.quant import quantize
    codes = quantize(x, s_x.reshape(())).to(torch.int8)
    w = w_q.reshape(-1, w_q.shape[-1])
    try:
        torch._int_mm(codes, w)
    except RuntimeError as e:
        print(f"[v1/hw] torch._int_mm refused {tuple(codes.shape)} x "
              f"{tuple(w.shape)}: {str(e).splitlines()[0]}", flush=True)
        return None
    return time_ms(lambda: torch._int_mm(codes, w), flush, KERNEL_REPS)


def hw_draw_phase(dev):
    """K4's own stream: raw Philox draws read back through the kernel (zero
    weights, unit scales and ADC step, sigma 16, so each output is
    rint(16 z)) held to N(0, 1) moments over 2^21 draws per gate; same seed
    gives the same output, another seed another; K3 gate g equals a K2
    launch with `stack_seed(seed, g)` bit for bit."""
    import torch

    from repro_torch.kernels import aimc_mvm, cprng
    from repro_torch.models.paper_nets import LSTM_GATE_ACTS

    b, np_ = 512, 4096
    x = torch.ones((b, 64), device=dev)
    w_q = torch.zeros((2, 1, 64, np_), dtype=torch.int8, device=dev)
    s_w = torch.ones((2, 1, np_), device=dev)
    s_x = torch.ones((1, 1), device=dev)
    z = aimc_mvm.aimc_mvm_stacked(x, w_q, s_w, s_x, 0x5EED, adc_step=1.0,
                                  sigma=16.0, noise_source="hw")
    z = z.double() / 16.0
    flat = z[0].flatten()
    n = flat.numel()
    mean, std = float(flat.mean()), float(flat.std())
    lag1 = float(torch.corrcoef(torch.stack([flat[:-1], flat[1:]]))[0, 1])
    gates = float(torch.corrcoef(torch.stack([flat, z[1].flatten()]))[0, 1])
    check(abs(mean) < 4.0 / n ** 0.5, f"hw draws mean {mean}")
    check(abs(std - 1.0) < 0.01, f"hw draws std {std}")
    check(abs(lag1) < 0.01 and abs(gates) < 0.01,
          f"hw draws correlated: lag-1 {lag1}, gate-to-gate {gates}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn((LSTM_B, 1024), generator=gen, device=dev)
    w_q = torch.randint(-127, 128, (4, 2, 512, 768), generator=gen,
                        device=dev, dtype=torch.int8)
    s_w = torch.rand((4, 2, 768), generator=gen, device=dev) * 1e-3 + 5e-4
    s_x = (x.abs().max() / 127).reshape(1, 1)
    kw = dict(adc_step=2873.0, sigma=8.62, noise_source="hw")
    y = aimc_mvm.aimc_mvm_stacked(x, w_q, s_w, s_x, 41,
                                  activations=LSTM_GATE_ACTS, **kw)
    check(torch.equal(y, aimc_mvm.aimc_mvm_stacked(
        x, w_q, s_w, s_x, 41, activations=LSTM_GATE_ACTS, **kw)),
        "hw noise: same seed, different output")
    check(not torch.equal(y, aimc_mvm.aimc_mvm_stacked(
        x, w_q, s_w, s_x, 42, activations=LSTM_GATE_ACTS, **kw)),
        "hw noise: another seed, same output")
    for g in range(4):
        check(torch.equal(y[g], aimc_mvm.aimc_mvm_v2(
            x, w_q[g], s_w[g], s_x, cprng.stack_seed(41, g),
            activation=LSTM_GATE_ACTS[g], **kw)),
            f"K3 hw gate {g} != K2 hw with stack_seed")
    out = {"n": n, "mean": mean, "std": std, "lag1": lag1,
           "gate_corr": gates}
    print(f"[hw] Philox draws over {n} per gate: mean {mean:.2e}, std "
          f"{std:.5f}, lag-1 rho {lag1:.2e}, gate-to-gate rho {gates:.2e}; "
          f"same seed equal, other seed differs; K3 hw gates bit-equal to "
          f"K2 hw launches", flush=True)
    return out


def snr_db(ref, test) -> float:
    import torch
    err = torch.linalg.norm((ref - test).double())
    return float(20 * torch.log10(torch.linalg.norm(ref.double())
                                  / torch.clamp_min(err, 1e-12)))


def _ctx_on(ctx, device):
    """A copy of an `AimcContext` whose programmed states live on
    ``device`` (noise off, so its key is never drawn from)."""
    from repro_torch.core.aimclib import AimcContext
    out = AimcContext(ctx.cfg)
    out._counts = dict(ctx._counts)
    for name, st in ctx._builder._entries.items():
        out._builder._entries[name] = dataclasses.replace(
            st, w_q=st.w_q.to(device), s_w=st.s_w.to(device))
    return out


def _code_flips(card_x, cpu_x):
    """How many DAC codes (dynamic max-abs scale, as `core/aimc.py` takes
    it) differ between two versions of one MVM input, and the largest
    distance in LSB of a flipped CPU value from its rounding tie."""
    from repro_torch.core.quant import quantize, sym_scale
    s_card, s_cpu = sym_scale(card_x), sym_scale(cpu_x)
    flip = quantize(card_x, s_card) != quantize(cpu_x, s_cpu)
    if not bool(flip.any()):
        return 0, 0.0
    v = (cpu_x / s_cpu)[flip]
    return int(flip.sum()), float(((v - v.floor()) - 0.5).abs().max())


def _hook_mvms(ctx, fn):
    """Route ``ctx.linear`` and ``ctx.linear_stack`` through
    ``fn(meth, orig, name, x, **kw)``; `del ctx.linear, ctx.linear_stack`
    undoes it."""
    for meth in ("linear", "linear_stack"):
        setattr(ctx, meth, functools.partial(fn, meth, getattr(ctx, meth)))


def card_vs_cpu(name, p, x, cfg, aimc, ctx, y):
    """Noise off, the programmed net on the card against the same programmed
    states on the CPU (plain versions), in two CPU forwards:
    - forced: each crossbar MVM returns the card's own output for that
      call, so only the digital parts (im2col, LRN, pooling, the LSTM
      gates, the digital head) run on the CPU. Every MVM is replayed on the
      CPU from the card's input within 1e-5 * max(1, max|y|), the
      kernel-vs-plain bound; every MVM input agrees with the card's within
      1e-5 * max(1, max|x|); every DAC code that still differs lies within
      1e-3 LSB of a rounding tie; the output agrees within 1e-4.
    - free: the whole forward on the CPU. Top-1 agrees with the card's on
      every sample; the MLP's and LSTM's outputs agree within 1e-4. A
      CNN's output is reported, not held: the ulp-level differences above
      move DAC codes on ties, each flip moves the next layer's inputs by an
      LSB, and the codes that differ per MVM are counted."""
    import torch
    ctx_cpu = _ctx_on(ctx, "cpu")
    card = []

    def record(meth, orig, mname, x_in, **kw):
        out = orig(mname, x_in, **kw)
        card.append((meth, mname, x_in, out))
        return out

    _hook_mvms(ctx, record)
    aimc(p, x, cfg, ctx=ctx)
    del ctx.linear, ctx.linear_stack
    res = {"mvm_err": 0.0, "digital_err": 0.0, "forced_flips": [],
           "tie_dist_lsb": 0.0, "free_flips": []}
    calls = iter(card)

    def forced(meth, orig, mname, x_in, **kw):
        cmeth, cname, card_x, card_out = next(calls)
        check((meth, mname) == (cmeth, cname),
              f"{name}: CPU called {meth} {mname}, the card {cmeth} {cname}")
        card_x, card_out = card_x.cpu(), card_out.cpu()
        want = orig(mname, card_x, **kw)
        err = float((card_out - want).abs().max())
        check(err <= 1e-5 * max(1.0, float(want.abs().max())),
              f"{name}: {meth} {mname} card vs CPU (plain) {err}")
        derr = float((x_in - card_x).abs().max())
        check(derr <= 1e-5 * max(1.0, float(card_x.abs().max())),
              f"{name}: {mname} input from the CPU's digital parts vs the "
              f"card's {derr}")
        flips, dist = _code_flips(card_x, x_in)
        check(dist <= 1e-3, f"{name}: {mname} DAC code flipped "
              f"{dist} LSB from a rounding tie")
        res["mvm_err"] = max(res["mvm_err"], err)
        res["digital_err"] = max(res["digital_err"], derr)
        res["tie_dist_lsb"] = max(res["tie_dist_lsb"], dist)
        res["forced_flips"].append(flips)
        return card_out

    def free(meth, orig, mname, x_in, **kw):
        res["free_flips"].append(_code_flips(next(calls)[2].cpu(), x_in)[0])
        return orig(mname, x_in, **kw)

    cpu_p = ({k: [t.cpu() for t in v] for k, v in p.items()}
             if name.startswith("CNN") else p)
    y_card = y.cpu()
    _hook_mvms(ctx_cpu, forced)
    y_forced, _ = aimc(cpu_p, x.cpu(), cfg, ctx=ctx_cpu)
    err = float((y_card - y_forced).abs().max())
    check(err <= 1e-4, f"{name}: card vs CPU digital parts on the card's "
          f"MVM outputs {err}")
    res["forced_err"] = err
    calls = iter(card)
    del ctx_cpu.linear, ctx_cpu.linear_stack
    _hook_mvms(ctx_cpu, free)
    y_cpu, _ = aimc(cpu_p, x.cpu(), cfg, ctx=ctx_cpu)
    del card
    err = float((y_card - y_cpu).abs().max())
    top1 = float((y_card.argmax(-1) == y_cpu.argmax(-1)).float().mean())
    check(top1 == 1.0, f"{name}: card vs CPU (plain) top-1 agree {top1}")
    if not name.startswith("CNN"):
        check(err <= 1e-4, f"{name}: card vs CPU (plain) output {err}")
    res.update(card_vs_cpu_err=err, card_vs_cpu_top1=top1)
    return res


def staged_v1_phase(dev):
    """The v1 staged entry on the card: the MLP's programmed layers through
    `ops.aimc_matmul` with a bulk `noise.read_noise` operand (kernel K1),
    relu digital. Counts zeroed just before, read just after: 2 K1
    launches, no other kernel. Fed the counter stream materialised, K1
    equals K2's in-kernel counter noise."""
    import torch

    from repro_torch.core import noise as noise_lib
    from repro_torch.core import prng
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.core.quant import sym_scale
    from repro_torch.kernels import aimc_mvm, cprng, ops
    from repro_torch.models import paper_nets

    cfg = AimcConfig(noise=paper_noise())
    key = prng.PRNGKey(SEED + 3)
    prog = paper_nets.mlp_program(paper_nets.mlp_init(key, MLP_N, device=dev),
                                  cfg, key)
    x = prng.normal(prng.fold_in(key, 1), (MLP_B, MLP_N), device=dev)
    sigma = noise_lib.read_sigma_lsb(cfg.tile_rows, cfg.noise)

    def forward():
        h = x
        for i, name in enumerate(prog.names):
            st = prog[name]
            kb, m, np_ = st.w_q.shape
            h = torch.nn.functional.pad(h, (0, kb * m - h.shape[1]))
            s_x = sym_scale(h).reshape(1, 1)
            rn = noise_lib.read_noise(prng.fold_in(key, 100 + i),
                                      (kb, h.shape[0], np_), m, cfg.noise,
                                      device=dev)
            h = torch.relu(ops.aimc_matmul(h, st.w_q, st.s_w, s_x, rn,
                                           adc_step=cfg.adc_step)[:, :st.n])
        return h

    aimc_mvm.reset_counts()
    y = forward()
    torch.cuda.synchronize(dev)
    counts = dict(aimc_mvm.LAUNCHES)
    check(counts["aimc_mvm_v1"] == 2
          and sum(counts.values()) == counts["aimc_mvm_v1"],
          f"staged MLP launches {counts}")
    check(bool(torch.isfinite(y).all()) and tuple(y.shape) == (MLP_B, MLP_N),
          "bad staged MLP output")
    st = prog["fc1"]
    kb, m, np_ = st.w_q.shape
    x = torch.nn.functional.pad(x, (0, kb * m - x.shape[1]))
    s_x = sym_scale(x).reshape(1, 1)
    rn = sigma * cprng.read_noise_array(NOISE_SEED, kb, MLP_B, np_,
                                        device=dev)
    y1 = ops.aimc_matmul(x, st.w_q, st.s_w, s_x, rn, adc_step=cfg.adc_step)
    y2 = ops.aimc_matmul_v2(x, st.w_q, st.s_w, s_x, NOISE_SEED,
                            adc_step=cfg.adc_step, sigma=sigma)
    torch.cuda.synchronize(dev)
    err = float((y1 - y2).abs().max())
    check(err <= 1e-5 * max(1.0, float(y2.abs().max())),
          f"K1 on materialised counter noise vs K2: {err}")
    ms, _ = timed(forward, dev)
    print(f"[staged] MLP {MLP_N} B={MLP_B} through ops.aimc_matmul + "
          f"noise.read_noise: launches {counts}; {ms:.3f} ms per forward; "
          f"K1 on the materialised counter stream vs K2: max|err| {err:.3g}"
          f"{' (bit-equal)' if err == 0.0 else ''}", flush=True)
    return {"launches": counts, "forward_ms": ms, "k1_vs_k2_err": err}


def paper_nets_phase(dev):
    """The paper's networks at their published widths through `AimcContext`
    and the `paper_nets` entry points, noise off and with the NOISY read
    noise of bench_accuracy under both noise sources. Launch counts zeroed
    just before and read just after each apply-only forward; fidelity
    against the digital fp32 path; noise off, the card's outputs against
    the same programmed nets run on the CPU through the plain versions."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.kernels import aimc_mvm
    from repro_torch.models import paper_nets as pn

    key = prng.PRNGKey(7)

    def fk(i):
        return prng.fold_in(key, i)

    cfgs = {"off": AimcConfig(tile_rows=512)}
    for src in ("counter", "hw"):
        cfgs[src] = AimcConfig(tile_rows=512, noise=paper_noise(),
                               noise_source=src)
    nets = []
    p = pn.mlp_init(key, MLP_N, device=dev)
    x = prng.normal(fk(1), (MLP_B, MLP_N), device=dev)
    nets.append(("MLP", p, x, 2, pn.mlp_forward_digital,
                 lambda p, x, c, k=None, ctx=None: pn.mlp_forward_aimc(
                     p, x, c, k, ctx), {"aimc_mvm_v2": 2}))
    p = pn.lstm_init(fk(3), LSTM_NH, LSTM_X, LSTM_X, device=dev)
    xs = prng.normal(fk(4), (LSTM_T, LSTM_B, LSTM_X), device=dev)
    for fused in (False, True):
        nets.append(
            (f"LSTM {'fused' if fused else 'side-by-side'}", p, xs, 5,
             lambda p, x: pn.lstm_forward_digital(p, x, LSTM_NH),
             lambda p, x, c, k=None, ctx=None, f=fused: pn.lstm_forward_aimc(
                 p, x, LSTM_NH, c, k, ctx, fuse_gates=f),
             {"aimc_mvm_stacked": LSTM_T, "aimc_mvm_v2": LSTM_T} if fused
             else {"aimc_mvm_v2": 2 * LSTM_T}))
    for v in ("F", "M", "S"):
        p = pn.cnn_init(fk(6), v, CNN_IMG, CNN_CLASSES, device=dev)
        x = prng.normal(fk(7), (CNN_B, CNN_IMG, CNN_IMG, 3), device=dev)
        nets.append((f"CNN-{v}", p, x, 8,
                     lambda p, x, v=v: pn.cnn_forward(p, x, v),
                     lambda p, x, c, k=None, ctx=None, v=v: pn.cnn_forward(
                         p, x, v, c, key=k, ctx=ctx), {"aimc_mvm_v2": 5}))

    results, off_outputs, hw_launches = {}, {}, 0
    for name, p, x, kfold, digital, aimc, per_fwd in nets:
        y_dig = digital(p, x)
        res = {"digital_ms": timed(lambda: digital(p, x), dev, reps=2)[0]}
        outs = {}
        for src, cfg in cfgs.items():
            t0 = time.perf_counter()
            y, ctx = aimc(p, x, cfg, fk(kfold))   # programs, then applies
            torch.cuda.synchronize(dev)
            first_s = time.perf_counter() - t0
            aimc_mvm.reset_counts()
            y2, _ = aimc(p, x, cfg, ctx=ctx)       # apply only
            torch.cuda.synchronize(dev)
            counts = {k: v for k, v in aimc_mvm.LAUNCHES.items() if v}
            want = ({f"{k}_hw": v for k, v in per_fwd.items()}
                    if src == "hw" else per_fwd)
            check(counts == want, f"{name} {src}: launches {counts} != "
                  f"{want} per forward")
            hw_launches += sum(v for k, v in counts.items()
                               if k.endswith("_hw"))
            check(bool(torch.isfinite(y).all())
                  and tuple(y.shape) == tuple(y_dig.shape),
                  f"{name} {src}: bad output {tuple(y.shape)}")
            ms, _ = timed(lambda: aimc(p, x, cfg, ctx=ctx), dev, reps=2)
            entry = {"launches_per_forward": counts, "first_call_s": first_s,
                     "apply_ms": ms, "snr_db": snr_db(y_dig, y)}
            if src == "off":
                check(torch.equal(y, y2), f"{name}: noise-off apply-only "
                      f"forward differs from the first")
                entry.update(card_vs_cpu(name, p, x, cfg, aimc, ctx, y))
            else:
                entry["profile"] = device_profile(
                    lambda: aimc(p, x, cfg, ctx=ctx), dev)
            if name.startswith("LSTM"):
                entry["top1"] = float((y.argmax(-1) == y_dig.argmax(-1))
                                      .float().mean())
            if name.startswith("CNN"):
                agree = y.argmax(-1) == y_dig.argmax(-1)
                top2 = torch.sort(y_dig, -1).values[:, -2:]
                margins = top2[:, 1] - top2[:, 0]
                err_scale = (y - y_dig).abs().amax(-1)
                entry["top1"] = float(agree.float().mean())
                entry["margin_ok"] = bool((agree | (margins < err_scale))
                                          .all())
            outs[src] = y
            res[src] = entry
            print(f"[paper] {name} {src}: {counts} per forward; first call "
                  f"(programs) {first_s:.2f} s, apply {ms:.2f} ms; SNR vs "
                  f"digital {entry['snr_db']:.2f} dB"
                  + (f", top-1 {entry['top1']:.0%}" if "top1" in entry
                     else "")
                  + (f", flips inside the noise margin: "
                     f"{entry['margin_ok']}" if "margin_ok" in entry else "")
                  + (f"; card vs CPU (plain): per MVM max|err| "
                     f"{entry['mvm_err']:.3g}; CPU digital parts on the "
                     f"card's MVM outputs: inputs max|err| "
                     f"{entry['digital_err']:.3g}, DAC codes flipped per MVM "
                     f"{entry['forced_flips']} (max {entry['tie_dist_lsb']:.2g}"
                     f" LSB from a tie), output max|err| "
                     f"{entry['forced_err']:.3g}; whole forward on the CPU: "
                     f"DAC codes flipped per MVM {entry['free_flips']}, "
                     f"output max|err| {entry['card_vs_cpu_err']:.3g}, top-1 "
                     f"agrees" if "card_vs_cpu_err" in entry else ""),
                  flush=True)
            if "profile" in entry:
                print_profile("paper", entry["profile"])
        gap = abs(res["hw"]["snr_db"] - res["counter"]["snr_db"])
        check(gap <= 1.0, f"{name}: hw SNR {res['hw']['snr_db']} vs "
              f"counter {res['counter']['snr_db']} dB")
        results[name] = res
        off_outputs[name] = outs["off"]
    check(torch.equal(off_outputs["LSTM fused"],
                      off_outputs["LSTM side-by-side"]),
          "fused LSTM differs from side-by-side (noise off)")
    print("[paper] fused LSTM bit-equal to side-by-side with noise off",
          flush=True)
    return results, hw_launches


def init_phase(dev, serve_init_s: float):
    """Weight init on JAX's keys: granite-8b's layer-0 w_gate key (ks[9] of
    `transformer.init`, layer 0 of its split) drawn at that layer's shape
    on the card and on the CPU. The uint32 draws must be equal and the
    normals within 4 ulps (f64 `log1p` on the card vs the CPU); the serve
    phase's full-width init seconds are reported beside the card's time for
    this one layer."""
    import torch

    from repro_torch.core import prng
    d, ff, layers = 4096, 14336, 36
    key = prng.split(prng.split(prng.PRNGKey(SEED), 16)[9], layers)[0]
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    card = prng.bits(key, (d, ff), device=dev)
    torch.cuda.synchronize(dev)
    bits_s = time.perf_counter() - t
    check(torch.equal(card.cpu(), prng.bits(key, (d, ff), device="cpu")),
          "threefry bits differ between the card and the CPU")
    del card
    t = time.perf_counter()
    card = prng.normal(key, (d, ff), device=dev)
    torch.cuda.synchronize(dev)
    normal_s = time.perf_counter() - t
    cpu = prng.normal(key, (d, ff), device="cpu")
    ulps = int((card.cpu().view(torch.int32).long()
                - cpu.view(torch.int32).long()).abs().max())
    differ = int((card.cpu() != cpu).sum())
    check(ulps <= 4, f"card vs CPU normals differ by {ulps} ulps")
    out = {"shape": [d, ff], "card_bits_s": bits_s,
           "card_normal_s": normal_s, "max_ulps": ulps,
           "normals_differing": differ, "full_width_init_s": serve_init_s}
    print(f"[init] w_gate layer 0 [{d}x{ff}] on JAX's keys: bits card == "
          f"CPU; normals max {ulps} ulps ({differ} of {d * ff} differ); "
          f"card {bits_s:.3f} s bits, {normal_s:.3f} s normals; full-width "
          f"granite-8b init (8.25e9 normals) {serve_init_s:.2f} s",
          flush=True)
    return out


@contextlib.contextmanager
def mvm_dispatch(wrap):
    """Route `kernels.ops.aimc_matmul_v2`, which every `aimc_apply` and
    `coupling.tight_forward` call goes through, via ``wrap(orig, *args,
    **kw)`` for the duration."""
    from repro_torch.kernels import ops
    orig = ops.aimc_matmul_v2
    ops.aimc_matmul_v2 = functools.partial(wrap, orig)
    try:
        yield
    finally:
        ops.aimc_matmul_v2 = orig


def _plain(orig, x, w_q, s_w, s_x, seed=None, bias=None, *, adc_step,
           sigma=0.0, activation="none", noise_source="counter"):
    """The plain version on the same (CUDA) tensors."""
    from repro_torch.kernels import ref
    return ref.aimc_matmul_ref_v2(x, w_q, s_w, s_x, seed, bias,
                                  adc_step=adc_step, sigma=sigma,
                                  activation=activation)


@contextlib.contextmanager
def read_keys(sched, key, log=None):
    """Every ``sched.apply`` call draws counter read noise from
    ``fold_in(key, i)``, i counting the calls from 0 (the paper nets'
    multi-core forwards pass no read key of their own); with ``log``, each
    call's (matrix, input, key, output) is appended to it."""
    from repro_torch.core import prng
    calls = iter(range(1 << 30))

    def apply(name, x, k=None):
        sub = prng.fold_in(key, next(calls))
        y = type(sched).apply(sched, name, x, sub)
        if log is not None:
            log.append((name, x, sub, y))
        return y

    sched.apply = apply
    try:
        yield
    finally:
        del sched.apply


def _err(y, want):
    err = float((y - want).abs().max())
    return err, 1e-5 * max(1.0, float(want.abs().max()))


def multicore_phase(dev, peaks):
    """The paper's multi-core mappings on the card (`core.schedule`): at the
    reference's own configurations and seeds (bench_pipeline: MLP 1024 on
    1024-row tiles B 1, cores 1/2/4; the LSTM at n_h 600 on 700-row tiles,
    4 steps of B 1, cores 1/2/5; CNN-F 224 px B 1 on 1024-row tiles as a
    position pipeline) and at the paper nets phase's full widths on 512-row
    tiles (MLP B 16 cores 1/2/4; LSTM n_h 750 B 8 T 20 cores 1/2; CNN-F/M/S
    224 px B 8 pipelines). Gates: column splits bit-equal to 1 core and the
    CNN pipeline to `cnn_forward_multicore` and the ctx path (noise off);
    under counter noise each forward within 1e-5 * max(1, max|y|) of the
    same schedule on the plain version; one K2 launch per shard per apply;
    ledgers partition the program's totals; modelled latency equals
    `costmodel.evaluate` within 1% (CNN-M recorded only: the reference's
    workload table gives its conv1 52x52 outputs, its CNN_SPECS 54x54);
    every new K2 shape held to its plain version and timed; tight == loose
    coupling."""
    import torch

    from repro_torch.core import costmodel, isa, prng
    from repro_torch.core import schedule as sl
    from repro_torch.core import workloads as wls
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.kernels import aimc_mvm
    from repro_torch.models import paper_nets as pn

    hp = costmodel.HIGH_POWER
    res = {"configs": {}, "k2_shapes": [], "coupling": []}

    def pk(i):
        return prng.PRNGKey(i)

    def fk(i):
        return prng.fold_in(prng.PRNGKey(7), i)

    noisy = paper_noise()
    # (name, cfg, program fn, programming key, input, schedules by cores,
    #  forward(sched), calls per matrix per forward, workload cases)
    configs = []
    p = pn.mlp_init(pk(0), MC_MLP_N, device=dev)
    configs.append(dict(
        name="MLP 1024 B1 (bench_pipeline)", net="mlp", params=p,
        x=prng.normal(pk(1), (1, MC_MLP_N), device=dev),
        cfg=AimcConfig(tile_rows=MC_MLP_N, tile_cols=MC_MLP_N),
        program=lambda p, c, k: pn.mlp_program(p, c, k),
        cores=(1, 2, 4), key=pk(10)))
    p = pn.lstm_init(pk(2), MC_LSTM_NH, device=dev)
    configs.append(dict(
        name="LSTM 600 B1 (bench_pipeline)", net="lstm", params=p,
        x=prng.normal(pk(3), (4, 1, 50), device=dev), nh=MC_LSTM_NH,
        cfg=AimcConfig(tile_rows=MC_LSTM_NH + 100,
                       tile_cols=4 * MC_LSTM_NH),
        program=lambda p, c, k: pn.lstm_program(p, c, k),
        cores=(1, 2, 5), key=pk(11)))
    p = pn.cnn_init(pk(4), "F", CNN_IMG, device=dev)
    configs.append(dict(
        name="CNN-F 224 B1 (bench_pipeline)", net="cnn", variant="F",
        params=p, x=prng.normal(pk(5), (1, CNN_IMG, CNN_IMG, 3), device=dev),
        cfg=AimcConfig(tile_rows=1024, tile_cols=4096),
        program=lambda p, c, k, v="F": pn.cnn_program(p, v, c, k),
        cores=(5,), key=pk(12)))
    p = pn.mlp_init(prng.PRNGKey(7), MLP_N, device=dev)
    configs.append(dict(
        name="MLP 1024 B16", net="mlp", params=p,
        x=prng.normal(fk(1), (MLP_B, MLP_N), device=dev),
        cfg=AimcConfig(tile_rows=512),
        program=lambda p, c, k: pn.mlp_program(p, c, k),
        cores=(1, 2, 4), key=fk(2)))
    p = pn.lstm_init(fk(3), LSTM_NH, LSTM_X, LSTM_X, device=dev)
    configs.append(dict(
        name="LSTM 750 B8 T20", net="lstm", params=p, nh=LSTM_NH,
        x=prng.normal(fk(4), (LSTM_T, LSTM_B, LSTM_X), device=dev),
        cfg=AimcConfig(tile_rows=512),
        program=lambda p, c, k: pn.lstm_program(p, c, k),
        cores=(1, 2), key=fk(5)))
    for v in ("F", "M", "S"):
        p = pn.cnn_init(fk(6), v, CNN_IMG, CNN_CLASSES, device=dev)
        configs.append(dict(
            name=f"CNN-{v} 224 B8", net="cnn", variant=v, params=p,
            x=prng.normal(fk(7), (CNN_B, CNN_IMG, CNN_IMG, 3), device=dev),
            cfg=AimcConfig(tile_rows=512),
            program=lambda p, c, k, v=v: pn.cnn_program(p, v, c, k),
            cores=(5,), key=fk(8)))

    def schedule(c, prog, cores):
        if c["net"] == "mlp":
            return sl.mlp_schedule(prog, cores)
        if c["net"] == "lstm":
            return sl.lstm_schedule(prog, cores, c["nh"])
        return sl.cnn_schedule(prog, pn.CNN_SPECS[c["variant"]],
                               img=c["x"].shape[1])

    def forward(c, sched):
        if c["net"] == "mlp":
            return pn.mlp_forward_multicore(c["params"], c["x"], c["cfg"],
                                            schedule=sched)[0]
        if c["net"] == "lstm":
            return pn.lstm_forward_multicore(c["params"], c["x"], c["nh"],
                                             c["cfg"], schedule=sched)[0]
        return pn.cnn_forward_multicore(c["params"], c["x"], c["variant"],
                                        c["cfg"], schedule=sched)[0]

    def workload(c, cores):
        cfg = c["cfg"]
        if c["net"] == "mlp":
            w = wls.mlp_workloads(c["params"]["w1"].shape[0])[
                {1: "ana_case1", 2: "ana_case3", 4: "ana_case4"}[cores]]
        elif c["net"] == "lstm":
            w = wls.lstm_workloads(c["nh"])[
                {1: "ana_case2", 2: "ana_case3", 5: "ana_case4"}[cores]]
        else:
            w = wls.cnn_workloads(c["variant"])["ana"]
        return dataclasses.replace(w, tile_rows=cfg.tile_rows)

    shapes = {}

    def record(orig, x, w_q, *a, **kw):
        """Operands of the first call at each shape no earlier phase ran
        (M != 512, or B <= 16; the 512-row CNN shapes are phase 7's)."""
        if w_q.shape[1] != 512 or x.shape[0] <= 16:
            shapes.setdefault((x.shape[0], *w_q.shape), (x, w_q) + a[:2])
        return orig(x, w_q, *a, **kw)

    for c in configs:
        name, cfg = c["name"], c["cfg"]
        prog = c["program"](c["params"], cfg, None)
        per = {}
        outs = {}
        for cores in c["cores"]:
            sched = schedule(c, prog, cores)
            calls = (c["x"].shape[0] if c["net"] == "lstm" else 1)
            want_launches = calls * len(sched.shards)
            aimc_mvm.reset_counts()
            y = forward(c, sched)
            torch.cuda.synchronize(dev)
            launches = {k: v for k, v in aimc_mvm.LAUNCHES.items() if v}
            check(launches == {"aimc_mvm_v2": want_launches},
                  f"{name} {cores} cores: launches {launches}, want "
                  f"{want_launches} K2 (one per shard per apply)")
            check(bool(torch.isfinite(y).all()), f"{name}: non-finite")
            with mvm_dispatch(record):
                forward(c, sched)
            ms, _ = timed(lambda: forward(c, sched), dev)
            tot, ref_counts = sched.ledger_totals(), prog.mvm_counts()
            splits = {}
            for sh in sched.shards:
                splits[sh.name] = splits.get(sh.name, 0) + 1
            if c["net"] == "cnn":
                want_tot = isa.total(
                    isa.mvm_counts(prog[sh.name].k, prog[sh.name].n,
                                      cfg.tile_rows).scaled(sh.count)
                    for sh in sched.shards)
                check(tot == want_tot, f"{name}: ledgers {tot} != counts "
                      f"scaled by positions {want_tot}")
            else:
                split_queue = sum(
                    isa.mvm_counts(prog[m].k, prog[m].n,
                                      cfg.tile_rows).queue * (k - 1)
                    for m, k in splits.items())
                check(tot.dequeue == ref_counts.dequeue
                      and tot.initialize == ref_counts.initialize
                      and tot.queue == ref_counts.queue + split_queue,
                      f"{name} {cores} cores: ledgers {tot} do not "
                      f"partition the program's {ref_counts}")
            wl = workload(c, cores)
            ev = costmodel.evaluate(wl, hp)
            modeled = sched.modeled_latency(hp)
            if c["net"] == "cnn":
                n_conv = len(pn.CNN_SPECS[c["variant"]])
                pred = max(ev.stage_times[:n_conv])
            else:
                pred = ev.time_s
            ratio = modeled / pred
            # the reference's CNN-M workload takes conv1 at 52x52 outputs
            # where its CNN_SPECS give 54x54: recorded, not gated
            if c["net"] != "cnn" or c["variant"] != "M":
                check(abs(ratio - 1.0) <= 0.01,
                      f"{name} {cores} cores: modelled {modeled} vs "
                      f"evaluate {pred}")
            entry = {"cores": cores, "shards": len(sched.shards),
                     "launches": launches, "forward_ms": ms,
                     "modeled_us": modeled * 1e6,
                     "modeled_seq_us": sl.sequential_latency(
                         sched.phase_times(hp)) * 1e6,
                     "evaluate_us": pred * 1e6, "modeled_vs_evaluate": ratio,
                     "ledgers": [led.row() for led in sched.ledgers()]}
            outs[cores] = y
            per[cores] = (sched, entry)
            print(f"[multicore] {name} {cores} cores: {len(sched.shards)} "
                  f"shards, launches {launches}; {ms:.3f} ms per forward; "
                  f"modelled ALPINE system (Table I-A, not measured on any "
                  f"chip) {modeled * 1e6:.1f} us/inference, evaluate "
                  f"{pred * 1e6:.1f} us (ratio {ratio:.4f})", flush=True)
        base = outs[c["cores"][0]]
        for cores, y in outs.items():
            check(torch.equal(y, base), f"{name}: {cores} cores differ "
                  f"from {c['cores'][0]}")
        if c["net"] == "mlp" and 2 in c["cores"]:
            for cores in (1, 2):
                s_f = sl.mlp_schedule(prog, cores, fuse_epilogue=True)
                wl = dataclasses.replace(wls.mlp_workloads(
                    c["params"]["w1"].shape[0])[f"ana_case{2 * cores - 1}"
                                                f"_fused"],
                    tile_rows=cfg.tile_rows)
                m_f, e_f = s_f.modeled_latency(hp), costmodel.evaluate(
                    wl, hp).time_s
                check(abs(m_f / e_f - 1.0) <= 0.01,
                      f"{name} fused {cores} cores: {m_f} vs {e_f}")
                per[cores][1]["fused_modeled_us"] = m_f * 1e6
        cres = {"cores": {k: v[1] for k, v in per.items()}}
        sched = per[c["cores"][-1]][0]
        if c["net"] == "cnn":
            cres.update(cnn_pipeline_checks(c, sched, base, prog, dev))
        cres["profile"] = device_profile(lambda: forward(c, sched), dev)
        print_profile("multicore", cres["profile"])
        cres["noise"] = multicore_noise_checks(c, schedule, forward, dev)
        res["configs"][name] = cres
    res["k2_shapes"] = multicore_k2_shapes(shapes, dev, peaks)
    res["coupling"] = coupling_checks(configs, dev, peaks)
    return res


def cnn_pipeline_checks(c, sched, y_mc, prog, dev):
    """The position pipeline: per-stage wallclock through `pipeline_run`
    (two inputs after one warm-up input), outputs equal to the multi-core
    forward and to the single-core ctx path; the measured sequential /
    pipelined speedup beside the cost model's."""
    import torch

    from repro_torch.core import costmodel, workloads
    from repro_torch.core import schedule as sl
    from repro_torch.models import paper_nets as pn
    v, cfg, x = c["variant"], c["cfg"], c["x"]
    stages = pn.cnn_pipeline_stages(c["params"], v, cfg, sched)
    sl.pipeline_run(stages, [x])
    outs, times = sl.pipeline_run(stages, [x, x])
    check(all(torch.equal(o, y_mc) for o in outs),
          f"{c['name']}: pipeline output != cnn_forward_multicore")
    y_ctx, _ = pn.cnn_forward(c["params"], x, v, cfg)
    torch.cuda.synchronize(dev)
    check(torch.equal(y_ctx, y_mc),
          f"{c['name']}: pipeline != single-core ctx path "
          f"(max |err| {float((y_ctx - y_mc).abs().max())})")
    ev = costmodel.evaluate(dataclasses.replace(
        workloads.cnn_workloads(v)["ana"], tile_rows=cfg.tile_rows),
        costmodel.HIGH_POWER)
    pt = sched.phase_times(costmodel.HIGH_POWER)
    out = {"stage_ms": [t * 1e3 for t in times],
           "measured_speedup": sum(times) / max(times),
           "modeled_speedup": (sl.sequential_latency(pt)
                               / sl.pipelined_latency(pt)),
           "evaluate_speedup": sum(ev.stage_times) / max(ev.stage_times)}
    print(f"[multicore] {c['name']} pipeline: stages "
          + " ".join(f"{t * 1e3:.3f}" for t in times)
          + f" ms; measured sequential/pipelined speedup "
          f"{out['measured_speedup']:.2f}x, modelled (schedule) "
          f"{out['modeled_speedup']:.2f}x, evaluate (with the digital head) "
          f"{out['evaluate_speedup']:.2f}x; pipeline == multi-core forward "
          f"== ctx path bit for bit", flush=True)
    return out


def multicore_noise_checks(c, schedule, forward, dev):
    """Programming noise from a key and counter read noise from a key per
    apply call, the multi-core forward on the kernels against the same
    schedules on the plain version (same CUDA tensors): every MVM, replayed
    on the plain version from the kernel run's input and key, within
    1e-5 * max(1, max|y|); the whole forward within that bound for the MLP
    and LSTM. A CNN's f32 row-block association moves DAC codes on rounding
    ties from layer to layer (phase 9 counts them), so its forward is held
    to bench_accuracy's flip-margin rule: top-1 equal on every sample whose
    top-2 margin exceeds its output difference."""
    import dataclasses as dc

    import torch

    from repro_torch.kernels import aimc_mvm
    cfg = dc.replace(c["cfg"], noise=paper_noise(), noise_source="counter")
    prog = c["program"](c["params"], cfg, c["key"])
    calls = c["x"].shape[0] if c["net"] == "lstm" else 1
    out = {}
    for cores in c["cores"]:
        sched = schedule(c, prog, cores)
        log = []
        with read_keys(sched, c["key"], log):
            aimc_mvm.reset_counts()
            y = forward(c, sched)
            torch.cuda.synchronize(dev)
            launches = dict(aimc_mvm.LAUNCHES)
        check(launches["aimc_mvm_v2"] == calls * len(sched.shards),
              f"{c['name']} {cores} cores under noise: launches {launches}")
        mvm_err = 0.0
        with mvm_dispatch(_plain):
            for name, x_in, key, y_mvm in log:
                err, tol = _err(y_mvm, type(sched).apply(sched, name, x_in,
                                                         key))
                check(err <= tol, f"{c['name']} {cores} cores, {name} under "
                      f"counter noise: kernels vs plain {err} > {tol}")
                mvm_err = max(mvm_err, err)
        del log
        with read_keys(sched, c["key"]), mvm_dispatch(_plain):
            want = forward(c, sched)
        torch.cuda.synchronize(dev)
        err, tol = _err(y, want)
        agree = y.argmax(-1) == want.argmax(-1)
        top1 = float(agree.float().mean())
        check(bool(torch.isfinite(y).all()), f"{c['name']}: non-finite")
        if c["net"] == "cnn":
            # bench_accuracy's flip-margin rule: a sample whose top-1 moved
            # had a top-2 margin below its own output difference
            top2 = torch.sort(want, -1).values[:, -2:]
            margin = top2[:, 1] - top2[:, 0]
            check(bool((agree | (margin < (y - want).abs().amax(-1))).all()),
                  f"{c['name']} under counter noise: top-1 kernels vs plain "
                  f"agree {top1}, a flip outside its margin")
        else:
            check(err <= tol, f"{c['name']} {cores} cores, counter noise: "
                  f"kernels vs plain {err} > {tol}")
        out[cores] = {"mvm_max_abs_err": mvm_err, "max_abs_err": err,
                      "tol": tol, "top1": top1}
        print(f"[multicore] {c['name']} {cores} cores, programming + counter "
              f"read noise: kernels vs plain per MVM max|err| {mvm_err:.3g}, "
              f"forward max|err| {err:.3g} (tol {tol:.3g}), top-1 agrees "
              f"{top1:.0%}", flush=True)
    return out


def multicore_k2_shapes(shapes, dev, peaks):
    """K2 at every shape the multi-core forwards gave it that no earlier
    phase ran (``shapes``: (B, KB, M, Np) -> operands): held to its plain
    version noise off and with counter noise, and timed as in phase 2."""
    import torch

    from repro_torch.core import noise as noise_lib
    from repro_torch.core.quant import adc_step_lsb
    from repro_torch.kernels import aimc_mvm, ref
    flush = flush_buffer(dev)
    rows = []
    for (b, kb, m, np_), (x, w_q, s_w, s_x) in sorted(shapes.items()):
        step = adc_step_lsb(m, 1.0)        # the paper nets' adc_alpha 1
        sigma = noise_lib.read_sigma_lsb(m, paper_noise())
        row = {"B": b, "KB": kb, "M": m, "Np": np_}
        for sg in (0.0, sigma):
            kw = dict(adc_step=step, sigma=sg)
            kern = functools.partial(aimc_mvm.aimc_mvm_v2, x, w_q, s_w, s_x,
                                     NOISE_SEED, **kw)
            plain = functools.partial(ref.aimc_matmul_ref_v2, x, w_q, s_w,
                                      s_x, NOISE_SEED, **kw)
            y, want = kern(), plain()
            torch.cuda.synchronize()
            err, tol = _err(y, want)
            check(bool(torch.isfinite(y).all()) and err <= tol,
                  f"K2 [{b}x{kb}x{m}]x[{np_}] sigma {sg}: {err} > {tol}")
            row[f"max_abs_err_sigma{sg:g}"] = err
            if sg == 0.0:
                row["ms"] = time_ms(kern, flush, KERNEL_REPS)
                row["plain_ms"] = time_ms(plain, flush, 3)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    b, kb, m, np_, 1, peaks, bias=False)
        row["plan"] = aimc_mvm.launch_plan(dev, b, kb, m, np_)
        rows.append(row)
        print(f"[multicore] K2 B={b} KB={kb} M={m} Np={np_} "
              f"({plan_str(row['plan'])}): max|err| off "
              f"{row['max_abs_err_sigma0']:.3g}, counter "
              f"{row[f'max_abs_err_sigma{sigma:g}']:.3g}; kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    del flush
    return rows


def coupling_checks(configs, dev, peaks):
    """`tight_forward` (one K2 call) against `loose_forward` (staged eager
    ops, the exact MAC in f64) at MLP 1024 B 1 (1024-row tiles) and CNN-F
    conv1 B 8 (512-row tiles, its im2col rows): equal within 1e-5 *
    max(1, max|y|), both timed (CUDA events, L2 flushed), with the modelled
    global-memory bytes of each and their ratio."""
    import torch

    from repro_torch.core import coupling
    from repro_torch.core.schedule import cnn_schedule
    from repro_torch.kernels import aimc_mvm
    from repro_torch.models import paper_nets as pn
    flush = flush_buffer(dev)
    by = {c["name"]: c for c in configs}
    mlp = by["MLP 1024 B1 (bench_pipeline)"]
    cnn = by["CNN-F 224 B8"]
    cases = [("MLP 1024 fc1 B1", mlp["cfg"],
              pn.mlp_program(mlp["params"], mlp["cfg"])["fc1"], mlp["x"])]
    _cin, k, _cout, stride, pad, _lrn, _pool = pn.CNN_SPECS["F"][1]
    prog = pn.cnn_program(cnn["params"], "F", cnn["cfg"])
    sched = cnn_schedule(prog, pn.CNN_SPECS["F"])
    h = pn.cnn_pipeline_stages(cnn["params"], "F", cnn["cfg"], sched)[0](
        cnn["x"])
    patches, _, _ = pn._im2col(h, k, stride, pad)
    cases.append(("CNN-F conv1 B8", cnn["cfg"], prog["conv1"],
                  patches.reshape(-1, patches.shape[-1])))
    out = []
    for name, cfg, st, x in cases:
        tight = functools.partial(coupling.tight_forward, st, x, cfg)
        loose = functools.partial(coupling.loose_forward, st, x, cfg)
        y_t, y_l = tight(), loose()
        torch.cuda.synchronize()
        err, tol = _err(y_t, y_l)
        check(err <= tol, f"coupling {name}: tight vs loose {err} > {tol}")
        kb, m, np_ = st.w_q.shape
        b = x.shape[0]
        plan = aimc_mvm.launch_plan(dev, b, kb, m, np_)
        bt = coupling.hbm_bytes_tight(st, b, rows_per_block=plan[
            "rows_per_block"], split=plan["split"])
        bl = coupling.hbm_bytes_loose(st, b)
        row = {"case": name, "B": b, "KB": kb, "M": m, "Np": np_,
               "max_abs_err": err, "tight_ms": time_ms(tight, flush,
                                                       KERNEL_REPS),
               "loose_ms": time_ms(loose, flush, KERNEL_REPS),
               "tight_bytes": bt, "loose_bytes": bl,
               "loose_over_tight_bytes": bl / bt, "plan": plan}
        out.append(row)
        print(f"[coupling] {name} [{b}x{kb * m}]x[{np_}]: tight == loose "
              f"(max|err| {err:.3g}, tol {tol:.3g}); tight {row['tight_ms']:.4f}"
              f" ms, loose {row['loose_ms']:.4f} ms; modelled bytes tight "
              f"{bt} ({plan_str(plan)}), loose {bl}, loose/tight "
              f"{bl / bt:.3f}", flush=True)
    del flush
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no repro_torch package under {src}: run from a checkout")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import aimc_mvm

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    print(f"[chip_smoke] {smi}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; peaks {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.0f} int8 TOP/s", flush=True)

    seconds = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        print(f"[phase] {name}: {seconds[name]:.1f} s", flush=True)
        return out

    def build_phase():
        lib = aimc_mvm.build()
        print(f"[build] {lib.name}\n"
              f"{aimc_mvm.BUILD_LOG.get('report', '(cached build)')}",
              flush=True)
        return build_report(lib, aimc_mvm.BUILD_LOG.get("report", ""))

    def free():
        gc.collect()              # the engine holds a reference cycle
        torch.cuda.empty_cache()

    build = phase("build", build_phase)
    rows, worst = phase("kernels", kernel_phase, dev, peaks, SLOTS, PROMPT)
    free()
    v1_rows, v1_worst = phase("v1/hw kernels", v1_hw_kernel_phase, dev, peaks)
    hw_draws = phase("hw draws", hw_draw_phase, dev)
    free()
    small_err = phase("small model", small_model_phase, dev)
    run, serve_stats = phase("serve", serve_phase, dev)
    stacked = phase("stacked", stacked_phase, run)
    del run                       # free granite's weights before the next
    free()
    init = phase("init", init_phase, dev, serve_stats["init_s"])
    fused = phase("fused serve", fused_serve_phase, dev)
    free()
    staged = phase("staged", staged_v1_phase, dev)
    paper, hw_launches = phase("paper nets", paper_nets_phase, dev)
    free()
    multicore = phase("multi-core", multicore_phase, dev, peaks)

    def decode_layer(kname, projs):
        sel = [r for r in rows if r["kernel"] == kname and r["B"] == SLOTS
               and r["sigma"] == 0.0]
        by = {r["proj"]: r for r in sel}
        tot = {key: sum(by[p][key] * c for p, c in projs.items())
               for key in ("ms", "plain_ms", "bound_ms")}
        tot["bound_by"] = by[next(iter(projs))]["bound_by"]
        return tot

    # per granite layer, one decode step at the slot count: K2 runs wq, wo
    # (4096x4096), wk, wv (4096x1024), w_gate, w_up (4096x14336) and w_down;
    # the fused path replaces w_gate + w_up by one K3 launch
    k2 = decode_layer("aimc_mvm_v2",
                      {"wq": 2, "wk": 2, "w_gate": 2, "w_down": 1})
    k3 = decode_layer("aimc_mvm_stacked", {"w_gu": 1})

    def mlp_forward(kname):
        # one MLP forward at its published width: two [16x1024]x[1024x1024]
        row = next(r for r in v1_rows
                   if r["kernel"] == kname and r["shape"] == "mlp fc")
        return {key: 2 * row[key] for key in ("ms", "plain_ms", "bound_ms")
                } | {"bound_by": row["bound_by"]}

    k1, k4 = mlp_forward("aimc_mvm_v1"), mlp_forward("aimc_mvm_v2 hw")
    src_rel = "src/repro_torch/kernels/csrc/aimc_mvm.cu"
    record = {"kernels": [
        {"name": "aimc_mvm_v2", "route": "cuda", "source": src_rel,
         "replaces": "src/repro/kernels/aimc_mvm.py:228",
         "launches": serve_stats["launches"]["aimc_mvm_v2"],
         "max_abs_err": worst["aimc_mvm_v2"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
        {"name": "aimc_mvm_stacked", "route": "cuda", "source": src_rel,
         "replaces": "src/repro/kernels/aimc_mvm.py:349",
         "launches": fused["launches"]["aimc_mvm_stacked"],
         "max_abs_err": worst["aimc_mvm_stacked"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
        {"name": "aimc_mvm_v1", "route": "cuda", "source": src_rel,
         "replaces": "src/repro/kernels/aimc_mvm.py:118",
         "launches": staged["launches"]["aimc_mvm_v1"],
         "max_abs_err": v1_worst["aimc_mvm_v1"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "aimc_mvm_hw", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/philox.cuh",
         "replaces": "src/repro/kernels/aimc_mvm.py:160",
         "launches": hw_launches, "max_abs_err": v1_worst["aimc_mvm_hw"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": None}]}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "torch": torch.__version__, "kernels": record,
        "build": build,
        "kernel_rows": rows, "v1_hw_kernel_rows": v1_rows,
        "hw_draws": hw_draws, "small_model_max_err": small_err,
        "serve": serve_stats, "stacked": stacked, "fused_serve": fused,
        "staged_v1": staged, "paper_nets": paper, "init": init,
        "multicore": multicore, "phase_seconds": seconds},
        indent=1))
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
