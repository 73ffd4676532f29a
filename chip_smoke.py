#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: serve granite-8b, the rest of the
dense zoo (glm4-9b, llama3.2-3b, qwen1.5-110b, internvl2-1b), the
recurrent zoo (xlstm-350m, recurrentgemma-9b) and the MoE zoo
(olmoe-1b-7b, arctic-480b) at their published widths on programmed AIMC
crossbars, dense, paged and through recurrent snapshot pages, granite-8b
also under chaos and drift with hot recalibration, int8-native and under
a cost-model placement that rotates layer groups through a tile budget,
granite-8b and xlstm-350m together on one tile pool behind the
multi-tenant server, and
run the paper's MLP, LSTM and CNN-F/M/S at theirs with read noise on,
single-core and in the paper's multi-core mappings, through the
hand-written Hopper kernels K1-K4 and K2's expert entry.

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
     static — on the same codes with the DAC scale fixed at 0.05, the
     engine equals `static_generate` bit for bit on a synchronized trace
     (the transformer path's batch invariance).
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

 11. fidelity — bench_accuracy's own settings (key 7, NOISY, MLP 1024 B 16,
     LSTM n_h 256, CNN-F 64 px B 8) on the card and on the CPU (plain):
     SNRs within 0.05 dB, equal top-1 and flip-margin verdicts, the
     benchmark's own checks (SNR >= 20 dB, LSTM top-1 >= 80%, CNN flips
     inside the margin), printed beside BENCH_all.json's figures; then
     CNN-M 224 px B 8 under counter and "hw" noise over 5 noise draws, the
     flip-margin verdict per draw (recorded, not gated).
 12. zoo — `serve.main` on internvl2-1b (prompt 256 patch positions + 16),
     llama3.2-3b, glm4-9b and qwen1.5-110b (published widths, 4 of 80
     layers: its int8 codes exceed one card; random nonzero QKV biases),
     --exec aimc, 4 Poisson requests. Launch counts zeroed just before and
     read just after: K2 = 7 x layers x passes, no K3; ledgers reconcile,
     tokens in the vocabulary, finite logits of the vocabulary's width.
     K2 at each arch's projection shapes (B 4, with its bias) held to its
     plain version and timed against its bytes bound; one decode step
     timed and profiled.
 13. paged (after llama3.2-3b's zoo serve, on its installed weights) — the
     dense and the paged engine (page size 16) on one synchronized trace:
     tokens bit-equal, K2 = 7 x layers x passes, page ledger exact, no new
     shapes after warmup; decode ms/step of both in turns and the page
     gather's device time; then 8 requests sharing a 32-token prefix with
     a fixed DAC scale on the prefix cache with 16-token legs, each
     admission drained: tokens equal the dense engine's, the shared span
     prefilled and billed once.
 14. recurrent — first the xlstm-350m and recurrentgemma-9b smoke configs
     held to the CPU as in phase 3; then at the published widths, uncut,
     seed 0, noise off, 4 Poisson requests at 20 req/s (prompt <= 16, gen
     <= 8, 4 slots) through `serve.main`, launch counts zeroed just before
     and read just after: xlstm K2 = 132 x passes (11 per pair; a
     recurrent prefill is one pass per prompt position), recurrentgemma
     K2 = 292 x passes (8 per RG-LRU block, 7 per local-attention block);
     ledgers reconcile, tokens in vocab, finite logits. xlstm with
     --fuse-gates on synchronized arrivals: K3 = 36 x passes (w_ug G=2,
     w_qkv G=3, w_ff_gu G=2), K2 = 48 x passes, tokens bit-equal to the
     unfused engine on the same codes. With the DAC scale fixed at 0.05:
     the xlstm engine equals `static_generate` bit for bit on a
     synchronized trace, and 8 requests sharing a 12-token prefix (+4 own)
     through snapshot pages of 4 with 8-token legs, each admission
     drained, equal the dense engine's tokens, restore the reference
     rule's 8 prompt tokens per follower, with an exact page ledger and no
     new shapes after warmup. K2/K3 at every projection shape of both
     models (layer 0's codes, B 4; rglru's w_a with a random bias in the
     epilogue) held to the plain version and timed as in phase 2; a decode
     step and a prefill of each timed and profiled; init seconds and peak
     memory recorded.
 15. moe — olmoe-1b-7b uncut (16 layers, d_model 2048, 64 experts top-8,
     d_ff 1024, vocab 50304) and arctic-480b at its published widths with
     the depth cut to 1 of 35 layers (d_model 7168, 56/8 heads, 128
     experts top-2, d_ff 4864 + a 4864 dense residual, vocab 32000; one
     layer is 56.3 GB of f32 weights + 13.8 GB of codes, two do not fit a
     card), seed 0, noise off, 4 Poisson requests at 20 req/s (prompt <=
     16, gen <= 8, 4 slots) through `serve.main`, launch counts zeroed just
     before and read just after: per layer and pass olmoe 4 K2 + 3 expert
     launches (`aimc_mvm_experts`, one per expert projection over the
     whole [E] stack), arctic 7 K2 + 3 expert; ledgers reconcile, tokens in
     vocab, finite logits. Layer 0's router and sort dispatch on the card
     and on the CPU from the identical hidden state: gate_idx and slot_o
     equal (rows at a router tie, gap < 1e-6, reported). olmoe with
     --fuse-gates (wqkv G=3 on K3) on synchronized arrivals: tokens equal
     the unfused engine's, 1 K3 + 1 K2 + 3 expert per layer and pass. The
     expert entry at every expert shape the path ran (decode and prefill
     capacity, layer 0's codes, one expert empty): bit-equal to E K2
     launches and within 1e-5 x max(1, max|y|) of its plain version, timed
     against its bytes bound; decode step, prefill and a profiled step
     timed; init seconds and peak memory recorded.

 16. resilience — granite-8b at its published widths, --cores 2, the DAC
     scale fixed at 0.1, noise off, unfused, on `make serve-chaos`'s
     traffic (6 Poisson requests at 300 req/s, prompt <= 8, gen <= 6, 3
     slots, decode chunk 2) through `serve.main`, launch counts zeroed
     just before and read just after each leg: (a) unfaulted; (b) --chaos
     "corrupt:0@1:0.5,kill:1@3": both events fire, recal reasons fault
     then dead_core, core 1 drained, every request finished, tokens
     bit-equal to (a), CM_* and recal books exact, K2 = 7 x 36 x passes
     and expert launches = 7 x (probes + 1) (a probe of a [36] stack is
     one expert-entry launch), every repaired state (rebuilt after the
     serve, equal to the live program's) probes exactly 0.0 and so does
     the next probe, the remap leaves every matrix one whole shard (no sum
     re-associated) and a moved layer's K2 output bit-equal; one probe
     timed, and its seven expert launches held within 1e-5 of their plain
     version and timed against their bound; (c) --drift 0.3
     --drift-t0 0.01, gen <= 4: every probe reads 1 - (age/t0)^-nu within
     1e-5, past the threshold, drift recals fire and each repaired state
     probes 0.0. Recal wall per event, health wall share, decode ms/step
     of (a) and (b) and peak memory are printed.
 17. int8 — granite-8b served digital in bf16 and with --int8: a [1 x 16]
     prompt's prefill logits at all 16 positions within the reference's
     bar (cosine > 0.99, top-1 agreement > 0.9), the int8 tree < 0.45 of
     the f32 bytes and <= 0.55 of bf16's, no kernel launched; decode
     ms/step and peak memory of both; then --int8 --exec aimc: the
     crossbars programmed from the codes, K2 = 7 x 36 x passes.
 18. placement — granite-8b at its published widths, 512x512 tiles,
     --cores 1, DAC scale fixed at 0.1, noise off, through `serve.main
     --placement auto:16128 --swap-every 1` (4 synchronized requests,
     prompt 16, gen 8, 4 slots, decode chunk 1): the plan is the reference
     algorithm's (w_gate hot; w_up | w_down | wo, wq, wk, wv), each prefill
     and decode call (warmup included) launches 36 x the stacks resident in
     the state in force (72, 72, 180 per pass), counts zeroed just before
     and read just after; at least one swap, the swap books close per event
     and in total, every state packs within the budget, no request lost;
     each state's analog leaves (layer 0, [4 x K], scale 0.1) within 1e-5 x
     max(1, max|y|) of their plain version; per state, a rotation engine
     that never swaps equals a plain engine on `install_subset(state)` bit
     for bit. The share of tokens equal to the all-digital
     `static_generate` is printed, not gated; decode and prefill per state,
     profiled, and peak memory are recorded.
 19. server — `serve.main --models granite-8b:aimc,xlstm-350m:aimc
     --tenants premium:granite-8b:2,standard:granite-8b:1:sjf,
     batch:xlstm-350m` (ci.sh's server traffic: 8 requests, prompt 8, gen
     4, 2 slots, poisson:200), both at published widths on ONE TilePool,
     DAC scale 0.1: K2 = 252 x granite passes + 132 x xlstm passes (counts
     zeroed just before, read just after), ledgers reconcile, no tenant
     starved, every request's tokens equal its model's `static_generate`
     on its prompt alone, the pool's tiles are the two programs' with
     labels granite-8b/… and xlstm-350m/… and no cell claimed twice; then
     `build_server` at one tile below the pair's pack raises CapacityError
     while programming. Per-tenant tok/s, TTFT/TPOT p50/p99, Jain's index
     and peak memory are printed.

The last two lines are the card's nvidia-smi name/power limit and the
contract line {"ok": true, "device": {...}}; the line before them is the
per-kernel JSON record (K2/K3 timed per granite layer at decode, K1/K4 per
MLP forward, the expert entry per olmoe-1b-7b layer at decode). Each phase's seconds are printed as it ends. Details go to
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


def small_model_phase(dev, arch=ARCH):
    """The smoke config served on the card (kernels); its prefill logits
    held against the same programmed weights on the CPU (plain versions)."""
    import torch

    from repro_torch.launch import serve

    card = serve.main(["--arch", arch, "--smoke", "--exec", "aimc",
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
    check(worst <= 1e-4, f"{arch} smoke prefill logits card vs CPU: {worst}")
    print(f"[small] {arch}: card (kernels) vs CPU (plain) prefill logits "
          f"max|err| {worst:.3g} <= 1e-4", flush=True)
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


def static_gate_phase(run, card):
    """granite-8b at full width, on the serve phase's installed codes, with
    the DAC scale fixed at PREFIX_SCALE: the engine (one [1 x 16] prefill
    per request, then decode steps over 4 slots) emits `static_generate`'s
    tokens (one [4 x 16] prefill, lockstep decode) bit for bit on a
    synchronized trace. A dynamic DAC scale depends on the batch by
    design; with it fixed, only a batch-dependent reduction order in the
    transformer's own ops could move a token."""
    import torch

    from repro_torch.runtime.batcher import synchronized_trace
    from repro_torch.runtime.engine import ServeEngine, static_generate

    eng = run.engine
    model, cfg = eng.model, eng.cfg
    exe_f = dataclasses.replace(eng.exe, aimc=dataclasses.replace(
        eng.exe.aimc, input_scale=PREFIX_SCALE))
    reqs = synchronized_trace(N_REQ, prompt_len=PROMPT, max_new=GEN,
                              seed=SEED + 1, vocab=cfg.vocab)
    e = ServeEngine(model, cfg, exe_f, eng.params, n_slots=N_REQ,
                    prompt_pad=PROMPT, max_seq=PROMPT + GEN,
                    program=eng.program)
    rep = e.serve(list(reqs))
    prompts = torch.tensor([r.prompt for r in reqs], dtype=torch.int32,
                           device=eng.device)
    toks, (t_pre, t_dec) = static_generate(model, cfg, exe_f, eng.params,
                                           prompts, GEN,
                                           max_seq=PROMPT + GEN)
    got = {r.rid: rep.tokens(r.rid) for r in reqs}
    want = {r.rid: toks[r.rid].tolist() for r in reqs}
    check(got == want, f"granite-8b engine != static_generate at a fixed "
          f"DAC scale: engine {got}, static {want}")
    print(f"[static] granite-8b engine == static_generate bit for bit (DAC "
          f"scale fixed at {PREFIX_SCALE}, {len(reqs)} synchronized "
          f"requests, {rep.generated_tokens} tokens); static prefill "
          f"{t_pre:.2f} s, {GEN - 1} decode steps {t_dec:.2f} s (host "
          f"clock, on {card})", flush=True)
    return {"tokens": rep.generated_tokens, "prefill_s": t_pre,
            "decode_s": t_dec}


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


# the dense zoo at published widths: (arch, prompt pad, layers served; 0 =
# all). internvl2's prompts start with its 256 patch positions; qwen1.5-
# 110b's int8 codes alone (80 layers x 1.36e9 + embeddings) exceed one card,
# so it serves 4 of its 80 layers.
ZOO = (("internvl2-1b", 256 + PROMPT, 0), ("llama3.2-3b", PROMPT, 0),
       ("glm4-9b", PROMPT, 0), ("qwen1.5-110b", PROMPT, 4))
PAGE_SIZE, PREFIX_LEN, PREFIX_TAIL, PREFIX_REQ, LEG = 16, 32, 8, 8, 16
PREFIX_SCALE = 0.05      # the prefix phase's fixed DAC scale (input_scale)
BIAS_STD = 0.02          # qwen's random nonzero QKV biases
# bench_accuracy's MLP / LSTM / CNN-F configuration (benchmarks/
# bench_accuracy.py), and CNN-M's noise draws for the "hw" flip question
BENCH_LSTM_NH, BENCH_IMG, FLIP_SEEDS = 256, 64, 5


@contextlib.contextmanager
def nonzero_qkv_bias(model, seed: int):
    """Make ``model.init`` return random nonzero QKV biases (N(0, BIAS_STD^2)
    from ``seed``) where it returns zeros, so a served qwen exercises K2's
    bias epilogue (install leaves biases as they are)."""
    import torch
    orig = model.init

    def init(*args, **kw):
        params = orig(*args, **kw)
        gen = None
        for name in ("bq", "bk", "bv"):
            b = params["blocks"].get(name)
            if b is not None:
                if gen is None:
                    gen = torch.Generator(device=b.device).manual_seed(seed)
                b.normal_(0.0, BIAS_STD, generator=gen)
        return params

    model.init = init
    try:
        yield
    finally:
        model.init = orig


def zoo_k2_rows(arch, eng, peaks, flush, gen, card):
    """K2 at each distinct projection shape of one served arch (layer 0's
    programmed codes, decode slot count, noise off), with the layer's bias
    where it has one: held to the plain version and timed against its
    bytes bound."""
    import torch

    from repro_torch.core.quant import sym_scale
    from repro_torch.kernels import aimc_mvm, ref

    blocks = eng.params["blocks"]
    step = eng.exe.aimc.adc_step
    rows, seen = [], set()
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        st = blocks[name]
        kb, m, np_ = st.w_q.shape[-3:]
        bname = {"wq": "bq", "wk": "bk", "wv": "bv"}.get(name)
        bias = blocks.get(bname) if bname else None
        if (st.k, st.n, bias is not None) in seen:
            continue
        seen.add((st.k, st.n, bias is not None))
        if bias is not None:
            bias = torch.nn.functional.pad(bias[0].float(), (0, np_ - st.n))
        x = torch.zeros((SLOTS, kb * m), device=eng.device)
        x[:, :st.k] = torch.randn((SLOTS, st.k), generator=gen,
                                  device=eng.device)
        s_x = sym_scale(x).reshape(1, 1)
        w_q, s_w = st.w_q[0], st.s_w[0]
        kern = functools.partial(aimc_mvm.aimc_mvm_v2, x, w_q, s_w, s_x,
                                 None, bias, adc_step=step)
        plain = functools.partial(ref.aimc_matmul_ref_v2, x, w_q, s_w, s_x,
                                  None, bias, adc_step=step)
        y, want = kern(), plain()
        torch.cuda.synchronize()
        err = float((y - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        check(err <= tol, f"{arch} K2 {name}: max |err| {err} > {tol}")
        row = {"arch": arch, "proj": name, "K": st.k, "N": st.n, "B": SLOTS,
               "KB": kb, "Np": np_, "bias": bias is not None,
               "max_abs_err": err, "tol": tol,
               "plan": aimc_mvm.launch_plan(eng.device, SLOTS, kb, m, np_),
               "ms": time_ms(kern, flush, KERNEL_REPS),
               "plain_ms": time_ms(plain, flush, 3),
               "codes_mb": w_q.numel() / 1e6}
        row["bound_ms"], row["bound_by"] = bound_ms(
            SLOTS, kb, m, np_, 1, peaks, bias=bias is not None)
        rows.append(row)
        print(f"[zoo] {arch} K2 {name} [{SLOTS}x{st.k}]x[{st.k}x{st.n}] "
              f"KB {kb}{' + bias' if row['bias'] else ''} "
              f"({plan_str(row['plan'])}; {row['codes_mb']:.0f} MB codes): "
              f"max|err| {err:.3g}; kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}) on {card}", flush=True)
        del x, y, want
    return rows


def zoo_serve(dev, peaks, arch, prompt, layers, card):
    """One arch of the dense zoo through the CLI entry point at its
    published widths, --exec aimc, 4 Poisson requests: launch counts
    zeroed just before and read just after (K2 = 7 x layers x passes, no
    K3), ledgers reconcile, tokens in the vocabulary, finite logits of the
    vocabulary's width; then its K2 shapes and a decode step timed."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import aimc_mvm
    from repro_torch.launch import serve
    from repro_torch.runtime.batcher import reconcile

    spec = get_arch(arch)
    pub = spec.model_cfg
    args = ["--arch", arch, "--exec", "aimc", "--requests", str(N_REQ),
            "--prompt-len", str(prompt), "--gen", str(GEN), "--slots",
            str(SLOTS), "--trace", f"poisson:{RATE:g}", "--seed", str(SEED),
            "--device", str(dev)] + (["--layers", str(layers)] if layers
                                     else [])
    print(f"[zoo] python -m repro_torch.launch.serve {' '.join(args)}"
          + (f"  (depth cut: {layers} of {pub.n_layers} layers at the "
             f"published widths; all {pub.n_layers} would need "
             f"~{pub.n_layers * _layer_codes_gb(pub):.0f} GB of int8 codes)"
             if layers else ""), flush=True)
    bias = (nonzero_qkv_bias(spec.model_module(), SEED) if pub.qkv_bias
            else contextlib.nullcontext())
    torch.cuda.reset_peak_memory_stats(dev)
    with bias:
        aimc_mvm.reset_counts()
        t0 = time.perf_counter()
        run = serve.main(args)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = dict(aimc_mvm.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    eng, rep, prog = run.engine, run.report, run.program
    cfg, n_layers, passes = eng.cfg, eng.cfg.n_layers, eng.forward_passes
    check(dataclasses.replace(cfg, n_layers=pub.n_layers) == pub
          and n_layers == (layers or pub.n_layers),
          f"{arch}: not the published widths: {cfg}")
    check(counts["aimc_mvm_v2"] == 7 * n_layers * passes
          and counts["aimc_mvm_stacked"] == 0,
          f"{arch}: launches {counts} != 7 x {n_layers} x {passes} K2")
    led, static = reconcile(prog, rep.records, rep.observed_vectors)
    check(led == static, f"{arch}: CM_* ledgers do not reconcile")
    check(len(rep.records) == N_REQ, f"{arch}: requests lost")
    for rec in rep.records.values():
        check(1 <= len(rec.tokens) <= rec.request.max_new
              and all(0 <= t < cfg.vocab for t in rec.tokens),
              f"{arch}: bad tokens for request {rec.request.rid}")
    if spec.family == "vlm":
        check(min(len(r.prompt) for r in run.requests) >= cfg.n_patches,
              f"{arch}: a prompt shorter than its patch prefix")
    if pub.qkv_bias:
        check(all(float(eng.params["blocks"][b].abs().min()) > 0
                  for b in ("bq", "bk", "bv")), f"{arch}: zero QKV bias")
    tokens, vl = eng._pad_prompt(run.requests[0].prompt)
    pe = (torch.zeros((1, cfg.n_patches, cfg.d_model), device=dev)
          if spec.family == "vlm" else None)
    logits, _ = eng.model.prefill(eng.params, tokens, cfg, eng.exe,
                                  max_seq=eng.max_seq, valid_len=vl,
                                  patch_embeds=pe)
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (1, 1, cfg.vocab),
          f"{arch}: bad logits {tuple(logits.shape)}")
    print(f"[zoo] {arch}: {n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}{', QKV bias (random, nonzero)' if pub.qkv_bias else ''}"
          f"{', tied embeddings' if pub.tie_embeddings else ''}"
          f"{f', {cfg.n_patches} patch positions' if cfg.n_patches else ''}"
          f"; {wall:.1f}s wall (init {run.init_s:.2f}s) on {card}, {passes} "
          f"passes, launches {counts}, peak {peak_gb:.2f} GB; ledgers "
          f"reconcile, tokens in vocab, logits finite", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = flush_buffer(dev)
    k2 = zoo_k2_rows(arch, eng, peaks, flush, gen, card)
    del flush
    print(f"[zoo] {arch} decode step and prefill on {card}:", flush=True)
    times = step_times(eng, run.requests[0].prompt)
    return run, {"wall_s": wall, "init_s": run.init_s, "layers": n_layers,
                 "published_layers": pub.n_layers, "forward_passes": passes,
                 "launches": counts, "peak_gb": peak_gb, "k2_rows": k2,
                 **times, "report": rep.summary(),
                 "program": prog.summary()}


def _layer_codes_gb(cfg) -> float:
    """int8 code bytes of one layer's seven projections (512-row blocks,
    128-lane columns), in GB."""
    def codes(k, n):
        return (-(-k // 512) * 512) * (-(-n // 128) * 128)
    d, hd = cfg.d_model, cfg.hd
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return (codes(d, q) + 2 * codes(d, kv) + codes(q, d)
            + 2 * codes(d, cfg.d_ff) + codes(cfg.d_ff, d)) / 1e9


def session_decode_ms(eng, reqs, steps: int = 5) -> float:
    """Host-clock ms of one synchronous decode step with every request of
    ``reqs`` admitted (`admit` then `step`, each step ending in the
    chunk's readback), after one warm step; the session then drains."""
    import torch
    sess = eng.begin()
    now = 0.0
    for r in reqs:
        now = eng.admit(sess, r, now)
    now = eng.step(sess, now)
    torch.cuda.synchronize(eng.device)
    t = time.perf_counter()
    for _ in range(steps):
        now = eng.step(sess, now)
    ms = (time.perf_counter() - t) / steps * 1e3
    while sess.slots.n_busy:
        now = eng.step(sess, now)
    eng.finish(sess, now)
    return ms


def paged_phase(dev, run, peaks, card):
    """llama3.2-3b at full width on the paged engine, on the zoo run's
    installed parameters: (1) the dense and the paged engine (page_size 16)
    on one synchronized trace, tokens bit-equal, K2 = 7 x layers x passes;
    decode ms/step of both in turns and the device time of the page gather;
    (2) 8 requests sharing a 32-token prefix, with a fixed DAC scale, on
    the prefix-cache engine with 16-token prefill legs, each admission
    drained before the next: tokens equal the dense engine's, the shared
    span is prefilled and billed once, the page ledger is exact and no
    closure saw a new shape after warmup."""
    import random

    import torch

    from repro_torch.kernels import aimc_mvm
    from repro_torch.runtime.batcher import (Request, reconcile,
                                             synchronized_trace)
    from repro_torch.runtime.engine import ServeEngine

    eng, prog = run.engine, run.program
    model, cfg, n_layers = eng.model, eng.cfg, eng.cfg.n_layers

    def build(exe, **kw):
        e = ServeEngine(model, cfg, exe, eng.params, program=prog,
                        family=eng.family, module=eng.module, **kw)
        return e, e.warmup()

    def served(e, fn):
        aimc_mvm.reset_counts()
        p0 = e.forward_passes
        rep = fn()
        torch.cuda.synchronize(dev)
        counts, passes = dict(aimc_mvm.LAUNCHES), e.forward_passes - p0
        check(counts["aimc_mvm_v2"] == 7 * n_layers * passes,
              f"paged: K2 launches {counts} != 7 x {n_layers} x {passes}")
        led, static = reconcile(prog, rep.records, rep.observed_vectors)
        check(led == static and rep.observed_vectors == rep.useful_vectors,
              "paged: CM_* or vector books do not close")
        return rep, counts, passes

    kw = dict(n_slots=SLOTS, prompt_pad=PROMPT, max_seq=PROMPT + GEN)
    reqs = synchronized_trace(N_REQ, prompt_len=PROMPT, max_new=GEN,
                              seed=SEED + 1, vocab=cfg.vocab)
    dense, _ = build(eng.exe, **kw)
    paged, counts0 = build(eng.exe, page_size=PAGE_SIZE, **kw)
    rd, _, _ = served(dense, lambda: dense.serve(list(reqs)))
    rp, cp, pp = served(paged, lambda: paged.serve(list(reqs)))
    for r in reqs:
        check(rp.tokens(r.rid) == rd.tokens(r.rid),
              f"paged decode differs from dense for request {r.rid}")
    check(rp.page_ledger_exact and rp.page_ledger["held"] == 0
          and paged.compile_counts() == counts0,
          f"paged: ledger {rp.page_ledger}, shapes {paged.compile_counts()}")
    print(f"[paged] page_size {PAGE_SIZE}: {len(reqs)} requests bit-equal "
          f"to the dense engine ({rp.generated_tokens} tokens); {pp} passes, "
          f"launches {cp}; page ledger exact, all pages freed, shapes "
          f"{counts0} unchanged", flush=True)
    times = {"dense": [session_decode_ms(dense, reqs)],
             "paged": [session_decode_ms(paged, reqs)]}
    times["paged"].append(session_decode_ms(paged, reqs))
    times["dense"].append(session_decode_ms(dense, reqs))
    sess = paged.begin()
    now = 0.0
    for r in reqs:
        now = paged.admit(sess, r, now)
    prof = device_profile(lambda: paged.step(sess, now), dev)
    kp, vp, pt = sess.cache["kp"], sess.cache["vp"], sess.cache["pt"]
    flush = flush_buffer(dev)
    gather_ms = time_ms(lambda: model.paged_view(kp, vp, pt, paged.max_seq),
                        flush, KERNEL_REPS)
    del flush
    view = SLOTS * paged.max_seq * cfg.n_kv_heads * cfg.hd * 4 * n_layers
    gather_bound = 2 * 2 * view / peaks[0] * 1e3   # k and v, read + write
    while sess.slots.n_busy:
        now = paged.step(sess, now)
    paged.finish(sess, now)
    print(f"[paged] decode ms/step (host clock, {SLOTS} busy slots, in "
          f"turns dense/paged/paged/dense): dense "
          f"{', '.join(f'{t:.2f}' for t in times['dense'])}; paged "
          f"{', '.join(f'{t:.2f}' for t in times['paged'])}; page gather "
          f"(paged_view, [{n_layers}, {SLOTS}, {paged.max_seq}, "
          f"{cfg.n_kv_heads}, {cfg.hd}] f32 x 2) {gather_ms:.4f} ms device "
          f"per step vs {gather_bound:.4f} ms bytes bound; on {card}",
          flush=True)
    print_profile("paged", prof)

    rng = random.Random(SEED)
    shared = tuple(rng.randint(1, cfg.vocab - 1) for _ in range(PREFIX_LEN))
    reqs2 = [Request(rid=i, prompt=shared + tuple(
        rng.randint(1, cfg.vocab - 1) for _ in range(PREFIX_TAIL)),
        max_new=GEN) for i in range(PREFIX_REQ)]
    plen = PREFIX_LEN + PREFIX_TAIL
    exe2 = dataclasses.replace(eng.exe, aimc=dataclasses.replace(
        eng.exe.aimc, input_scale=PREFIX_SCALE))
    kw2 = dict(n_slots=PREFIX_REQ, prompt_pad=plen + PREFIX_TAIL,
               max_seq=plen + PREFIX_TAIL + GEN)
    dense2, _ = build(exe2, **kw2)
    legged, counts2 = build(exe2, page_size=PAGE_SIZE, prefix_cache=True,
                            prefill_chunk=LEG, **kw2)
    rd2, _, _ = served(dense2, lambda: dense2.serve(list(reqs2)))

    def drained():
        sess = legged.begin()
        now = 0.0
        for r in reqs2:
            now = legged.admit(sess, r, now, drain=True)
        while sess.slots.n_busy:
            now = legged.step(sess, now)
        return legged.finish(sess, now)

    rl, cl, pl = served(legged, drained)
    for r in reqs2:
        check(rl.tokens(r.rid) == rd2.tokens(r.rid),
              f"prefix-cache tokens differ from dense for request {r.rid}")
    paid = [rl.records[r.rid].prefill_vectors for r in reqs2]
    check(paid == [plen] + [plen - PREFIX_LEN] * (PREFIX_REQ - 1)
          and rl.prefix_hits == PREFIX_REQ - 1
          and rl.prefix_hit_vectors == (PREFIX_REQ - 1) * PREFIX_LEN,
          f"shared span not billed exactly once: prefill vectors {paid}, "
          f"hits {rl.prefix_hits} ({rl.prefix_hit_vectors} vectors)")
    check(rl.page_ledger_exact
          and rl.page_ledger["held"] == len(legged.prefix)
          and legged.compile_counts() == counts2,
          f"prefix: ledger {rl.page_ledger}, shapes "
          f"{legged.compile_counts()} vs {counts2}")
    leg_ms = rl.wall_prefill_s / rl.prefill_chunks * 1e3
    print(f"[paged] prefix cache + {LEG}-token legs, DAC scale fixed at "
          f"{PREFIX_SCALE}: {PREFIX_REQ} requests sharing {PREFIX_LEN} "
          f"tokens equal the dense engine's tokens; prefill vectors {paid} "
          f"(shared span billed once), {rl.prefix_hits} hits, "
          f"{rl.prefill_chunks} legs at {leg_ms:.2f} ms per leg (host "
          f"clock, synchronised, on {card}); {pl} passes, launches {cl}; "
          f"page ledger "
          f"exact, {rl.page_ledger['held']} pages held by the cache; shapes "
          f"{counts2} unchanged", flush=True)
    return {"launches": cp, "passes": pp, "decode_ms_per_step": times,
            "gather_ms": gather_ms, "gather_bound_ms": gather_bound,
            "profile": prof, "prefix_launches": cl, "prefix_passes": pl,
            "prefill_vectors": paid, "prefix_hits": rl.prefix_hits,
            "legs": rl.prefill_chunks, "ms_per_leg": leg_ms,
            "page_ledger": rl.page_ledger}


# the recurrent zoo (phase 14), at the published widths, uncut
RECURRENT = ("xlstm-350m", "recurrentgemma-9b")
SNAP_PAGE, SNAP_PREFIX, SNAP_TAIL, SNAP_REQ, SNAP_LEG = 4, 12, 4, 8, 8


def recurrent_launches(cfg, module: str, fused: bool = False):
    """(K2, K3) launches per forward pass: xlstm runs 7 projections per
    mLSTM block and 4 per sLSTM block (fused: w_ug, w_qkv and w_ff_gu on
    K3, the other 4 on K2); rglru 8 per recurrent block and 7 per local
    attention block."""
    if module == "xlstm":
        n = cfg.n_pairs
        return (4 * n, 3 * n) if fused else (11 * n, 0)
    return (8 * (2 * cfg.n_units + cfg.n_tail) + 7 * cfg.n_units, 0)


def recurrent_serve(dev, arch, extra, card):
    """``serve.main`` on a recurrent arch at its published widths, 4
    requests, prompt 16, gen 8, 4 slots: launch counts zeroed just before
    and read just after (exact per-pass K2/K3), ledgers reconcile, vector
    books close, tokens in the vocabulary, finite logits of its width."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import aimc_mvm
    from repro_torch.launch import serve
    from repro_torch.runtime.batcher import reconcile

    spec = get_arch(arch)
    args = ["--arch", arch, "--exec", "aimc", "--requests", str(N_REQ),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--slots",
            str(SLOTS), "--seed", str(SEED), "--device", str(dev), *extra]
    print(f"[recurrent] python -m repro_torch.launch.serve {' '.join(args)}",
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
    cfg, passes = eng.cfg, eng.forward_passes
    check(cfg == spec.model_cfg, f"{arch}: not the published config: {cfg}")
    k2, k3 = recurrent_launches(cfg, spec.module, "--fuse-gates" in extra)
    check(counts["aimc_mvm_v2"] == k2 * passes
          and counts["aimc_mvm_stacked"] == k3 * passes,
          f"{arch}: launches {counts} != ({k2} K2, {k3} K3) x {passes}")
    led, static = reconcile(prog, rep.records, rep.observed_vectors)
    check(led == static and rep.observed_vectors == rep.useful_vectors,
          f"{arch}: CM_* or vector books do not close")
    check(len(rep.records) == N_REQ, f"{arch}: requests lost")
    for rec in rep.records.values():
        check(1 <= len(rec.tokens) <= rec.request.max_new
              and all(0 <= t < cfg.vocab for t in rec.tokens),
              f"{arch}: bad tokens for request {rec.request.rid}")
    tokens, vl = eng._pad_prompt(run.requests[0].prompt)
    logits, _ = eng.model.prefill(eng.params, tokens, cfg, eng.exe,
                                  max_seq=eng.max_seq, valid_len=vl)
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (1, 1, cfg.vocab),
          f"{arch}: bad logits {tuple(logits.shape)}")
    print(f"[recurrent] {arch}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}; {wall:.1f}s wall (init "
          f"{run.init_s:.2f}s) on {card}, {passes} passes, launches "
          f"{counts} = ({k2} K2, {k3} K3) per pass, peak {peak_gb:.2f} GB; "
          f"ledgers reconcile, tokens in vocab, logits finite", flush=True)
    return run, {"wall_s": wall, "init_s": run.init_s, "forward_passes":
                 passes, "launches": counts, "per_pass": [k2, k3],
                 "peak_gb": peak_gb, "report": rep.summary(),
                 "program": prog.summary()}


def recurrent_kernel_rows(arch, params, peaks, flush, gen, card,
                          stacks_only=False):
    """K2 (and K3, on a gate stack) at each distinct projection shape of a
    served recurrent arch: layer 0's programmed codes at the decode slot
    count, noise off, with a random nonzero bias where the model has one
    (rglru's b_a / b_x ride K2's epilogue): held to the plain version and
    timed against its bytes bound. ``stacks_only`` skips single matrices
    (a fused tree's K2 shapes are the unfused tree's)."""
    import torch

    from repro_torch.core.aimc import AimcConfig, AimcLinearState
    from repro_torch.core.program import _flatten
    from repro_torch.core.quant import sym_scale
    from repro_torch.kernels import aimc_mvm, ref

    step = AimcConfig().adc_step
    rows, seen = [], set()
    for path, st in _flatten(params):
        if not isinstance(st, AimcLinearState):
            continue
        g = st.stack_shape[1] if len(st.stack_shape) == 2 else 1
        if stacks_only and g == 1:
            continue
        name = path.rsplit("/", 1)[-1]
        has_bias = name in ("w_a", "w_x")
        if (st.k, st.n, g, has_bias) in seen:
            continue
        seen.add((st.k, st.n, g, has_bias))
        w_q, s_w = st.w_q[0], st.s_w[0]
        kb, m, np_ = w_q.shape[-3:]
        x = torch.zeros((SLOTS, kb * m), device=w_q.device)
        x[:, :st.k] = torch.randn((SLOTS, st.k), generator=gen,
                                  device=w_q.device)
        s_x = sym_scale(x).reshape(1, 1)
        bias = (torch.nn.functional.pad(torch.randn(
            (st.n,), generator=gen, device=w_q.device), (0, np_ - st.n))
            if has_bias else None)
        if g > 1:
            kern = functools.partial(aimc_mvm.aimc_mvm_stacked, x, w_q, s_w,
                                     s_x, adc_step=step)
            plain = functools.partial(ref.aimc_matmul_stacked_ref, x, w_q,
                                      s_w, s_x, adc_step=step)
        else:
            kern = functools.partial(aimc_mvm.aimc_mvm_v2, x, w_q, s_w, s_x,
                                     None, bias, adc_step=step)
            plain = functools.partial(ref.aimc_matmul_ref_v2, x, w_q, s_w,
                                      s_x, None, bias, adc_step=step)
        y, want = kern(), plain()
        torch.cuda.synchronize()
        err, tol = _err(y, want)
        kname = "aimc_mvm_stacked" if g > 1 else "aimc_mvm_v2"
        check(err <= tol, f"{arch} {kname} {path}: max |err| {err} > {tol}")
        row = {"arch": arch, "kernel": kname, "proj": path, "K": st.k,
               "N": st.n, "G": g, "B": SLOTS, "KB": kb, "Np": np_,
               "bias": has_bias, "max_abs_err": err, "tol": tol,
               "plan": aimc_mvm.launch_plan(w_q.device, SLOTS, kb, m, np_, g),
               "ms": time_ms(kern, flush, KERNEL_REPS),
               "plain_ms": time_ms(plain, flush, 3)}
        row["bound_ms"], row["bound_by"] = bound_ms(
            SLOTS, kb, m, np_, g, peaks, bias=has_bias)
        rows.append(row)
        print(f"[recurrent] {arch} {kname} {path} [{SLOTS}x{st.k}]x"
              f"[{st.k}x{st.n}]{f' G={g}' if g > 1 else ''} KB {kb} Np "
              f"{np_}{' + bias' if has_bias else ''} ({plan_str(row['plan'])})"
              f": max|err| {err:.3g} (tol {tol:.3g}); kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}) on {card}",
              flush=True)
        del x, y, want
    return rows


def _snapshot_hit(prefix: int, plen: int, page: int, leg: int) -> int:
    """Prompt tokens a follower restores under the reference's rule:
    snapshots exist at page-aligned leg ends, a hit must lie inside the
    shared prefix, and the deepest usable one stops short of the last
    prompt token ((plen - 1) // page pages)."""
    ends = [e for e in range(leg, plen + 1, leg) if e % page == 0]
    cap = (plen - 1) // page * page
    return max([e for e in ends if e <= prefix and e <= cap], default=0)


def recurrent_phase(dev, peaks, card):
    """xlstm-350m and recurrentgemma-9b at their published widths on the
    card (see the module docstring, phase 14)."""
    import random

    import torch

    from repro_torch.kernels import aimc_mvm
    from repro_torch.runtime.batcher import (Request, reconcile,
                                             synchronized_trace)
    from repro_torch.runtime.engine import ServeEngine, static_generate

    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # -- xlstm-350m: Poisson main path, then --fuse-gates on synchronized
    # arrivals held to the unfused engine on the same installed codes
    xrun, out["xlstm"] = recurrent_serve(
        dev, "xlstm-350m", ["--trace", f"poisson:{RATE:g}"], card)
    eng, prog = xrun.engine, xrun.program
    model, cfg = eng.model, eng.cfg
    frun, out["xlstm_fused"] = recurrent_serve(dev, "xlstm-350m",
                                               ["--fuse-gates"], card)
    check("w_qkv" in frun.engine.params["pairs"]["mlstm"],
          "xlstm --fuse-gates built no w_qkv stack")
    unfused = ServeEngine(model, cfg, eng.exe, eng.params, n_slots=SLOTS,
                          prompt_pad=PROMPT, max_seq=PROMPT + GEN,
                          program=prog, family=eng.family, module=eng.module)
    aimc_mvm.reset_counts()
    rep_u = unfused.serve([dataclasses.replace(r) for r in frun.requests])
    torch.cuda.synchronize(dev)
    for r in frun.requests:
        check(rep_u.tokens(r.rid) == frun.report.tokens(r.rid),
              f"xlstm fused tokens differ from unfused (request {r.rid})")
    print(f"[recurrent] xlstm-350m fused (K3: w_ug G=2, w_qkv G=3, w_ff_gu "
          f"G=2) == unfused bit for bit on synchronized arrivals "
          f"({frun.report.generated_tokens} tokens); unfused launches "
          f"{dict(aimc_mvm.LAUNCHES)} for {unfused.forward_passes} passes",
          flush=True)
    flush = flush_buffer(dev)
    out["xlstm"]["kernel_rows"] = (
        recurrent_kernel_rows("xlstm-350m", eng.params, peaks, flush, gen,
                              card)
        + recurrent_kernel_rows("xlstm-350m", frun.engine.params, peaks,
                                flush, gen, card, stacks_only=True))
    del flush
    print(f"[recurrent] xlstm-350m decode step and prefill on {card}:",
          flush=True)
    out["xlstm"]["times"] = step_times(eng, xrun.requests[0].prompt)
    del frun

    # -- engine == static_generate, fixed DAC scale, synchronized
    exe_f = dataclasses.replace(eng.exe, aimc=dataclasses.replace(
        eng.exe.aimc, input_scale=PREFIX_SCALE))
    reqs = synchronized_trace(N_REQ, prompt_len=PROMPT, max_new=GEN,
                              seed=SEED + 1, vocab=cfg.vocab)
    e = ServeEngine(model, cfg, exe_f, eng.params, n_slots=N_REQ,
                    prompt_pad=PROMPT, max_seq=PROMPT + GEN, program=prog,
                    family=eng.family, module=eng.module)
    rep = e.serve(list(reqs))
    prompts = torch.tensor([r.prompt for r in reqs], dtype=torch.int32,
                           device=dev)
    toks, (t_pre, t_dec) = static_generate(model, cfg, exe_f, eng.params,
                                           prompts, GEN,
                                           max_seq=PROMPT + GEN)
    for r in reqs:
        check(rep.tokens(r.rid) == toks[r.rid].tolist(),
              f"xlstm engine != static_generate for request {r.rid}")
    out["static"] = {"prefill_s": t_pre, "decode_s": t_dec,
                     "tokens": rep.generated_tokens}
    print(f"[recurrent] xlstm-350m engine == static_generate bit for bit "
          f"(DAC scale fixed at {PREFIX_SCALE}, {len(reqs)} synchronized "
          f"requests, {rep.generated_tokens} tokens); static prefill "
          f"{t_pre:.2f} s, {GEN - 1} decode steps {t_dec:.2f} s (host "
          f"clock, on {card})", flush=True)

    # -- snapshot pages: shared prefix, page 4, 8-token legs, drained
    rng = random.Random(SEED)
    shared = tuple(rng.randint(1, cfg.vocab - 1) for _ in range(SNAP_PREFIX))
    reqs2 = [Request(rid=i, prompt=shared + tuple(
        rng.randint(1, cfg.vocab - 1) for _ in range(SNAP_TAIL)),
        max_new=GEN) for i in range(SNAP_REQ)]
    plen = SNAP_PREFIX + SNAP_TAIL
    kw = dict(n_slots=SNAP_REQ, prompt_pad=plen, max_seq=plen + GEN,
              program=prog, family=eng.family, module=eng.module)
    dense = ServeEngine(model, cfg, exe_f, eng.params, **kw)
    snap = ServeEngine(model, cfg, exe_f, eng.params, page_size=SNAP_PAGE,
                       prefix_cache=True, prefill_chunk=SNAP_LEG, **kw)
    counts0 = snap.warmup()
    rd = dense.serve(list(reqs2))
    aimc_mvm.reset_counts()
    p0 = snap.forward_passes
    sess = snap.begin()
    now = 0.0
    for r in reqs2:
        now = snap.admit(sess, r, now, drain=True)
    while sess.slots.n_busy:
        now = snap.step(sess, now)
    rs = snap.finish(sess, now)
    torch.cuda.synchronize(dev)
    counts, passes = dict(aimc_mvm.LAUNCHES), snap.forward_passes - p0
    for r in reqs2:
        check(rs.tokens(r.rid) == rd.tokens(r.rid),
              f"snapshot tokens differ from dense for request {r.rid}")
    hit = _snapshot_hit(SNAP_PREFIX, plen, SNAP_PAGE, SNAP_LEG)
    paid = [rs.records[r.rid].prefill_vectors for r in reqs2]
    check(hit > 0 and paid == [plen] + [plen - hit] * (SNAP_REQ - 1)
          and rs.prefix_hits == SNAP_REQ - 1
          and rs.prefix_hit_vectors == (SNAP_REQ - 1) * hit,
          f"snapshot hits: prefill vectors {paid}, {rs.prefix_hits} hits "
          f"({rs.prefix_hit_vectors} vectors), rule gives {hit} per follower")
    check(rs.page_ledger_exact and rs.page_ledger["held"] == len(snap.prefix)
          and snap.compile_counts() == counts0,
          f"snapshot: ledger {rs.page_ledger}, shapes "
          f"{snap.compile_counts()} vs {counts0}")
    k2 = recurrent_launches(cfg, "xlstm")[0]
    check(counts["aimc_mvm_v2"] == k2 * passes,
          f"snapshot: launches {counts} != {k2} x {passes}")
    led, static = reconcile(prog, rs.records, rs.observed_vectors)
    check(led == static and rs.observed_vectors == rs.useful_vectors,
          "snapshot: CM_* or vector books do not close")
    out["snapshot"] = {"prefill_vectors": paid, "hit_per_follower": hit,
                       "prefix_hits": rs.prefix_hits,
                       "prefix_hit_vectors": rs.prefix_hit_vectors,
                       "legs": rs.prefill_chunks, "launches": counts,
                       "passes": passes, "page_ledger": {
                           k: v for k, v in rs.page_ledger.items()
                           if k != "by_owner"},
                       "shapes": counts0,
                       "ms_per_leg": rs.wall_prefill_s
                       / max(rs.prefill_chunks, 1) * 1e3}
    print(f"[recurrent] snapshot pages (page {SNAP_PAGE}, {SNAP_LEG}-token "
          f"legs, DAC scale {PREFIX_SCALE}): {SNAP_REQ} requests sharing "
          f"{SNAP_PREFIX} tokens equal the dense engine's tokens; prefill "
          f"vectors {paid} ({hit} restored per follower), "
          f"{rs.prefill_chunks} legs, {passes} passes, launches {counts}; "
          f"page ledger exact, {rs.page_ledger['held']} snapshot pages "
          f"held; shapes {counts0} unchanged", flush=True)
    del xrun, eng, unfused, e, dense, snap, sess
    gc.collect()
    torch.cuda.empty_cache()

    # -- recurrentgemma-9b: Poisson main path, unfused
    grun, out["rglru"] = recurrent_serve(
        dev, "recurrentgemma-9b", ["--trace", f"poisson:{RATE:g}"], card)
    flush = flush_buffer(dev)
    out["rglru"]["kernel_rows"] = recurrent_kernel_rows(
        "recurrentgemma-9b", grun.engine.params, peaks, flush, gen, card)
    del flush
    print(f"[recurrent] recurrentgemma-9b decode step and prefill on "
          f"{card}:", flush=True)
    out["rglru"]["times"] = step_times(grun.engine, grun.requests[0].prompt)
    del grun
    return out


MOE = (("olmoe-1b-7b", 0), ("arctic-480b", 1))    # (arch, --layers)
GAP = 1e-6      # router k-th/(k+1)-th probability gap reported as a tie


def moe_sizes(cfg):
    """(f32 parameters of one layer, f32 parameters outside the layers,
    int8 code bytes of one layer at 512-row blocks and 128-lane columns)."""
    def codes(k, n):
        return (-(-k // 512) * 512) * (-(-n // 128) * 128)
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    e, ff, dff = cfg.n_experts, cfg.d_ff, cfg.moe_dense_ff or cfg.d_ff
    mats = [(d, q), (d, kv), (d, kv), (q, d)] + [(d, ff), (d, ff),
                                                (ff, d)] * e
    if cfg.moe_dense_residual:
        mats += [(d, dff), (d, dff), (dff, d)]
    per_layer = sum(k * n for k, n in mats) + d * e + 2 * d
    outside = cfg.vocab * d * (1 if cfg.tie_embeddings else 2) + d
    return per_layer, outside, sum(codes(k, n) for k, n in mats)


def moe_launches(cfg, fused: bool = False):
    """(K2, K3, expert-entry) launches per forward pass: attention wq, wk,
    wv, wo on K2 (fused: wqkv on K3 + wo), arctic's dense residual w_gate,
    w_up, w_down on K2, and one expert launch per expert projection."""
    dense = 3 if cfg.moe_dense_residual else 0
    l = cfg.n_layers
    return ((1 if fused else 4) + dense) * l, (l if fused else 0), 3 * l


def expert_bound_ms(e, b, kb, m, np_, peaks):
    """Least time of one expert launch: each expert's x, codes, scales,
    DAC scale and output moved once, against its int8 MACs."""
    k_pad = kb * m
    nbytes = e * (b * k_pad * 4 + k_pad * np_ + kb * np_ * 4 + b * np_ * 4
                  + 4)
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = 2 * e * b * k_pad * np_ / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def moe_expert_rows(arch, eng, peaks, flush, gen, card, caps):
    """The expert entry at each expert projection of layer 0, at each
    capacity the main path ran (``caps``: label -> rows per expert), on
    random inputs with expert 1 empty (DAC scale 1e-12 / 127): bit-equal
    to E K2 launches (the oracle loop, never on the main path), within
    1e-5 x max(1, max|y|) of its plain version, and timed (kernel, plain,
    the E-launch loop) against its bytes bound."""
    import torch

    from repro_torch.core.quant import sym_scale
    from repro_torch.kernels import aimc_mvm, ref

    blocks = eng.params["blocks"]
    step = eng.exe.aimc.adc_step
    rows = []
    for label, b in caps.items():
        for name in ("we_gate", "we_down"):
            st = blocks[name][0]                         # layer 0: [E]
            e = st.stack_shape[0]
            kb, m, np_ = st.w_q.shape[-3:]
            x = torch.zeros((e, b, kb * m), device=eng.device)
            x[:, :, :st.k] = torch.randn((e, b, st.k), generator=gen,
                                         device=eng.device)
            x[1] = 0.0
            s_x = sym_scale(x.reshape(e, -1), dim=1).reshape(e)
            w_q, s_w = st.w_q, st.s_w
            kern = functools.partial(aimc_mvm.aimc_mvm_experts, x, w_q, s_w,
                                     s_x, adc_step=step)
            plain = functools.partial(ref.aimc_matmul_experts_ref, x, w_q,
                                      s_w, s_x, adc_step=step)

            def loop():
                return [aimc_mvm.aimc_mvm_v2(x[i], w_q[i], s_w[i],
                                             s_x[i:i + 1], adc_step=step)
                        for i in range(e)]

            y, want, per = kern(), plain(), torch.stack(loop())
            torch.cuda.synchronize()
            check(torch.equal(y, per), f"{arch} {name} [{label}]: the expert "
                  f"launch differs from {e} K2 launches")
            check(not y[1].any(), f"{arch} {name}: an empty expert's output "
                  f"is not zero")
            err = float((y - want).abs().max())
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            check(err <= tol, f"{arch} {name} [{label}]: max |err| {err} > "
                  f"{tol}")
            row = {"arch": arch, "proj": name, "phase": label, "E": e,
                   "B": b, "K": st.k, "N": st.n, "KB": kb, "Np": np_,
                   "max_abs_err": err, "tol": tol,
                   "plan": aimc_mvm.launch_plan(eng.device, b, kb, m, np_, e,
                                                experts=True),
                   "ms": time_ms(kern, flush, KERNEL_REPS),
                   "plain_ms": time_ms(plain, flush, 3),
                   "e_k2_loop_ms": time_ms(loop, flush, 3),
                   "codes_gb": w_q.numel() / 1e9}
            row["bound_ms"], row["bound_by"] = expert_bound_ms(
                e, b, kb, m, np_, peaks)
            rows.append(row)
            print(f"[moe] {arch} {name} {label} E {e} x [{b}x{st.k}]x"
                  f"[{st.k}x{st.n}] KB {kb} ({plan_str(row['plan'])}; "
                  f"{row['codes_gb']:.3f} GB codes): == {e} K2 launches bit "
                  f"for bit, max|err| {err:.3g} vs plain; kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"{e} K2 launches {row['e_k2_loop_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}) on {card}",
                  flush=True)
            del x, y, want, per
    return rows


def moe_layer0_routing(eng, prompt, card, ffn_on_cpu: bool):
    """Layer 0's router and sort dispatch on the card and on the CPU from
    the identical hidden state (captured from a card prefill of
    ``prompt``): gate_idx and slot_o equal, unless the rows that differ
    all have a k-th/(k+1)-th probability gap under GAP (reported, not
    failed). ``ffn_on_cpu``: layer 0's whole MoE FFN also runs on the CPU
    (plain versions) from that state; its difference is recorded."""
    import torch

    from repro_torch.models import moe

    seen = []
    orig = moe.moe_ffn

    def rec(x, *args, **kw):
        if not seen:
            seen.append((x.clone(), args, kw))
        return orig(x, *args, **kw)

    moe.moe_ffn = rec
    try:
        tokens, vl = eng._pad_prompt(prompt)
        eng.model.prefill(eng.params, tokens, eng.cfg, eng.exe,
                          max_seq=eng.max_seq, valid_len=vl)
    finally:
        moe.moe_ffn = orig
    x, args, kw = seen[0]
    router = args[0]
    k, e = eng.cfg.top_k, router.shape[1]
    cap = moe.capacity(x.shape[0], k, e, eng.cfg.capacity_factor)
    _, idx_d, aux_d = moe.route(x, router, k)
    _, idx_c, aux_c = moe.route(x.cpu(), router.cpu(), k)
    probs = torch.softmax(x.cpu() @ router.cpu(), dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    gaps = (top[:, k - 1] - top[:, k])
    differ = (idx_d.cpu() != idx_c).any(dim=-1)
    out = {"tokens": x.shape[0], "cap": cap, "min_gap": float(gaps.min()),
           "rows_differ": int(differ.sum()),
           "aux_abs_diff": float((aux_d.cpu() - aux_c).abs())}
    if differ.any():
        ties = gaps[differ]
        check(bool((ties < GAP).all()), f"layer-0 routing differs card vs "
              f"CPU at rows {differ.nonzero().flatten().tolist()} with "
              f"gaps {ties.tolist()}")
        print(f"[moe] layer-0 routing: {int(differ.sum())} rows differ at "
              f"router ties (gaps {ties.tolist()} < {GAP}); slot_o not "
              f"compared", flush=True)
        return out
    xe_d, slot_d = moe._dispatch_sort(x, idx_d, e, cap, k)
    xe_c, slot_c = moe._dispatch_sort(x.cpu(), idx_c, e, cap, k)
    check(torch.equal(slot_d.cpu(), slot_c) and torch.equal(xe_d.cpu(), xe_c),
          "layer-0 slot_o or expert buffers differ card vs CPU")
    out["dropped"] = int((slot_c == e * cap).sum())
    if ffn_on_cpu:
        y_d, _ = orig(x, *args, **kw)
        y_c, _ = orig(x.cpu(), *(_to(a, "cpu") for a in args), **kw)
        out["ffn_max_abs_diff"] = float((y_d.cpu() - y_c).abs().max())
        out["ffn_max_abs"] = float(y_c.abs().max())
    print(f"[moe] layer-0 routing card == CPU on {x.shape[0]} tokens (cap "
          f"{cap}, {out['dropped']} assignments over capacity, smallest "
          f"k-th/(k+1)-th gap {out['min_gap']:.3g})"
          + (f"; the layer's MoE FFN card vs CPU max|diff| "
             f"{out['ffn_max_abs_diff']:.3g} (|y| <= {out['ffn_max_abs']:.3g},"
             f" recorded)" if ffn_on_cpu else "") + f" on {card}", flush=True)
    return out


def moe_serve(dev, peaks, arch, layers, card):
    """One MoE arch through the CLI entry point at its published widths,
    --exec aimc, 4 Poisson requests at 20 req/s: launch counts zeroed just
    before and read just after (`moe_launches` x passes, exact), ledgers
    reconcile, tokens in the vocabulary, finite logits; layer-0 routing
    card == CPU; the expert entry at layer 0's shapes; a decode step, a
    prefill and a profiled step timed; init seconds and peak memory."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import aimc_mvm
    from repro_torch.launch import serve
    from repro_torch.models.moe import capacity
    from repro_torch.runtime.batcher import reconcile

    spec = get_arch(arch)
    pub = spec.model_cfg
    args = ["--arch", arch, "--exec", "aimc", "--requests", str(N_REQ),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--slots",
            str(SLOTS), "--trace", f"poisson:{RATE:g}", "--seed", str(SEED),
            "--device", str(dev)] + (["--layers", str(layers)] if layers
                                     else [])
    per_layer, outside, codes = moe_sizes(pub)
    print(f"[moe] python -m repro_torch.launch.serve {' '.join(args)}"
          + (f"  (depth cut: {layers} of {pub.n_layers} layers at the "
             f"published widths and all {pub.n_experts} experts: "
             f"{layers} layer(s) draw "
             f"{(layers * per_layer + outside) / 1e9:.2f}e9 f32 parameters "
             f"({(layers * per_layer + outside) * 4e-9:.1f} GB) and program "
             f"{layers * codes / 1e9:.1f} GB of int8 codes; "
             f"{layers + 1} layers need "
             f"{((layers + 1) * per_layer + outside) * 4e-9:.1f} GB of f32 "
             f"alone, more than one card)" if layers else ""), flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    aimc_mvm.reset_counts()
    t0 = time.perf_counter()
    run = serve.main(args)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = dict(aimc_mvm.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    eng, rep, prog = run.engine, run.report, run.program
    cfg, n_layers, passes = eng.cfg, eng.cfg.n_layers, eng.forward_passes
    check(dataclasses.replace(cfg, n_layers=pub.n_layers) == pub
          and n_layers == (layers or pub.n_layers),
          f"{arch}: not the published widths: {cfg}")
    k2, k3, ex = moe_launches(cfg)
    check(counts["aimc_mvm_v2"] == k2 * passes
          and counts["aimc_mvm_stacked"] == k3 * passes
          and counts["aimc_mvm_experts"] == ex * passes,
          f"{arch}: launches {counts} != ({k2} K2, {k3} K3, {ex} expert) x "
          f"{passes} passes")
    led, static = reconcile(prog, rep.records, rep.observed_vectors)
    check(led == static, f"{arch}: CM_* ledgers do not reconcile")
    check(len(rep.records) == N_REQ, f"{arch}: requests lost")
    for rec in rep.records.values():
        check(1 <= len(rec.tokens) <= rec.request.max_new
              and all(0 <= t < cfg.vocab for t in rec.tokens),
              f"{arch}: bad tokens for request {rec.request.rid}")
    tokens, vl = eng._pad_prompt(run.requests[0].prompt)
    logits, _ = eng.model.prefill(eng.params, tokens, cfg, eng.exe,
                                  max_seq=eng.max_seq, valid_len=vl)
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (1, 1, cfg.vocab),
          f"{arch}: bad logits {tuple(logits.shape)}")
    print(f"[moe] {arch}: {n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} experts "
          f"top-{cfg.top_k}, d_ff {cfg.d_ff}"
          f"{f' + dense residual {cfg.moe_dense_ff}' if cfg.moe_dense_residual else ''}"
          f", vocab {cfg.vocab}; {wall:.1f}s wall (init {run.init_s:.2f}s) "
          f"on {card}, {passes} passes, launches {counts} ({k2} K2 + {ex} "
          f"expert per pass), peak {peak_gb:.2f} GB; {prog.summary()}; "
          f"ledgers reconcile, tokens in vocab, logits finite", flush=True)
    routing = moe_layer0_routing(eng, run.requests[0].prompt, card,
                                 ffn_on_cpu=layers == 0)
    caps = {"decode": capacity(SLOTS, cfg.top_k, cfg.n_experts,
                               cfg.capacity_factor)}
    prefill_cap = capacity(PROMPT, cfg.top_k, cfg.n_experts,
                           cfg.capacity_factor)
    if prefill_cap != caps["decode"]:
        caps["prefill"] = prefill_cap
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = flush_buffer(dev)
    rows = moe_expert_rows(arch, eng, peaks, flush, gen, card, caps)
    del flush
    print(f"[moe] {arch} decode step and prefill on {card}:", flush=True)
    times = step_times(eng, run.requests[0].prompt)
    return run, {"wall_s": wall, "init_s": run.init_s, "layers": n_layers,
                 "published_layers": pub.n_layers, "forward_passes": passes,
                 "launches": counts, "per_pass": [k2, k3, ex],
                 "peak_gb": peak_gb, "routing": routing, "caps": caps,
                 "expert_rows": rows, **times, "report": rep.summary(),
                 "program": prog.summary()}


def moe_fused(run, card):
    """olmoe's --fuse-gates on the served codes (wq/wk/wv on one G=3 K3
    stack; experts unfused), synchronized arrivals: tokens equal the
    unfused engine's; launches per pass 1 K3 + 1 K2 + 3 expert per layer,
    counts zeroed just before and read just after each run."""
    import torch

    from repro_torch.kernels import aimc_mvm
    from repro_torch.runtime.engine import ServeEngine

    eng = run.engine
    fused = eng.model.fuse_gate_stacks(eng.params)
    check("wqkv" in fused["blocks"] and "we_gate" in fused["blocks"],
          "olmoe fuse_gate_stacks built no wqkv stack")
    sync = [dataclasses.replace(r, arrival=0.0) for r in run.requests]
    reports, counts = {}, {}
    for name, params in (("unfused", eng.params), ("fused", fused)):
        e = ServeEngine(eng.model, eng.cfg, eng.exe, params,
                        n_slots=eng.n_slots, prompt_pad=eng.prompt_pad,
                        max_seq=eng.max_seq, program=eng.program,
                        family=eng.family)
        aimc_mvm.reset_counts()
        reports[name] = e.serve(sync)
        torch.cuda.synchronize()
        counts[name] = (dict(aimc_mvm.LAUNCHES), e.forward_passes)
        del e
    for name, (c, p) in counts.items():
        k2, k3, ex = moe_launches(eng.cfg, fused=name == "fused")
        check(c["aimc_mvm_v2"] == k2 * p and c["aimc_mvm_stacked"] == k3 * p
              and c["aimc_mvm_experts"] == ex * p,
              f"olmoe {name} launches {c} for {p} passes")
    for r in sync:
        check(reports["fused"].tokens(r.rid) == reports["unfused"].tokens(r.rid),
              f"olmoe fused tokens differ for request {r.rid}")
    (cu, pu), (cf, pf) = counts["unfused"], counts["fused"]
    print(f"[moe] olmoe-1b-7b fused == unfused token for token on "
          f"synchronized arrivals ({reports['fused'].generated_tokens} "
          f"tokens); launches per pass: unfused K2 {cu['aimc_mvm_v2'] // pu}"
          f" + expert {cu['aimc_mvm_experts'] // pu}, fused K3 "
          f"{cf['aimc_mvm_stacked'] // pf} + K2 {cf['aimc_mvm_v2'] // pf} + "
          f"expert {cf['aimc_mvm_experts'] // pf} (on {card})", flush=True)
    return {"unfused": {"launches": cu, "passes": pu},
            "fused": {"launches": cf, "passes": pf}}


def moe_phase(dev, peaks, card):
    """olmoe-1b-7b uncut (fused and unfused) and arctic-480b at 1 of 35
    layers through `moe_serve`, each freed before the next."""
    import torch
    out = {}
    for arch, layers in MOE:
        run, out[arch] = moe_serve(dev, peaks, arch, layers, card)
        if arch == "olmoe-1b-7b":
            out["olmoe_fused"] = moe_fused(run, card)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return out


def fidelity_phase(dev):
    """bench_accuracy's own configuration (key 7 and its folds, the NOISY
    model, MLP 1024 B 16, LSTM n_h 256, CNN-F at 64 px B 8) on the card,
    beside the same forwards on the CPU (plain versions) and the figures
    BENCH_all.json records for the reference; then CNN-M at 224 px under
    both noise sources over FLIP_SEEDS noise draws: the flip-margin
    verdict per draw."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.models import paper_nets as pn

    key = prng.PRNGKey(7)

    def fk(i):
        return prng.fold_in(key, i)

    noisy = AimcConfig(tile_rows=512, noise=paper_noise())

    def verdict(y_dig, y):
        agree = y.argmax(-1) == y_dig.argmax(-1)
        out = {"snr_db": snr_db(y_dig, y),
               "top1": float(agree.float().mean())}
        if y.dim() == 2:
            top2 = torch.sort(y_dig, -1).values[:, -2:]
            margins = top2[:, 1] - top2[:, 0]
            err = (y - y_dig).abs().amax(-1)
            out["margin_ok"] = bool((agree | (margins < err)).all())
            out["decided_flips"] = int((~agree & (margins >= err)).sum())
        return out

    def nets(device):
        p = pn.mlp_init(key, device=device)
        x = prng.normal(fk(1), (16, 1024), device=device)
        yield "MLP", pn.mlp_forward_digital(p, x), \
            pn.mlp_forward_aimc(p, x, noisy, fk(2))[0]
        nh = BENCH_LSTM_NH
        p = pn.lstm_init(fk(3), nh, device=device)
        xs = prng.normal(fk(4), (20, 8, 50), device=device)
        yield "LSTM", pn.lstm_forward_digital(p, xs, nh), \
            pn.lstm_forward_aimc(p, xs, nh, noisy, fk(5))[0]
        p = pn.cnn_init(fk(6), "F", img=BENCH_IMG, device=device)
        x = prng.normal(fk(7), (8, BENCH_IMG, BENCH_IMG, 3), device=device)
        yield "CNN-F", pn.cnn_forward(p, x, "F"), \
            pn.cnn_forward(p, x, "F", noisy, key=fk(8))[0]

    card = {n: verdict(d, y) for n, d, y in nets(dev)}
    cpu = {n: verdict(d, y) for n, d, y in nets("cpu")}
    bench = json.loads((ROOT / "BENCH_all.json").read_text())
    recorded = bench["modules"]["accuracy"]["results"]
    rec = {"MLP": recorded["mlp_snr"], "LSTM": recorded["lstm_snr"],
           "CNN-F": recorded["cnn_snr"]}
    for n in card:
        gap = abs(card[n]["snr_db"] - cpu[n]["snr_db"])
        check(gap <= 0.05, f"fidelity {n}: card {card[n]['snr_db']} vs CPU "
              f"{cpu[n]['snr_db']} dB")
        check(card[n]["top1"] == cpu[n]["top1"]
              and card[n].get("margin_ok") == cpu[n].get("margin_ok"),
              f"fidelity {n}: card {card[n]} vs CPU {cpu[n]}")
    check(card["MLP"]["snr_db"] >= 20 and card["LSTM"]["snr_db"] >= 20
          and card["LSTM"]["top1"] >= 0.8 and card["CNN-F"]["margin_ok"],
          f"bench_accuracy's checks fail on the card: {card}")
    print("[fidelity] bench_accuracy settings (MLP 1024 B 16, LSTM n_h "
          f"{BENCH_LSTM_NH}, CNN-F {BENCH_IMG} px B 8, NOISY, counter "
          "noise), port on the card / CPU / BENCH_all.json (reference, "
          "recorded): " + "; ".join(
              f"{n} {card[n]['snr_db']:.2f} / {cpu[n]['snr_db']:.2f} / "
              f"{rec[n]:.2f} dB" for n in card)
          + f"; LSTM top-1 {card['LSTM']['top1']:.0%} (recorded "
          f"{recorded['lstm_top1']:.0%}), CNN-F top-1 "
          f"{card['CNN-F']['top1']:.0%} (recorded "
          f"{recorded['cnn_top1']:.0%}), flips inside the margin: "
          f"{card['CNN-F']['margin_ok']}", flush=True)

    p = pn.cnn_init(fk(6), "M", CNN_IMG, CNN_CLASSES, device=dev)
    x = prng.normal(fk(7), (CNN_B, CNN_IMG, CNN_IMG, 3), device=dev)
    y_dig = pn.cnn_forward(p, x, "M")
    draws = {}
    for src in ("counter", "hw"):
        cfg = AimcConfig(tile_rows=512, noise=paper_noise(),
                         noise_source=src)
        draws[src] = []
        for s in range(FLIP_SEEDS):
            k = fk(8) if s == 0 else prng.fold_in(fk(8), s)
            draws[src].append(verdict(y_dig, pn.cnn_forward(
                p, x, "M", cfg, key=k)[0]))
    for src, vs in draws.items():
        print(f"[fidelity] CNN-M {CNN_IMG} px B {CNN_B} {src} noise over "
              f"{FLIP_SEEDS} draws (draw 0 = the paper-nets phase's key): "
              f"margin verdicts {[v['margin_ok'] for v in vs]}, decided "
              f"flips {[v['decided_flips'] for v in vs]}, top-1 "
              f"{[round(v['top1'], 3) for v in vs]}, SNR "
              f"{[round(v['snr_db'], 2) for v in vs]} dB", flush=True)
    return {"card": card, "cpu": cpu, "recorded": rec,
            "cnn_m_draws": draws}


# the resilience phase: `make serve-chaos`'s traffic at granite-8b's
# published widths, 2 cores, the DAC scale fixed (batch-invariant tokens)
CHAOS_N, CHAOS_PROMPT, CHAOS_GEN, CHAOS_SLOTS, CHAOS_RATE = 6, 8, 6, 3, 300.0
CHAOS_SCALE, CHAOS_SPEC = 0.1, "corrupt:0@1:0.5,kill:1@3"
DRIFT_NU, DRIFT_T0, DRIFT_GEN = 0.3, 0.01, 4


def chaos_args(dev, gen=CHAOS_GEN):
    return ["--arch", ARCH, "--exec", "aimc", "--requests", str(CHAOS_N),
            "--prompt-len", str(CHAOS_PROMPT), "--gen", str(gen), "--slots",
            str(CHAOS_SLOTS), "--trace", f"poisson:{CHAOS_RATE:g}",
            "--decode-chunk", "2", "--cores", "2", "--input-scale",
            str(CHAOS_SCALE), "--seed", str(SEED), "--device", str(dev)]


def repaired_probes(health, events):
    """Probe every state that ``events`` repaired, rebuilt after the serve
    (`Recalibrator.fresh_state` is deterministic), so the check adds no
    time to the engine's recal walls or its health share: each rebuilt
    state must equal the live program's bit for bit, and its probe reads
    the error a probe at the repair instant (age 0) would. Returns one
    {core: error} per event."""
    import torch

    prog = health.program
    by_name = {}
    for name in sorted({n for ev in events for n in ev.names}):
        fresh, live = health.recal.fresh_state(name), prog[name]
        check(torch.equal(fresh.w_q, live.w_q)
              and torch.equal(fresh.s_w, live.s_w),
              f"{name}: the repaired state is not the fresh program's")
        by_name[name] = max(health.measure({name: fresh}).values())
        del fresh
    ctx = dict(zip(prog.names, prog.contexts))
    out = []
    for ev in events:
        errs = {}
        for n in ev.names:
            errs[ctx[n]] = max(errs.get(ctx[n], 0.0), by_name[n])
        out.append(errs)
    return out


def probe_kernel_rows(health, peaks, card):
    """The expert entry at each shape of the resilience path's probe: each
    of granite-8b's seven programmed [36] layer stacks on its probe
    vectors (x broadcast to [36, 2, K], the DAC scale the program's), as
    `runtime.health.apply_state` launches it. The wrapper call on the
    probe's own operands must give the probe's output bit for bit, lie
    within 1e-5 x max(1, max|y|) of its plain version on the same
    operands, and is timed (kernel, plain) against its bytes bound."""
    import torch

    from repro_torch.core.quant import sym_scale
    from repro_torch.kernels import aimc_mvm, ref
    from repro_torch.runtime.health import apply_state

    prog, cfg = health.program, health.program.cfg
    flush = flush_buffer(prog.states[0].w_q.device)
    rows = []
    for name, st in zip(prog.names, prog.states):
        x = health._probes[name]
        e, (kb, m, np_) = st.instances, st.w_q.shape[-3:]
        w_q = st.w_q.reshape(e, kb, m, np_)
        s_w = st.s_w.reshape(e, kb, np_)
        xe = torch.nn.functional.pad(x.expand(e, *x.shape),
                                     (0, kb * m - st.k)).contiguous()
        if cfg.input_scale > 0.0:
            s_x = torch.full((e,), cfg.input_scale, device=x.device)
        else:
            s_x = sym_scale(xe.reshape(e, -1), dim=1).reshape(e)
        kern = functools.partial(aimc_mvm.aimc_mvm_experts, xe, w_q, s_w,
                                 s_x, adc_step=cfg.adc_step)
        plain = functools.partial(ref.aimc_matmul_experts_ref, xe, w_q, s_w,
                                  s_x, adc_step=cfg.adc_step)
        y = apply_state(st, x, cfg)
        check(torch.equal(kern()[:, :, :st.n], y),
              f"probe {name}: the timed operands are not the probe's")
        want = plain()[:, :, :st.n]
        err = float((y - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        check(err <= tol, f"probe {name}: max |err| {err} > {tol} against "
              f"the plain version")
        row = {"proj": name, "E": e, "B": x.shape[0], "K": st.k, "N": st.n,
               "KB": kb, "Np": np_, "max_abs_err": err, "tol": tol,
               "plan": aimc_mvm.launch_plan(x.device, x.shape[0], kb, m,
                                            np_, e, experts=True),
               "ms": time_ms(kern, flush, KERNEL_REPS),
               "plain_ms": time_ms(plain, flush, 3),
               "codes_gb": w_q.numel() / 1e9}
        row["bound_ms"], row["bound_by"] = expert_bound_ms(
            e, x.shape[0], kb, m, np_, peaks)
        rows.append(row)
        print(f"[resilience] probe {name} E {e} x [{x.shape[0]}x{st.k}]x"
              f"[{st.k}x{st.n}] KB {kb} ({plan_str(row['plan'])}; "
              f"{row['codes_gb']:.3f} GB codes): max|err| {err:.3g} vs "
              f"plain (tol {tol:.3g}); kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}) on {card}", flush=True)
        del xe, y, want
    return rows


def resilience_serve(dev, extra, card, gen=CHAOS_GEN):
    """``serve.main`` on the chaos traffic with ``extra`` flags, launch
    counts zeroed just before and read just after: every request served
    with tokens in the vocabulary, K2 = 7 x 36 x passes, CM_* books close.
    Returns (run, stats)."""
    import torch

    from repro_torch.kernels import aimc_mvm
    from repro_torch.launch import serve
    from repro_torch.runtime.batcher import reconcile

    args = chaos_args(dev, gen) + extra
    print(f"[resilience] python -m repro_torch.launch.serve "
          f"{' '.join(args)}", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    aimc_mvm.reset_counts()
    t0 = time.perf_counter()
    run = serve.main(args)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = dict(aimc_mvm.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    eng, rep = run.engine, run.report
    cfg, passes = eng.cfg, eng.forward_passes
    check(cfg.n_layers == 36 and cfg.d_model == 4096 and cfg.d_ff == 14336
          and cfg.vocab == 49152, "not the published granite-8b width")
    check(counts["aimc_mvm_v2"] == 7 * cfg.n_layers * passes,
          f"K2 launches {counts['aimc_mvm_v2']} != 7 x 36 x {passes}")
    check(len(rep.records) == CHAOS_N, f"requests lost: {len(rep.records)}")
    for rec in rep.records.values():
        check(rec.finish_reason == "length"
              and len(rec.tokens) == rec.request.max_new
              and all(0 <= t < cfg.vocab for t in rec.tokens),
              f"request {rec.request.rid} did not finish: "
              f"{rec.finish_reason} {rec.tokens}")
    led, static = reconcile(eng.program, rep.records, rep.observed_vectors)
    check(led == static, "CM_* ledgers do not reconcile")
    stats = {"wall_s": wall, "init_s": run.init_s, "forward_passes": passes,
             "launches": counts, "peak_gb": peak_gb,
             "decode_ms_per_step": rep.wall_decode_s / max(rep.n_steps, 1)
             * 1e3, "n_steps": rep.n_steps, "probes": rep.probes,
             "n_recals": rep.n_recals, "wall_health_s": rep.wall_health_s,
             "makespan_s": rep.makespan_s,
             "health_share": rep.wall_health_s / max(rep.makespan_s, 1e-9),
             "recal_events": [dataclasses.asdict(e)
                              for e in rep.recal_events],
             "fault_events": [e.describe() for e in rep.fault_events],
             "tokens": {rid: r.tokens for rid, r in rep.records.items()},
             "report": rep.summary()}
    print(f"[resilience] {wall:.1f}s wall (init {run.init_s:.2f}s) on "
          f"{card}, {passes} passes, launches {counts}, peak {peak_gb:.2f} "
          f"GB; decode {stats['decode_ms_per_step']:.2f} ms/step over "
          f"{rep.n_steps} steps; {rep.probes} probes, {rep.n_recals} recals, "
          f"health wall {rep.wall_health_s:.3f}s = "
          f"{stats['health_share']:.3f} of the {rep.makespan_s:.3f}s serve",
          flush=True)
    for ev in rep.recal_events:
        print(f"[resilience]   hot recal [{ev.reason}] cores={list(ev.cores)} "
              f"{len(ev.names)} matrices, CM_INITIALIZE={ev.initialize}, "
              f"wall {ev.wall_s:.4f} s", flush=True)
    return run, stats


def _first_sample_after(history, t):
    return next((smp for smp in history if smp.t > t), None)


def resilience_phase(dev, peaks, card):
    """Leg (a) unfaulted, leg (b) `CHAOS_SPEC` on the same trace, leg (c)
    drift nu 0.3, t0 0.01 s: faults fire, recal reasons fault then
    dead_core, core 1 drained, tokens bit-equal to leg (a), books and
    recal books exact, every repaired state probes exactly 0.0; the drift
    probe reads 1 - g(age) and recalibrates with reason drift. The probe's
    expert launches are held against their plain version and timed."""
    import torch

    from repro_torch.core.aimc import aimc_apply
    from repro_torch.core.program import installed_entries
    from repro_torch.core.schedule import CoreSchedule
    from repro_torch.kernels import aimc_mvm
    from repro_torch.runtime.health import reconcile_recal

    out = {}
    run_a, out["a"] = resilience_serve(dev, [], card)
    check(run_a.report.probes == 0 and out["a"]["launches"][
        "aimc_mvm_experts"] == 0, "the unfaulted leg probed")
    del run_a
    gc.collect()
    torch.cuda.empty_cache()

    run_b, out["b"] = resilience_serve(
        dev, ["--chaos", CHAOS_SPEC], card)
    eng, rep, prog0 = run_b.engine, run_b.report, run_b.program
    health = eng.health
    check(eng.chaos.exhausted and len(rep.fault_events) == 2,
          f"chaos events fired: {out['b']['fault_events']}")
    reasons = [e.reason for e in rep.recal_events]
    check(reasons == ["fault", "dead_core"], f"recal reasons {reasons}")
    check(1 not in eng.program.contexts, "core 1 still holds matrices")
    check(out["b"]["tokens"] == out["a"]["tokens"],
          f"chaos tokens differ from the unfaulted run: "
          f"{out['b']['tokens']} vs {out['a']['tokens']}")
    check(reconcile_recal(eng.program, rep), "recal books do not close")
    want_init = sum(eng.program.reprogram_counts(e.names).initialize
                    for e in rep.recal_events)
    check(rep.recal_initialize == want_init,
          f"recal CM_INITIALIZE {rep.recal_initialize} != {want_init}")
    n_probe = len(prog0.names)
    check(out["b"]["launches"]["aimc_mvm_experts"]
          == n_probe * (rep.probes + 1),
          f"expert launches {out['b']['launches']['aimc_mvm_experts']} != "
          f"{n_probe} x ({rep.probes} probes + the references)")
    # every repaired state probes exactly 0.0 at its repair, and the next
    # probe of the live tree (or, past the trace's end, a final one) too
    after_b = repaired_probes(health, rep.recal_events)
    check(all(e == 0.0 for errs in after_b for e in errs.values()),
          f"repaired states probe {after_b}")
    nxt = []
    for ev in rep.recal_events:
        smp = _first_sample_after(health.history, ev.t)
        nxt.append(smp.errors if smp is not None else
                   health.measure(installed_entries(eng.params)))
    check(all(e == 0.0 for errs in nxt for e in errs.values()),
          f"the probe after a recal reads {nxt}")
    # the remap reshards no sum: each matrix is ONE whole shard before and
    # after (one K2 on the whole state), and a moved layer's K2 output is
    # bit-equal on the original and the repaired codes
    before = CoreSchedule.from_program(prog0)
    shards = [(s.name, s.cols, s.count) for s in before.shards]
    check(shards == [(s.name, s.cols, s.count) for s in eng.schedule.shards]
          and all(c is None for _, c, _ in shards),
          "the remap changed a shard's columns")
    moved = [n for n, c in zip(prog0.names, prog0.contexts) if c == 1]
    x = torch.randn((CHAOS_SLOTS, prog0[moved[0]].k), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    check(torch.equal(aimc_apply(prog0[moved[0]][0], x, prog0.cfg),
                      aimc_apply(eng.program[moved[0]][0], x, prog0.cfg)),
          f"{moved[0]} layer 0 differs after the remap")
    # one probe of the live tree, timed, with its launches
    live = installed_entries(eng.params)
    aimc_mvm.reset_counts()
    health.measure(live)
    per_probe = {k: v for k, v in aimc_mvm.LAUNCHES.items() if v}
    probe_ms, _ = timed(lambda: health.measure(live), dev)
    check(per_probe == {"aimc_mvm_experts": n_probe},
          f"launches per probe {per_probe}")
    probe_rows = probe_kernel_rows(health, peaks, card)
    out["b"] |= {"probe_ms": probe_ms, "launches_per_probe": per_probe,
                 "probe_rows": probe_rows,
                 "probe_device_ms": sum(r["ms"] for r in probe_rows),
                 "probe_bound_ms": sum(r["bound_ms"] for r in probe_rows),
                 "after_recal_probe": after_b,
                 "next_probe": nxt, "moved": moved,
                 "quant_floor": health.quant_floor}
    print(f"[resilience] chaos tokens bit-equal to the unfaulted run; "
          f"recal reasons {reasons}; core 1 drained ({len(moved)} matrices "
          f"moved, shards unchanged); every repaired state and the next "
          f"probe read exactly 0.0; one probe {probe_ms:.3f} ms = "
          f"{per_probe} (host clock; its launches "
          f"{out['b']['probe_device_ms']:.4f} ms device, bound "
          f"{out['b']['probe_bound_ms']:.4f} ms, on {card}); decode "
          f"{out['a']['decode_ms_per_step']:.2f} ms/step unfaulted vs "
          f"{out['b']['decode_ms_per_step']:.2f} chaos", flush=True)
    del run_b, eng, health, live
    gc.collect()
    torch.cuda.empty_cache()

    run_c, out["c"] = resilience_serve(
        dev, ["--drift", str(DRIFT_NU), "--drift-t0", str(DRIFT_T0)], card,
        gen=DRIFT_GEN)
    eng, rep = run_c.engine, run_c.report
    health = eng.health
    reasons = {e.reason for e in rep.recal_events}
    check(rep.n_recals >= 1 and reasons == {"drift"},
          f"drift recals {[e.reason for e in rep.recal_events]}")
    # each probe reads 1 - g(age) of the decay law, age since the last recal
    t_prog = {c: 0.0 for c in set(eng.program.contexts)}
    recal_at = {ev.t: ev.cores for ev in rep.recal_events}
    ages, worst = [], 0.0
    for smp in health.history:
        for c, err in smp.errors.items():
            age = smp.t - t_prog[c]
            g = health.noise.drift_gain_at(age)
            worst = max(worst, abs(err - (1.0 - g)))
            ages.append((age, err))
        for c in recal_at.get(smp.t, ()):
            t_prog[c] = smp.t
    over = [a for a in ages if a[1] > health.policy.threshold]
    check(worst <= 1e-5 and over,
          f"drift probe vs 1 - g(age): worst {worst}, over threshold {over}")
    after_c = repaired_probes(health, rep.recal_events)
    check(all(e == 0.0 for errs in after_c for e in errs.values()),
          f"drift-repaired states probe {after_c}")
    out["c"] |= {"age_error": ages, "law_max_err": worst,
                 "after_recal_probe": after_c}
    print(f"[resilience] drift nu {DRIFT_NU} t0 {DRIFT_T0}s: {rep.probes} "
          f"probes read 1 - (age/t0)^-nu within {worst:.2e} (largest "
          f"{max(e for _, e in ages):.4f} at threshold "
          f"{health.policy.threshold}); {rep.n_recals} drift recals, each "
          f"repaired state probes 0.0", flush=True)
    return out


def tree_bytes(tree) -> int:
    from repro_torch.core.aimc import AimcLinearState
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, AimcLinearState):
        return tree_bytes({"w_q": tree.w_q, "s_w": tree.s_w})
    return tree.numel() * tree.element_size()


def int8_phase(dev, card):
    """granite-8b at its published widths served digital in bf16 and with
    --int8: the [1 x 16] prefill logits at all 16 positions within the
    reference's bar (cosine > 0.99, top-1 agreement > 0.9), the int8 tree
    about half of bf16's bytes; then --int8 --exec aimc: crossbars
    programmed from the codes, K2 = 7 x 36 x passes."""
    import torch

    from repro_torch.kernels import aimc_mvm
    from repro_torch.launch import serve
    from repro_torch.runtime.batcher import synchronized_trace

    base = ["--arch", ARCH, "--requests", str(N_REQ), "--prompt-len",
            str(PROMPT), "--gen", str(GEN), "--slots", str(SLOTS), "--trace",
            f"poisson:{RATE:g}", "--seed", str(SEED), "--device", str(dev)]
    vl = torch.arange(1, PROMPT + 1, dtype=torch.int32, device=dev)
    out, logits = {}, {}
    for name, extra in (("bf16", []), ("int8", ["--int8"]),
                        ("int8 aimc", ["--int8", "--exec", "aimc"])):
        args = base + extra
        print(f"[int8] python -m repro_torch.launch.serve {' '.join(args)}",
              flush=True)
        torch.cuda.reset_peak_memory_stats(dev)
        aimc_mvm.reset_counts()
        t0 = time.perf_counter()
        run = serve.main(args)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = dict(aimc_mvm.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        eng, rep = run.engine, run.report
        cfg, passes = eng.cfg, eng.forward_passes
        check(cfg.n_layers == 36 and cfg.d_model == 4096
              and cfg.vocab == 49152, "not the published granite-8b width")
        check(len(rep.records) == N_REQ and all(
            1 <= len(r.tokens) <= r.request.max_new
            and all(0 <= t < cfg.vocab for t in r.tokens)
            for r in rep.records.values()), f"{name}: bad serve")
        k2 = 7 * cfg.n_layers * passes if "aimc" in name else 0
        check(counts["aimc_mvm_v2"] == k2 and sum(counts.values()) == k2,
              f"{name}: launches {counts}, want {k2} K2")
        check(eng.exe.serve_int8 == (name == "int8"), f"{name}: exe")
        stats = {"wall_s": wall, "init_s": run.init_s, "launches": counts,
                 "forward_passes": passes, "peak_gb": peak_gb,
                 "params_bytes": tree_bytes(eng.params),
                 "report": rep.summary()}
        if name != "int8 aimc":
            stats |= step_times(eng, run.requests[0].prompt)
            # one [1 x 16] prompt's logits at every position: row i of a
            # [16 x 16] prefill ends at position i (valid_len i + 1)
            prompt = synchronized_trace(1, prompt_len=PROMPT, max_new=1,
                                        seed=SEED + 3,
                                        vocab=cfg.vocab)[0].prompt
            toks = torch.tensor([prompt] * PROMPT, dtype=torch.int32,
                                device=dev)
            lg, _ = eng.model.prefill(eng.params, toks, cfg, eng.exe,
                                      max_seq=PROMPT, valid_len=vl)
            check(bool(torch.isfinite(lg).all())
                  and tuple(lg.shape) == (PROMPT, 1, cfg.vocab),
                  f"{name}: bad logits {tuple(lg.shape)}")
            logits[name] = lg[:, 0].float()
        out[name] = stats
        print(f"[int8] {name}: {wall:.1f}s wall (init {run.init_s:.2f}s) on "
              f"{card}, {passes} passes, launches {counts}, params "
              f"{stats['params_bytes'] / 1e9:.2f} GB, peak {peak_gb:.2f} GB"
              + (f", decode {stats['decode_ms_per_step']:.2f} ms/step"
                 if "decode_ms_per_step" in stats else ""), flush=True)
        del run, eng
        gc.collect()
        torch.cuda.empty_cache()
    a, b = logits["bf16"], logits["int8"]
    cos = float((a * b).sum() / (a.norm() * b.norm() + 1e-9))
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    f32_bytes = out["bf16"]["params_bytes"]
    ratio = out["int8"]["params_bytes"] / (f32_bytes / 2)
    check(cos > 0.99 and agree > 0.9,
          f"int8 logits vs bf16: cosine {cos}, top-1 agreement {agree}")
    check(out["int8"]["params_bytes"] < 0.45 * f32_bytes and ratio <= 0.55,
          f"int8 params {out['int8']['params_bytes']} bytes vs "
          f"{f32_bytes} f32 ({ratio:.3f} of bf16)")
    out["logits"] = {"cosine": cos, "top1_agreement": agree,
                     "positions": PROMPT}
    out["int8_over_bf16_bytes"] = ratio
    print(f"[int8] [1 x {PROMPT}] prefill logits at all {PROMPT} positions, "
          f"int8 vs bf16: cosine {cos:.5f} (> 0.99), top-1 agreement "
          f"{agree:.3f} (> 0.9); int8 params {ratio:.3f} of bf16's bytes "
          f"(the bf16 serve holds f32 weights, cast per call); decode "
          f"{out['int8']['decode_ms_per_step']:.2f} ms/step int8 vs "
          f"{out['bf16']['decode_ms_per_step']:.2f} bf16", flush=True)
    return out


# the placement phase: granite-8b at its published widths under the
# cost-model placer with a budget of 16128 tiles per context (just over
# half of its 29952). From the reference's algorithm on these shapes: w_gate
# stays hot, the rest rotate in three groups (each [36] stack is one leaf)
PLACE_BUDGET, PLACE_SCALE = 16128, 0.1
PLACE_HOT = ("blocks/w_gate",)
PLACE_GROUPS = (("blocks/w_up",), ("blocks/w_down",),
                ("blocks/wo", "blocks/wq", "blocks/wk", "blocks/wv"))
# the server phase: ci.sh's server smoke, both models AIMC at their
# published widths on one TilePool
SERVER_MODELS = "granite-8b:aimc,xlstm-350m:aimc"
SERVER_TENANTS = "premium:granite-8b:2,standard:granite-8b:1:sjf,batch:xlstm-350m"
SERVER_REQ, SERVER_PROMPT, SERVER_GEN, SERVER_SLOTS = 8, 8, 4, 2
SERVER_K2_PER_PASS = {"granite-8b": 252, "xlstm-350m": 132}


@contextlib.contextmanager
def k2_per_call(cls):
    """While active, log every prefill and decode call of ``cls`` engines
    as (closure, rotation state in force, forward passes, K2 launches)."""
    from repro_torch.kernels import aimc_mvm
    log = []
    orig = {n: getattr(cls, n) for n in ("_prefill_fn", "_decode_fn")}

    def wrap(name, fn):
        @functools.wraps(fn)
        def inner(self, *a, **kw):
            k0, p0 = aimc_mvm.LAUNCHES["aimc_mvm_v2"], self.forward_passes
            state = self.rotation_state
            out = fn(self, *a, **kw)
            log.append((name, state, self.forward_passes - p0,
                        aimc_mvm.LAUNCHES["aimc_mvm_v2"] - k0))
            return out
        return inner

    for n, fn in orig.items():
        setattr(cls, n, wrap(n, fn))
    try:
        yield log
    finally:
        for n, fn in orig.items():
            setattr(cls, n, fn)


def state_leaf_rows(tree, names, state, dev):
    """K2 on layer 0's codes of every analog leaf of one rotation state's
    installed tree ([SLOTS x K], the path's fixed DAC scale), held to its
    plain version within 1e-5 x max(1, max|y|)."""
    import torch

    from repro_torch.core.aimc import AimcConfig
    from repro_torch.kernels import aimc_mvm, ref

    step = AimcConfig().adc_step
    gen = torch.Generator(device=dev).manual_seed(SEED + state)
    rows = []
    for path in names:
        st = tree["blocks"][path.split("/", 1)[1]]
        kb, m, np_ = st.w_q.shape[-3:]
        x = torch.zeros((SLOTS, kb * m), device=dev)
        x[:, :st.k] = torch.randn((SLOTS, st.k), generator=gen, device=dev)
        s_x = torch.full((1, 1), PLACE_SCALE, device=dev)
        y = aimc_mvm.aimc_mvm_v2(x, st.w_q[0], st.s_w[0], s_x, None, None,
                                 adc_step=step)
        want = ref.aimc_matmul_ref_v2(x, st.w_q[0], st.s_w[0], s_x, None,
                                      None, adc_step=step)
        torch.cuda.synchronize(dev)
        err = float((y - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        check(err <= tol, f"state {state} K2 {path}: max|err| {err} > {tol}")
        rows.append({"state": state, "proj": path, "K": st.k, "N": st.n,
                     "B": SLOTS, "max_abs_err": err, "tol": tol})
    return rows


def placement_phase(dev, card):
    """granite-8b at its published widths through `serve.main --placement
    auto:16128`: the 3-state rotation plan, K2 launches per pass matching
    the state in force, exact swap books, every state within the budget,
    each state's analog leaves held to their plain version, and each state
    bit-equal to a plain engine on its own tree."""
    import torch

    from repro_torch.core.placement import reconcile_swaps
    from repro_torch.core.tile import pack_contexts
    from repro_torch.kernels import aimc_mvm
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import ServeEngine, static_generate

    args = ["--arch", ARCH, "--exec", "aimc", "--requests", str(N_REQ),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--slots",
            str(SLOTS), "--decode-chunk", "1", "--seed", str(SEED),
            "--cores", "1", "--input-scale", f"{PLACE_SCALE:g}",
            "--placement", f"auto:{PLACE_BUDGET}", "--swap-every", "1",
            "--device", str(dev)]
    print(f"[placement] python -m repro_torch.launch.serve {' '.join(args)}",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    with k2_per_call(ServeEngine) as log:
        aimc_mvm.reset_counts()
        t0 = time.perf_counter()
        run = serve.main(args)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = dict(aimc_mvm.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    eng, rep, prog, res = run.engine, run.report, run.program, run.placement
    cfg, rot = eng.cfg, eng.rotation
    check(cfg.n_layers == 36 and cfg.d_model == 4096 and cfg.d_ff == 14336,
          "not the published granite-8b width")
    check(rot is not None and rot.hot == PLACE_HOT
          and rot.groups == PLACE_GROUPS and rot.digital == (),
          f"rotation plan {rot} is not the one the reference's algorithm "
          f"gives at budget {PLACE_BUDGET}")
    states = rot.states()
    print(f"[placement] {res.summary()}", flush=True)
    # K2 per pass = 36 x the stacks resident in the state in force
    want = {i: cfg.n_layers * len(ns) for i, ns in enumerate(states)}
    per_pass = {}
    for name, state, passes, k2 in log:
        check(passes > 0 and k2 == want[state] * passes,
              f"{name} under state {state}: {k2} K2 launches over {passes} "
              f"passes, want {want[state]} per pass")
        per_pass[state] = k2 // passes
    decodes = sum(p for n, _, p, _ in log if n == "_decode_fn")
    check(counts["aimc_mvm_v2"] == sum(k for *_, k in log)
          and sum(counts.values()) == counts["aimc_mvm_v2"],
          f"launches {counts} outside the logged passes")
    check(sorted(per_pass) == list(range(len(states))),
          f"not every state ran a pass: {per_pass}")
    print(f"[placement] K2 per pass by state {per_pass} (36 x resident "
          f"stacks), {len(log)} prefill/decode calls, {decodes} decode "
          f"passes; launches {counts}", flush=True)
    # swap books, budget, requests
    check(rep.n_swaps >= 1 and reconcile_swaps(prog, rep)
          and all(ev.initialize == prog.reprogram_counts(ev.incoming).initialize
                  for ev in rep.swap_events),
          f"swap books: {rep.n_swaps} swaps, reconcile "
          f"{reconcile_swaps(prog, rep)}")
    packs = []
    for ns in states:
        per = pack_contexts([c.item for c in res.costs if c.path in set(ns)],
                            rot.n_contexts, prog.cfg.tile_rows,
                            prog.cfg.tile_cols)
        packs.append(max(per))
    check(max(packs) <= PLACE_BUDGET, f"state packs {packs} > budget")
    check(len(rep.records) == N_REQ and all(
        len(r.tokens) == GEN and all(0 <= t < cfg.vocab for t in r.tokens)
        for r in rep.records.values()), "placement serve lost a request")
    walls = [ev.wall_s * 1e3 for ev in rep.swap_events]
    print(f"[placement] {rep.n_swaps} swaps, CM_INITIALIZE "
          f"{rep.swap_initialize} (books close), swap wall ms {walls}; "
          f"state packs {packs} <= {PLACE_BUDGET}; backing program "
          f"{prog.n_tiles} tiles, {sum(st.w_q.numel() for st in prog.states) / 1e9:.2f}"
          f" GB of codes", flush=True)
    # each state's analog leaves against their plain version
    raw = run.params_raw
    trees = [prog.install_subset(raw, ns) for ns in states]
    leaf_rows = [r for i, ns in enumerate(states)
                 for r in state_leaf_rows(trees[i], ns, i, dev)]
    worst = max(r["max_abs_err"] for r in leaf_rows)
    print(f"[placement] {len(leaf_rows)} state leaves through K2 vs plain: "
          f"max|err| {worst:.3g}", flush=True)
    # per state: a rotation engine that never swaps == a plain engine on
    # install_subset(states[i]), bit for bit
    kw = dict(n_slots=SLOTS, prompt_pad=PROMPT, max_seq=PROMPT + GEN,
              family=eng.family, module=eng.module, program=prog)
    still = dataclasses.replace(rot, swap_every=10 ** 6)
    per_state = []
    for i in range(len(states)):
        order = trees[i:] + trees[:i]
        r_eng = ServeEngine(eng.model, cfg, eng.exe, order[0], rotation=still,
                            rotation_params=order, **kw)
        r_eng.warmup()
        r_rep = r_eng.serve(run.requests)
        p_eng = ServeEngine(eng.model, cfg, eng.exe, trees[i], **kw)
        p_eng.warmup()
        p_rep = p_eng.serve(run.requests)
        same = all(r_rep.tokens(r.rid) == p_rep.tokens(r.rid)
                   for r in run.requests)
        check(r_rep.n_swaps == 0 and same,
              f"state {i}: non-swapping rotation engine != plain engine "
              f"({r_rep.n_swaps} swaps)")
        per_state.append({"state": i, "tokens_equal": same,
                          "tokens": {r.rid: p_rep.tokens(r.rid)
                                     for r in run.requests}})
        del r_eng, p_eng
    print(f"[placement] every state: a non-swapping rotation engine equals "
          f"a plain ServeEngine on install_subset(state) bit for bit", flush=True)
    # the reference's all-digital claim, reported without a gate
    prompts = torch.tensor([list(r.prompt) for r in run.requests],
                           dtype=torch.int32, device=dev)
    dig, _ = static_generate(eng.model, cfg,
                             dataclasses.replace(eng.exe, mode="digital"),
                             raw, prompts, GEN, max_seq=PROMPT + GEN,
                             cache_dtype=torch.float32)
    dig = dig.tolist()
    n_eq = sum(a == b for i, r in enumerate(run.requests)
               for a, b in zip(rep.tokens(r.rid), dig[i]))
    share = n_eq / (len(run.requests) * GEN)
    print(f"[placement] share of tokens equal to the all-digital "
          f"static_generate: {share:.3f} (not gated: the reference's "
          f"rotation == all-digital claim fails under jax 0.9.0 at its own "
          f"locked smoke; an analog layer is a different function)",
          flush=True)
    # decode step and profile per state
    times = {}
    for i in range(len(states)):
        eng._use_tree(i, trees[i])
        print(f"[placement] state {i} ({len(states[i])} stacks analog):",
              flush=True)
        times[i] = step_times(eng, run.requests[0].prompt)
    ms_step = rep.wall_decode_s / max(rep.n_steps, 1) * 1e3
    print(f"[placement] serve decode {ms_step:.2f} ms/step over "
          f"{rep.n_steps} steps; peak {peak_gb:.2f} GB on {card}", flush=True)
    return {"args": args, "wall_s": wall, "init_s": run.init_s,
            "summary": res.summary(), "rotation": rot.summary(),
            "states": [list(ns) for ns in states], "packs": packs,
            "launches": counts, "k2_per_pass": per_pass,
            "n_swaps": rep.n_swaps, "swap_initialize": rep.swap_initialize,
            "swap_wall_ms": walls, "leaf_rows": leaf_rows,
            "per_state_equal": per_state, "digital_token_share": share,
            "decode_ms_per_step": ms_step, "state_times": times,
            "peak_gb": peak_gb, "report": rep.summary()}


def server_phase(dev, card):
    """granite-8b and xlstm-350m at their published widths co-programmed on
    ONE TilePool through `serve.main --models/--tenants` (ci.sh's server
    traffic): every request's tokens equal its model's `static_generate`
    on its prompt alone, exact ledgers, no starved tenant, K2 per pass, the
    pool's tiles and labels, and the --tile-budget frontier."""
    import torch

    from repro_torch.core.program import CapacityError
    from repro_torch.core.tile import overlapping_placements
    from repro_torch.kernels import aimc_mvm
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import static_generate
    from repro_torch.runtime.server import build_server

    args = ["--models", SERVER_MODELS, "--tenants", SERVER_TENANTS,
            "--requests", str(SERVER_REQ), "--prompt-len", str(SERVER_PROMPT),
            "--gen", str(SERVER_GEN), "--slots", str(SERVER_SLOTS),
            "--trace", "poisson:200", "--seed", str(SEED), "--device",
            str(dev)]
    print(f"[server] python -m repro_torch.launch.serve {' '.join(args)}",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    aimc_mvm.reset_counts()
    t0 = time.perf_counter()
    run = serve.main(args)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = dict(aimc_mvm.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    srv, rep = run.server, run.report
    engines = srv.engines
    check(engines["granite-8b"].cfg.d_model == 4096
          and engines["xlstm-350m"].cfg.d_model == 1024,
          "not the published widths")
    passes = {m: e.forward_passes for m, e in engines.items()}
    k2 = sum(SERVER_K2_PER_PASS[m] * p for m, p in passes.items())
    check(counts["aimc_mvm_v2"] == k2
          and sum(counts.values()) == counts["aimc_mvm_v2"],
          f"launches {counts}, want K2 = 252 x {passes['granite-8b']} + "
          f"132 x {passes['xlstm-350m']} = {k2}")
    check(all(run.reconciled.values()), f"ledgers: {run.reconciled}")
    stats = rep.tenant_stats()
    check(all(st.generated_tokens > 0 for st in stats.values()
              if st.n_requests), "a tenant with requests was starved")
    pool = srv.pool
    own = sum(e.program.n_tiles for e in engines.values())
    labels = {p.matrix_id.split("/", 1)[0] for p in pool.placements()}
    check(pool.n_tiles == own and pool.labels == list(engines)
          and labels == set(engines)
          and not any(overlapping_placements(a.placements)
                      for a in pool.allocators),
          f"pool: {pool.n_tiles} tiles vs programs {own}, labels "
          f"{pool.labels} / {labels}")
    # every request against its model's static_generate on its prompt alone
    n_req = 0
    for m, mrep in rep.model_reports.items():
        e = engines[m]
        for rid, rec in mrep.records.items():
            prompt = torch.tensor([list(rec.request.prompt)],
                                  dtype=torch.int32, device=dev)
            out, _ = static_generate(e.model, e.cfg, e.exe, e.params, prompt,
                                     rec.request.max_new, max_seq=e.max_seq,
                                     cache_dtype=torch.float32)
            check(rec.tokens == out[0].tolist(),
                  f"{m} request {rid}: engine {rec.tokens} != "
                  f"static_generate {out[0].tolist()}")
            n_req += 1
    check(n_req == SERVER_REQ, f"{n_req} of {SERVER_REQ} requests served")
    fair = {m: rep.fairness(m) for m in engines}
    for st in stats.values():
        print(f"[server]   {st.row()}", flush=True)
    print(f"[server] {wall:.1f}s wall; {pool.summary()}; K2 {k2} = 252 x "
          f"{passes['granite-8b']} + 132 x {passes['xlstm-350m']} passes; "
          f"every request == static_generate alone; Jain {fair}; peak "
          f"{peak_gb:.2f} GB on {card}", flush=True)
    n_tiles = pool.n_tiles
    out = {"args": args, "wall_s": wall, "launches": counts,
           "forward_passes": passes, "pool": pool.summary(),
           "pool_tiles": n_tiles, "fairness": fair, "peak_gb": peak_gb,
           "tenants": {n: dataclasses.asdict(st) for n, st in stats.items()},
           "makespan_s": rep.makespan_s, "report": rep.summary()}
    del run, srv, rep, engines, pool
    gc.collect()
    torch.cuda.empty_cache()
    # the capacity frontier: one tile below the pair's pack refuses at
    # program time
    t0 = time.perf_counter()
    try:
        build_server(serve.parse_models(SERVER_MODELS),
                     serve.parse_tenants(SERVER_TENANTS,
                                         serve.parse_models(SERVER_MODELS)),
                     smoke=False, n_slots=SERVER_SLOTS,
                     prompt_pad=SERVER_PROMPT,
                     max_seq=SERVER_PROMPT + SERVER_GEN, seed=SEED,
                     tiles_per_context=n_tiles - 1, device=dev)
        refused = None
    except CapacityError as e:
        refused = str(e)
    check(refused is not None,
          f"--tile-budget {n_tiles - 1} did not raise CapacityError")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[server] --tile-budget {n_tiles - 1} refused at program time "
          f"({time.perf_counter() - t0:.1f}s): {refused}", flush=True)
    out["frontier"] = {"budget": n_tiles - 1, "refused": refused}
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
    static = phase("static", static_gate_phase, run, smi)
    del run                       # free granite's weights before the next
    free()
    init = phase("init", init_phase, dev, serve_stats["init_s"])
    fused = phase("fused serve", fused_serve_phase, dev)
    free()
    staged = phase("staged", staged_v1_phase, dev)
    paper, hw_launches = phase("paper nets", paper_nets_phase, dev)
    free()
    multicore = phase("multi-core", multicore_phase, dev, peaks)
    fidelity = phase("fidelity", fidelity_phase, dev)
    free()
    zoo, paged = {}, None
    for arch, prompt, layers in ZOO:
        zrun, zoo[arch] = phase(f"zoo {arch}", zoo_serve, dev, peaks, arch,
                                prompt, layers, smi)
        if arch == "llama3.2-3b":
            paged = phase("paged", paged_phase, dev, zrun, peaks, smi)
        del zrun
        free()
    recurrent = {"small_model_max_err": {
        arch: phase(f"small {arch}", small_model_phase, dev, arch)
        for arch in RECURRENT}}
    recurrent |= phase("recurrent", recurrent_phase, dev, peaks, smi)
    free()
    moe = phase("moe", moe_phase, dev, peaks, smi)
    free()
    resilience = phase("resilience", resilience_phase, dev, peaks, smi)
    free()
    int8 = phase("int8", int8_phase, dev, smi)
    free()
    placement = phase("placement", placement_phase, dev, smi)
    free()
    server = phase("server", server_phase, dev, smi)
    free()

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

    # per olmoe-1b-7b layer, one decode step (4 slots, 1 row per expert):
    # the expert launches of we_gate, we_up (its shape) and we_down
    olmoe = moe["olmoe-1b-7b"]
    by = {r["proj"]: r for r in olmoe["expert_rows"]
          if r["phase"] == "decode"}
    kx = {key: 2 * by["we_gate"][key] + by["we_down"][key]
          for key in ("ms", "plain_ms", "bound_ms")}
    kx["bound_by"] = by["we_gate"]["bound_by"]
    kx_err = max([r["max_abs_err"] for arch in ("olmoe-1b-7b", "arctic-480b")
                  for r in moe[arch]["expert_rows"]]
                 + [r["max_abs_err"] for r in resilience["b"]["probe_rows"]])
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
         "library_ms": None},
        {"name": "aimc_mvm_experts", "route": "cuda", "source": src_rel,
         "replaces": "src/repro/kernels/aimc_mvm.py:228",
         "launches": olmoe["launches"]["aimc_mvm_experts"],
         "max_abs_err": kx_err, "ms": kx["ms"], "plain_ms": kx["plain_ms"],
         "bound_ms": kx["bound_ms"], "bound_by": kx["bound_by"],
         "library_ms": None}]}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "torch": torch.__version__, "kernels": record,
        "build": build,
        "kernel_rows": rows, "v1_hw_kernel_rows": v1_rows,
        "hw_draws": hw_draws, "small_model_max_err": small_err,
        "serve": serve_stats, "stacked": stacked, "static": static,
        "fused_serve": fused, "moe": moe,
        "staged_v1": staged, "paper_nets": paper, "init": init,
        "multicore": multicore, "fidelity": fidelity, "zoo": zoo,
        "paged": paged, "recurrent": recurrent, "resilience": resilience,
        "int8": int8, "placement": placement, "server": server,
        "phase_seconds": seconds},
        indent=1))
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
