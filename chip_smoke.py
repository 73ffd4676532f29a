#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: serve granite-8b at its published
width on programmed AIMC crossbars through the hand-written Hopper kernels.

    python3 chip_smoke.py        # one CUDA card; exits non-zero without one

Phases (any failure exits non-zero; nothing falls back to a plain version):
  1. build — nvcc builds the kernel library from src/repro_torch/kernels/csrc
     (sm_90a) and the compiler's register/spill report is printed.
  2. kernels — K2 (`aimc_mvm_v2`) and K3 (`aimc_mvm_stacked`) at every
     granite-8b projection shape, at the decode slot count and the prompt
     pad, noise off and on, every epilogue with a bias: each held against
     its plain PyTorch version (`kernels/ref.py`) on the same CUDA tensors
     within |err| <= 1e-5 * max(1, max|y|) (f32 association of the
     row-block sum), and timed with CUDA events, L2 flushed per launch.
  3. small model — the granite smoke config served on the card (kernels);
     its prefill logits within 1e-4 of the same programmed weights run on
     the CPU (plain versions).
  4. serve — `repro_torch.launch.serve.main` on the published granite-8b
     config (36 layers, d_model 4096, 32/8 heads, d_ff 14336, vocab 49152),
     --exec aimc, 4 Poisson requests, prompt 16, gen 8, 4 slots. Launch
     counts are zeroed just before and read just after: K2 must have run
     7 x 36 x forward passes; the CM_* ledgers must reconcile exactly.
  5. stacked — `fuse_gate_stacks` on the installed parameters: prefill
     logits and served tokens (all requests at t=0, so both runs decode the
     same batches) bit-equal to the unfused run; K3 runs 36 x passes.
  6. fused serve — the phase-4 command with --fuse-gates, launch counts
     zeroed just before and read just after: K3 36 x passes, K2 5 x 36 x
     passes, ledgers reconcile. K3's launch count in the record is this
     run's; K2's is phase 4's.

The last two lines are the card's nvidia-smi name/power limit and the
contract line {"ok": true, "device": {...}}; the line before them is the
per-kernel JSON record. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
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
NOISE_SEED, NOISE_SIGMA = 0xC0FFEE, 57.5     # sigma: read_sigma_lsb(512)
KERNEL_REPS = 20
# published dense peaks of the card (data sheets): bytes/s, int8 ops/s
PEAKS = {"H200": (4.8e12, 1979e12), "H100 PCIe": (2.0e12, 1513e12),
         "H100": (3.35e12, 1979e12)}


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


def time_ms(fn, flush, reps: int) -> float:
    """Mean device time of ``fn`` with the L2 cache flushed before each
    launch (decode reads each weight panel once per step, cold). The flush
    READS a 64 MB buffer: a write would leave dirty lines whose write-back
    the timed kernel would pay."""
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


def bound_ms(b, k_pad, np_, g, peaks, bias: bool):
    """Least time for the same work: bytes moved once (x, w_q, s_w, s_x,
    bias, out) over the memory rate vs int8 MACs over the int8 rate."""
    kb = k_pad // 512
    nbytes = (b * k_pad * 4 + g * (k_pad * np_ + kb * np_ * 4)
              + g * b * np_ * 4 + 4 + (g * np_ * 4 if bias else 0))
    ops = 2 * g * b * k_pad * np_
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, ops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(dev, peaks, slots: int, prompt_pad: int):
    import torch

    from repro_torch.core.aimc import AimcConfig, program_stacked
    from repro_torch.core.quant import sym_scale
    from repro_torch.kernels import aimc_mvm, cprng, ref

    cfg = AimcConfig()
    step = cfg.adc_step
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
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
        np_ = st.w_q.shape[-1]
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
                       "B": b, "sigma": sigma, "max_abs_err": err, "tol": tol}
                if sigma == 0.0:
                    row["ms"] = time_ms(kern, flush, KERNEL_REPS)
                    row["plain_ms"] = time_ms(plain, flush, 3)
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        b, k, np_, g, peaks, bias=True)
                rows.append(row)
                print(f"[kernels] {kname} {name} [{b}x{k}]x[{k}x{n}]"
                      f"{f' G={g}' if g > 1 else ''} sigma={sigma}: max|err| "
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
    return rows, worst


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


def step_times(eng, prompt):
    """Host-clock times of one synchronised [1 x prompt_pad] prefill and one
    decode step with every slot busy, and a torch.profiler trace of that
    decode step: device-busy time (union of kernel intervals), idle share
    and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = eng.device
    tokens, vl = eng._pad_prompt(prompt)

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t) / reps * 1e3, out

    prefill_ms, (tok1, cache1) = timed(lambda: eng._prefill_fn(tokens, vl))
    sess = eng.begin()
    for slot in range(eng.n_slots):
        eng._insert(sess, cache1, tok1, slot, int(vl[0]), GEN)

    def step():
        return eng._decode_fn(sess.cache, sess.tok_buf, sess.state, 1)

    decode_ms, _ = timed(step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
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
    out = {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
           "decode_tok_s": eng.n_slots / decode_ms * 1e3,
           "profiled_step_ms": wall_us / 1e3,
           "device_busy_ms": busy_us / 1e3 if spans else None,
           "device_idle_share": 1.0 - busy_us / wall_us if spans else None,
           "top_kernels_ms": {n[:80]: v / 1e3 for n, v in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:6]}}
    print(f"[times] prefill [1x{len(tokens[0])}] {prefill_ms:.2f} ms; decode "
          f"step [{eng.n_slots} slots] {decode_ms:.2f} ms "
          f"({out['decode_tok_s']:.1f} tok/s); profiled step "
          f"{out['profiled_step_ms']:.2f} ms, device busy "
          + (f"{out['device_busy_ms']:.2f} ms (idle share "
             f"{out['device_idle_share']:.2f})" if spans else
             "not measured (profiler saw no device events)"), flush=True)
    for n, v in out["top_kernels_ms"].items():
        print(f"[times]   {v:8.3f} ms  {n}", flush=True)
    return out


def serve_phase(dev):
    import torch

    from repro_torch.kernels import aimc_mvm
    from repro_torch.launch import serve
    from repro_torch.runtime.batcher import reconcile

    args = ["--arch", ARCH, "--exec", "aimc", "--requests", str(N_REQ),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--slots",
            str(SLOTS), "--trace", f"poisson:{RATE:g}", "--seed", str(SEED),
            "--device", str(dev)]
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
             "peak_gb": peak_gb, **times,
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

    t0 = time.perf_counter()
    lib = aimc_mvm.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f}s\n"
          f"{aimc_mvm.BUILD_LOG.get('report', '(cached build)')}", flush=True)

    rows, worst = kernel_phase(dev, peaks, SLOTS, PROMPT)
    torch.cuda.empty_cache()
    small_err = small_model_phase(dev)
    run, serve_stats = serve_phase(dev)
    stacked = stacked_phase(run)
    del run                       # free granite's weights before the next
    gc.collect()                  # (the engine holds a reference cycle)
    torch.cuda.empty_cache()
    fused = fused_serve_phase(dev)

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
         "bound_by": k3["bound_by"], "library_ms": None}]}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "torch": torch.__version__, "kernels": record,
        "kernel_rows": rows, "small_model_max_err": small_err,
        "serve": serve_stats, "stacked": stacked, "fused_serve": fused},
        indent=1))
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
