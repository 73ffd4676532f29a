#!/usr/bin/env python3
"""Where the MoE expert entry (`aimc_mvm.aimc_mvm_experts`) spends its time,
on one CUDA card, and which of its two bodies is faster at which shape.

    python3 tools/expert_profile.py [--reps N] [--experts E] [--rows C]
                                    [--no-sweep]

At olmoe-1b-7b's training shapes (E 64 experts of C 2560 rows, we_gate/
we_up [2048 -> 1024] (KB 4) and we_down [1024 -> 2048] (KB 2)), read noise
off and on (counter noise, a seed per expert), per shape and noise setting:

  * the entry's device ms (CUDA events, L2 read-flushed per launch, as
    `chip_smoke.time_ms`), its CUDA kernels' device ms by name
    (`torch.profiler`) and the launcher's plan;
  * the large-capacity body alone on the same DAC codes, whole and with
    parts of it left out (the measurement-only unit
    `csrc/aimc_experts_diag.cu`, built here on its own): "all"; "no_epi"
    (the TMA feed and the MACs; the epilogue only takes part in the
    hand-offs); "macs_only" (wgmma on whatever the ring holds, no feed);
    "loads_only" (the feed, no MACs); "epi_only" (the epilogue on the
    hand-offs alone); "handoffs" (none of the three); and, with noise,
    the whole body with each share of the draws the MMA warps take
    (`MMA_DRAWS`);
  * a yardstick for the int8 MACs in one launch: one `torch._int_mm` of
    [E*C x K] x [K x N], the same MACs with one weight for every row (the
    port never calls it; a grouped GEMM moves more weight bytes, so this is
    a lower bound on one);
  * the draws alone at full occupancy (`aimc_experts_draw_bench`) and the
    torch ops `core.aimc.aimc_apply_experts` runs around the entry (the f32
    cast of a bf16 x, `sym_scale`'s per-expert amax);
  * the bounds: bytes and int8 operations at the card's peaks, and the
    draw floor (`chip_smoke.expert_bound_terms`).

The build's ptxas registers and spills and the SASS instructions of one
epilogue element (the diag unit's never-launched probes: a diagnostic of
this build, not a bound) are printed with them, and the card's name, power
limit and SM clocks (also sampled while the noise-on entry runs).

The sweep (skipped with --no-sweep) runs both bodies through the library's
C entry on the same operands, holds them to each other bit for bit and
times them in turns (mma, wide, wide, mma) at the small-capacity shapes
the paths run (olmoe's and arctic's serving stacks, granite-8b's [36]
probe stacks at B 2) and across the threshold of `expert_body`'s rule
(olmoe we_gate and we_down at E 64 and E 8 over C 16..512). Results go to
chiprun_out/expert_profile.json, the probes' SASS to
chiprun_out/expert_probe.sass.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = (("we_gate", 2048, 1024), ("we_down", 1024, 2048))
SIGMA, TILE = 57.5, 512
# the body's parts (csrc/aimc_experts.cuh): TMA feed, MACs, epilogue
PARTS = {"all": 7, "no_epi": 3, "macs_only": 2, "loads_only": 1,
         "epi_only": 4, "handoffs": 0}
MMA_DRAWS = range(6)      # the MMA group's share of the draws, of 8
EPILOGUE_PROBES = {"adc": ("aimc_probe_adc1", "aimc_probe_adc2"),
                   "draw_adc": ("aimc_probe_draw1", "aimc_probe_draw2")}


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]


def build_diag() -> Path:
    """nvcc the measurement-only unit into a library of its own, beside
    the kernel library, with the library's flags."""
    from repro_torch.kernels import aimc_mvm
    src = aimc_mvm._CSRC / "aimc_experts_diag.cu"
    out = aimc_mvm._BUILD / "libaimc_experts_diag.so"
    aimc_mvm._BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=aimc_mvm._BUILD) as tmp:
        so = Path(tmp) / "diag.so"
        proc = subprocess.run([aimc_mvm._nvcc(), *aimc_mvm.NVCC_FLAGS, "-o",
                               str(so), str(src)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
        so.replace(out)
    return out


def hot_path_length(code: list) -> int:
    """Instructions issued on a function's hot path: from its entry to its
    unpredicated EXIT, taking every forward branch (each slow path of the
    division and sqrtf is skipped by a branch taken on the fast path, or
    called as a subroutine past EXIT) and falling through every
    backward one. ``code``: (address, predicate, text) in order."""
    at = {addr: i for i, (addr, _, _) in enumerate(code)}
    i, count = 0, 0
    while i < len(code) and count <= len(code):
        addr, pred, text = code[i]
        count += 1
        if text.startswith("EXIT") and not pred:
            return count
        m = re.match(r"BRA\s+(?:!?U?P\w+\s*,\s*)?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) > addr:
            i = at[int(m.group(1), 16)]
            continue
        i += 1
    raise RuntimeError("no EXIT on the hot path of a probe")


def epilogue_sass(sass: str) -> dict:
    """SASS instructions of one element of the wide body's epilogue in this
    build, from the diag unit's never-launched probes: the two-element
    probe's hot path (`hot_path_length`) less the one-element probe's.
    "adc": ADC and dequant of a noise-off accumulator; "draw_adc": with
    the counter draw."""
    funcs: dict = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z][^;]*);", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    hot = {name: hot_path_length(code) for name, code in funcs.items()
           if name.startswith("aimc_probe")}
    out = {}
    for key, (one, two) in EPILOGUE_PROBES.items():
        out[key] = hot[two] - hot[one]
        out[f"{key}_probe_hot"] = [hot[one], hot[two]]
    return out


def kernel_ms(fn, launches: int = 5) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` issues, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t:
            out[ev.key] = out.get(ev.key, 0.0) + t / 1e3 / launches
    return out


def draw_bench_ms(diag, dev, draws: int, sigma: float, step: float,
                  flush, reps: int) -> float:
    """Device ms of ``draws`` noise-on epilogue elements alone, 16 blocks
    of 256 threads per SM (`aimc_experts_draw_bench`)."""
    import chip_smoke as cs
    import torch
    fn = diag.aimc_experts_draw_bench
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * 16
    per_thread = -(-draws // (blocks * 256 * 4)) * 4
    out = torch.empty(blocks * 256, device=dev)

    def launch():
        err = fn(out.data_ptr(), blocks, per_thread, sigma, step,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"aimc_experts_draw_bench: CUDA error {err}")
    return cs.time_ms(launch, flush, reps) * draws / (blocks * 256 *
                                                       per_thread)


def part_fn(lib, diag, x, w_q, s_w, s_x, seeds, *, step, sigma, part,
            draw=-1):
    """The wide body alone with the parts in ``part`` (and, whole with
    noise, the MMA group's share ``draw`` of the draws, n8 blocks of 8; -1
    the library's) on DAC codes made once by the library's
    `aimc_dac_launch`."""
    import torch

    from repro_torch.kernels.aimc_mvm import _device_seeds
    e, kb, m, np_ = w_q.shape
    c = x.shape[1]
    mp = -(-m // 128) * 128
    stream = torch.cuda.current_stream().cuda_stream
    codes = torch.empty(e * c * kb * mp, dtype=torch.int8, device=x.device)
    lib.aimc_dac_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    err = lib.aimc_dac_launch(x.data_ptr(), s_x.data_ptr(), codes.data_ptr(),
                              e * c, kb, m, mp, c, stream)
    if err:
        raise RuntimeError(f"aimc_dac_launch: CUDA error {err}")
    dseeds = _device_seeds(seeds, e, x.device) if sigma > 0.0 else None
    out = torch.empty((e, c, np_), device=x.device)
    fn = diag.aimc_experts_part_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
                   + [ctypes.c_int] * 3)
    fn.restype = ctypes.c_int

    def launch():
        err = fn(codes.data_ptr(), w_q.data_ptr(), s_w.data_ptr(),
                 s_x.data_ptr(),
                 dseeds.data_ptr() if dseeds is not None else None,
                 out.data_ptr(), c, kb, m, np_, e, step, sigma,
                 torch.cuda.current_stream().cuda_stream, part,
                 1 if sigma > 0.0 else 0, draw)
        if err:
            raise RuntimeError(f"aimc_experts_part_launch(part {part}): "
                               f"CUDA error {err}")
        return out
    return launch


def rounded(ms: dict) -> str:
    return json.dumps({k: round(v, 4) for k, v in ms.items()})


def clocks_while(fn, seconds: float = 2.0) -> list:
    """nvidia-smi's SM clock and power, sampled while ``fn`` runs back to
    back."""
    import threading
    import time

    import torch
    samples = []

    def sample():
        t = time.time()
        while time.time() - t < seconds:
            samples.append(smi("clocks.sm,power.draw"))
            time.sleep(0.1)
    th = threading.Thread(target=sample)
    th.start()
    while th.is_alive():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    th.join()
    return samples


def body_call(lib, x, w_q, s_w, s_x, seeds, *, step, sigma, body):
    """One launch of the library's expert entry with ``body`` (0 "mma",
    1 "wide") forced, as the wrapper would issue it."""
    import torch

    from repro_torch.kernels import aimc_mvm
    e, kb, m, np_ = w_q.shape
    c = x.shape[1]
    need = ctypes.c_longlong(0)
    lib.aimc_mvm_experts_plan(c, kb, m, np_, e, body, ctypes.byref(need))
    work = torch.empty(max(int(need.value), 16), dtype=torch.uint8,
                       device=x.device)
    dseeds = (aimc_mvm._device_seeds(seeds, e, x.device) if sigma > 0.0
              else None)
    out = torch.empty((e, c, np_), device=x.device)
    fast = int(body == 1 and aimc_mvm.fast_epilogue(x.device.index or 0,
                                                    step))
    err = lib.aimc_mvm_experts_launch(
        x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(), s_x.data_ptr(),
        dseeds.data_ptr() if dseeds is not None else None, out.data_ptr(),
        c, kb, m, np_, e, step, sigma,
        torch.cuda.current_stream().cuda_stream, work.data_ptr(), np_, 0,
        np_, body, fast)
    if err:
        raise RuntimeError(f"expert launch (body {body}): CUDA error {err}")
    return out


def sweep_shapes():
    """(label, E, C, K, N): the small-capacity stacks the paths run, and
    olmoe's projections across expert_body's threshold."""
    out = [(f"olmoe serve {p} C={c}", 64, c, k, n) for c in (1, 2)
           for p, k, n in SHAPES]
    out += [(f"arctic serve {p}", 128, 1, k, n) for p, k, n in
            (("we_gate", 7168, 4864), ("we_down", 4864, 7168))]
    out += [(f"granite probe {p}", 36, 2, k, n) for p, k, n in
            (("wq", 4096, 4096), ("wk", 4096, 1024),
             ("w_gate", 4096, 14336), ("w_down", 14336, 4096))]
    out += [(f"olmoe {p} E {e} C={c}", e, c, k, n)
            for e, cs_ in ((64, (16, 32, 48, 64, 96, 128)),
                           (8, (64, 128, 256, 512)))
            for c in cs_ for p, k, n in SHAPES]
    return out


def sweep(lib, dev, flush, gen, reps, step):
    """Both bodies at `sweep_shapes`, noise off and on: bit-equal, timed
    in turns."""
    import chip_smoke as cs
    import torch

    from repro_torch.core.quant import sym_scale
    from repro_torch.kernels import aimc_mvm
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, e, c, k, n in sweep_shapes():
        kb, m = -(-k // TILE), TILE
        w_q = torch.randint(-127, 128, (e, kb, m, n), generator=gen,
                            device=dev, dtype=torch.int8)
        s_w = torch.rand((e, kb, n), generator=gen, device=dev) * 1e-3
        x = torch.zeros((e, c, kb * m), device=dev)
        x[:, :, :k] = torch.randn((e, c, k), generator=gen, device=dev)
        s_x = sym_scale(x.reshape(e, -1), dim=1).reshape(e)
        seeds = torch.randint(0, 2**31, (e,), generator=gen,
                              device=dev).tolist()
        rule = aimc_mvm.expert_body(c, kb, m, n, e, sms)
        for sigma in (0.0, SIGMA):
            mma, wide = (functools.partial(
                body_call, lib, x, w_q, s_w, s_x, seeds, step=step,
                sigma=sigma, body=b) for b in (0, 1))
            equal = bool(torch.equal(mma(), wide()))
            t_mma = [cs.time_ms(mma, flush, reps)]
            t_wide = [cs.time_ms(wide, flush, reps) for _ in range(2)]
            t_mma.append(cs.time_ms(mma, flush, reps))
            row = {"shape": name, "E": e, "C": c, "K": k, "N": n,
                   "sigma": sigma, "bit_equal": equal, "rule": rule,
                   "mma_ms": sum(t_mma) / 2, "wide_ms": sum(t_wide) / 2,
                   "mma_runs": t_mma, "wide_runs": t_wide}
            rows.append(row)
            print(f"[sweep] {name} E {e} x [{c}x{k}]x[{k}x{n}] sigma "
                  f"{sigma}: {'bit-equal' if equal else 'DIFFER'}; mma "
                  f"{row['mma_ms']:.4f} {t_mma}, wide {row['wide_ms']:.4f} "
                  f"{t_wide} (mma/wide {row['mma_ms'] / row['wide_ms']:.2f}"
                  f"x); expert_body -> {rule}", flush=True)
        del w_q, s_w, x
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--experts", type=int, default=64)
    ap.add_argument("--rows", type=int, default=2560)
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.core.quant import adc_step_lsb, sym_scale
    from repro_torch.kernels import aimc_mvm

    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    clocks = smi("clocks.sm,clocks.max.sm")
    print(f"[profile] {card}; SM clock now, max: {clocks}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    lib_path = aimc_mvm.build()
    lib = aimc_mvm._load()
    diag_path = build_diag()
    diag = ctypes.CDLL(str(diag_path))
    build = cs.build_report(aimc_mvm.BUILD_LOG.get("report", ""),
                            cs.sass_listing(lib_path))
    diag_sass = cs.sass_listing(diag_path)
    probes = epilogue_sass(diag_sass)
    print(f"[profile] SASS per epilogue element in this build: {probes}",
          flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    keep, chunks = False, []
    for line in diag_sass.splitlines():
        if "Function :" in line:
            keep = "aimc_probe" in line
        if keep:
            chunks.append(line)
    (out_dir / "expert_probe.sass").write_text("\n".join(chunks) + "\n")
    max_mhz = float(re.findall(r"[\d.]+", clocks)[-1])
    cs.DRAW_COST["sm_mhz"] = max_mhz

    peaks = cs.peaks_for(torch.cuda.get_device_name(0))
    flush = cs.flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(27)
    step = adc_step_lsb(TILE, 1.0)
    e, c = args.experts, args.rows
    rows = []
    for name, k, n in SHAPES:
        kb, m, np_ = k // TILE, TILE, n
        w_q = torch.randint(-127, 128, (e, kb, m, np_), generator=gen,
                            device=dev, dtype=torch.int8)
        s_w = torch.rand((e, kb, np_), generator=gen, device=dev) * 1e-3
        x16 = torch.randn((e, c, k), generator=gen, device=dev).to(
            torch.bfloat16)
        x = x16.to(torch.float32)
        s_x = sym_scale(x.reshape(e, -1), dim=1).reshape(e)
        seeds = torch.randint(0, 2**31, (e,), generator=gen,
                              device=dev).tolist()
        around = {
            "bf16_to_f32_ms": cs.time_ms(lambda: x16.to(torch.float32),
                                         flush, args.reps),
            "sym_scale_ms": cs.time_ms(
                lambda: sym_scale(x.reshape(e, -1), dim=1), flush, args.reps)}
        codes = torch.round(x / s_x[:, None, None]).clamp(-127, 127).to(
            torch.int8).reshape(e * c, k)
        # cuBLASLt's int8 GEMM takes B column-major
        w2 = w_q[0].reshape(k, np_).t().contiguous()
        int_mm = cs.time_ms(lambda: torch._int_mm(codes, w2.t()), flush,
                            args.reps)
        del codes, w2
        for sigma in (0.0, SIGMA):
            kern = functools.partial(
                aimc_mvm.aimc_mvm_experts, x, w_q, s_w, s_x,
                seeds if sigma > 0.0 else None, adc_step=step, sigma=sigma)
            y = kern()
            ms = cs.time_ms(kern, flush, args.reps)
            by_kernel = kernel_ms(kern)
            terms = cs.expert_bound_terms(e, c, kb, m, np_, peaks, sigma)
            parts = {}
            for label, part in PARTS.items():
                fn = part_fn(lib, diag, x, w_q, s_w, s_x, seeds, step=step,
                             sigma=sigma, part=part)
                if label == "all":
                    ok = bool(torch.equal(fn(), y))
                    if not ok:
                        raise SystemExit(f"{name} sigma {sigma}: the diag "
                                         f"body differs from the entry's")
                parts[label] = cs.time_ms(fn, flush, args.reps)
            # the MMA group's share of the draws, n8 blocks of 8
            for draw in MMA_DRAWS if sigma > 0.0 else ():
                fn = part_fn(lib, diag, x, w_q, s_w, s_x, seeds, step=step,
                             sigma=sigma, part=7, draw=draw)
                if not torch.equal(fn(), y):
                    raise SystemExit(f"{name}: MMA share {draw} differs "
                                     f"from the entry's")
                parts[f"all_mma_draws_{draw}_of_8"] = cs.time_ms(
                    fn, flush, args.reps)
            row = {"proj": name, "E": e, "C": c, "K": k, "N": n, "KB": kb,
                   "sigma": sigma, "ms": ms, "kernels_ms": by_kernel,
                   "plan": aimc_mvm.launch_plan(dev, c, kb, m, np_, e,
                                                experts=True),
                   "bound_terms_ms": terms, "parts_ms": parts,
                   "int_mm_one_launch_ms": int_mm, **around}
            if sigma > 0.0:
                row["draws_alone_ms"] = draw_bench_ms(
                    diag, dev, e * c * np_ * kb, sigma, step, flush,
                    args.reps)
                row["clocks_under_load"] = clocks_while(kern)
                print(f"[profile] draws alone at full occupancy: "
                      f"{row['draws_alone_ms']:.4f} ms; SM clock, power "
                      f"while the entry runs: "
                      f"{row['clocks_under_load'][2:5]}", flush=True)
            rows.append(row)
            print(f"[profile] {name} E {e} x [{c}x{k}]x[{k}x{n}] sigma "
                  f"{sigma}: {ms:.4f} ms ({cs.plan_str(row['plan'])}); by "
                  f"kernel {rounded(by_kernel)}; body parts "
                  f"{rounded(parts)}; bounds {rounded(terms)}; "
                  f"one _int_mm [{e * c}x{k}]x[{k}x{n}] {int_mm:.4f} ms; "
                  f"bf16->f32 {around['bf16_to_f32_ms']:.4f} ms, sym_scale "
                  f"{around['sym_scale_ms']:.4f} ms on {card}", flush=True)
            del y
        del w_q, s_w, x, x16
        torch.cuda.empty_cache()
    sweep_rows = ([] if args.no_sweep else
                  sweep(lib, dev, flush, gen, max(3, args.reps // 2), step))
    (out_dir / "expert_profile.json").write_text(json.dumps(
        {"card": card, "clocks_sm_now_max": clocks, "build": build,
         "epilogue_sass": probes, "rows": rows, "sweep": sweep_rows},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
