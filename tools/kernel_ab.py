#!/usr/bin/env python3
"""A/B of the AIMC MVM kernel library against another checkout's, on one
CUDA card: both libraries get the same operands at every shape the port's
main paths run (granite-8b at decode and prompt pad, K3's w_gu stack, the
paper nets' MVMs at their published widths), with read noise off, counter
noise, Philox ("hw") noise and K1's explicit noise operand; and the MoE
expert entry at every expert shape the paths run (olmoe-1b-7b's training
projections at E 64 x C 2560 whole and per data:2,model:2 position, E 32;
olmoe's and arctic-480b's serving stacks at decode and prefill capacity;
granite-8b's [36] health-probe stacks at B 2; a ragged C 333 and E 20,
each with the tiles that send it to the wide body),
noise off and with counter noise and a seed per expert. Each output of
this checkout must equal the other's bit for bit; both are timed in turns
(other, this, this, other; CUDA events, L2 read-flushed per launch).

    python3 tools/kernel_ab.py --other DIR
        [--other-abi bodies|cols|work|pre-work] [--draws-differ]

``--draws-differ``: the other tree draws its read noise with other
functions (before `csrc/f32math.cuh`, its Box-Muller ran the card's
`logf` and `cosf`), so the rows with counter or "hw" noise differ from it
by design: they are timed and their differences reported, and only the
rows that draw nothing (noise off, K1's explicit operand) must be
bit-equal.

DIR is the root of the other tree (its `csrc/aimc_mvm.cu`, and
`aimc_experts.cu` where it has one, are built into one library). Its
kernel is called through the C entry point of its time: ``bodies`` (the
default) is the entry since the expert entry has two bodies, whose
`aimc_mvm_experts_plan` and `aimc_mvm_experts_launch` take the body this
tree's `expert_body` chose and its launch a trailing flag for the wide
body's branch-free epilogue, set where the other library's own
`aimc_experts_check` passes; ``cols`` is `aimc_mvm_launch` with the
trailing workspace pointer, row stride, column offset and state width, and
`aimc_mvm_experts_launch` with the same trailing arguments (the entries
since column pieces came in); ``work`` is `aimc_mvm_launch` with the
workspace pointer alone, ``pre-work`` the entry before the workspace
(neither has the expert entry's seeds: no expert cases). This tree's
kernels run through their wrappers with the column-piece arguments at
their defaults (the whole state); each expert row records the body this
tree's `expert_body` chose. Results go to chiprun_out/kernel_ab.json.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build_other(other: Path, abi: str) -> ctypes.CDLL:
    from repro_torch.kernels import aimc_mvm
    csrc = other / "src" / "repro_torch" / "kernels" / "csrc"
    units = [str(csrc / u) for u in ("aimc_mvm.cu", "aimc_experts.cu")
             if (csrc / u).exists()]
    out = ROOT / "chiprun_out" / "ab_build" / "libaimc_mvm_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([aimc_mvm._nvcc(), *aimc_mvm.NVCC_FLAGS, "-o",
                           str(out), *units], capture_output=True,
                          text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {units}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.aimc_mvm_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_uint, ctypes.c_int,
           ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
        + ([ctypes.c_void_p] if abi != "pre-work" else [])
        + ([ctypes.c_int] * 3 if abi in ("bodies", "cols") else []))
    lib.aimc_mvm_launch.restype = ctypes.c_int
    plans = [(lib.aimc_mvm_plan, 5)] if abi != "pre-work" else []
    if abi in ("bodies", "cols"):
        ex = lib.aimc_mvm_experts_launch
        ex.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                          ctypes.c_void_p]
                       + [ctypes.c_int] * (5 if abi == "bodies" else 3))
        ex.restype = ctypes.c_int
        plans.append((lib.aimc_mvm_experts_plan, 6 if abi == "bodies" else 5))
    if abi == "bodies":
        lib.aimc_experts_check.argtypes = [ctypes.c_float, ctypes.c_void_p,
                                           ctypes.c_void_p]
        lib.aimc_experts_check.restype = ctypes.c_int
    for plan, ints in plans:
        plan.argtypes = ([ctypes.c_int] * ints
                         + [ctypes.POINTER(ctypes.c_longlong)])
        plan.restype = ctypes.c_int
    lib.abi = abi
    lib.fast = {}
    return lib


def other_fast(lib, adc_step: float, device) -> int:
    """1 where the other library's own check of its wide body's branch-free
    epilogue (`aimc_experts_check`, as `aimc_mvm.check_fast_paths` reads
    it) passes at ``adc_step``, else 0; once per step. Its counts come
    first and the least |cos| last: 4 slots in a library with the
    `aimc_draws` export, 5 before (a cosine column, since dropped)."""
    import torch
    if adc_step not in lib.fast:
        n = 4 if hasattr(lib, "aimc_draws") else 5
        bad = torch.zeros(n, dtype=torch.int64, device=device)
        bad[n - 1] = 0x7F800000
        err = lib.aimc_experts_check(float(adc_step), bad.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"other aimc_experts_check: CUDA error {err}")
        v = bad.tolist()
        lib.fast[adc_step] = int(not any(v[:-1]) and v[-1] != 0)
    return lib.fast[adc_step]


def other_call(lib, x, w_q, s_w, s_x, seed, bias, noise, *, adc_step, sigma,
               acts, stacked, philox):
    """One launch of the other library; w_q [G, KB, M, Np]."""
    import torch

    from repro_torch.kernels.aimc_mvm import _ACT_CODES
    g, kb, m, np_ = w_q.shape
    out = torch.empty((g, x.shape[0], np_), dtype=torch.float32,
                      device=x.device)
    packed = 0
    for i, a in enumerate(acts):
        packed |= _ACT_CODES[a] << (2 * i)
    extra = []
    if lib.abi != "pre-work":
        need = ctypes.c_longlong(0)
        lib.aimc_mvm_plan(x.shape[0], kb, m, np_, g, ctypes.byref(need))
        work = torch.empty(max(int(need.value), 16), dtype=torch.uint8,
                           device=x.device)
        extra = [work.data_ptr()] + ([np_, 0, np_]
                                     if lib.abi in ("bodies", "cols")
                                     else [])
    err = lib.aimc_mvm_launch(
        x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(), s_x.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        noise.data_ptr() if noise is not None else None, out.data_ptr(),
        x.shape[0], kb, m, np_, g, float(adc_step), float(sigma),
        int(seed) & 0xFFFFFFFF, int(stacked), packed, int(philox),
        torch.cuda.current_stream().cuda_stream, *extra)
    if err:
        raise RuntimeError(f"other library launch failed: CUDA error {err}")
    return out


def other_experts_call(lib, x, w_q, s_w, s_x, seeds, *, adc_step, sigma):
    """One expert-entry launch of the other library (its entry with the
    trailing row stride, column offset and state width):
    x [E, C, KB*M], w_q [E, KB, M, Np], s_x [E], ``seeds`` E host ints or
    None, uploaded as this tree's wrapper uploads them (and as the other
    tree's did), so both timings hold the same host-to-device copy."""
    import torch

    from repro_torch.kernels import aimc_mvm
    from repro_torch.kernels.aimc_mvm import _device_seeds
    e, kb, m, np_ = w_q.shape
    if seeds is not None:
        seeds = _device_seeds(seeds, e, x.device)
    c = x.shape[1]
    out = torch.empty((e, c, np_), dtype=torch.float32, device=x.device)
    need = ctypes.c_longlong(0)
    body = []
    if lib.abi == "bodies":
        plan = aimc_mvm.launch_plan(x.device, c, kb, m, np_, e, experts=True)
        body = [aimc_mvm.EXPERT_BODIES.index(plan["body"])]
    lib.aimc_mvm_experts_plan(c, kb, m, np_, e, *body, ctypes.byref(need))
    work = torch.empty(max(int(need.value), 16), dtype=torch.uint8,
                       device=x.device)
    if body:
        body.append(other_fast(lib, adc_step, x.device))
    err = lib.aimc_mvm_experts_launch(
        x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(), s_x.data_ptr(),
        seeds.data_ptr() if seeds is not None else None, out.data_ptr(), c,
        kb, m, np_, e, float(adc_step), float(sigma),
        torch.cuda.current_stream().cuda_stream, work.data_ptr(), np_, 0,
        np_, *body)
    if err:
        raise RuntimeError(f"other library's expert launch failed: CUDA "
                           f"error {err}")
    return out


def expert_shapes():
    """(name, E, C, K, N) of every expert-entry shape the paths run."""
    olmoe = (("we_gate", 2048, 1024), ("we_down", 1024, 2048))
    arctic = (("we_gate", 7168, 4864), ("we_down", 4864, 7168))
    granite = (("wq", 4096, 4096), ("wk", 4096, 1024),
               ("w_gate", 4096, 14336), ("w_down", 14336, 4096))
    out = [(f"olmoe train {p}", 64, 2560, k, n) for p, k, n in olmoe]
    out += [(f"olmoe train piece {p}", 32, 2560, k, n) for p, k, n in olmoe]
    out += [(f"olmoe serve {p} C={c}", 64, c, k, n) for c in (1, 2)
            for p, k, n in olmoe]
    out += [(f"arctic serve {p}", 128, 1, k, n) for p, k, n in arctic]
    out += [(f"granite probe {p}", 36, 2, k, n) for p, k, n in granite]
    out += [("ragged C 333", 64, 333, 1024, 1024),
            ("E 20", 20, 128, 1536, 4096)]
    return out


def expert_rows(other, dev, flush, gen, reps, draws_differ=False):
    """The expert entry of both libraries at `expert_shapes`, noise off and
    with counter noise and E seeds: bit-equal (noise off only, under
    ``draws_differ``), timed in turns."""
    import torch

    import chip_smoke as cs
    from repro_torch.core.quant import adc_step_lsb, sym_scale
    from repro_torch.kernels import aimc_mvm
    step = adc_step_lsb(512, 1.0)
    rows = []
    for name, e, c, k, n in expert_shapes():
        kb, m = -(-k // 512), 512
        w_q = torch.randint(-127, 128, (e, kb, m, n), generator=gen,
                            device=dev, dtype=torch.int8)
        s_w = torch.rand((e, kb, n), generator=gen, device=dev) * 1e-3 + 5e-4
        x = torch.zeros((e, c, kb * m), device=dev)
        x[:, :, :k] = torch.randn((e, c, k), generator=gen, device=dev)
        x[1] = 0.0                                # an expert with no token
        s_x = sym_scale(x.reshape(e, -1), dim=1).reshape(e)
        seeds = torch.randint(0, 2 ** 31, (e,), generator=gen, device=dev,
                              dtype=torch.int32).tolist()
        plan = aimc_mvm.launch_plan(dev, c, kb, m, n, e, experts=True)
        for mode, sigma in (("off", 0.0), ("counter", cs.NOISE_SIGMA)):
            mine = functools.partial(
                aimc_mvm.aimc_mvm_experts, x, w_q, s_w, s_x,
                seeds if sigma > 0.0 else None, adc_step=step, sigma=sigma)
            theirs = functools.partial(
                other_experts_call, other, x, w_q, s_w, s_x,
                seeds if sigma > 0.0 else None, adc_step=step, sigma=sigma)
            y_mine, y_theirs = mine(), theirs()
            torch.cuda.synchronize()
            equal = bool(torch.equal(y_mine, y_theirs))
            diff = float((y_mine - y_theirs).abs().max())
            t_other = [cs.time_ms(theirs, flush, reps)]
            t_mine = [cs.time_ms(mine, flush, reps) for _ in range(2)]
            t_other.append(cs.time_ms(theirs, flush, reps))
            row = {"shape": name, "E": e, "B": c, "K": k, "N": n,
                   "kernel": "experts", "noise": mode, "bit_equal": equal,
                   "must_equal": mode == "off" or not draws_differ,
                   "max_abs_diff": diff, "ms": sum(t_mine) / 2,
                   "other_ms": sum(t_other) / 2, "ms_runs": t_mine,
                   "other_ms_runs": t_other, "plan": plan}
            rows.append(row)
            print(f"[ab] experts {name} E {e} x [{c}x{k}]x[{k}x{n}] noise "
                  f"{mode} (this: {plan['body']} body): "
                  f"{'bit-equal' if equal else f'DIFFERS by {diff:.3g}'}; "
                  f"this {row['ms']:.4f} ms {t_mine}, other "
                  f"{row['other_ms']:.4f} ms {t_other} "
                  f"({row['other_ms'] / row['ms']:.2f}x)", flush=True)
            del y_mine, y_theirs
        del w_q, s_w, x
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--other-abi",
                    choices=("bodies", "cols", "work", "pre-work"),
                    default="bodies")
    ap.add_argument("--draws-differ", action="store_true",
                    help="the other tree's read noise draws with other "
                         "functions: only noise-off rows must be equal")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.core.aimc import AimcConfig, program_stacked
    from repro_torch.core.quant import sym_scale
    from repro_torch.kernels import aimc_mvm
    from repro_torch.models.paper_nets import LSTM_GATE_ACTS

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"[ab] {smi}", flush=True)
    aimc_mvm.build()
    other = build_other(args.other.resolve(), args.other_abi)
    cfg = AimcConfig()
    step = cfg.adc_step
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = cs.flush_buffer(dev)
    shapes = [(f"granite {p} B={b}", b, k, n, g)
              for b in (cs.SLOTS, cs.PROMPT)
              for p, k, n, g in (("wq", 4096, 4096, 1), ("wk", 4096, 1024, 1),
                                 ("w_gate", 4096, 14336, 1),
                                 ("w_down", 14336, 4096, 1),
                                 ("w_gu", 4096, 14336, 2))]
    shapes += list(cs.paper_shapes())
    rows = []
    for name, b, k, n, g in shapes:
        w = torch.randn((g, k, n), generator=gen, device=dev)
        st = program_stacked(w * (2.0 / (k + n)) ** 0.5, cfg)
        del w
        kb, m, np_ = st.w_q.shape[-3:]
        x = torch.nn.functional.pad(
            torch.randn((b, k), generator=gen, device=dev), (0, kb * m - k))
        s_x = sym_scale(x).reshape(1, 1)
        bias = torch.randn((g, np_), generator=gen, device=dev)
        acts = (LSTM_GATE_ACTS if g == 4 else ("sigmoid", "tanh")[:g]
                if g > 1 else ("relu",))
        modes = [("off", 0.0, "counter", None), ("counter", 8.62, "counter",
                                                 None),
                 ("hw", 8.62, "hw", None)]
        if g == 1:
            modes.append(("operand", 0.0, "counter", 8.62 * torch.randn(
                (kb, b, np_), generator=gen, device=dev)))
        for mode, sigma, src, noise in modes:
            if noise is not None:
                mine = functools.partial(aimc_mvm.aimc_mvm_v1, x, st.w_q[0],
                                         st.s_w[0], s_x, noise,
                                         adc_step=step)
                mine_g = lambda f=mine: f()[None]  # noqa: E731
                theirs = functools.partial(
                    other_call, other, x, st.w_q, st.s_w, s_x, 0, None,
                    noise, adc_step=step, sigma=0.0, acts=("none",),
                    stacked=0, philox=0)
            else:
                kw = dict(adc_step=step, sigma=sigma, noise_source=src)
                if g > 1:
                    mine_g = functools.partial(
                        aimc_mvm.aimc_mvm_stacked, x, st.w_q, st.s_w, s_x,
                        0xC0FFEE, bias, activations=acts, **kw)
                else:
                    mine = functools.partial(
                        aimc_mvm.aimc_mvm_v2, x, st.w_q[0], st.s_w[0], s_x,
                        0xC0FFEE, bias[0], activation=acts[0], **kw)
                    mine_g = lambda f=mine: f()[None]  # noqa: E731
                theirs = functools.partial(
                    other_call, other, x, st.w_q, st.s_w, s_x, 0xC0FFEE,
                    bias, None, adc_step=step, sigma=sigma, acts=acts,
                    stacked=int(g > 1), philox=int(src == "hw"))
            y_mine, y_theirs = mine_g(), theirs()
            torch.cuda.synchronize()
            equal = bool(torch.equal(y_mine, y_theirs))
            diff = float((y_mine - y_theirs).abs().max())
            t_other = [cs.time_ms(theirs, flush, args.reps)]
            t_mine = [cs.time_ms(mine_g, flush, args.reps)
                      for _ in range(2)]
            t_other.append(cs.time_ms(theirs, flush, args.reps))
            row = {"shape": name, "B": b, "K": k, "N": n, "G": g,
                   "noise": mode, "bit_equal": equal,
                   "must_equal": sigma == 0.0 or not args.draws_differ,
                   "max_abs_diff": diff,
                   "ms": sum(t_mine) / 2, "other_ms": sum(t_other) / 2,
                   "ms_runs": t_mine, "other_ms_runs": t_other,
                   "plan": aimc_mvm.launch_plan(dev, b, kb, m, np_, g)}
            rows.append(row)
            print(f"[ab] {name} [{b}x{k}]x[{k}x{n}] noise {mode}: "
                  f"{'bit-equal' if equal else f'DIFFERS by {diff:.3g}'}; "
                  f"this {row['ms']:.4f} ms, other {row['other_ms']:.4f} ms "
                  f"({row['other_ms'] / row['ms']:.2f}x)", flush=True)
        del st, x
    if args.other_abi in ("bodies", "cols"):
        rows += expert_rows(other, dev, flush, gen, args.reps,
                            args.draws_differ)
    out = ROOT / "chiprun_out" / "kernel_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    bad = [r for r in rows if r["must_equal"] and not r["bit_equal"]]
    drawn = [r for r in rows if not r["must_equal"]]
    print(f"[ab] {sum(r['bit_equal'] for r in rows)} of {len(rows)} "
          f"bit-equal; {len(rows) - len(drawn)} must be, of which "
          f"{len(bad)} differ; {len(drawn)} rows draw read noise with "
          f"functions the other tree does not have, and differ from it by "
          f"design ({sum(not r['bit_equal'] for r in drawn)} do); written "
          f"to {out}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
