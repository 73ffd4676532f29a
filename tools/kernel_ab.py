#!/usr/bin/env python3
"""A/B of the AIMC MVM kernel library against another checkout's, on one
CUDA card: both libraries get the same operands at every shape the port's
main paths run (granite-8b at decode and prompt pad, K3's w_gu stack, the
paper nets' MVMs at their published widths), with read noise off, counter
noise, Philox ("hw") noise and K1's explicit noise operand. Each output of
this checkout must equal the other's bit for bit; both are timed in turns
(other, this, this, other; CUDA events, L2 read-flushed per launch).

    python3 tools/kernel_ab.py --other DIR     # DIR: root of the other tree

The other tree's kernel is called through the C entry point it had before
the launcher took a workspace (`aimc_mvm_launch` without the trailing
`work` pointer). Results go to chiprun_out/kernel_ab.json.
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


def build_other(other: Path) -> ctypes.CDLL:
    from repro_torch.kernels import aimc_mvm
    src = other / "src" / "repro_torch" / "kernels" / "csrc" / "aimc_mvm.cu"
    out = ROOT / "chiprun_out" / "ab_build" / "libaimc_mvm_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([aimc_mvm._nvcc(), *aimc_mvm.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.aimc_mvm_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_uint, ctypes.c_int,
           ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
    lib.aimc_mvm_launch.restype = ctypes.c_int
    return lib


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
    err = lib.aimc_mvm_launch(
        x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(), s_x.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        noise.data_ptr() if noise is not None else None, out.data_ptr(),
        x.shape[0], kb, m, np_, g, float(adc_step), float(sigma),
        int(seed) & 0xFFFFFFFF, int(stacked), packed, int(philox),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"other library launch failed: CUDA error {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=20)
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
    other = build_other(args.other.resolve())
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
                   "noise": mode, "bit_equal": equal, "max_abs_diff": diff,
                   "ms": sum(t_mine) / 2, "other_ms": sum(t_other) / 2,
                   "ms_runs": t_mine, "other_ms_runs": t_other,
                   "plan": aimc_mvm.launch_plan(dev, b, kb, m, np_, g)}
            rows.append(row)
            print(f"[ab] {name} [{b}x{k}]x[{k}x{n}] noise {mode}: "
                  f"{'bit-equal' if equal else f'DIFFERS by {diff:.3g}'}; "
                  f"this {row['ms']:.4f} ms, other {row['other_ms']:.4f} ms "
                  f"({row['other_ms'] / row['ms']:.2f}x)", flush=True)
        del st, x
    out = ROOT / "chiprun_out" / "kernel_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    bad = [r for r in rows if not r["bit_equal"]]
    print(f"[ab] {len(rows) - len(bad)} of {len(rows)} bit-equal; "
          f"written to {out}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
