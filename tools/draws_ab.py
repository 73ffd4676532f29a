#!/usr/bin/env python3
"""A/B of the port's plain threefry normal (`core/prng.normal_batch`, what
weight init and programming noise draw) on one CUDA card: another
checkout's `core/prng.py` against this tree's, and this tree's draw with
its threefry rounds on int64 words (`int64_bits` here) in place of the
int32 ones (`prng._threefry_bits`), which give the same bits. In turns
(other, int64, this, this, int64, other): host clock around 5 calls of 4
keys x 2^22 draws after a warm-up, synchronized; then the device time of
one call of each (torch.profiler). Prints the card's name and power
limit first.

    python3 tools/draws_ab.py --other DIR
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def load_other(other: Path):
    path = other / "src" / "repro_torch" / "core" / "prng.py"
    spec = importlib.util.spec_from_file_location("prng_other", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def int64_bits(prng, k0, k1, i):
    """``y0 ^ y1`` of threefry-2x32 on int64 counters ``i``, each uint32 word
    an int64 masked to 32 bits (the rounds of `prng.threefry2x32`)."""
    m = prng.M32
    ks = (k0, k1, k0 ^ k1 ^ prng._PARITY)
    x0, x1 = ((i >> 32) + ks[0]) & m, ((i & m) + ks[1]) & m
    for j in range(5):
        for r in prng._ROTATIONS[j % 2]:
            x0 = (x0 + x1) & m
            x1 = (((x1 << r) & m) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(j + 1) % 3]) & m
        x1 = (x1 + ks[(j + 2) % 3] + j + 1) & m
    return x0 ^ x1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.core import prng

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    other = load_other(args.other.resolve())
    keys = prng.split(prng.PRNGKey(5), 4).to(dev)
    shape = (1 << 22,)

    def int64_rounds():
        saved = prng._threefry_bits

        prng._threefry_bits = functools.partial(int64_bits, prng)
        try:
            return prng.normal_batch(keys, shape)
        finally:
            prng._threefry_bits = saved

    sides = {"other": lambda: other.normal_batch(keys, shape),
             "int64": int64_rounds,
             "this": lambda: prng.normal_batch(keys, shape)}
    outs = {name: fn() for name, fn in sides.items()}
    print(f"this == int64 rounds: {torch.equal(outs['this'], outs['int64'])}"
          f"; this == other: {torch.equal(outs['this'], outs['other'])}",
          flush=True)

    def host_ms(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / args.reps * 1e3

    runs = [(name, host_ms(sides[name])) for name in
            ("other", "int64", "this", "this", "int64", "other")]
    print("normal_batch 4 x 2^22, host ms a call in turns: "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in runs), flush=True)
    for name, fn in sides.items():
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        dev_us = sum(e.self_device_time_total for e in prof.key_averages())
        print(f"normal_batch 4 x 2^22, device ms ({name}): "
              f"{dev_us / 1e3:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
