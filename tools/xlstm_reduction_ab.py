#!/usr/bin/env python3
"""A/B of the reductions in xlstm's training forward, on one CUDA card.

`models/xlstm.py` sums across features two ways: the serving path (a block
given a carried state) in `layers.row_sum`'s fixed pairwise order, so a
row's state does not depend on its batch; the training forward
(``state=None``) with torch's reductions (`mean`, `einsum`). This script
times the train step's microbatch loss and gradients
(`launch.steps.make_micro_grad`: forward, checkpoint recompute and
backward) of xlstm-350m at its published widths, digital bf16, weights
from seed 0, with the training path as it is ("torch") and with every
reduction of the blocks forced to `row_sum` ("row_sum"), in turns (torch,
row_sum, row_sum, torch, after one warm-up pass of each). Host-clock ms
per pass, the card synchronized at the end of each; the losses of both
are printed.

    python3 tools/xlstm_reduction_ab.py [--seq 128] [--batch 1]

Results go to chiprun_out/xlstm_reduction_ab.json.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (function, position of its batch_invariant argument)
FORCED = {"rmsnorm": 3, "_groupnorm": 4, "_slstm_seq": 5}


def _forced(fn, pos):
    def call(*a, **k):
        if len(a) > pos:
            a = (*a[:pos], True, *a[pos + 1:])
        else:
            k["batch_invariant"] = True
        return fn(*a, **k)
    return call


@contextlib.contextmanager
def row_sum_everywhere():
    """Every reduction of xlstm's blocks in `row_sum`'s order."""
    from repro_torch.models import xlstm
    orig = {name: getattr(xlstm, name) for name in FORCED}
    for name, pos in FORCED.items():
        setattr(xlstm, name, _forced(orig[name], pos))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(xlstm, name, fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args()

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.prng import PRNGKey, fold_in
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.launch.steps import make_micro_grad
    from repro_torch.models.layers import Execution

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    spec = get_arch("xlstm-350m")
    cfg = spec.model_cfg
    params = spec.model_module().init(PRNGKey(0), cfg, device=dev)
    mb = {k: torch.from_numpy(v).to(dev) for k, v in host_batch(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch, seed=0), 0, 0, 1).items()}
    key = fold_in(torch.tensor([0, 0], dtype=torch.int64), 0)
    micro_grad = make_micro_grad(spec, Execution(compute_dtype="bfloat16"))

    def run(mode):
        ctx = row_sum_everywhere() if mode == "row_sum" else \
            contextlib.nullcontext()
        with ctx:
            t = time.perf_counter()
            loss, grads = micro_grad(params, mb, key)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t) * 1e3
        del grads
        return ms, float(loss)

    out = {"card": card, "arch": "xlstm-350m", "batch": args.batch,
           "seq": args.seq, "warmup": {}, "ms": {"torch": [], "row_sum": []},
           "loss": {}}
    for mode in ("torch", "row_sum"):
        out["warmup"][mode] = run(mode)[0]
    for mode in ("torch", "row_sum", "row_sum", "torch"):
        ms, loss = run(mode)
        out["ms"][mode].append(ms)
        out["loss"][mode] = loss
    mean = {m: sum(v) / len(v) for m, v in out["ms"].items()}
    out["mean_ms"] = mean
    print(f"[xlstm reductions] xlstm-350m {args.batch} x {args.seq}, digital "
          f"bf16, microbatch loss and grads (forward, recompute, backward): "
          f"torch's reductions {out['ms']['torch']} ms, row_sum "
          f"{out['ms']['row_sum']} ms (means {mean['torch']:.1f} vs "
          f"{mean['row_sum']:.1f}); losses {out['loss']} on {card}",
          flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "xlstm_reduction_ab.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
