"""Dry run of every (architecture x shape) cell on the production meshes
(PyTorch port of `repro/launch/dryrun.py`).

    python -m repro_torch.launch.dryrun --arch granite-8b
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --arch qwen1.5-110b \\
        --shape decode_32k --exec aimc --variant aimc

For each cell the step is built with `launch.steps.make_step` on the
production mesh (16x16 data x model, or 2x16x16 with ``pod``) folded onto
the ``meta`` device: 256 or 512 positions, no tensor placed or allocated.
From the bundle's abstract inputs and ``in_specs`` alone the record gives,
per position:

  * ``argument_bytes``: each input leaf's shard shape (its dims divided by
    the mesh axes its spec names) times its item size, summed over the
    parameters, a train cell's optimizer state, the batch and a decode
    cell's cache and token (``argument_parts`` splits it by input);
  * ``model_flops_per_position``: `launch.modelstats.model_flops` over the
    positions;
  * the lower bounds ``compute_s`` (model FLOPs against the card's dense
    bf16 peak, or its int8 peak under ``--exec aimc``) and ``memory_s``
    (the argument bytes read once against its HBM bandwidth);
  * ``fits``: whether the arguments fit the card's memory.

The card is the one torch sees (`torch.cuda.get_device_properties`: its
name and memory), its peaks from `CARDS` by name; without a card, the
H100 SXM of `CARDS`. The record names the card and where its figures came
from. The reference's TPU v5e constants do not carry over.

What has no counterpart is recorded as ``None``:

  * ``temp_bytes``, ``output_bytes`` and ``peak_bytes``: they are XLA's
    `memory_analysis` of a compiled executable, and eager PyTorch compiles
    none, so activations are not reckoned and ``fits`` is a lower bound
    (``fits_is_lower_bound``);
  * ``hlo_flops`` / ``hlo_bytes`` and ``xla_*_raw``: XLA's cost analysis
    of the optimized HLO;
  * ``collectives`` and ``collective_s``: the positions fold onto devices
    of one process, so nothing moves between them.

`repro/launch/hlostats.py` has no counterpart either: it re-derives XLA's
per-``while``-body counts (scanned layers, microbatches, CE chunks) from
optimized HLO text, because `cost_analysis` counts each loop body once.
Eager PyTorch has no HLO, and it runs every loop iteration, so there is
nothing to correct. Failures are recorded per cell (``ok: false``) and the
sweep goes on; the CLI exits 1 if any cell failed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

# published dense peaks (data sheets): HBM bytes/s, bf16 FLOP/s, int8
# ops/s, memory bytes; the first key whose every word is in the card's
# name wins
CARDS = {
    "H200": {"hbm_bytes_s": 4.8e12, "bf16_flops": 989e12,
             "int8_ops": 1979e12, "memory_bytes": 141e9},
    "H100 PCIe": {"hbm_bytes_s": 2.0e12, "bf16_flops": 756e12,
                  "int8_ops": 1513e12, "memory_bytes": 80e9},
    "H100": {"hbm_bytes_s": 3.35e12, "bf16_flops": 989e12,
             "int8_ops": 1979e12, "memory_bytes": 80e9},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def peaks_of(name: str) -> dict | None:
    """The `CARDS` entry of a card's name, or None."""
    return next((v for k, v in CARDS.items()
                 if all(part in name for part in k.split())), None)


def card() -> dict:
    """The card's name, memory and peaks: the device's own name and memory
    where torch sees a card, else `DEFAULT_CARD`'s table entry."""
    import torch
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        name, memory, source = props.name, props.total_memory, "device"
    else:
        name, memory, source = DEFAULT_CARD, None, "table"
    peaks = peaks_of(name)
    if peaks is None:
        raise ValueError(f"no peaks for card {name!r} in CARDS")
    return dict(peaks, name=name, source=source,
                memory_bytes=memory or peaks["memory_bytes"])


def position_bytes(tree, specs, mesh) -> int:
    """Bytes one position holds of ``tree`` (meta tensors) laid out by
    ``specs``: each leaf's shard shape times its item size."""
    from repro_torch.launch import shardings as sh
    total = [0]

    def one(x, spec):
        shape = list(x.shape)
        for d, entry in enumerate(spec):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                shape[d] //= math.prod(mesh.shape[a] for a in axes)
        total[0] += math.prod(shape) * x.element_size()
    sh.tree_map(one, tree, specs)
    return total[0]


def _exe(exec_mode: str):
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.models.layers import Execution
    if exec_mode == "aimc":
        return Execution(mode="aimc", aimc=AimcConfig())
    if exec_mode == "int8":
        return Execution(serve_int8=True)
    return Execution()


_INPUTS = {"train": ("params", "opt_state", "batch"),
           "prefill": ("params", "batch"),
           "decode": ("params", "cache", "tokens")}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             exec_mode: str = "digital", variant: str = "baseline",
             out_dir: str = "experiments/dryrun", save: bool = True) -> dict:
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.modelstats import model_flops
    from repro_torch.launch.steps import make_step

    spec = get_arch(arch_id)
    cell = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"])
    n = math.prod(mesh.sizes)
    cd = card()
    rec = {"arch": spec.arch_id, "shape": shape_name, "kind": cell.kind,
           "mesh": "x".join(str(s) for s in mesh.sizes), "positions": n,
           "fold": mesh.fold(), "exec": exec_mode, "variant": variant,
           "card": {k: cd[k] for k in ("name", "source", "memory_bytes",
                                       "hbm_bytes_s", "bf16_flops",
                                       "int8_ops")}}
    t0 = time.time()
    try:
        bundle = make_step(spec, cell, mesh, _exe(exec_mode))
        parts = {name: position_bytes(x, s, mesh) for name, x, s in zip(
            _INPUTS[cell.kind], bundle.abstract_inputs, bundle.in_specs)}
        arg = sum(parts.values())
        mflops = model_flops(spec, cell) / n
        peak = cd["int8_ops"] if exec_mode == "aimc" else cd["bf16_flops"]
        roof = {"compute_s": mflops / peak,
                "memory_s": arg / cd["hbm_bytes_s"], "collective_s": None}
        roof["dominant"] = max(("compute_s", "memory_s"), key=roof.get)
        roof["step_s_bound"] = roof[roof["dominant"]]
        rec |= {
            "ok": True, "build_s": round(time.time() - t0, 3),
            "memory": {"argument_bytes": arg, "argument_parts": parts,
                       "output_bytes": None, "temp_bytes": None,
                       "peak_bytes": None,
                       "fits": arg <= cd["memory_bytes"],
                       "fits_is_lower_bound": True},
            "hlo_flops": None, "hlo_bytes": None, "xla_flops_raw": None,
            "xla_bytes_raw": None, "collectives": None,
            "model_flops_per_position": mflops, "roofline": roof}
    except Exception as e:  # noqa: BLE001 (record the failure, keep sweeping)
        rec |= {"ok": False, "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}
    if save:
        os.makedirs(out_dir, exist_ok=True)
        fname = (f"{spec.arch_id}.{shape_name}."
                 f"{'multi' if multi_pod else 'single'}.{exec_mode}."
                 f"{variant}.json")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--exec", dest="exec_mode",
                    choices=["digital", "aimc", "int8"], default="digital")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    from repro_torch.configs import all_cells, cells

    if args.all:
        todo = all_cells()
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    elif args.arch:
        todo = cells(args.arch)
    else:
        ap.error("--arch/--shape or --all required")

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cd = card()
    print(f"[dryrun] card {cd['name']} ({cd['source']}): "
          f"{cd['memory_bytes'] / 1e9:.1f} GB, {cd['hbm_bytes_s'] / 1e12:.2f}"
          f" TB/s, {cd['bf16_flops'] / 1e12:.0f} bf16 TFLOP/s, "
          f"{cd['int8_ops'] / 1e12:.0f} int8 TOP/s")
    recs, failures = [], 0
    for arch_id, shape_name in todo:
        for multi in meshes:
            rec = run_cell(arch_id, shape_name, multi, args.exec_mode,
                           args.variant, args.out)
            recs.append(rec)
            tag = f"{arch_id}/{shape_name}/{'multi' if multi else 'single'}"
            if rec["ok"]:
                m, r = rec["memory"], rec["roofline"]
                print(f"OK  {tag}: {rec['positions']} positions on meta, "
                      f"args {m['argument_bytes'] / 1e9:.3f} GB/position "
                      f"(fits {m['fits']}, activations not reckoned), "
                      f"model flops {rec['model_flops_per_position']:.3g}"
                      f"/position, compute {r['compute_s']:.3g} s, memory "
                      f"{r['memory_s']:.3g} s, dominant {r['dominant']}")
            else:
                failures += 1
                print(f"FAIL {tag}: {rec['error']}")
    if failures:
        raise SystemExit(1)
    return recs


if __name__ == "__main__":
    main()
