"""Dry run of every (architecture x shape) cell on the production meshes
(PyTorch port of `repro/launch/dryrun.py`).

    python -m repro_torch.launch.dryrun --arch granite-8b
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --arch qwen1.5-110b \\
        --shape decode_32k --exec aimc --variant aimc

For each cell the step is built with `launch.steps.make_step` on the
production mesh (16x16 data x model, or 2x16x16 with ``pod``) folded onto
the ``meta`` device: 256 or 512 positions, no tensor placed or allocated.
The step then runs once on its abstract inputs (a train cell on a CPU
key) under `launch.stepstats.count_step`, the counterpart of the
reference's `hlostats`: every aten op it dispatches is counted, each
kernel wrapper as one crossbar launch, and every loop over layers,
sequence chunks or microbatches is counted over a few trips and
extrapolated to its full trip count. Per position the record gives:

  * ``memory``: ``argument_bytes``, each input leaf's shard shape (its
    dims divided by the mesh axes its spec names) times its item size,
    summed over the parameters, a train cell's optimizer state and key,
    the batch and a decode cell's cache and token (``argument_parts``
    splits it by input); ``output_bytes`` and ``temp_bytes``, the counted
    step's results and the rest of its peak above its arguments, over the
    positions; ``peak_bytes`` = arguments + outputs + temporaries, which
    ``fits`` compares with the card's memory;
  * ``hlo_flops`` / ``hlo_bytes``: the counted step over the positions.
    The names are the reference's, so the two packages' records line up,
    but the counts come from the dispatcher, not from HLO: eager PyTorch
    fuses nothing, so the bytes are every op's result and operands, and
    the folded step computes each position's share once, where XLA's
    per-device count also holds the work it replicates;
    ``flops_by_class`` splits the FLOPs into matmul, crossbar, elementwise
    and reduce; ``launches`` counts the whole step's kernel launches;
  * ``collectives``: wire bytes per position by kind (an all-reduce at
    twice its size, an all-gather at its result, hlostats' factors): the
    joins the port's sharded code makes (column pieces concatenated,
    `Placed.gather`), counted where they happen over the data positions,
    and a train cell's gradient reduction, reckoned from its ``in_specs``:
    each parameter's f32 gradient shard is all-reduced over the data axes
    on which the parameter is replicated and reduce-scattered over those
    it is sharded on. The positions share one device, so none of this is
    measured traffic;
  * ``model_flops_per_position`` (`launch.modelstats.model_flops` over the
    positions) and ``useful_ratio`` = model FLOPs / counted FLOPs;
  * ``roofline``: ``compute_s`` (crossbar operations at the card's int8
    peak, every other FLOP at its dense bf16 peak), ``memory_s`` (counted
    bytes over its HBM bandwidth), ``collective_s`` (wire bytes over its
    NVLink bandwidth per direction), ``dominant``, ``step_s_bound`` (the
    largest) and ``roofline_fraction`` (model FLOPs at the peak of the
    cell's execution, int8 under ``--exec aimc``, over the bound).

``xla_flops_raw`` / ``xla_bytes_raw`` stay ``None``: they are XLA's
`cost_analysis`, and there is no XLA here.

The card is the one torch sees (`torch.cuda.get_device_properties`: its
name, memory and SM count), its peaks from `CARDS` by name; without a
card, the H100 SXM of `CARDS`. The record names the card and where its
figures came from. The reference's TPU v5e constants do not carry over.
Failures are recorded per cell (``ok: false``) and the sweep goes on; the
CLI exits 1 if any cell failed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

# published dense peaks (data sheets): HBM bytes/s, bf16 FLOP/s, int8
# ops/s, memory bytes, SMs, and NVLink bytes/s per direction (half the
# data sheet's bidirectional "NVLink: 900GB/s" for SXM cards, 600GB/s for
# the PCIe card's bridge); the first key whose every word is in the
# card's name wins
CARDS = {
    "H200": {"hbm_bytes_s": 4.8e12, "bf16_flops": 989e12,
             "int8_ops": 1979e12, "memory_bytes": 141e9, "sms": 132,
             "nvlink_bytes_s": 450e9},
    "H100 PCIe": {"hbm_bytes_s": 2.0e12, "bf16_flops": 756e12,
                  "int8_ops": 1513e12, "memory_bytes": 80e9, "sms": 114,
                  "nvlink_bytes_s": 300e9},
    "H100": {"hbm_bytes_s": 3.35e12, "bf16_flops": 989e12,
             "int8_ops": 1979e12, "memory_bytes": 80e9, "sms": 132,
             "nvlink_bytes_s": 450e9},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def peaks_of(name: str) -> dict | None:
    """The `CARDS` entry of a card's name, or None."""
    return next((v for k, v in CARDS.items()
                 if all(part in name for part in k.split())), None)


def card() -> dict:
    """The card's name, memory, SM count and peaks: the device's own name,
    memory and SMs where torch sees a card, else `DEFAULT_CARD`'s table
    entry."""
    import torch
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        name, memory, source = props.name, props.total_memory, "device"
        sms = props.multi_processor_count
    else:
        name, memory, source, sms = DEFAULT_CARD, None, "table", None
    peaks = peaks_of(name)
    if peaks is None:
        raise ValueError(f"no peaks for card {name!r} in CARDS")
    return dict(peaks, name=name, source=source,
                memory_bytes=memory or peaks["memory_bytes"],
                sms=sms or peaks["sms"])


def _shard_shape(x, spec, mesh) -> list:
    shape = list(x.shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            axes = entry if isinstance(entry, tuple) else (entry,)
            shape[d] //= math.prod(mesh.shape[a] for a in axes)
    return shape


def position_bytes(tree, specs, mesh) -> int:
    """Bytes one position holds of ``tree`` (meta tensors) laid out by
    ``specs``: each leaf's shard shape times its item size."""
    from repro_torch.launch import shardings as sh
    total = [0]

    def one(x, spec):
        total[0] += math.prod(_shard_shape(x, spec, mesh)) * x.element_size()
    sh.tree_map(one, tree, specs)
    return total[0]


def grad_collectives(params, specs, mesh) -> dict:
    """Wire bytes per position of a train step's gradient reduction: each
    parameter's f32 gradient shard (its spec's shard shape) all-reduced
    over the data axes on which the parameter is replicated, and
    reduce-scattered over the data axes it is sharded on (operand: the
    shard before the scatter), with hlostats' factors."""
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import dp_axes
    out = {"all-reduce": 0, "reduce-scatter": 0}

    def one(x, spec):
        named = set()
        for entry in spec:
            if entry is not None:
                named |= set(entry if isinstance(entry, tuple) else (entry,))
        shard = math.prod(_shard_shape(x, spec, mesh)) * 4
        rep = math.prod(mesh.shape[a] for a in dp_axes(mesh)
                        if a not in named)
        scat = math.prod(mesh.shape[a] for a in dp_axes(mesh) if a in named)
        if rep > 1:
            out["all-reduce"] += 2 * shard
        if scat > 1:
            out["reduce-scatter"] += shard * scat
    sh.tree_map(one, params, specs)
    return {k: v for k, v in out.items() if v}


def position_collectives(bundle, kind: str, counted: dict, mesh) -> dict:
    """Wire bytes per position by kind: the counted step's joins (made
    once over all rows of the folded step) over the data positions, plus
    a train cell's `grad_collectives`; ``total`` sums them."""
    from repro_torch.launch.mesh import axis_size, dp_axes
    dp = axis_size(mesh, dp_axes(mesh))
    coll = {k: v / dp for k, v in counted["collectives"].items()
            if k != "total"}
    if kind == "train":
        for k, v in grad_collectives(bundle.abstract_inputs[0],
                                     bundle.in_specs[0], mesh).items():
            coll[k] = coll.get(k, 0) + v
    coll["total"] = sum(coll.values())
    return coll


def _exe(exec_mode: str):
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.models.layers import Execution
    if exec_mode == "aimc":
        return Execution(mode="aimc", aimc=AimcConfig())
    if exec_mode == "int8":
        return Execution(serve_int8=True)
    return Execution()


_INPUTS = {"train": ("params", "opt_state", "batch", "rng"),
           "prefill": ("params", "batch"),
           "decode": ("params", "cache", "tokens")}


def step_inputs(bundle, kind: str) -> tuple:
    """The bundle's abstract inputs as the step takes them: a train cell's
    key on the host (the step reads its words there)."""
    from repro_torch.core import prng
    args = tuple(bundle.abstract_inputs)
    if kind == "train":
        args = args[:3] + (prng.PRNGKey(0),)
    return args


def count(bundle, kind: str, sms: int) -> dict:
    """`stepstats.count_step` of the bundle's step on its inputs, its
    placed outputs read whole (`Placed` views: no copy)."""
    from repro_torch.launch.shardings import whole_tree
    from repro_torch.launch.stepstats import count_step

    def step(*args):
        return whole_tree(bundle.fn(*args))
    return count_step(step, *step_inputs(bundle, kind), sms=sms)


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
                                       "int8_ops", "sms",
                                       "nvlink_bytes_s")}}
    t0 = time.time()
    try:
        bundle = make_step(spec, cell, mesh, _exe(exec_mode))
        t1 = time.time()
        parts = {name: position_bytes(x, s, mesh) for name, x, s in zip(
            _INPUTS[cell.kind], bundle.abstract_inputs, bundle.in_specs)}
        arg = sum(parts.values())
        st = count(bundle, cell.kind, cd["sms"])
        t2 = time.time()
        coll = position_collectives(bundle, cell.kind, st, mesh)
        flops, nbytes = st["flops"] / n, st["bytes"] / n
        by_class = {k: v / n for k, v in st["flops_by_class"].items()}
        out_b = st["output_bytes"] / n
        extra = (st["peak_bytes"] - st["argument_bytes"]) / n
        mflops = model_flops(spec, cell) / n
        peak = cd["int8_ops"] if exec_mode == "aimc" else cd["bf16_flops"]
        roof = {"compute_s": by_class["crossbar"] / cd["int8_ops"]
                + (flops - by_class["crossbar"]) / cd["bf16_flops"],
                "memory_s": nbytes / cd["hbm_bytes_s"],
                "collective_s": coll["total"] / cd["nvlink_bytes_s"]}
        roof["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                               key=roof.get)
        roof["step_s_bound"] = roof[roof["dominant"]]
        roof["roofline_fraction"] = ((mflops / peak) / roof["step_s_bound"]
                                     if roof["step_s_bound"] else 0.0)
        rec |= {
            "ok": True, "build_s": round(t1 - t0, 3),
            "count_s": round(t2 - t1, 3), "count_runs": st["runs"],
            "memory": {"argument_bytes": arg, "argument_parts": parts,
                       "output_bytes": out_b, "temp_bytes": extra - out_b,
                       "peak_bytes": arg + extra,
                       "fits": arg + extra <= cd["memory_bytes"]},
            "hlo_flops": flops, "hlo_bytes": nbytes, "xla_flops_raw": None,
            "xla_bytes_raw": None, "flops_by_class": by_class,
            "launches": st["launches"], "collectives": coll,
            "model_flops_per_position": mflops,
            "useful_ratio": mflops / flops if flops else 0.0,
            "roofline": roof}
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
                      f"counted in {rec['count_s']} s: "
                      f"flops={rec['hlo_flops']:.3g}/position "
                      f"peak={m['peak_bytes'] / 1e9:.3f}GB/position "
                      f"(args {m['argument_bytes'] / 1e9:.3f}, fits "
                      f"{m['fits']}) coll="
                      f"{rec['collectives']['total'] / 1e9:.3f}GB "
                      f"useful={rec['useful_ratio']:.3f} "
                      f"dominant={r['dominant']}")
            else:
                failures += 1
                print(f"FAIL {tag}: {rec['error']}")
    if failures:
        raise SystemExit(1)
    return recs


if __name__ == "__main__":
    main()
