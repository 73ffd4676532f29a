"""Run one cell of the port's benchmark:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. The cell, its configuration, traffic, limits and per-layer metrics
are found by name (BENCHMARK.json, portbench/configs, traffic, limits,
metrics). With ``--trace 0`` the result line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiled window. ``--control <names>`` and ``--fault <name>`` are not
benchmark runs: they print the readings of the program and of the
controls, one precision step below what the configuration states
(training: ``fp8``, the reference on e4m3 digital products, and
``int4``, the reference on int4 crossbar codes; serving: ``tf32``, the
program with TF32 products, and ``int4``), comma-separated, or of the
program with a fault of `harness/faults.py` planted, which is how the
limits were set. ``--readings <n>`` prints the digital stages' readings
of n seeds from ``--seed`` on, in one process: the program's, or with
``--control`` the one named control's (training: set-up's checked steps
only; serving: a window of ``--seconds``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import common  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--readings", type=int, default=0)
    return ap.parse_args(argv)


def reader(name: str):
    path = common.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(bench: dict, cell, ctx: dict) -> dict:
    """Every per-layer metric this cell reports, by its own reader."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell.name in m["workloads"]}
    out = {}
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if cells is not None and cell.name not in cells:
            continue
        if cells is None and m["moves"] not in e2e:
            continue
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = (v, m["unit"])
    return out


def main(argv=None) -> int:
    args = parse(argv)
    common.use_checkout_caches()
    if not (common.ROOT / "src" / "repro_torch").is_dir():
        raise common.Unfit("no port (src/repro_torch) in this checkout")
    from portbench.harness import counts, spec as spec_mod
    bench = common.benchmark()
    cell = spec_mod.load(args.workload)
    dev = common.require_cuda(cell.chips)
    card = common.card_info(dev)
    kind = cell.traffic["kind"]
    if kind == "train":
        from portbench.harness import train as driver
    elif kind == "serve":
        from portbench.harness import serve as driver
    else:
        raise common.Unfit(f"traffic kind {kind!r} has no driver")
    if args.readings:
        return stage_readings(driver, cell, args, dev, card)
    if args.control:
        return control(driver, cell, args, dev, card)
    if args.fault:
        return fault(driver, cell, args, dev, card)
    got = driver.program_side(cell, args.seed, args.seconds,
                              bool(args.trace), dev)
    from portbench.harness import judge
    t_ref = time.perf_counter()
    readings, judged = judge.readings_of(driver, cell, args.seed, got,
                                         dev)
    t_ref = time.perf_counter() - t_ref
    checks = judge.checks(readings, cell.limits)
    bad = common.forbidden_loaded()
    if bad:
        raise common.Unfit(f"modules of JAX or the JAX package loaded: "
                           f"{bad}")
    device = {"platform": card["platform"], "kind": card["kind"],
              "count": card["count"],
              "memory_peak_bytes": int(got["memory_peak_bytes"])}
    breakdown = None
    if args.trace:
        ctx = {"kind": kind, "cell": cell, "got": got,
               "peaks": counts.peaks(card["kind"])}
        metrics = per_layer(bench, cell, ctx)
        tr = got["trace"]
        device.update(busy_s=tr["busy_s"], window_s=got["window_s"])
        breakdown = {"device_ops": tr["device_ops"],
                     "idle_gaps": tr["idle_gaps"]}
    else:
        metrics = driver.e2e(cell, got)
    lead = (f" ({got['ahead']:.2f} steps ahead)" if "ahead" in got
            else "")
    print(f"[portbench] {cell.name} seed {args.seed}: {card['kind']}, "
          f"power limit {card['power_limit']}; set-up {got['setup_s']:.2f} s,"
          f" window {got['window_s']:.2f} s{lead}, reference {t_ref:.2f} s; "
          f"judged {judged}; readings {json.dumps(readings)}",
          file=sys.stderr)
    failed = got.get("failed", got.get("nonfinite", 0))
    common.result(all(c["ok"] for c in checks) and not failed,
                  got.get("attempted", got.get("steps", 0)), failed,
                  metrics, device, checks, breakdown)
    return 0


def control(driver, cell, args, dev, card) -> int:
    """The program's readings and the controls', one seed, each with its
    verdict under the cell's limits."""
    from portbench.harness import judge
    names = [n for n in args.control.split(",") if n]
    out = {"program": {}, "control": {}}
    if cell.traffic["kind"] == "train":
        got = driver.program_side(cell, args.seed, 0.0, False, dev)
        ref_out = driver.reference_side(cell, args.seed, dev)
        out["program"] = judge.train_readings(got, ref_out)
        for k in names:
            ctl = driver.reference_side(cell, args.seed, dev, k)
            out["control"][k] = judge.train_readings(ctl, ref_out)
    else:
        got = driver.program_side(cell, args.seed, args.seconds, False, dev)
        out["program"], _ = judge.readings_of(driver, cell, args.seed, got,
                                              dev)
        for k in names:
            if k == "tf32":
                ctl = driver.program_side(cell, args.seed, args.seconds,
                                          False, dev, tf32=True)
                out["control"][k], _ = judge.readings_of(
                    driver, cell, args.seed, ctl, dev)
            else:
                out["control"][k] = driver.int4_readings(cell, args.seed,
                                                         got, dev)
    for side in [out["program"], *out["control"].values()]:
        side["correct"] = all(c["ok"] for c in judge.checks(side,
                                                            cell.limits)
                              if c["value"] is not None)
    out.update(workload=cell.name, seed=args.seed, card=card)
    print(json.dumps({"control": out}), flush=True)
    return 0


def stage_readings(driver, cell, args, dev, card) -> int:
    """The digital stages' readings of ``--readings`` seeds, one line
    each."""
    for seed in range(args.seed, args.seed + args.readings):
        if cell.traffic["kind"] == "train":
            got = (driver.reference_side(cell, seed, dev, args.control)
                   if args.control else
                   driver.program_side(cell, seed, 0.0, False, dev))
        else:
            got = driver.program_side(cell, seed, args.seconds, False, dev,
                                      tf32=args.control == "tf32")
        print(json.dumps({"readings": got["stages"], "seed": seed,
                          "side": args.control or "program",
                          "workload": cell.name, "card": card}), flush=True)
    return 0


def fault(driver, cell, args, dev, card) -> int:
    """The readings of a run with a fault planted under the timed path."""
    from portbench.harness import faults, judge
    table = faults.TRAIN if cell.traffic["kind"] == "train" else faults.SERVE
    got = driver.program_side(cell, args.seed, args.seconds, False, dev,
                              wrap=table[args.fault])
    readings, judged = judge.readings_of(driver, cell, args.seed, got, dev)
    checks = judge.checks(readings, cell.limits)
    print(json.dumps({"fault": {"name": args.fault, "readings": readings,
                                "correct": all(c["ok"] for c in checks),
                                "judged": judged, "workload": cell.name,
                                "seed": args.seed, "card": card}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
