"""Serving CLI over the continuous-batching engine (PyTorch port of the
dense path of `repro/launch/serve.py`).

    python -m repro_torch.launch.serve --arch granite-8b --exec aimc \\
        --requests 4 --prompt-len 16 --gen 8 --slots 4 --trace poisson:20

Runs on the CUDA card by default (``--device cuda``) and refuses to start
without one unless ``--device cpu`` is given. With ``--exec aimc`` every
stationary projection is programmed ONCE (CM_INITIALIZE), the program is
installed into the parameter tree, and every token vector afterwards runs
the crossbar kernel K2 on the stationary int8 codes; ``--fuse-gates`` runs
w_gate + w_up as one gate-fused launch of K3 per layer instead. The run prints the
program summary, decode ms/step and the CM_* ledger reconciliation, and
exits non-zero if the per-request ledgers do not close exactly.
``--cores N`` spreads the programmed matrices over N per-core tile contexts
(`MappingPlan(n_contexts=N)`) and prints the per-core CM_*/comm ledgers of
`CoreSchedule.from_program` and its modeled latency per token vector;
``--pipeline`` prices that schedule with the position-pipelined law.

Weights are random from ``--seed`` (`transformer.init(PRNGKey(seed))`, the
reference's weights for the same seed) unless ``--weights FILE.npz`` gives
a flat ``"blocks/wq"``-keyed archive (`convert.load_npz`). Load shapes:
synchronized arrivals (default) or ``--trace poisson:RATE``. The
reference's multi-tenant, paged, drift/chaos, placement, mesh and int8
paths are later slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12,
                    help="decode budget: max_new per request (includes the "
                         "prefill's first token)")
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots; 0 -> min(requests, 8)")
    ap.add_argument("--trace", default="",
                    help="poisson:RATE (req/s, staggered ragged arrivals); "
                         "default synchronized")
    ap.add_argument("--exec", dest="exec_mode", default="digital",
                    choices=["digital", "aimc"])
    ap.add_argument("--decode-chunk", dest="decode_chunk", type=int,
                    default=1, help="decode steps per host sync")
    ap.add_argument("--fuse-gates", dest="fuse_gates", action="store_true",
                    help="with --exec aimc: stack w_gate + w_up (and MHA "
                         "wq/wk/wv) so each group runs as ONE gate-fused "
                         "kernel launch per layer (bit-equal, noise off)")
    ap.add_argument("--cores", type=int, default=1,
                    help="virtual AIMC cores: the MappingPlan spreads the "
                         "programmed matrices over this many per-core tile "
                         "contexts and the run reports per-core CM_*/comm "
                         "ledgers (core.schedule)")
    ap.add_argument("--pipeline", action="store_true",
                    help="price the multi-core schedule with the "
                         "position-pipelined latency law instead of the "
                         "sequential mutex chain")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu must be asked for explicitly")
    ap.add_argument("--weights", default="",
                    help="flat npz parameter archive (default: random)")
    return ap.parse_args(argv)


def build_requests(args, vocab: int):
    """The synthetic request stream the CLI serves."""
    from repro_torch.runtime.batcher import poisson_trace, synchronized_trace
    n, p, g = args.requests, args.prompt_len, args.gen
    if args.trace:
        kind, _, param = args.trace.partition(":")
        if kind != "poisson":
            raise SystemExit(f"unknown --trace kind {kind!r} "
                             "(supported: poisson:RATE)")
        return poisson_trace(n, float(param or "100"), seed=args.seed,
                             prompt_len=(max(1, p // 2), p), max_new=(1, g),
                             vocab=vocab)
    return synchronized_trace(n, prompt_len=p, max_new=g, seed=args.seed,
                              vocab=vocab)


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device available; the port serves on the "
                         "card (pass --device cpu to run on the CPU)")
    return dev


@dataclasses.dataclass
class ServeRun:
    """What `main` served: the report plus the engine, program and
    schedule behind it (so a caller can reuse the installed parameters)."""
    report: object
    engine: object
    program: object
    requests: list
    schedule: object = None
    init_s: float = 0.0


def main(argv=None) -> ServeRun:
    args = parse_args(argv)
    if args.fuse_gates and args.exec_mode != "aimc":
        raise SystemExit("--fuse-gates stacks programmed states: it needs "
                         "--exec aimc")
    if (args.cores > 1 or args.pipeline) and args.exec_mode != "aimc":
        raise SystemExit("--cores/--pipeline require the programmed AIMC "
                         "path (--exec aimc): the multi-core schedule lowers "
                         "an installed AimcProgram")
    from repro_torch.configs import get_arch
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.core.prng import PRNGKey
    from repro_torch.models.layers import Execution
    from repro_torch.runtime.batcher import reconcile
    from repro_torch.runtime.engine import ServeEngine

    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.smoke_cfg if args.smoke else spec.model_cfg
    model = spec.model_module()
    aimc_cfg = AimcConfig()
    exe = (Execution(mode="aimc", aimc=aimc_cfg, compute_dtype="float32",
                     programmed=True)
           if args.exec_mode == "aimc"
           else Execution(compute_dtype="float32" if args.smoke
                          else "bfloat16"))
    b, p, g = args.requests, args.prompt_len, args.gen
    requests = build_requests(args, cfg.vocab)

    t0 = time.time()
    if args.weights:
        from repro_torch.convert import load_npz
        params = load_npz(args.weights, device)
    else:
        params = model.init(PRNGKey(args.seed), cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_s = time.time() - t0
    print(f"[serve] {spec.arch_id} ({cfg.n_layers}L d_model={cfg.d_model} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab}) on {device}: weights ready in "
          f"{init_s:.2f}s")

    program = schedule = None
    if args.exec_mode == "aimc":
        # CM_INITIALIZE: program the whole network once, outside the
        # serving loop (paper §IV-B); the raw float weights of the mapped
        # projections are dropped with the raw tree. --cores spreads the
        # matrices over per-core tile contexts (paper Fig. 2).
        from repro_torch.core.program import MappingPlan, program_model
        from repro_torch.core.schedule import CoreSchedule
        t0 = time.time()
        program = program_model(params, MappingPlan(n_contexts=args.cores),
                                aimc_cfg, PRNGKey(args.seed + 2))
        params = program.install(params)
        if args.fuse_gates:
            params = model.fuse_gate_stacks(params)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"[serve] programmed in {time.time() - t0:.2f}s: "
              f"{program.summary()}")
        schedule = CoreSchedule.from_program(program, pipelined=args.pipeline)
        if args.cores > 1 or args.pipeline:
            print(f"[serve] {schedule.summary()}")
    print(f"[serve] {spec.arch_id} exec={args.exec_mode} requests={b}"
          + (" (gate-fused stacks)" if args.fuse_gates else ""))

    n_slots = args.slots or min(b, 8)
    engine = ServeEngine(model, cfg, exe, params, n_slots=n_slots,
                         prompt_pad=p, max_seq=p + g, program=program,
                         decode_chunk=args.decode_chunk)
    t0 = time.time()
    engine.warmup()
    print(f"[serve] engine warmed up in {time.time() - t0:.2f}s "
          f"({n_slots} slots, prompt_pad={p}, max_seq={p + g}, "
          f"decode_chunk={args.decode_chunk})")

    report = engine.serve(requests)
    print(f"[serve] {report.summary()}")
    if report.n_steps == 0:
        print(f"  prefill-only run: no decode steps executed "
              f"({report.n_prefills} prefills) — no decode tok/s to report")
    else:
        print(f"  decode: {report.n_steps} batch steps in "
              f"{report.wall_decode_s:.2f}s "
              f"({report.wall_decode_s / report.n_steps * 1e3:.1f} ms/step); "
              f"slot-idle lanes {report.idle_vectors}, retries "
              f"{report.retries}, stragglers {len(report.stragglers)}")
    if program is not None:
        init = program.initialize_counts()
        per_vec = program.mvm_counts()
        roi = per_vec.scaled(report.useful_vectors)
        print(f"  CM_INITIALIZE: {init.initialize} device writes, once per "
              f"session — independent of the {report.generated_tokens} "
              f"generated tokens")
        print(f"  CM_* in the serving ROI ({report.useful_vectors} useful "
              f"token vectors): queue={roi.queue} process={roi.process} "
              f"dequeue={roi.dequeue} (per vector: {per_vec.queue}/"
              f"{per_vec.process}/{per_vec.dequeue})")
        led_sum, static_sum = reconcile(program, report.records,
                                        report.observed_vectors)
        ok = led_sum == static_sum
        print(f"  per-request ledger sum reconciles with the program's "
              f"static accounting: {ok}")
        if not ok:
            raise SystemExit(1)
        _print_schedule(args, schedule)
    for rid in sorted(report.records)[:3]:
        rec = report.records[rid]
        print(f"  req{rid}: arrival={rec.request.arrival * 1e3:.1f}ms "
              f"prompt={len(rec.request.prompt)} "
              f"gen={len(rec.tokens)}/{rec.request.max_new} "
              f"({rec.finish_reason}) ttft={rec.ttft * 1e3:.1f}ms "
              f"latency={rec.latency * 1e3:.1f}ms tokens={rec.tokens[:6]}...")
    return ServeRun(report=report, engine=engine, program=program,
                    requests=requests, schedule=schedule, init_s=init_s)


def _print_schedule(args, schedule):
    """Per-core ledgers of one token vector and the modeled latency of the
    schedule on the paper's Table I-A system (a model, not a measurement)."""
    if schedule is None or not (args.cores > 1 or args.pipeline):
        return
    from repro_torch.core.schedule import pipelined_latency, sequential_latency
    print("  per-core ledgers, one token vector "
          "(queue/process/dequeue, comm bytes, load+store bytes):")
    for led in schedule.ledgers():
        print(f"    core{led.core}: {led.cm.queue}/{led.cm.process}/"
              f"{led.cm.dequeue}  comm={led.comm_bytes}B  "
              f"io={led.load_bytes + led.store_bytes}B")
    times = schedule.phase_times()
    print(f"  modeled latency/vector (Table I-A system): "
          f"sequential={sequential_latency(times) * 1e6:.1f}us  "
          f"pipelined={pipelined_latency(times) * 1e6:.1f}us  "
          f"(law in effect: "
          f"{'pipelined' if args.pipeline else 'sequential'})")


if __name__ == "__main__":
    main()
