"""Serving CLI over the continuous-batching engine (PyTorch port of the
dense path of `repro/launch/serve.py`).

    python -m repro_torch.launch.serve --arch granite-8b --exec aimc \\
        --requests 4 --prompt-len 16 --gen 8 --slots 4 --trace poisson:20
    python -m repro_torch.launch.serve --arch llama3.2-3b --smoke \\
        --page-size 4 --prefix-cache --prefill-chunk 4 --shared-prefix 8 \\
        --paged-verify --device cpu

``--arch`` takes the ported dense decoders: granite-8b, glm4-9b,
llama3.2-3b, qwen1.5-110b and internvl2-1b (whose prompts start with its
patch positions: ``--prompt-len`` must cover them), the recurrent
xlstm-350m and recurrentgemma-9b, which serve through per-slot state
insertion (no max_seq cap) and, with ``--page-size``, through recurrent
snapshot pages and prefill legs, and the MoE olmoe-1b-7b and arctic-480b
(``--layers N`` cuts arctic's depth to fit one card), whose expert stacks
run one kernel launch per expert projection (dense or paged KV; the
prefix cache and chunked prefill refuse MoE, as the reference does).

Runs on the CUDA card by default (``--device cuda``) and refuses to start
without one unless ``--device cpu`` is given. With ``--exec aimc`` every
stationary projection is programmed ONCE (CM_INITIALIZE), the program is
installed into the parameter tree, and every token vector afterwards runs
the crossbar kernel K2 on the stationary int8 codes; ``--fuse-gates`` runs
each shared-input gate group as one launch of K3 instead (the arch module's
own `fuse_gate_stacks`: w_gate + w_up per dense transformer layer, wq + wk
+ wv where K/V are as wide as Q (olmoe); w_up + w_gate, w_q + w_k + w_v and
the sLSTM FFN pair per xLSTM pair; rglru has none; expert stacks never
fuse).
The run prints the program summary, decode ms/step and the CM_* ledger
reconciliation, and exits non-zero if the per-request ledgers do not close
exactly.
``--cores N`` spreads the programmed matrices over N per-core tile contexts
(`MappingPlan(n_contexts=N)`) and prints the per-core CM_*/comm ledgers of
`CoreSchedule.from_program` and its modeled latency per token vector;
``--pipeline`` prices that schedule with the position-pipelined law.

Weights are random from ``--seed`` (`transformer.init(PRNGKey(seed))`, the
reference's weights for the same seed) unless ``--weights FILE.npz`` gives
a flat ``"blocks/wq"``-keyed archive (`convert.load_npz`). Load shapes:
synchronized arrivals (default) or ``--trace poisson:RATE``;
``--shared-prefix K`` gives every prompt request 0's first K tokens.

``--page-size P`` serves from a paged KV cache (bit-equal to the dense
one); ``--prefix-cache`` reuses resident full prompt pages by content hash
and ``--prefill-chunk C`` runs prefills as C-token legs between decode
chunks; ``--paged-verify`` exits non-zero unless the page ledger is exact,
every useful vector is booked, no closure saw a new shape after warmup
and (synchronized, unchunked, with a shared prefix) the shared span was
prefilled exactly once. ``--admission sjf`` admits the shortest decode
budget first among arrived requests (default fifo). ``--static`` runs the
legacy static-batch loop (`engine.static_generate`: one synchronized batch,
lockstep decode) for A/B against the engine. The reference's multi-tenant,
drift/chaos, placement, mesh and int8 paths are later slices.
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
    ap.add_argument("--layers", type=int, default=0,
                    help="serve the first N layers only: a depth cut for a "
                         "config whose int8 codes exceed one card (widths "
                         "stay as configured); 0 = every layer")
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
    ap.add_argument("--static", action="store_true",
                    help="legacy monolithic static-batch loop (A/B baseline)")
    ap.add_argument("--admission", default="fifo", choices=["fifo", "sjf"])
    ap.add_argument("--decode-chunk", dest="decode_chunk", type=int,
                    default=1, help="decode steps per host sync")
    ap.add_argument("--page-size", dest="page_size", type=int, default=0,
                    help="paged slot cache: KV pages of this many token rows "
                         "behind a page table (bit-equal to the dense "
                         "cache); 0 = dense")
    ap.add_argument("--pages", type=int, default=0,
                    help="page-pool size including the scratch page (0: "
                         "sized so every slot can hold a max-length "
                         "request)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true",
                    help="content-hashed prefix cache over full pages: a "
                         "request whose prompt prefix is resident admits "
                         "without re-running the shared span's prefill "
                         "(needs --page-size)")
    ap.add_argument("--prefill-chunk", dest="prefill_chunk", type=int,
                    default=0,
                    help="run prefills as bounded legs of this many tokens, "
                         "interleaved with decode chunks (needs "
                         "--page-size; 0 = one full-width prefill)")
    ap.add_argument("--shared-prefix", dest="shared_prefix", type=int,
                    default=0,
                    help="make the first K prompt tokens identical across "
                         "every request (a shared system prompt)")
    ap.add_argument("--paged-verify", dest="paged_verify",
                    action="store_true",
                    help="exit nonzero unless the page ledger reconciles "
                         "exactly, no closure saw a new shape after warmup, "
                         "and (with --shared-prefix + --prefix-cache, "
                         "synchronized, unchunked) the shared span was "
                         "prefilled exactly once")
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
    args = ap.parse_args(argv)
    if args.page_size < 0 or args.pages < 0 or args.prefill_chunk < 0 \
            or args.shared_prefix < 0:
        ap.error("--page-size/--pages/--prefill-chunk/--shared-prefix "
                 "must be >= 0")
    if args.page_size == 0 and (args.prefix_cache or args.prefill_chunk
                                or args.pages or args.paged_verify):
        ap.error("--prefix-cache/--prefill-chunk/--pages/--paged-verify "
                 "require --page-size")
    if args.static and args.trace:
        ap.error("--static serves one synchronized batch; staggered "
                 "traces need the engine")
    if args.static and args.decode_chunk > 1:
        ap.error("--decode-chunk applies to the engine's decode loop; "
                 "--static is the legacy lockstep baseline")
    if args.page_size and args.static:
        ap.error("--page-size serves through the slot engine; --static is "
                 "the legacy dense-batch baseline")
    if args.shared_prefix and args.shared_prefix >= args.prompt_len:
        ap.error(f"--shared-prefix {args.shared_prefix} must leave every "
                 f"request a unique continuation (< --prompt-len "
                 f"{args.prompt_len})")
    return args


def build_requests(args, vocab: int, min_prompt: int = 1):
    """The synthetic request stream the CLI serves. ``min_prompt`` floors
    the ragged prompt lengths (vlm prompts must cover the patch prefix)."""
    from repro_torch.runtime.batcher import poisson_trace, synchronized_trace
    n, p, g = args.requests, args.prompt_len, args.gen
    if p < min_prompt:
        raise SystemExit(f"--prompt-len {p} < minimum prompt length "
                         f"{min_prompt} for this arch")
    if args.trace:
        kind, _, param = args.trace.partition(":")
        if kind != "poisson":
            raise SystemExit(f"unknown --trace kind {kind!r} "
                             "(supported: poisson:RATE)")
        return poisson_trace(n, float(param or "100"), seed=args.seed,
                             prompt_len=(max(min_prompt, p // 2), p),
                             max_new=(1, g), vocab=vocab)
    return synchronized_trace(n, prompt_len=p, max_new=g, seed=args.seed,
                              vocab=vocab)


def apply_shared_prefix(requests, k: int):
    """Overwrite the first ``k`` tokens of every prompt with request 0's
    (a shared system prompt). Prompts shorter than ``k`` become a prefix
    of the shared span."""
    if not k:
        return requests
    shared = requests[0].prompt[:k]
    return [dataclasses.replace(
        r, prompt=(shared + r.prompt[k:] if len(r.prompt) > k
                   else shared[:len(r.prompt)]))
        for r in requests]


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
    static_tokens: object = None     # [B, gen] tokens of a --static run


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
    if args.layers:
        if not 0 < args.layers <= cfg.n_layers:
            raise SystemExit(f"--layers {args.layers} outside 1..{cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if spec.family == "audio":
        raise SystemExit("serve.py drives decoder-only LMs; the enc-dec "
                         "audio family decodes via launch.steps")
    model = spec.model_module()
    if args.fuse_gates and not hasattr(model, "fuse_gate_stacks"):
        raise SystemExit(f"--fuse-gates: {spec.arch_id} ({spec.module}) has "
                         f"no gate stacks to fuse")
    aimc_cfg = AimcConfig()
    exe = (Execution(mode="aimc", aimc=aimc_cfg, compute_dtype="float32",
                     programmed=True)
           if args.exec_mode == "aimc"
           else Execution(compute_dtype="float32" if args.smoke
                          else "bfloat16"))
    b, p, g = args.requests, args.prompt_len, args.gen
    requests = build_requests(
        args, cfg.vocab,
        min_prompt=cfg.n_patches if spec.family == "vlm" else 1)
    requests = apply_shared_prefix(requests, args.shared_prefix)

    t0 = time.time()
    if args.weights:
        from repro_torch.convert import load_npz
        params = load_npz(args.weights, device)
    else:
        params = model.init(PRNGKey(args.seed), cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_s = time.time() - t0
    cut = (f", depth cut to {cfg.n_layers} of "
           f"{(spec.smoke_cfg if args.smoke else spec.model_cfg).n_layers}"
           if args.layers else "")
    d_ff = getattr(cfg, "d_ff", None) or getattr(cfg, "d_ff_s", None)
    print(f"[serve] {spec.arch_id} ({cfg.n_layers}L d_model={cfg.d_model} "
          f"d_ff={d_ff} vocab={cfg.vocab}{cut}) on {device}: weights "
          f"ready in {init_s:.2f}s")

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
    if args.static:
        return _run_static(args, cfg, exe, model, params, program, schedule,
                           requests, device, init_s)

    n_slots = args.slots or min(b, 8)
    engine = ServeEngine(model, cfg, exe, params, n_slots=n_slots,
                         prompt_pad=p, max_seq=p + g,
                         cache_dtype=torch.float32, family=spec.family,
                         module=spec.module, program=program,
                         admission=args.admission,
                         decode_chunk=args.decode_chunk,
                         page_size=args.page_size, n_pages=args.pages,
                         prefix_cache=args.prefix_cache,
                         prefill_chunk=args.prefill_chunk)
    t0 = time.time()
    counts0 = engine.warmup()
    print(f"[serve] engine warmed up in {time.time() - t0:.2f}s "
          f"({n_slots} slots, prompt_pad={p}, max_seq={p + g}, "
          f"decode_chunk={args.decode_chunk}; shapes {counts0})")
    if engine.pages is not None:
        print(f"[serve] paged cache: {engine.pages.n_pages} pages x "
              f"{args.page_size} rows (+1 scratch in the count), "
              f"prefix_cache={args.prefix_cache}, "
              f"prefill_chunk={args.prefill_chunk or 'off'}"
              + (f", shared_prefix={args.shared_prefix}"
                 if args.shared_prefix else ""))

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
    if engine.pages is not None:
        led = report.page_ledger
        print(f"  pages: {led.get('free', 0)} free / {led.get('held', 0)} "
              f"held of {led.get('total', 0)} (ledger exact: "
              f"{report.page_ledger_exact}); prefix hits "
              f"{report.prefix_hits} ({report.prefix_hit_vectors} prompt "
              f"vectors never re-prefilled), evictions "
              f"{report.page_evictions}; prefill legs "
              f"{report.prefill_chunks}, prompt-pad waste "
              f"{report.prefill_pad_vectors} vectors")
        if args.paged_verify:
            _verify_paged(engine, report, requests, args, counts0)
    for rid in sorted(report.records)[:3]:
        rec = report.records[rid]
        print(f"  req{rid}: arrival={rec.request.arrival * 1e3:.1f}ms "
              f"prompt={len(rec.request.prompt)} "
              f"gen={len(rec.tokens)}/{rec.request.max_new} "
              f"({rec.finish_reason}) ttft={rec.ttft * 1e3:.1f}ms "
              f"latency={rec.latency * 1e3:.1f}ms tokens={rec.tokens[:6]}...")
    return ServeRun(report=report, engine=engine, program=program,
                    requests=requests, schedule=schedule, init_s=init_s)


def _run_static(args, cfg, exe, model, params, program, schedule, requests,
                device, init_s) -> ServeRun:
    """The legacy monolithic path: one synchronized batch, lockstep
    decode (`engine.static_generate`)."""
    from repro_torch.runtime.engine import static_generate
    b, p, g = args.requests, args.prompt_len, args.gen
    prompts = torch.tensor([list(r.prompt) for r in requests],
                           dtype=torch.int32, device=device)
    gen_toks, (t_prefill, t_decode) = static_generate(
        model, cfg, exe, params, prompts, g, max_seq=p + g,
        cache_dtype=torch.float32)
    print(f"  prefill: {b}x{p} tokens in {t_prefill:.2f}s")
    if g <= 1:
        print("  decode:  0 steps (prefill-only, --gen 1) — no decode "
              "tok/s to report")
    else:
        print(f"  decode:  {g - 1} steps in {t_decode:.2f}s "
              f"({b * (g - 1) / max(t_decode, 1e-9):.1f} tok/s batched, "
              f"{t_decode / (g - 1) * 1e3:.1f} ms/step)")
    if program is not None:
        init = program.initialize_counts()
        per_vec = program.mvm_counts()
        n_vec = b * (p + g - 1)
        roi = per_vec.scaled(n_vec)
        print(f"  CM_INITIALIZE: {init.initialize} device writes, once "
              f"per session — independent of the {g} generated tokens")
        print(f"  CM_* in the serving ROI ({n_vec} token vectors): "
              f"queue={roi.queue} process={roi.process} "
              f"dequeue={roi.dequeue} (per vector: {per_vec.queue}/"
              f"{per_vec.process}/{per_vec.dequeue})")
    _print_schedule(args, schedule)
    for i in range(min(b, 3)):
        print(f"  req{i}: prompt={list(requests[i].prompt[:6])}... "
              f"-> gen={gen_toks[i].tolist()}")
    return ServeRun(report=None, engine=None, program=program,
                    requests=requests, schedule=schedule, init_s=init_s,
                    static_tokens=gen_toks)


def _verify_paged(engine, report, requests, args, counts0):
    """Hard acceptance for a paged run: exit nonzero unless every request
    retired, the page ledger reconciles exactly, no closure saw a new shape
    after warmup, the vector books close, and (shared prefix + prefix
    cache, synchronized, unchunked) the shared span was prefilled exactly
    once across the whole trace."""
    failures = []
    if len(report.records) != len(requests):
        lost = {r.rid for r in requests} - set(report.records)
        failures.append(f"{len(lost)} request(s) never served: "
                        f"{sorted(lost)}")
    if not report.page_ledger_exact:
        failures.append(f"page ledger does not reconcile: "
                        f"{report.page_ledger}")
    held = report.page_ledger.get("held", 0)
    cached = len(engine.prefix) if engine.prefix is not None else 0
    if held != cached:
        failures.append(f"{held} pages held at finish but {cached} prefix "
                        f"entries resident — a request leaked pages")
    if report.observed_vectors != report.useful_vectors:
        failures.append(f"device-loop vector count "
                        f"{report.observed_vectors} != per-request books "
                        f"{report.useful_vectors}")
    counts = engine.compile_counts()
    if counts != counts0:
        failures.append(f"closures saw new shapes after warmup: {counts0} "
                        f"-> {counts}")
    exact_once = (args.shared_prefix and args.prefix_cache
                  and not args.prefill_chunk and not args.trace
                  and not engine.recurrent)
    if exact_once:
        # synchronized + unchunked: admission is synchronous, so the
        # exactly-once contract is exact, not statistical
        span = (args.shared_prefix // args.page_size) * args.page_size
        plen = args.prompt_len
        paid = sorted(r.prefill_vectors for r in report.records.values())
        want = sorted([plen] + [plen - span] * (len(requests) - 1))
        if paid != want:
            failures.append(
                f"shared span not prefilled exactly once: per-request "
                f"prefill vectors {paid}, want one producer at {plen} and "
                f"{len(requests) - 1} sharers at {plen - span}")
        if report.prefix_hits != len(requests) - 1:
            failures.append(f"prefix hits {report.prefix_hits}, want "
                            f"{len(requests) - 1}")
    if failures:
        for f in failures:
            print(f"  PAGED FAILURE: {f}")
        raise SystemExit(1)
    print("  paged books close exactly: all requests served, page ledger "
          "reconciles, no new shapes after warmup"
          + (", shared span prefilled exactly once" if exact_once else ""))


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
