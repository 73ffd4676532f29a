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
lockstep decode) for A/B against the engine. ``--arrivals`` gives each
request an explicit arrival offset; ``--eos ID`` retires a lane early on
that token; ``--tile-rows``/``--adc-alpha``/``--input-scale`` set the
crossbar's word lines, ADC full scale and a fixed DAC scale.

``--reprogram`` restores the per-call STE path: nothing is programmed
before serving and every forward re-programs each projection
(`layers.linear` -> `core.aimc.aimc_linear_ste`), for A/B measurement of
the program-once speed-up; with the noise off its tokens are program-once's.
It refuses --placement, --chaos/--drift, --models and --cores/--pipeline
with the reference's messages, and --fuse-gates (whose stacks are
programmed states).

``--int8`` serves int8-native: every projection is packed into per-channel
int8 codes + scales (`core.quant.quantize_params_int8`, other float
leaves bf16) and dequantized per call on the digital path; with
``--exec aimc`` the crossbars are programmed from those codes.

``--drift NU`` ages the programmed conductances along the power law on the
serve clock and ``--chaos kill:CORE@CHUNK,corrupt:CORE@CHUNK[:MAG]``
injects deterministic faults on the chunk-dispatch clock (DESIGN.md §14):
the engine probes the live states at chunk boundaries, drains dead cores
onto peers, hot-reprograms past ``--health-threshold`` from the raw
weights under their original keys, and the run exits nonzero unless every
request retires, every fault fires, and the CM_* and recal CM_INITIALIZE
books close exactly. ``--heartbeat PATH`` beats a liveness file per chunk.

``--placement auto[:BUDGET]`` (with ``--exec aimc``) searches the
analog/digital split per layer with the cost-model placer
(`core.placement`, DESIGN.md §16); a model whose profitable layers exceed
BUDGET tiles per context serves through a rotation plan, one installed tree
per state, swapping every ``--swap-every`` decode chunks (each swap billed
as CM_INITIALIZE). ``--placement-verify`` applies the reference's checks:
every request served, tokens equal to the all-digital static oracle, every
state within the budget, exact swap books, no new shapes after warmup.

``--models NAME:EXEC[,...]`` serves several models on one shared `TilePool`
through the multi-tenant `runtime.server.ModelServer`; ``--tenants
NAME:MODEL[:WEIGHT[:ADMISSION]][,...]`` routes a mixed Poisson trace by
tenant and ``--tile-budget N`` caps the pool. The run exits nonzero on an
unreconciled ledger or a starved tenant.

``--mesh data:D,model:M`` serves through the sharded engine
(`runtime.engine.ShardedServeEngine`, DESIGN.md §11): decode slots over the
data axis, programmed crossbar bit lines over the model axis as column
pieces (one kernel launch each), tokens bit-equal to the single-device
engine outside the ambient mesh; with ``--cores N`` and ``--exec aimc`` it also prints the
schedule's per-core books reconciled (`batcher.reconcile_cores`) and each
mesh device's CM_* line (`CoreSchedule.mesh_placement`). The legacy
``DxM`` spelling keeps the single-device engine, and ``--static`` refuses a
named mesh. The engine path runs inside the ambient mesh of either
spelling, and the ``--models`` path inside a named one
(`compat.use_mesh`), where the reference's CLI enters its mesh: a digital
MoE then dispatches per data shard (`moe._moe_sharded`). The mesh's positions fold round-robin onto the devices of
``--device`` (``cuda``: every visible card; ``cpu``: the CPU), and the run
prints the fold, e.g. "4 positions on 1 device (cuda:0)". The reference's
``force_host_device_count`` (which sets XLA's host-platform device count
before JAX starts) has no counterpart: positions fold onto whatever
devices there are, and the fold is printed instead of refused. With
``--models`` a named mesh builds every model's engine sharded
(`runtime.server.build_server(mesh=)`).
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
    ap.add_argument("--arrivals", default="",
                    help="explicit comma-separated arrival offsets in "
                         "seconds, one per request")
    ap.add_argument("--eos", type=int, default=-1,
                    help="EOS token id for early retirement (-1: disabled)")
    ap.add_argument("--mesh", default="1x1",
                    help="device mesh: 'data:D,model:M' serves through the "
                         "sharded engine (slots over data, crossbar bit "
                         "lines over model; bit-equal to the single-device "
                         "path); legacy 'DxM' keeps the single-device "
                         "engine. Positions fold round-robin onto the "
                         "--device devices, and the fold is printed")
    ap.add_argument("--exec", dest="exec_mode", default="digital",
                    choices=["digital", "aimc"])
    ap.add_argument("--reprogram", action="store_true",
                    help="legacy AIMC path: re-program every forward call "
                         "(per-call STE) instead of program-once/apply-many")
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
    ap.add_argument("--int8", action="store_true",
                    help="int8-native weights: per-channel int8 codes + "
                         "scales, dequantized per call (digital) or "
                         "programmed from the codes (--exec aimc)")
    ap.add_argument("--tile-rows", dest="tile_rows", type=int, default=0,
                    help="crossbar word lines per physical tile "
                         "(0: AimcConfig default, 512)")
    ap.add_argument("--adc-alpha", dest="adc_alpha", type=float, default=0.0,
                    help="ADC clipping alpha (0: AimcConfig default)")
    ap.add_argument("--input-scale", dest="input_scale", type=float,
                    default=0.0,
                    help="fixed DAC scale (0: dynamic max-abs over the "
                         "batch, which makes AIMC tokens depend on the "
                         "batch composition)")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="conductance drift exponent nu (power-law decay of "
                         "the programmed weights on the serve clock); the "
                         "health monitor probes at chunk boundaries and "
                         "hot-reprograms cores whose output error passes "
                         "--health-threshold. 0 = off")
    ap.add_argument("--drift-t0", dest="drift_t0", type=float, default=0.05,
                    help="drift reference time t0 in seconds (decay starts "
                         "once program age exceeds t0)")
    ap.add_argument("--chaos", default="",
                    help="deterministic fault injection on the chunk-"
                         "dispatch clock: kill:CORE@CHUNK / "
                         "corrupt:CORE@CHUNK[:MAG], comma-joined (e.g. "
                         "'corrupt:0@2:0.5,kill:1@4'); the run exits "
                         "nonzero if any request is lost, any event never "
                         "fires, or the recal ledger drifts")
    ap.add_argument("--health-threshold", dest="health_threshold",
                    type=float, default=0.05,
                    help="per-core relative probe error that triggers hot "
                         "recalibration")
    ap.add_argument("--heartbeat", default="",
                    help="liveness file beaten once per decode chunk with "
                         "slot occupancy and the last-chunk wall timestamp "
                         "(fault_tolerance.Heartbeat)")
    ap.add_argument("--models", default="",
                    help="multi-tenant server: NAME:EXEC[,NAME:EXEC...] "
                         "(EXEC: aimc|digital) keeps every listed model "
                         "resident, the AIMC ones co-programmed on ONE "
                         "shared TilePool, and routes a mixed trace by "
                         "tenant (supersedes --arch/--exec)")
    ap.add_argument("--tenants", default="",
                    help="with --models: NAME:MODEL[:WEIGHT[:ADMISSION]]"
                         "[,...]: routing target, fair-share slot weight "
                         "and fifo/sjf admission per tenant (default: one "
                         "fifo tenant per model, weight 1)")
    ap.add_argument("--tile-budget", dest="tile_budget", type=int, default=0,
                    help="with --models: cap the shared pool at this many "
                         "crossbar tiles per context (0: uncapped); "
                         "co-programmed models exceeding it together fail "
                         "with CapacityError at program time")
    ap.add_argument("--placement", default="",
                    help="auto[:BUDGET]: search the analog/digital split "
                         "per layer with the cost-model placer "
                         "(core.placement) instead of the default "
                         "MappingPlan patterns. BUDGET caps the tiles per "
                         "context; a model whose profitable layers exceed "
                         "it serves through a rotation plan, reprogramming "
                         "cold groups at decode-chunk boundaries (billed as "
                         "CM_INITIALIZE per swap). Needs --exec aimc")
    ap.add_argument("--placement-verify", dest="placement_verify",
                    action="store_true",
                    help="exit nonzero unless every request served, tokens "
                         "equal the all-digital static oracle, every "
                         "rotation state packs within the budget, the "
                         "per-swap CM_INITIALIZE books close exactly, and no "
                         "closure saw a new shape after warmup")
    ap.add_argument("--swap-every", dest="swap_every", type=int, default=1,
                    help="with an overflowing --placement auto:BUDGET: "
                         "advance the rotation one state every this many "
                         "decode chunks (default 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu must be asked for explicitly")
    ap.add_argument("--weights", default="",
                    help="flat npz parameter archive (default: random)")
    args = ap.parse_args(argv)
    args.placement_budget = 0
    if args.placement:
        mode, _, budget = args.placement.partition(":")
        if mode != "auto" or (budget and not budget.isdigit()):
            ap.error(f"--placement {args.placement!r}: expected "
                     "auto or auto:BUDGET (BUDGET a positive integer)")
        if budget and int(budget) < 1:
            ap.error(f"--placement budget must be >= 1, got {budget}")
        args.placement_budget = int(budget) if budget else 0
        if args.exec_mode != "aimc" or args.reprogram:
            ap.error("--placement searches the programmed AIMC path "
                     "(--exec aimc, without --reprogram)")
        for on, name in [(args.models, "--models"),
                         (args.static, "--static"),
                         (args.drift, "--drift"), (args.chaos, "--chaos"),
                         (args.prefix_cache, "--prefix-cache"),
                         (args.prefill_chunk, "--prefill-chunk"),
                         (args.fuse_gates, "--fuse-gates")]:
            if on:
                ap.error(f"--placement cannot combine with {name} "
                         "(rotation swaps and cached/chunked prefill "
                         "spans, mid-trace repairs or fused stacks do not "
                         "compose)")
    if args.placement_verify:
        if not args.placement:
            ap.error("--placement-verify requires --placement")
        if args.trace or args.arrivals or args.eos >= 0:
            ap.error("--placement-verify compares against the synchronized "
                     "static oracle: drop --trace/--arrivals/--eos")
    if args.swap_every < 1:
        ap.error(f"--swap-every must be >= 1, got {args.swap_every}")
    if args.models:
        for on, name in [(args.static, "--static"), (args.int8, "--int8"),
                         (args.reprogram, "--reprogram"),
                         (args.cores > 1, "--cores"),
                         (args.pipeline, "--pipeline"),
                         (args.arrivals, "--arrivals"),
                         (args.paged_verify, "--paged-verify"),
                         (args.shared_prefix, "--shared-prefix"),
                         (args.drift, "--drift"), (args.chaos, "--chaos"),
                         (args.fuse_gates, "--fuse-gates"),
                         (args.layers, "--layers"),
                         (args.weights, "--weights"),
                         (args.tile_rows, "--tile-rows"),
                         (args.adc_alpha, "--adc-alpha"),
                         (args.input_scale, "--input-scale")]:
            if on:
                ap.error(f"{name} is a single-model option; --models serves "
                         "through the multi-tenant ModelServer")
    elif args.tenants or args.tile_budget:
        ap.error("--tenants/--tile-budget require --models")
    if args.tile_rows < 0 or args.adc_alpha < 0 or args.input_scale < 0:
        ap.error("--tile-rows/--adc-alpha/--input-scale must be >= 0")
    if args.chaos or args.drift:
        flag = "--chaos" if args.chaos else "--drift"
        if args.exec_mode != "aimc" or args.reprogram:
            ap.error(f"{flag} degrades/repairs PROGRAMMED crossbar states: "
                     "it requires --exec aimc without --reprogram")
        if args.static:
            ap.error(f"{flag} runs through the engine's chunk-boundary "
                     "resilience tick (drop --static)")
        if args.fuse_gates:
            ap.error(f"{flag} repairs the programmed matrices by their "
                     "paths; gate-fused stacks replace them (drop "
                     "--fuse-gates)")
    if args.chaos and args.cores < 2:
        ap.error("--chaos needs --cores >= 2: a killed core drains onto "
                 "surviving peers, so there must be at least one")
    if args.drift < 0:
        ap.error(f"--drift must be >= 0, got {args.drift}")
    if ((args.cores > 1 or args.pipeline)
            and (args.exec_mode != "aimc" or args.reprogram)):
        ap.error("--cores/--pipeline require the programmed AIMC path "
                 "(--exec aimc, without --reprogram): the multi-core "
                 "schedule lowers an installed AimcProgram")
    if args.fuse_gates and args.reprogram:
        ap.error("--fuse-gates stacks programmed states; --reprogram "
                 "programs every forward call instead")
    if args.trace and args.arrivals:
        ap.error("--trace and --arrivals are mutually exclusive")
    if args.page_size < 0 or args.pages < 0 or args.prefill_chunk < 0 \
            or args.shared_prefix < 0:
        ap.error("--page-size/--pages/--prefill-chunk/--shared-prefix "
                 "must be >= 0")
    if args.page_size == 0 and (args.prefix_cache or args.prefill_chunk
                                or args.pages or args.paged_verify):
        ap.error("--prefix-cache/--prefill-chunk/--pages/--paged-verify "
                 "require --page-size")
    if args.static and (args.trace or args.arrivals):
        ap.error("--static serves one synchronized batch; staggered "
                 "traces/arrivals need the engine")
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


def parse_mesh(arg: str):
    """(shape, axes, sharded) from a --mesh string.

    ``data:D,model:M`` (any subset/order of named axes) selects the sharded
    engine; the legacy ``DxM`` / ``PxDxM`` positional syntax keeps the
    single-device `ServeEngine`."""
    if ":" in arg:
        pairs = [p.split(":", 1) for p in arg.split(",")]
        bad = [p for p in pairs if len(p) != 2 or not p[1].isdigit()
               or int(p[1]) < 1]
        if bad or not pairs:
            raise SystemExit(f"--mesh {arg!r}: expected AXIS:SIZE[,AXIS:SIZE]"
                             " with SIZE >= 1 (e.g. data:2,model:1)")
        axes = tuple(name for name, _ in pairs)
        if len(set(axes)) != len(axes):
            raise SystemExit(f"--mesh {arg!r}: duplicate axis")
        return tuple(int(s) for _, s in pairs), axes, True
    try:
        shape = tuple(int(s) for s in arg.split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {arg!r}: expected DxM / PxDxM or the "
                         "named AXIS:SIZE[,AXIS:SIZE] syntax") from None
    if len(shape) not in (2, 3) or any(s < 1 for s in shape):
        raise SystemExit(f"--mesh {arg!r}: positional syntax takes 2 (DxM) "
                         "or 3 (PxDxM) sizes, each >= 1")
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    return shape, axes, False


def parse_named_mesh(arg: str):
    """(shape, axes) from a --mesh string, requiring the named syntax (the
    positional spelling means "single-device engine" in this CLI and must
    not select the sharded one elsewhere)."""
    shape, axes, sharded = parse_mesh(arg)
    if not sharded:
        raise SystemExit(f"--mesh {arg!r}: this path takes the named "
                         "AXIS:SIZE[,AXIS:SIZE] syntax (e.g. "
                         "data:2,model:1); the positional DxM spelling "
                         "selects the single-device engine in launch.serve")
    return shape, axes


def _named_mesh(args, device):
    """The sharded engine's mesh for a named --mesh, its positions folded
    onto ``device``'s devices (every visible card for ``cuda``), or None
    for the legacy spelling."""
    from repro_torch.launch.mesh import make_mesh, visible_devices
    shape, axes, sharded = parse_mesh(args.mesh)
    if not sharded:
        return None
    mesh = make_mesh(shape, axes, visible_devices(str(device)))
    print(f"[serve] {mesh.describe()}")
    return mesh


def _legacy_mesh(args, device):
    """The ambient mesh of the legacy ``DxM`` / ``PxDxM`` spelling: the
    engine stays single-device, but the reference serves inside this mesh
    (so a digital MoE takes `moe._moe_sharded`), and so does the port."""
    from repro_torch.launch.mesh import make_mesh, visible_devices
    shape, axes, _ = parse_mesh(args.mesh)
    return make_mesh(shape, axes, visible_devices(str(device)))


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
    base = synchronized_trace(n, prompt_len=p, max_new=g, seed=args.seed,
                              vocab=vocab)
    if args.arrivals:
        offs = [float(x) for x in args.arrivals.split(",")]
        if len(offs) != n:
            raise SystemExit(f"--arrivals needs {n} offsets, got {len(offs)}")
        base = [dataclasses.replace(r, arrival=t) for r, t in zip(base, offs)]
    return base


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
    placement: object = None         # the --placement search's result
    params_raw: object = None        # the raw tree, kept under rotation
                                     # or --placement-verify


def parse_models(arg: str):
    """``NAME:EXEC[,NAME:EXEC...]`` -> list of `runtime.server.ModelSpec`;
    NAME is an arch id and doubles as the model id requests route by."""
    from repro_torch.runtime.server import ModelSpec
    specs = []
    for part in arg.split(","):
        name, _, mode = part.partition(":")
        if not name:
            raise SystemExit(f"--models {arg!r}: empty model name")
        try:
            specs.append(ModelSpec(name=name, arch=name,
                                   exec_mode=mode or "digital"))
        except ValueError as e:
            raise SystemExit(f"--models {arg!r}: {e}") from None
    return specs


def parse_tenants(arg: str, specs):
    """``NAME:MODEL[:WEIGHT[:ADMISSION]][,...]`` -> `TenantPolicy` list."""
    from repro_torch.runtime.tenancy import TenantPolicy
    known = {s.name for s in specs}
    out = []
    for part in arg.split(","):
        fields = part.split(":")
        if len(fields) < 2 or len(fields) > 4:
            raise SystemExit(f"--tenants {arg!r}: expected "
                             f"NAME:MODEL[:WEIGHT[:ADMISSION]], got {part!r}")
        name, model = fields[0], fields[1]
        if model not in known:
            raise SystemExit(f"--tenants {arg!r}: tenant {name!r} routes to "
                             f"{model!r}, not in --models ({sorted(known)})")
        try:
            out.append(TenantPolicy(
                name=name, model=model,
                weight=float(fields[2]) if len(fields) > 2 else 1.0,
                admission=fields[3] if len(fields) > 3 else "fifo"))
        except ValueError as e:
            raise SystemExit(f"--tenants {arg!r}: {e}") from None
    return out


@dataclasses.dataclass
class ServerRun:
    """What a --models run served: the report and the server behind it."""
    report: object
    server: object
    trace: list
    reconciled: dict


def _run_server(args) -> ServerRun:
    """The --models path: multi-tenant, multi-model serving on one pool."""
    device = resolve_device(args.device)
    specs = parse_models(args.models)
    tenants = parse_tenants(args.tenants, specs) if args.tenants else None
    mesh = _named_mesh(args, device)
    rate = 100.0
    if args.trace:
        kind, _, param = args.trace.partition(":")
        if kind != "poisson":
            raise SystemExit(f"unknown --trace kind {kind!r} "
                             "(supported: poisson:RATE)")
        rate = float(param or "100")
    if mesh is not None:
        from repro_torch import compat
        with compat.use_mesh(mesh):
            return _serve_models(args, device, specs, tenants, mesh, rate)
    return _serve_models(args, device, specs, tenants, mesh, rate)


def _serve_models(args, device, specs, tenants, mesh, rate) -> ServerRun:
    """The --models path after parsing (inside a named mesh, when given)."""
    from repro_torch.configs import get_arch
    from repro_torch.runtime.server import build_server
    from repro_torch.runtime.tenancy import mixed_poisson_trace

    p, g = args.prompt_len, args.gen
    n_slots = args.slots or 4
    t0 = time.time()
    server = build_server(
        specs, tenants, smoke=args.smoke, n_slots=n_slots, prompt_pad=p,
        max_seq=p + g, seed=args.seed,
        tiles_per_context=args.tile_budget or None,
        eos_id=None if args.eos < 0 else args.eos,
        decode_chunk=args.decode_chunk, page_size=args.page_size,
        n_pages=args.pages, prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk, device=device, mesh=mesh)
    server.warmup()
    print(f"[serve] {len(specs)} model(s) resident, "
          f"{len(server.policies)} tenant(s), {n_slots} slots each on "
          f"{device}; built+warmed in {time.time() - t0:.2f}s")
    if server.pool is not None:
        print(f"[serve] {server.pool.summary()} (crossbar-capacity "
              f"utilization {server.pool.utilization * 100:.0f}%)")

    def vocab(s):
        a = get_arch(s.arch)
        return (a.smoke_cfg if args.smoke else a.model_cfg).vocab

    trace = mixed_poisson_trace(
        list(server.policies.values()), args.requests, rate,
        vocab_of={s.name: vocab(s) for s in specs}, seed=args.seed,
        prompt_len=(max(1, p // 2), p), max_new=(1, g))
    heartbeat = None
    if args.heartbeat:
        from repro_torch.runtime.fault_tolerance import Heartbeat
        heartbeat = Heartbeat(args.heartbeat)
    report = server.serve(trace, heartbeat=heartbeat)
    print(f"[serve] {report.summary()}")
    for m in server.engines:
        shares = server.fair_shares(m)
        print(f"  {m}: entitled slots "
              + ", ".join(f"{t}={v:.2f}" for t, v in sorted(shares.items())))
    recon = server.reconcile(report)
    for m, ok in sorted(recon.items()):
        label = {True: "True", False: "FAILED", None: "n/a (digital)"}[ok]
        print(f"  {m}: per-tenant CM_* ledgers reconcile against "
              f"program.mvm_counts(): {label}")
    stats = report.tenant_stats()
    starved = [name for name, st in stats.items()
               if st.n_requests > 0 and st.generated_tokens == 0]
    if starved:
        print(f"[serve] STARVED tenants (had requests, got 0 tokens): "
              f"{starved}")
    if any(ok is False for ok in recon.values()) or starved:
        raise SystemExit(1)
    return ServerRun(report=report, server=server, trace=trace,
                     reconciled=recon)


def main(argv=None):
    """Serve one model (returns a `ServeRun`) or, with --models, several
    on one pool (returns a `ServerRun`)."""
    args = parse_args(argv)
    if args.models:
        return _run_server(args)
    if args.fuse_gates and args.exec_mode != "aimc":
        raise SystemExit("--fuse-gates stacks programmed states: it needs "
                         "--exec aimc")
    from repro_torch import compat

    device = resolve_device(args.device)
    if parse_mesh(args.mesh)[2] and args.static:
        raise SystemExit("--static is the single-device A/B oracle; "
                         "the sharded engine needs the named-mesh engine "
                         "path (drop --static or use the legacy DxM syntax)")
    mesh = _named_mesh(args, device)
    with compat.use_mesh(mesh or _legacy_mesh(args, device)):
        return _serve_one(args, device, mesh)


def _serve_one(args, device, mesh):
    """The single-model path of `main`, inside the ambient mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.core.aimc import AimcConfig
    from repro_torch.core.prng import PRNGKey
    from repro_torch.models.layers import Execution
    from repro_torch.runtime.batcher import reconcile, reconcile_cores
    from repro_torch.runtime.engine import ServeEngine, ShardedServeEngine

    spec = get_arch(args.arch)
    cfg = spec.smoke_cfg if args.smoke else spec.model_cfg
    if spec.family == "audio":
        raise SystemExit("serve.py drives decoder-only LMs; the enc-dec "
                         "audio family decodes via launch.steps")
    if args.layers:
        if not 0 < args.layers <= cfg.n_layers:
            raise SystemExit(f"--layers {args.layers} outside 1..{cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = spec.model_module()
    if args.fuse_gates and not hasattr(model, "fuse_gate_stacks"):
        raise SystemExit(f"--fuse-gates: {spec.arch_id} ({spec.module}) has "
                         f"no gate stacks to fuse")
    aimc_kw = {}
    if args.tile_rows:
        aimc_kw["tile_rows"] = args.tile_rows
    if args.adc_alpha:
        aimc_kw["adc_alpha"] = args.adc_alpha
    aimc_cfg = AimcConfig(input_scale=args.input_scale, **aimc_kw)
    exe = (Execution(mode="aimc", aimc=aimc_cfg, compute_dtype="float32",
                     programmed=not args.reprogram)
           if args.exec_mode == "aimc"
           else Execution(compute_dtype="float32" if args.smoke
                          else "bfloat16", serve_int8=args.int8))
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
    if args.int8:
        from repro_torch.core.quant import quantize_params_int8
        params = quantize_params_int8(params)
    cut = (f", depth cut to {cfg.n_layers} of "
           f"{(spec.smoke_cfg if args.smoke else spec.model_cfg).n_layers}"
           if args.layers else "")
    d_ff = getattr(cfg, "d_ff", None) or getattr(cfg, "d_ff_s", None)
    print(f"[serve] {spec.arch_id} ({cfg.n_layers}L d_model={cfg.d_model} "
          f"d_ff={d_ff} vocab={cfg.vocab}{cut}) on {device}: weights "
          f"ready in {init_s:.2f}s")

    program = schedule = health = chaos = None
    placement = rotation = rotation_params = params_raw = None
    if args.exec_mode == "aimc" and not args.reprogram:
        # CM_INITIALIZE: program the whole network once, outside the
        # serving loop (paper §IV-B); the raw float weights of the mapped
        # projections are dropped with the raw tree. --cores spreads the
        # matrices over per-core tile contexts (paper Fig. 2).
        from repro_torch.core.program import MappingPlan, program_model
        from repro_torch.core.schedule import CoreSchedule
        t0 = time.time()
        plan = MappingPlan(n_contexts=args.cores)
        if args.placement:
            # cost-model placement (DESIGN.md §16): search the split under
            # the tile budget; an overflowing model gets a rotation plan
            # whose states time-multiplex the freed headroom
            from repro_torch.core.placement import plan_placement
            placement = plan_placement(
                params, plan, aimc_cfg,
                tiles_per_context=args.placement_budget or None,
                n_contexts=args.cores, swap_every=args.swap_every)
            print(f"[serve] {placement.summary()}")
            plan = (placement.rotation.plan()
                    if placement.rotation is not None else placement.plan)
        prog_key = PRNGKey(args.seed + 2)
        program = program_model(params, plan, aimc_cfg, prog_key)
        params_raw = params
        if placement is not None and placement.rotation is not None:
            # one uncapped program over every sometimes-analog layer; each
            # rotation state installs only its resident subset (the rest
            # serve digitally from the raw weights, which stay alive)
            rotation = placement.rotation
            rotation_params = tuple(program.install_subset(params_raw, ns)
                                    for ns in rotation.states())
            params = rotation_params[0]
        else:
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
        if args.drift or args.chaos:
            # drift-aware serving (DESIGN.md §14): the raw weights and the
            # programming keys are captured off the RAW tree, so a hot
            # reprogram is bit-exact
            health, chaos = _build_resilience(args, program, params_raw,
                                              plan, prog_key)
        if rotation is None and not args.placement_verify:
            params_raw = None    # frees the raw weights of mapped leaves
    print(f"[serve] {spec.arch_id} exec={args.exec_mode} int8={args.int8} "
          f"requests={b}"
          + (" (per-call reprogram)" if args.exec_mode == "aimc"
             and args.reprogram else "")
          + (" (gate-fused stacks)" if args.fuse_gates else ""))
    if args.static:
        return _run_static(args, cfg, exe, model, params, program, schedule,
                           requests, device, init_s)

    n_slots = args.slots or min(b, 8)
    heartbeat = None
    if args.heartbeat:
        from repro_torch.runtime.fault_tolerance import Heartbeat
        heartbeat = Heartbeat(args.heartbeat)
    common = dict(n_slots=n_slots, prompt_pad=p, max_seq=p + g,
                  cache_dtype=torch.float32, family=spec.family,
                  module=spec.module, program=program, schedule=schedule,
                  eos_id=None if args.eos < 0 else args.eos,
                  admission=args.admission, decode_chunk=args.decode_chunk,
                  page_size=args.page_size, n_pages=args.pages,
                  prefix_cache=args.prefix_cache,
                  prefill_chunk=args.prefill_chunk, health=health,
                  chaos=chaos, heartbeat=heartbeat, rotation=rotation,
                  rotation_params=rotation_params)
    if mesh is not None:
        engine = ShardedServeEngine(model, cfg, exe, params, mesh=mesh,
                                    **common)
    else:
        engine = ServeEngine(model, cfg, exe, params, **common)
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
    if program is not None and rotation is not None:
        # rotation books: the per-vector CM_* split varies by state, so the
        # per-request ledgers are ill-defined; the per-swap CM_INITIALIZE
        # bill is what must close exactly
        from repro_torch.core.placement import reconcile_swaps
        init = program.initialize_counts()
        print(f"  CM_INITIALIZE: {init.initialize} device writes for the "
              f"initial program ({rotation.n_states} rotation states over "
              f"{len(rotation.all_names)} analog matrices)")
        print(f"  rotation: {report.n_swaps} swaps (every "
              f"{rotation.swap_every} chunk(s)), swap CM_INITIALIZE="
              f"{report.swap_initialize}, {report.wall_swap_s * 1e3:.0f}ms "
              f"swap wall")
        for ev in report.swap_events[:3]:
            print(f"    swap@chunk{ev.chunk} -> state {ev.state}: "
                  f"{len(ev.incoming)} matrices, "
                  f"CM_INITIALIZE={ev.initialize}")
        print(f"  per-swap CM_INITIALIZE books close exactly: "
              f"{reconcile_swaps(program, report)}")
    elif program is not None:
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
        led_sum, static_sum = reconcile(engine.program, report.records,
                                        report.observed_vectors)
        ok = led_sum == static_sum
        print(f"  per-request ledger sum reconciles with the program's "
              f"static accounting: {ok}")
        if not ok:
            raise SystemExit(1)
        if mesh is not None and schedule is not None:
            core_sum, sched_total = reconcile_cores(
                engine.schedule, report.records, report.observed_vectors)
            print(f"  per-core ledgers (aggregated across shards) "
                  f"reconcile with the schedule totals: "
                  f"{core_sum == sched_total}")
            for dev, cm in sorted(engine.device_ledgers(report).items()):
                print(f"    mesh device[{engine.model_axis}={dev}]: "
                      f"queue={cm.queue} process={cm.process} "
                      f"dequeue={cm.dequeue}")
            if core_sum != sched_total:
                raise SystemExit(1)
        if health is not None:
            _verify_resilience(engine, report, requests, chaos)
        _print_schedule(args, engine.schedule)
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
    if args.placement_verify:
        _verify_placement(engine, report, requests, args, placement, program,
                          params_raw, model, cfg, exe, counts0, device)
    for rid in sorted(report.records)[:3]:
        rec = report.records[rid]
        print(f"  req{rid}: arrival={rec.request.arrival * 1e3:.1f}ms "
              f"prompt={len(rec.request.prompt)} "
              f"gen={len(rec.tokens)}/{rec.request.max_new} "
              f"({rec.finish_reason}) ttft={rec.ttft * 1e3:.1f}ms "
              f"latency={rec.latency * 1e3:.1f}ms tokens={rec.tokens[:6]}...")
    return ServeRun(report=report, engine=engine, program=program,
                    requests=requests, schedule=schedule, init_s=init_s,
                    placement=placement, params_raw=params_raw)


def _build_resilience(args, program, params_raw, plan, prog_key):
    """(HealthMonitor, FaultInjector or None) for --drift / --chaos."""
    from repro_torch.core import noise as noise_lib
    from repro_torch.runtime.chaos import parse_chaos
    from repro_torch.runtime.health import HealthPolicy, build_health
    noise = (noise_lib.drift_only(nu=args.drift, t0=args.drift_t0)
             if args.drift else None)
    health = build_health(program, params_raw, plan, prog_key,
                          policy=HealthPolicy(threshold=args.health_threshold),
                          noise=noise)
    chaos = parse_chaos(args.chaos) if args.chaos else None
    what = " + ".join(
        ([f"drift nu={args.drift:g} t0={args.drift_t0:g}s"]
         if args.drift else [])
        + ([f"chaos [{', '.join(e.describe() for e in chaos.events)}]"]
           if chaos else []))
    print(f"[serve] resilience: {what}; probe threshold "
          f"{args.health_threshold:g}")
    return health, chaos


def _verify_resilience(engine, report, requests, chaos):
    """Hard acceptance for a drift/chaos run: exit nonzero if any request
    was lost, any scheduled fault never fired, the per-request CM_* books
    fail against the (possibly remapped) program, or the recalibration
    ledger does not close exactly."""
    from repro_torch.runtime.batcher import reconcile
    from repro_torch.runtime.health import reconcile_recal
    for ev in report.fault_events:
        print(f"  fault injected: {ev.describe()}")
    for ev in report.recal_events:
        print(f"  hot recal [{ev.reason}] cores={list(ev.cores)}: "
              f"{len(ev.names)} matrices reprogrammed, "
              f"CM_INITIALIZE={ev.initialize}, {ev.wall_s * 1e3:.0f}ms")
    print(f"  health: {report.probes} probes, {report.n_recals} recals, "
          f"recal CM_INITIALIZE={report.recal_initialize} (charged on top "
          f"of the session's program-once bill), "
          f"{report.wall_health_s:.2f}s health wall")
    failures = []
    if len(report.records) != len(requests):
        lost = {r.rid for r in requests} - set(report.records)
        failures.append(f"LOST {len(lost)} in-flight request(s): "
                        f"{sorted(lost)}")
    if chaos is not None and not chaos.exhausted:
        left = [e.describe() for e in chaos.events if e not in chaos.fired]
        failures.append(f"chaos events never fired: {left}")
    led_sum, static_sum = reconcile(engine.program, report.records,
                                    report.observed_vectors)
    if led_sum != static_sum:
        failures.append("per-request CM_* ledgers do not reconcile against "
                        "the recovered program")
    if not reconcile_recal(engine.program, report):
        failures.append("recalibration CM_INITIALIZE books do not close")
    if failures:
        for f in failures:
            print(f"  RESILIENCE FAILURE: {f}")
        raise SystemExit(1)
    print("  resilience books close exactly: no lost requests, every "
          "fault fired, CM_* + recal ledgers reconcile")


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


def _verify_placement(engine, report, requests, args, placement, program,
                      params_raw, model, cfg, exe, counts0, device):
    """Hard acceptance for a --placement run, the reference's checks as
    written: exit nonzero unless every request retired, every token equals
    the ALL-DIGITAL static oracle on the raw weights, every rotation state
    packs within the budget, the per-swap CM_INITIALIZE books close
    (`placement.reconcile_swaps`), an overflowing trace actually swapped,
    and no closure saw a new shape after warmup."""
    from repro_torch.core.placement import reconcile_swaps
    from repro_torch.core.tile import pack_contexts
    from repro_torch.runtime.engine import static_generate
    failures = []
    if len(report.records) != len(requests):
        lost = {r.rid for r in requests} - set(report.records)
        failures.append(f"{len(lost)} request(s) never served: "
                        f"{sorted(lost)}")
    dig_exe = dataclasses.replace(exe, mode="digital")
    prompts = torch.tensor([list(r.prompt) for r in requests],
                           dtype=torch.int32, device=device)
    oracle, _ = static_generate(model, cfg, dig_exe, params_raw, prompts,
                                args.gen, max_seq=args.prompt_len + args.gen,
                                cache_dtype=torch.float32)
    bad = [r.rid for i, r in enumerate(requests)
           if r.rid in report.records
           and report.tokens(r.rid) != oracle[i].tolist()]
    if bad:
        failures.append(f"tokens diverge from the all-digital oracle for "
                        f"request(s) {bad}")
    rot = engine.rotation
    if rot is not None:
        for i, names in enumerate(rot.states()):
            resident = set(names)
            per = pack_contexts([c.item for c in placement.costs
                                 if c.path in resident], rot.n_contexts,
                                program.cfg.tile_rows, program.cfg.tile_cols)
            if max(per) > rot.tiles_per_context:
                failures.append(f"rotation state {i} packs to {max(per)} "
                                f"tiles > budget {rot.tiles_per_context}")
        if rot.n_states > 1 and report.n_swaps == 0:
            failures.append("overflowing plan never swapped (trace too "
                            "short for the swap cadence?)")
        if not reconcile_swaps(program, report):
            failures.append("per-swap CM_INITIALIZE books do not close")
    counts = engine.compile_counts()
    if counts != counts0:
        failures.append(f"closures saw new shapes after warmup: {counts0} "
                        f"-> {counts}")
    if failures:
        for f in failures:
            print(f"  PLACEMENT FAILURE: {f}")
        raise SystemExit(1)
    print("  placement books close exactly: all requests served, tokens "
          "bit-equal to the all-digital oracle"
          + (f", {report.n_swaps} swaps billed + reconciled"
             if rot is not None else "")
          + ", no new shapes after warmup")


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
