"""The serving driver: the port's `runtime.engine.ServeEngine`, built as
`launch/serve.py` builds it for ``--exec aimc`` (the whole network
programmed once with `core.program.program_model`, then installed),
serving its own loop (`ServeEngine.serve`) over the cell's backlog.

The engine's loop cannot be ended from outside, so the benchmark wraps
the engine's chunk readback (`_process_chunk`): it stamps every token
that became readable there with the host clock, and at the first
readback past ``seconds`` it stops the loop, counting only what
completed inside. A second wrapper counts the prompt positions of each
prefill leg (`_advance_leg`). Each request's tokens are judged after
the window against the reference's logits over its prompt and tokens,
and a sample of the window's digital stages on their own inputs
(`stages.py`).

Set-up warms up the cell's own shapes and nothing else: it serves one
request of ``prefill_chunk + 1`` prompt positions (a whole leg and a
part leg) and two tokens (a decode turn of every slot), which builds the
kernels and fills the engine's page pools that the window then reuses."""

from __future__ import annotations

import contextlib
import gc
import random
import time

import torch

from portbench.harness import common, counts, faults, judge, \
    spec as spec_mod, stages, trace, traffic, weights
from portbench.reference import aimc as ref_aimc
from portbench.reference import model as ref


class _Stop(Exception):
    pass


def build(cell, seed: int, dev):
    """The programmed engine (built as `launch/serve.py` builds it)."""
    from repro_torch.core.prng import PRNGKey
    from repro_torch.core.program import MappingPlan, program_model
    from repro_torch.core.schedule import CoreSchedule
    from repro_torch.runtime.engine import ServeEngine

    t = cell.traffic
    spec = spec_mod.port_spec(cell.config)
    exe = spec_mod.execution(cell.config, None, programmed=True)
    m = spec_mod.ref_model_of(cell.config)
    params = weights.make(m, seed, torch.float32, dev)
    weights.check_against_port(params, spec)
    program = program_model(params, MappingPlan(n_contexts=1), exe.aimc,
                            PRNGKey(seed))
    params = program.install(params)
    engine = ServeEngine(
        spec.model_module(), spec.model_cfg, exe, params,
        n_slots=t["slots"], prompt_pad=t["prompt"]["max"],
        max_seq=t["max_seq"], cache_dtype=torch.float32, family=spec.family,
        module=spec.module, program=program,
        schedule=CoreSchedule.from_program(program), eos_id=None,
        decode_chunk=t["decode_chunk"], page_size=t["page_size"],
        prefill_chunk=t["prefill_chunk"])
    del params
    return engine


def warm_up(engine, cell, seed: int) -> None:
    """Serve one request of a whole leg and one position more, two tokens
    out, with every digital stage's first call checked (its kernels load
    here, not in the window)."""
    from repro_torch.runtime.batcher import Request

    t = cell.traffic
    g = torch.Generator().manual_seed(common.gen_seed(seed, 5))
    ids = torch.randint(1, engine.cfg.vocab, (t["prefill_chunk"] + 1,),
                        generator=g)
    with stages.program(stages.Watch(cap=1), train=False):
        engine.serve([Request(rid=-1, prompt=tuple(ids.tolist()), max_new=2,
                              arrival=0.0)])


def program_side(cell, seed: int, seconds: float, trace_on: bool, dev,
                 wrap=None, tf32: bool = False) -> dict:
    """Set-up, the window, and the finished requests' prompts and
    tokens. ``wrap(engine)`` (tests) plants a fault in the engine;
    ``tf32`` (the control) lets the program's f32 products round their
    operands to TF32."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with (faults.tf32_products() if tf32 and dev.type != "cuda"
              else contextlib.nullcontext()):
            return _program_side(cell, seed, seconds, trace_on, dev, wrap)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _program_side(cell, seed, seconds, trace_on, dev, wrap):
    from repro_torch.runtime.batcher import Request

    t = cell.traffic
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    engine = build(cell, seed, dev)
    if wrap is not None:
        wrap(engine)
    warm_up(engine, cell, seed)
    reqs = [Request(rid=i, prompt=p, max_new=n, arrival=0.0)
            for i, (p, n) in enumerate(
                traffic.serve_requests(t, engine.cfg.vocab, seed))]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - common.T0

    stamps: dict = {}           # rid -> host time of each token
    done: set = set()
    reads: list = []            # (host time, steps) per readback
    legs: list = []             # (host time, pos0, span) per finished leg
    box = {}
    calls: dict = {}
    marks = {"t0": 0.0, "trace": None}
    prof = trace.Profiler(dev) if trace_on else None
    trace_from = seconds - t["trace_seconds"]
    orig_chunk = engine._process_chunk
    orig_leg = engine._advance_leg

    def chunk(sess, pend, now):
        out = orig_chunk(sess, pend, now)
        tn = time.perf_counter()
        reads.append((tn, pend.n))
        for rid, rec in sess.report.records.items():
            if rid in done:
                continue
            have = stamps.setdefault(rid, [])
            have.extend([tn] * (len(rec.tokens) - len(have)))
            if rec.finish_reason:
                done.add(rid)
        box["sess"] = sess
        if tn - marks["t0"] >= seconds:
            box["t_end"] = tn
            if prof is not None:
                box["trace_s"] = prof.stop()
            raise _Stop
        if (prof is not None and marks["trace"] is None
                and tn - marks["t0"] >= trace_from):
            for v in calls.values():
                v.clear()
            marks["trace"] = tn
            prof.start()
        return out

    def leg(sess, job, now):
        pos0, span, _ = job.legs[job.leg_i]
        out = orig_leg(sess, job, now)
        legs.append((time.perf_counter(), pos0, span))
        return out

    engine._process_chunk = chunk
    engine._advance_leg = leg
    watch = stages.Watch(cap=4, offset=common.gen_seed(seed, 6))
    with contextlib.ExitStack() as st:
        st.enter_context(stages.program(watch, train=False))
        if trace_on:
            engine._process_chunk = trace.ranged("pb.readback", chunk)
            engine._advance_leg = trace.ranged("pb.leg", leg)
            st.enter_context(trace.instrument(calls))
        marks["t0"] = time.perf_counter()
        _serve(engine, reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sess = box["sess"]
    recs = sess.report.records
    if len(recs) >= len(reqs):
        raise RuntimeError("the backlog ran dry inside the window: the "
                           "traffic file's backlog is too short")
    plen = {rid: len(recs[rid].request.prompt) for rid in stamps}
    got = {"setup_s": setup_s, "window_s": box["t_end"] - marks["t0"],
           "finished": {rid: (recs[rid].request.prompt,
                              list(recs[rid].tokens))
                        for rid in done
                        if recs[rid].finish_reason == "length"},
           "attempted": len(recs), "failed": 0, "calls": calls,
           "stages": watch.readings(),
           "itl_s": [b - a for ts in stamps.values()
                     for a, b in zip(ts, ts[1:])],
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    got.update(_tally(cell.config, stamps, plen, legs, reads, marks["t0"]))
    if trace_on:
        before = _tally(cell.config, stamps, plen, legs, reads, marks["t0"],
                        marks["trace"])
        got.update(mfu_flops=before["window_flops"],
                   mfu_s=marks["trace"] - marks["t0"])
        got.update(_tally(cell.config, stamps, plen, legs, reads,
                          marks["trace"]))
        got["trace"] = trace.read(prof.prof)
        got["window_s"] = box["trace_s"]
    engine.__dict__.pop("_process_chunk", None)   # the wrappers' cycle
    engine.__dict__.pop("_advance_leg", None)
    del engine, sess, recs, box, chunk, leg, orig_chunk, orig_leg
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return got


def _tally(c: dict, stamps: dict, plen: dict, legs: list, reads: list,
           since: float, until: float = float("inf")) -> dict:
    """What completed in host time [``since``, ``until``): prompt
    positions prefilled, tokens read back, their model FLOPs, and the host
    time per decoded step between consecutive readbacks."""
    legs = [(p0, span) for t, p0, span in legs if since <= t < until]
    flops = sum(counts.sequence_flops(c, p0, span) for p0, span in legs)
    generated = 0
    for rid, ts in stamps.items():
        new = [i for i, t in enumerate(ts) if since <= t < until]
        generated += len(new)
        dec = [i for i in new if i >= 1]       # token 0 is the prefill's
        if dec:
            flops += counts.sequence_flops(c, plen[rid] + dec[0] - 1,
                                           len(dec))
    reads = [r for r in reads if since <= r[0] < until]
    return {"prefilled": sum(span for _, span in legs),
            "generated": generated, "window_flops": flops,
            "decode_step_s": [(b[0] - a[0]) / b[1]
                              for a, b in zip(reads, reads[1:])]}


def _serve(engine, reqs):
    try:
        engine.serve(reqs)
    except _Stop:
        pass


def sample(finished: dict, seed: int, want_tokens: int) -> list:
    """Finished requests to judge, drawn from the seed: the one with the
    longest prompt and tokens first, then others until ``want_tokens``
    served tokens are in."""
    if not finished:
        return []
    rids = sorted(finished)
    longest = max(rids, key=lambda r: len(finished[r][0])
                  + len(finished[r][1]))
    rest = [r for r in rids if r != longest]
    random.Random(common.gen_seed(seed, 4)).shuffle(rest)
    out, n = [longest], len(finished[longest][1])
    for r in rest:
        if n >= want_tokens:
            break
        out.append(r)
        n += len(finished[r][1])
    return [finished[r] for r in out]


def reference_states(cell, seed: int, dev, qmax: int = ref_aimc.QMAX):
    """The reference's own programming of the seed's weights (noise off):
    name -> (int8 codes [L, KB, M, Np], scales [L, KB, Np], n), and the
    digital leaves; ``qmax`` 7 programs the int4 control."""
    m = spec_mod.ref_model_of(cell.config)
    xb = spec_mod.crossbar_of(cell.config, None, qmax)
    states, digital = {}, {"blocks": {}}
    for name, w in weights.leaves(m, seed, torch.float32, dev):
        leaf = name.split("/")[-1]
        if name.startswith("blocks/w"):
            codes, scales = [], []
            for i in range(w.shape[0]):
                c, s = ref_aimc.program(w[i][None], xb)
                codes.append(c[0].to(torch.int8))
                scales.append(s[0])
            states[leaf] = (torch.stack(codes), torch.stack(scales),
                            w.shape[-1])
        elif name.startswith("blocks/"):
            digital["blocks"][leaf] = w
        else:
            digital[name] = w
    return states, digital


def reference_logits(cell, states, digital, prompt, tokens, dev,
                     qmax: int = ref_aimc.QMAX) -> torch.Tensor:
    """Logits [len(prompt) + len(tokens) - 1, V] at every position of one
    forward over the prompt and the served tokens before the last; the
    last ``len(tokens)`` rows are those that served ``tokens``."""
    m = spec_mod.ref_model_of(cell.config)
    xb = spec_mod.crossbar_of(cell.config, None, qmax)
    seq = torch.tensor(list(prompt) + list(tokens[:-1]), dtype=torch.int64,
                       device=dev)
    with torch.no_grad():
        return ref.serve_logits(_IntStates(states), digital, seq, m, xb,
                                ref.Precision(act=torch.float32))


class _IntStates(dict):
    """int8 codes handed to the reference as f32 one layer at a time."""

    def __getitem__(self, name):
        codes, scales, n = dict.__getitem__(self, name)
        return _F32Codes(codes), scales, n


class _F32Codes:
    def __init__(self, codes):
        self.codes = codes

    def __getitem__(self, i):
        return self.codes[i].to(torch.float32)


def e2e(cell, got: dict) -> dict:
    from portbench.harness.stats import percentile
    return {"serve_tok_s": ((got["prefilled"] + got["generated"])
                            / got["window_s"], "tokens/s"),
            "itl_p95_ms": (percentile(got["itl_s"], 95) * 1e3, "ms"),
            "setup_s": (got["setup_s"], "s")}


def judge_served(cell, seed: int, got: dict, dev) -> tuple[dict, int]:
    """(readings, tokens judged) of the sampled finished requests."""
    picked = sample(got["finished"], seed, cell.traffic["check_tokens"])
    states, digital = reference_states(cell, seed, dev)
    worst, n = 0.0, 0
    for prompt, toks in picked:
        lg = reference_logits(cell, states, digital, prompt, toks, dev)
        worst = max(worst, judge.logit_gap(
            lg[len(prompt) - 1:], torch.tensor(toks, device=dev)))
        n += len(toks)
    del states, digital
    st = got["stages"]
    return {"token_gap": worst if picked else float("nan"),
            "digital_gap": st["digital_gap"],
            "where": {"digital": st["digital"]}}, n


def int4_readings(cell, seed: int, got: dict, dev) -> dict:
    """The int4 control (the reference with int4 crossbar codes, one step
    below the configuration's int8), read at every position of the
    served prompts and tokens as the gap of the token it puts first."""
    picked = sample(got["finished"], seed, cell.traffic["check_tokens"])
    states, digital = reference_states(cell, seed, dev)
    lgs = [reference_logits(cell, states, digital, p, t, dev)
           for p, t in picked]
    del states
    gc.collect()
    states4, _ = reference_states(cell, seed, dev, qmax=7)
    int4 = max(judge.logit_gap(lg, reference_logits(
        cell, states4, digital, p, t, dev, qmax=7).argmax(-1))
        for lg, (p, t) in zip(lgs, picked))
    return {"token_gap": int4, "requests": len(picked),
            "positions": sum(lg.shape[0] for lg in lgs)}
