"""The training driver: `launch.steps.make_train_step(...).fn` of the
port, with its model and AdamW state, driven from the seed.

Set-up makes the weights and the optimizer state, runs the first
``check_steps`` steps through the same step object the window then
drives (they also warm every shape and build every kernel), and keeps
their losses, each leaf's first gradient as AdamW got it and each
leaf's change over those steps; every digital stage of those steps is
checked on its own inputs (`stages.py`), and the checks' time is not
set-up's. The window sends whole steps, up to the traffic's
``ahead_steps`` ahead of the one it waits for, until ``seconds`` have
passed, and closes when every step it sent has ended. A traced run times
``trace_steps`` steps on the host clock (for the MFU), then profiles as
many. Then the program's state is freed and the reference runs the same
checked steps from the same seed, batches and keys."""

from __future__ import annotations

import collections
import contextlib
import gc
import time

import torch

from portbench.harness import common, judge, spec as spec_mod, stages, \
    trace, traffic, weights
from portbench.reference import model as ref


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _changes(flat: dict, m, seed: int, dtype, dev) -> dict:
    """Norm of each leaf's change from the seed's weights, made again
    one leaf at a time."""
    out = {}
    for name, w0 in weights.leaves(m, seed, dtype, dev):
        out[name] = float(torch.linalg.vector_norm(
            flat[name].to(torch.float32) - w0.to(torch.float32)))
    return out


def program_side(cell, seed: int, seconds: float, trace_on: bool, dev,
                 wrap=None) -> dict:
    """Set-up, checked steps and the window of the port's train step.
    ``wrap`` (tests) wraps the step function to plant a fault."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import make_optimizer

    t = cell.traffic
    spec = spec_mod.port_spec(cell.config)
    exe = spec_mod.execution(cell.config, cell.noise, programmed=False)
    m = spec_mod.ref_model_of(cell.config)
    dtype = getattr(torch, cell.run["param_dtype"])
    shape = ShapeCell("train", t["seq_len"], t["global_batch"], "train")
    fn = make_train_step(spec, shape, None, exe).fn
    if wrap is not None:
        fn = wrap(fn)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = weights.make(m, seed, dtype, dev)
    weights.check_against_port(params, spec)
    opt = make_optimizer(spec.optimizer)[0](params)
    b1 = make_optimizer(spec.optimizer)[2].b1
    vocab = m.vocab

    def step(s, params, opt):
        batch = traffic.train_batch(t, vocab, seed, s, dev)
        return fn(params, opt, batch, common.step_key(seed, s))

    out = {"losses": []}
    n_check = t["check_steps"]
    watch = stages.Watch(timed=True)
    with stages.program(watch, train=True):
        for s in range(n_check):
            params, opt, met = step(s, params, opt)
            out["losses"].append(float(met["loss"]))
            if s == 0:
                out["grads"] = {n: v / (1.0 - b1) for n, v in
                                judge.leaf_norms(ref.flatten(opt.mu)).items()}
    out["changes"] = _changes(ref.flatten(params), m, seed, dtype, dev)
    out["stages"] = watch.readings()
    _sync(dev)
    out["setup_s"] = time.perf_counter() - common.T0 - watch.seconds
    tokens = t["global_batch"] * t["seq_len"]
    s, done, nonfinite = n_check, 0, 0
    calls: dict = {}
    if trace_on:
        t0 = time.perf_counter()
        for _ in range(t["trace_steps"]):
            params, opt, met = step(s, params, opt)
            nonfinite += not torch.isfinite(met["loss"]).item()
            s += 1
        _sync(dev)
        out["mfu_s"] = time.perf_counter() - t0
        out["mfu_steps"] = t["trace_steps"]
        with trace.instrument(calls), trace.profiled(dev) as tr:
            for _ in range(t["trace_steps"]):
                params, opt, met = step(s, params, opt)
                nonfinite += not torch.isfinite(met["loss"]).item()
                s += 1
                done += 1
        out["trace"] = trace.read(tr["prof"])
        out["window_s"] = tr["window_s"]
    elif seconds > 0:
        # Whole steps are sent up to ``ahead_steps`` ahead of the one
        # waited for, so that the card stays fed while the host stands
        # still, and the losses are counted on the card and read once.
        # When the time is up nothing more is sent, all that was sent is
        # waited for and the clock is read after that wait: every step
        # sent counts, over all of that time. ``ahead`` is the mean number
        # of sent steps still running each time the host had sent one.
        ahead = t.get("ahead_steps", 1)
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        sent: collections.deque = collections.deque()
        lead = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            params, opt, met = step(s, params, opt)
            bad += (~torch.isfinite(met["loss"])).to(torch.int64)
            s += 1
            done += 1
            if dev.type == "cuda":
                sent.append(torch.cuda.Event())
                sent[-1].record()
                lead += sum(not e.query() for e in sent)
                while len(sent) > ahead:
                    sent.popleft().synchronize()
        _sync(dev)
        out["window_s"] = time.perf_counter() - t0
        nonfinite += int(bad)
        out["ahead"] = lead / done
    out.update(steps=done, tokens=done * tokens, nonfinite=nonfinite,
               calls=calls)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    del params, opt, met, fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def reference_side(cell, seed: int, dev, control: str | None = None
                   ) -> dict:
    """The reference's own checked steps from the seed's weights;
    ``control`` "fp8" takes its digital products on e4m3 operands (its
    digital stages checked as the program's are), "int4" programs int4
    crossbar codes: the controls one precision step below the
    configuration's bf16 and int8."""
    t = cell.traffic
    m = spec_mod.ref_model_of(cell.config)
    xb = spec_mod.crossbar_of(cell.config, cell.noise,
                              7 if control == "int4" else 127)
    prec = ref.Precision(act=getattr(torch, cell.run["compute_dtype"]),
                         fp8=control == "fp8")
    dtype = getattr(torch, cell.run["param_dtype"])
    flat = dict(weights.leaves(m, seed, dtype, dev))
    state = ref.adamw_init(flat)
    proj = ref.Projections(xb, prec)
    opt = ref.AdamW()
    out = {"losses": []}
    watch = stages.Watch()
    with (stages.reference(watch) if control == "fp8"
          else contextlib.nullcontext()):
        for s in range(t["check_steps"]):
            batch = traffic.train_batch(t, m.vocab, seed, s, dev)
            flat, state, loss = ref.train_step(
                flat, state, batch, common.step_key(seed, s), m, proj,
                cell.run["microbatch"], opt)
            out["losses"].append(loss)
            if s == 0:
                out["grads"] = {n: v / (1.0 - opt.b1) for n, v in
                                judge.leaf_norms(state["mu"]).items()}
    out["changes"] = _changes(flat, m, seed, dtype, dev)
    out["stages"] = watch.readings()
    del flat, state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def e2e(cell, got: dict) -> dict:
    return {"train_tok_s": (got["tokens"] / got["window_s"], "tokens/s"),
            "setup_s": (got["setup_s"], "s")}

