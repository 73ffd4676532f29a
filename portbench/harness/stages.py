"""Checks of the digital stages on the timed path: wrappers around the
functions that compute a step's digital parts (attention, RMSNorm, the
output projection, the straight-through backward) that hand a sample of
their calls, inputs and output, to `reference/digital.py`.

`digital_gap` is the widest gap over the checked calls, the norm of the
difference over the norm of the f64 recomputation. It follows the
program's own state (each stage's inputs as the program made them), so
it reads the precision each stage computed in and nothing upstream; the
comparisons from the seed alone (`judge.py`) judge the whole.

Which calls are checked: every call (training's checked steps, in
set-up), or from a seeded offset every ``stride``-th call of a kind, at
most ``cap`` of each (serving's window). A run in which no call was
checked has no reading and is not correct."""

from __future__ import annotations

import contextlib
import inspect
import time

import torch

from portbench.reference import digital

# call strides of a kind in a serving window: primes, so that the checked
# calls walk through the layers
STRIDES = {"decode_attention": 211, "attention": 199, "rmsnorm": 401,
           "logits": 7}


class Watch:
    """The checked calls' gaps by kind, the calls seen, and (``timed``)
    the host seconds the checks took, each synchronised."""

    def __init__(self, cap=None, offset=0, timed=False):
        self.cap, self.offset, self.timed = cap, offset, timed
        self.seen: dict = {}
        self.pairs: dict = {}
        self.seconds = 0.0

    def want(self, kind: str) -> bool:
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            return False
        i = self.seen.get(kind, 0)
        self.seen[kind] = i + 1
        if self.cap is None:
            return True
        stride = STRIDES.get(kind, 1)
        if len(self.pairs.get(kind, ())) >= self.cap:
            return False
        return i >= self.offset % stride and \
            (i - self.offset % stride) % stride == 0

    @contextlib.contextmanager
    def checking(self, dev):
        t = None
        if self.timed:
            _sync(dev)
            t = time.perf_counter()
        with torch.no_grad():
            yield
        if self.timed:
            _sync(dev)
            self.seconds += time.perf_counter() - t

    def add(self, kind: str, acc) -> None:
        self.pairs.setdefault(kind, []).append(acc)

    def readings(self) -> dict:
        """{"digital_gap": widest gap or None, "digital": {kind: [widest
        gap, calls checked, calls seen]}}."""
        by_kind = {}
        for kind, n in self.seen.items():
            gaps = [float(torch.sqrt(e / torch.clamp_min(r, 1e-300)))
                    for e, r in self.pairs.get(kind, ())]
            by_kind[kind] = [max(gaps, default=None), len(gaps), n]
        worst = max((v[0] for v in by_kind.values() if v[0] is not None),
                    default=None)
        return {"digital_gap": worst, "digital": by_kind}


def _sync(dev):
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _detach(*ts):
    return [t.detach() if isinstance(t, torch.Tensor) else t for t in ts]


def _bind(fn, a, k):
    """Arguments of a call by name, defaults filled."""
    ba = inspect.signature(fn).bind(*a, **k)
    ba.apply_defaults()
    return ba.arguments


def _rmsnorm(w: Watch, fn):
    """`rmsnorm(x, scale, eps, ...)`, the port's or the reference's."""
    def wrapped(*a, **k):
        out = fn(*a, **k)
        if w.want("rmsnorm"):
            args = _bind(fn, a, k)
            x, scale = _detach(args["x"], args["scale"])
            with w.checking(x.device):
                w.add("rmsnorm", digital.rmsnorm(x, scale,
                                                 float(args["eps"]),
                                                 out.detach()))
        return out
    return wrapped


def _flash(w: Watch, fn):
    """The port's `flash_attention` (training's blocks, serving's legs)."""
    def wrapped(*a, **k):
        out = fn(*a, **k)
        if k.get("causal", True) and k.get("window") is None and \
                w.want("attention"):
            args = _bind(fn, a, k)
            q, kk, v = _detach(args["q"], args["k"], args["v"])
            with w.checking(q.device):
                w.add("attention", digital.attention(
                    q, kk, v, out.detach(), q_offset=int(args["q_offset"])))
        return out
    return wrapped


def _decode(w: Watch, fn):
    """The port's `decode_attention` over a (paged view of the) cache."""
    def wrapped(*a, **k):
        out = fn(*a, **k)
        if w.want("decode_attention"):
            args = _bind(fn, a, k)
            q, kc, vc = _detach(args["q"], args["k_cache"], args["v_cache"])
            n = args["kv_len"]
            if n is None:
                n = torch.full((q.shape[0],), kc.shape[1], device=q.device)
            with w.checking(q.device):
                w.add("decode_attention", digital.attention(
                    q.to(kc.dtype), kc, vc, out.detach(), kv_len=n))
        return out
    return wrapped


def _logits(w: Watch, fn, unembed):
    """The port's output projection ``_logits(params, h, cfg)``."""
    def wrapped(params, h, cfg):
        out = fn(params, h, cfg)
        if w.want("logits"):
            hh = h.detach()
            with w.checking(hh.device):
                w.add("logits", digital.product(
                    hh.to(torch.float32), unembed(params, cfg).detach(),
                    out.detach()))
        return out
    return wrapped


def _reference_attention(w: Watch, fn):
    """The reference's causal `attention(q, k, v, ...)` (the control)."""
    def wrapped(*a, **k):
        out = fn(*a, **k)
        if w.want("attention"):
            args = _bind(fn, a, k)
            q, kk, v = _detach(args["q"], args["k"], args["v"])
            with w.checking(q.device):
                w.add("attention", digital.attention(q, kk, v, out.detach()))
        return out
    return wrapped


class _Saved:
    """A backward's context whose saved tensors were unpacked once (a
    checkpoint lets them be unpacked once only)."""

    def __init__(self, ctx):
        self._ctx = ctx
        self.saved_tensors = ctx.saved_tensors

    def __getattr__(self, name):
        return getattr(self._ctx, name)


def _backward(w: Watch, fn):
    """An autograd Function's straight-through ``backward(ctx, g)`` that
    saved (x, w) and returns (dx, dw, ...)."""
    def wrapped(ctx, g):
        ctx = _Saved(ctx)
        grads = fn(ctx, g)
        if w.want("ste"):
            x, wt = ctx.saved_tensors
            gg, x, wt = _detach(g, x, wt)
            dx, dw = grads[0], grads[1]
            with w.checking(gg.device):
                ax, aw = digital.ste_backward(gg, x, wt, dx, dw)
                w.add("ste", ax)
                w.add("ste", aw)
        return grads
    return wrapped


@contextlib.contextmanager
def _patch(obj, name, make):
    """``obj.name = make(obj.name)`` for the block; a class's own
    descriptor (a staticmethod) is put back as it was."""
    had = inspect.getattr_static(obj, name)
    fn = getattr(obj, name)
    setattr(obj, name, make(fn))
    try:
        yield
    finally:
        setattr(obj, name, had)


@contextlib.contextmanager
def program(w: Watch, train: bool):
    """The port's digital stages under ``w``: attention, RMSNorm, and in
    training the straight-through backward of every crossbar linear, in
    serving the decode attention and the output projection."""
    from repro_torch.core import aimc as core_aimc
    from repro_torch.models import transformer

    with contextlib.ExitStack() as st:
        st.enter_context(_patch(transformer, "rmsnorm",
                                lambda f: _rmsnorm(w, f)))
        st.enter_context(_patch(transformer, "flash_attention",
                                lambda f: _flash(w, f)))
        if train:
            for cls in (core_aimc._AimcLinearSTE,
                        core_aimc._AimcLinearSTEExperts):
                st.enter_context(_patch(cls, "backward",
                                        lambda f: _backward(w, f)))
        else:
            st.enter_context(_patch(transformer, "decode_attention",
                                    lambda f: _decode(w, f)))
            um = transformer.unembed_matrix
            st.enter_context(_patch(
                transformer, "_logits", lambda f: _logits(
                    w, f, lambda p, c: um(p, c).to(torch.float32))))
        yield w


@contextlib.contextmanager
def reference(w: Watch):
    """The same stages of the reference put in the program's place (the
    control): its attention, RMSNorm and straight-through backward."""
    from portbench.reference import aimc as ref_aimc
    from portbench.reference import model as ref_model

    with contextlib.ExitStack() as st:
        st.enter_context(_patch(ref_model, "rmsnorm",
                                lambda f: _rmsnorm(w, f)))
        st.enter_context(_patch(ref_model, "attention",
                                lambda f: _reference_attention(w, f)))
        for cls in (ref_aimc._STE, ref_aimc._STEExperts):
            st.enter_context(_patch(cls, "backward",
                                    lambda f: _backward(w, f)))
        yield w
