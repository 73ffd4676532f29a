"""A step's FLOPs, bytes, collectives, kernel launches and peak memory,
counted on ``meta`` tensors (the port's counterpart of
`repro/launch/hlostats.py`).

The reference compiles a step and re-derives the roofline terms from the
optimized HLO, multiplying every ``while`` body by its
``known_trip_count``. Eager PyTorch has no HLO: `StepCounter`, a
`TorchDispatchMode`, sees every aten op the step dispatches and counts it
by hlostats' rules (`repro/launch/hlostats.py:1-30`, `:371-442`):

  matmul       ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution``
               and their kin: 2*M*N*K FLOPs; bytes = result + operands
  crossbar     one call of the AIMC kernel wrapper (`kernels/ops.py`) on a
               meta tensor: 2*G*B*KB*M*Np int8 operations, bytes of
               `core.coupling.tight_bytes` for the launcher's plan on the
               card's SM count, one launch of the wrapper's name
  elementwise  1 FLOP per output element; bytes = result + operands
  reduce       1 FLOP per input element; bytes = result + operands
  views        free (``view``, ``permute``, ``expand``, ``slice``, ...:
               every op whose result aliases its input)
  movement     ``copy_``, ``cat``, ``index``, ``gather``, ``scatter``,
               ``clone``, ``_to_copy``, ``pad``, fills: bytes only
  slice write  ``copy_`` into a view, ``index_put_``: the written
               slice's bytes twice (hlostats' dynamic-update-slice rule)

Ops whose tensors all sit on the host (the PRNG keys) are not counted.

Memory. Eager code has no fusion: every op's result is materialized, so
the bytes are what eager PyTorch requests, not what XLA's fused program
would move. Live bytes are tracked per storage (a meta storage has no
address; each is followed by a finalizer on its storage object, which
fires when the last view, autograd's saved copies included, lets go; a
view adds nothing). ``peak_bytes`` is the highest sum of live device
bytes during the step, the arguments included; ``output_bytes`` the
step's results that are not arguments; ``temp_bytes`` the rest of the
peak. On the card these are what `torch.cuda.max_memory_allocated`
sees over the call (`chip_smoke.py`'s phase 26 holds them to it).

Loops. A Python loop whose trip count scales with layers, sequence chunks
or microbatches is written ``for i in trips(n, x)``. With no counter
active, or ``x`` not on ``meta``, that is ``range(n)``. Under
`count_step` it runs ``k`` of its trips, keyed by its call site, its trip
count and the loops around it: a base run with every loop at ``min(n,
2)`` trips (3 for a loop whose trips a later backward runs last one
first, whose first, second and last trips differ there; 1 for a loop
that runs a whole backward inside each trip, the microbatches), then one
run per loop with one trip more. Each loop's role is found in the first
run and kept per call site, so the next count of the same code needs no
extra run. A count is a sum over every trip: it is affine in each loop's
trips along its nesting chain (a trip costs the same whatever its index,
its inner loops, backward and recomputation included, and the gradient
adds autograd makes where every trip reads one stacked parameter are one
more per trip), so the runs' differences extrapolate it exactly. The peak
is not a sum: every allocation is classed by its moment (each open loop's
key, its trip's place among the first, second-last, last and other
trips, the segment of the trip and the allocation's rank there; in the
backward, the forward stretch whose autograd node runs), the highest live
bytes of a class grows by what each earlier trip of each loop left live,
and the peak is the highest class extrapolated so. `fill` pads a list
that a loop builds to its ``n`` entries (the last one repeated), so the
shapes after the loop stay right; `keep_context` lets the recomputation
of a checkpointed block see the loops it ran inside.

Collectives. The positions of a mesh fold onto one device, so nothing
here is a measurement of traffic between cards: the joins the port's
sharded code makes (`collective`, with hlostats' wire factors: an
all-reduce moves twice its size, an all-gather its result) are counted
where they happen, and `launch.dryrun` reckons a train cell's gradient
reduction from its specs.
"""

from __future__ import annotations

import bisect
import dataclasses
import fractions
import gc
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_STACK: list = []          # active counters, innermost last

BASE_TRIPS = 2             # a plain loop's trips in the base run
MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
          "_int_mm", "convolution", "convolution_backward"}
REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
          "var", "std", "var_mean", "std_mean", "norm",
          "linalg_vector_norm", "argmax", "argmin", "all", "any", "cumsum",
          "cumprod", "cummax", "cummin", "_softmax", "_log_softmax",
          "count_nonzero", "nansum", "aminmax"}
MOVEMENT = {"copy_", "_to_copy", "clone", "cat", "stack", "index",
            "_unsafe_index", "index_select", "gather", "scatter",
            "scatter_add", "scatter_reduce", "index_put", "index_add",
            "index_copy", "index_copy_", "index_add_", "scatter_",
            "scatter_add_", "embedding", "embedding_dense_backward",
            "constant_pad_nd", "repeat", "flip", "roll", "select_backward",
            "slice_backward", "fill", "fill_", "zero_", "zeros",
            "zeros_like", "ones", "ones_like", "full", "full_like",
            "arange", "tril", "triu", "new_zeros", "new_ones", "new_full",
            "one_hot", "lift_fresh_copy"}
# the result written once: fills in place, and fills whose tensor
# argument is only a template of the shape
WRITE_ONLY = {"fill_", "zero_", "zeros_like", "ones_like", "full_like",
              "new_zeros", "new_ones", "new_full"}
FREE = {"empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "detach", "alias", "lift_fresh",
        "_unsafe_view", "_local_scalar_dense", "sym_size", "sym_stride",
        "sym_numel", "is_same_size", "_has_compatible_shallow_copy_type",
        "resize_", "set_", "record_stream"}
COLLECTIVE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0}


def active():
    """The innermost active counter, or None."""
    return _STACK[-1] if _STACK else None


def counting(x) -> "StepCounter | None":
    """The active counter when ``x`` is a meta tensor, else None: the
    test every counted branch of the port makes."""
    c = active()
    if c is None or not isinstance(x, torch.Tensor) or not x.is_meta:
        return None
    return c


def _tensors(obj, out):
    """Every tensor in a tree of dicts, sequences and dataclasses (the
    port's programmed states), appended to ``out``."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    return out


def _flat(args, kwargs) -> list:
    """The tensors among an aten op's arguments (nested one list deep)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(b for b in a if isinstance(b, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(args):
    """A hashable key of an op's arguments for the shape cache, or raise
    TypeError for one that has none (a host tensor of more than one
    element, whose values may shape the result)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if not a.is_meta and a.numel() > 1:
                raise TypeError("host values")
            out.append((a.shape, a.stride(), a.dtype, a.is_meta))
        elif isinstance(a, (list, tuple)):
            out.append(_key(a))
        else:
            hash(a)
            out.append(a)
    return tuple(out)


class _Kind:
    VIEW, MATMUL, REDUCE, MOVE, SLICE_WRITE, ELEMWISE, FREE = range(7)


def _kind_of(func) -> tuple[int, bool, str]:
    """(kind, whether the result may be cached by shape, name) of an aten
    op."""
    name = func._schema.name.split("::")[-1]
    rets = func._schema.returns
    aliased = any(r.alias_info is not None for r in rets)
    writes = any(r.alias_info is not None and r.alias_info.is_write
                 for r in rets)
    if name in FREE:
        return _Kind.FREE, False, name
    if aliased and not writes:
        return _Kind.VIEW, False, name
    if name in ("copy_", "index_put_", "_index_put_impl_"):
        return _Kind.SLICE_WRITE, False, name
    cacheable = not aliased and not func._schema.is_mutable
    kind = (_Kind.MATMUL if name in MATMUL else _Kind.REDUCE
            if name in REDUCE else _Kind.MOVE if name in MOVEMENT
            else _Kind.ELEMWISE)
    return kind, cacheable, name


def _matmul_flops(name: str, ins, outs) -> int:
    if name == "convolution" and len(ins) >= 2:
        out = outs[0]
        cout = out.shape[1] if out.dim() > 1 else 1
        return 2 * out.numel() * ins[1].numel() // max(cout, 1)
    if name == "convolution_backward":
        # grad_input and grad_weight, each a forward's worth
        w = ins[2] if len(ins) > 2 else ins[-1]
        g = ins[0]
        cout = g.shape[1] if g.dim() > 1 else 1
        fwd = 2 * g.numel() * w.numel() // max(cout, 1)
        return fwd * sum(1 for o in outs[:2] if o is not None)
    a = ins[-2] if name in ("addmm", "baddbmm", "addbmm", "addmv") else ins[0]
    k = a.shape[-1] if a.dim() else 1
    if name == "addbmm":
        k *= a.shape[0]
    return 2 * outs[0].numel() * k


_CACHE: dict = {}
_KINDS: dict = {}
# (loop site, grad mode) -> its role in the backward, as the last count
# that ran it found: "reversed", "inside" or None
_ROLES: dict = {}


def _position(t: int, k: int) -> int:
    """A trip's place among the ``k`` a run takes: 0 the first, 3 the
    last, 2 the one before it, 1 any other. The backward runs a loop's
    trips last one first, so its first, second and last there differ from
    the rest (the gradient buffers of what every trip reads)."""
    if t == 0:
        return 0
    return 3 if t == k - 1 else 2 if t == k - 2 else 1


def _base_trips(role, n: int) -> int:
    """The trips of a loop's base run. A loop whose trips the backward
    runs last one first has a first, a second and a last trip of its own
    there (the gradient buffers of what every trip reads): one trip more;
    a loop that runs a whole backward inside each trip (the
    microbatches) keeps nothing from one trip to the next but its
    accumulators: one trip."""
    if role == "reversed":
        return min(n, BASE_TRIPS + 1)
    if role == "inside":
        return 1
    return min(n, BASE_TRIPS)


def _stand_in(a):
    if isinstance(a, torch.Tensor) and a.is_meta:
        return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                   device="meta")
    if isinstance(a, (list, tuple)):
        return type(a)(_stand_in(b) for b in a)
    return a


def _out_spec(func, args, kwargs):
    """(single, [(shape, stride, dtype)]) of a functional op's results, or
    False where they are not all meta tensors. The op runs on stand-ins
    of its meta inputs: whatever its meta kernel keeps hold of is not the
    step's, so a step's lifetimes do not depend on what is cached."""
    out = func(*_stand_in(args), **{k: _stand_in(v)
                                   for k, v in kwargs.items()})
    flat = out if isinstance(out, tuple) else (out,)
    if not all(isinstance(o, torch.Tensor) and o.is_meta for o in flat):
        return False
    return (not isinstance(out, tuple),
            [(tuple(o.shape), tuple(o.stride()), o.dtype) for o in flat])


class StepCounter(TorchDispatchMode):
    """Counts every aten op dispatched while it is active (see the module
    docstring); ``trip_plan`` maps a loop's key id to the trips to run."""

    def __init__(self, keys=None, trip_plan=None, sms: int = 132,
                 full: bool = False, roles=None):
        super().__init__()
        self.sms = sms               # the card's SMs: the kernels' plans
        self.full = full             # every loop runs all its trips
        self.flops = {"matmul": 0, "crossbar": 0, "elementwise": 0,
                      "reduce": 0}
        self.bytes = 0
        self.coll: dict = {}
        self.launches: dict = {}
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self.keys = {} if keys is None else keys     # (parent, site, n) -> id
        self.trip_plan = trip_plan or {}
        # the open loops, innermost last: [key id, trip, segment, trips
        # this run, whether the backward runs them last first] each; a
        # segment counts the inner loops a trip (or the step) has begun
        self.ctx: list = []
        self.top = [0]
        self.recompute = False
        self.tag = (0, ())
        self.peaks: dict = {}        # moment class -> its highest live
        self.reversed: set = set()   # loops whose trips a later backward
                                     # runs, last trip first
        self.inside: set = set()     # loops a backward runs inside
        self.used: dict = {}         # the base trips of loops not planned
        self.roles = roles or {}     # loop -> its role, where known
        self.grad: dict = {}         # loop -> grad mode at its start
        self._seq_at: list = []      # forward autograd sequence numbers ...
        self._seq_tag: list = []     # ... from which each class runs
        self._ord = 0                # allocations since the last boundary
        self._bord: dict = {}        # ... in the backward, per interval

    # -- memory ------------------------------------------------------------
    def _free(self, sid: int, nbytes: int) -> None:
        if self._storages.pop(sid, None) is not None:
            self.live -= nbytes

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed (device tensors
        only; a storage already tracked adds nothing)."""
        if not t.is_meta:
            return
        st = t.untyped_storage()
        sid = st._cdata
        if sid in self._storages:
            return
        n = st.nbytes()
        self._storages[sid] = n
        weakref.finalize(st, self._free, sid, n)
        live = self.live = self.live + n
        if live > self.peak:
            self.peak = live
        tag = self._moment()
        if live > self.peaks.get(tag, -1):
            self.peaks[tag] = live

    def _moment(self):
        """The class of this allocation: where the step is in its loops
        (each open loop's key, whether this is its first trip, the segment
        of its trip) and its rank among the allocations there; in the
        backward, the class of the forward stretch that made the autograd
        node running now, and the rank among that stretch's backward
        allocations. Every class is one moment of a homogeneous trip, so
        its highest live bytes are affine in each loop's trips."""
        if not self.recompute:
            node = torch._C._current_autograd_node()
            if node is not None:
                i = bisect.bisect_right(self._seq_at,
                                        node._sequence_nr()) - 1
                rank = self._bord[i] = self._bord.get(i, -1) + 1
                if len(self.inside) < len(self.ctx):
                    self.inside.update(e[0] for e in self.ctx)
                if i < 0:
                    return ("b", None, rank)
                tag = self._seq_tag[i]
                if len(tag[1]) > len(self.ctx):
                    self.reversed.update(e[0] for e in
                                         tag[1][len(self.ctx):])
                return ("b", tag, rank)
        self._ord += 1
        return ("r" if self.recompute else "f", self.tag, self._ord)

    def _retag(self) -> None:
        self.tag = (self.top[0], tuple(
            (k, _position(t, n) if rev else t > 0, g)
            for k, t, g, n, rev in self.ctx))
        self._ord = 0
        if torch.is_grad_enabled() and not self.recompute:
            with torch.enable_grad():
                t = torch.empty(0, device="meta", requires_grad=True)
                seq = t.view(0).grad_fn._sequence_nr()
            self._seq_at.append(seq)
            self._seq_tag.append(self.tag)

    def close(self) -> None:
        """Stop following storages (their finalizers become no-ops)."""
        self._storages = {}

    # -- counting entry points for the port's code -------------------------
    def collective(self, kind: str, nbytes: int) -> None:
        """One join of ``nbytes`` (its size: an all-reduce's operand, an
        all-gather's result) on the wire with hlostats' factor."""
        self.coll[kind] = self.coll.get(kind, 0) + int(
            COLLECTIVE_FACTOR[kind] * nbytes)

    def crossbar(self, name: str, ops: int, nbytes: int) -> None:
        """One launch of a crossbar kernel wrapper: ``ops`` int8
        operations and ``nbytes`` of global memory."""
        self.flops["crossbar"] += ops
        self.bytes += nbytes
        self.launches[name] = self.launches.get(name, 0) + 1

    def scatter(self, ins, out) -> None:
        """A scatter the port runs as host-driven passes (the embedding
        gradient's bf16 adds), counted as XLA's one scatter: bytes =
        result + operands."""
        self.bytes += _nbytes(out) + sum(_nbytes(t) for t in ins)

    # -- the dispatch ------------------------------------------------------
    @classmethod
    def _should_skip_dynamo(cls):
        # nothing here is compiled: no compiler guard around each op
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kc = _KINDS.get(func)
        if kc is None:
            kc = _KINDS[func] = _kind_of(func)
        kind, cacheable, name = kc
        if kind == _Kind.VIEW:               # free, and shares a storage
            return func(*args, **kwargs)
        out = None
        if cacheable:
            try:
                ckey = (func, _key(args),
                        _key(kwargs.items()) if kwargs else ())
            except TypeError:
                ckey = None
            if ckey is not None:
                spec = _CACHE.get(ckey)
                if spec is None:
                    spec = _CACHE[ckey] = _out_spec(func, args, kwargs)
                if spec is not False:
                    made = [torch.empty_strided(sh, st, dtype=dt,
                                                device="meta")
                            for sh, st, dt in spec[1]]
                    out = made[0] if spec[0] else tuple(made)
        if out is None:
            out = func(*args, **kwargs)
        ins = _flat(args, kwargs)
        if isinstance(out, torch.Tensor):
            outs = [out]
        elif isinstance(out, (tuple, list)):
            outs = [o for o in out if isinstance(o, torch.Tensor)]
        else:
            outs = []
        if kind != _Kind.FREE:
            meta = False
            for t in ins:
                if t.is_meta:
                    meta = True
                    break
            else:
                meta = any(o.is_meta for o in outs)
            if meta:
                self._count(name, kind, ins, outs)
        for o in outs:
            self.track(o)
        return out

    def _count(self, name, kind, ins, outs) -> None:
        if kind == _Kind.SLICE_WRITE:
            if name == "copy_":
                dst = ins[0]
                whole = dst.untyped_storage().nbytes()
                w = _nbytes(dst)
                self.bytes += 2 * w if w < whole else w + _nbytes(ins[1])
            else:                              # index_put_: the values
                self.bytes += 2 * _nbytes(ins[-1])
            return
        nb = 0
        for o in outs:
            nb += o.numel() * o.element_size()
        if name not in WRITE_ONLY:
            for t in ins:
                nb += t.numel() * t.element_size()
        self.bytes += nb
        if kind == _Kind.ELEMWISE:
            self.flops["elementwise"] += outs[0].numel() if outs else 0
        elif kind == _Kind.MATMUL:
            self.flops["matmul"] += _matmul_flops(name, ins, outs)
        elif kind == _Kind.REDUCE:
            self.flops["reduce"] += ins[0].numel() if ins else 0

    # -- loops ---------------------------------------------------------------
    def _trips(self, n: int, site: str):
        parent = self.ctx[-1][0] if self.ctx else -1
        kid = self.keys.setdefault((parent, site, n), len(self.keys))
        role = (self.roles[kid] if kid in self.roles
                else _ROLES.get((site, torch.is_grad_enabled())))
        if self.full:
            k = n
        elif kid in self.trip_plan:
            k = self.trip_plan[kid]
        else:
            k = self.used[kid] = _base_trips(role, n)

        def run():
            ctx = self.ctx
            outer = ctx[-1] if ctx else None
            entry = [kid, 0, 0, k, role == "reversed"]
            ctx.append(entry)
            try:
                for i in range(k):
                    entry[1], entry[2] = i, 0
                    self._retag()
                    yield i
            finally:
                ctx.pop()
                if outer is not None:
                    outer[2] += 1
                else:
                    self.top[0] += 1
                self._retag()
        self.grad.setdefault(kid, (site, torch.is_grad_enabled()))
        if self.ctx:
            self.ctx[-1][2] += 1
        else:
            self.top[0] += 1
        return run()

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _STACK.remove(self)

    def result(self) -> dict:
        return {"flops_by_class": dict(self.flops),
                "bytes": self.bytes, "collectives": dict(self.coll),
                "launches": dict(self.launches), "peak_bytes": self.peak,
                "peaks": dict(self.peaks)}


def trips(n: int, x=None):
    """``range(n)`` for a loop whose trip count scales with the step's
    size; under an active counter with ``x`` on ``meta``, the trips
    `count_step` asks of this loop (see the module docstring)."""
    c = active()
    if c is None or (x is not None and not (isinstance(x, torch.Tensor)
                                            and x.is_meta)):
        return range(n)
    f = sys._getframe(1)
    return c._trips(n, f"{f.f_globals.get('__name__')}:{f.f_lineno}")


def fill(seq: list, n: int) -> list:
    """A loop's ``n`` outputs: ``seq`` itself when the loop ran every
    trip; after the trips `count_step` cut, ``seq`` with its last entry
    repeated (the same tensor: shapes right, no bytes added)."""
    if len(seq) >= n or not seq:
        return seq
    return list(seq) + [seq[-1]] * (n - len(seq))


def keep_context(fn):
    """``fn`` itself with no counter active; under one, ``fn`` run inside
    the loops that are open now, also when a checkpoint recomputes it in
    the backward, after those loops have ended."""
    c = active()
    if c is None:
        return fn
    saved = [list(e) for e in c.ctx]
    top = c.top[0]

    def run(*a, **k):
        if torch._C._current_autograd_node() is None:     # the forward
            return fn(*a, **k)
        old = c.ctx, c.top, c.recompute, c.tag
        c.ctx, c.top = [list(e) for e in saved], [top]
        c.recompute = True
        c._retag()
        try:
            return fn(*a, **k)
        finally:
            c.ctx, c.top, c.recompute, c.tag = old
    return run


# ---------------------------------------------------------------------------
# the whole step, extrapolated over its loops
# ---------------------------------------------------------------------------

def meta_like(tree):
    """``tree`` (dicts, sequences, dataclasses such as programmed states)
    with every tensor replaced by a ``meta`` tensor of its shape, strides
    and dtype: the inputs of a call that `count_step` counts at the shapes
    a real call took (views of one storage become storages of their
    own)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(),
                                   dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [meta_like(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: meta_like(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _flatten(stats: dict) -> dict:
    out = {f"flops/{k}": v for k, v in stats["flops_by_class"].items()}
    out |= {f"coll/{k}": v for k, v in stats["collectives"].items()}
    out |= {f"launch/{k}": v for k, v in stats["launches"].items()}
    for k in ("bytes", "peak_bytes", "output_bytes", "argument_bytes"):
        out[k] = stats[k]
    out |= {("peak", k): v for k, v in stats["peaks"].items()}
    return out


def _run_once(fn, args, keys, plan, sms, full=False, roles=None):
    """One counted call of ``fn(*args)`` -> (flat stats, counter)."""
    c = StepCounter(keys, plan, sms, full, roles)
    arg_t = [t for t in _tensors(args, []) if t.is_meta]
    for t in arg_t:
        c.track(t)
    arg_ids = set(c._storages)
    arg_bytes = c.live
    enabled = gc.isenabled()
    gc.disable()
    try:
        with c:
            out = fn(*args)
        outs = [t for t in _tensors(out, []) if t.is_meta]
        seen, out_bytes = set(arg_ids), 0
        for t in outs:
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                out_bytes += st.nbytes()
        stats = c.result() | {"argument_bytes": arg_bytes,
                              "output_bytes": out_bytes}
        del out, outs
    finally:
        c.close()
        if enabled:
            gc.enable()
    return _flatten(stats), c


def _num(v):
    return int(v) if v.denominator == 1 else float(v)


def count_step(fn, *args, sms: int = 132, full: bool = False) -> dict:
    """Count ``fn(*args)`` (meta tensors; host keys allowed) with every
    `trips` loop extrapolated to its full trip count -> a dict with
    hlostats' keys (``flops``, ``bytes``, ``collectives`` = {kind: wire
    bytes, "total": ...}) plus ``flops_by_class``, ``launches`` (per
    kernel wrapper name), ``argument_bytes``, ``output_bytes``,
    ``temp_bytes``, ``peak_bytes``, and ``runs`` / ``loops`` (the counted
    calls and each loop's site, trip count and enclosing loop). ``sms``
    is the card's SM count, which the kernels' plans depend on; ``full``
    runs every loop's every trip once instead (the check of the
    extrapolation)."""
    # torch imports its compiler on the first dispatch to a Python mode;
    # an import inside the step would hold the step's frames (and their
    # tensors) alive for as long as the importing frame lives
    import torch._dynamo  # noqa: F401
    keys: dict = {}
    stat0, c0 = _run_once(fn, args, keys, {}, sms, full)
    info = {kid: {"parent": p, "site": s, "n": n}
            for (p, s, n), kid in keys.items()}
    plan, roles = {}, {}
    guessed = {kid: _ROLES.get(sg) for kid, sg in c0.grad.items()}
    for kid, (site, grad) in c0.grad.items():
        role = roles[kid] = ("reversed" if kid in c0.reversed
                             else "inside" if kid in c0.inside else None)
        _ROLES[(site, grad)] = role
        plan[kid] = _base_trips(role, info[kid]["n"])
        if guessed[kid] != role:     # run 0 classed its trips otherwise
            c0.used = None
    if full:
        plan = {}
    elif plan != c0.used:     # a loop's role was not known: run the base
        stat0, _ = _run_once(fn, args, keys, plan, sms, roles=roles)

    def b(kid):
        return info[kid]["n"] if full else plan[kid]
    bumped = {}
    for kid, k in info.items():
        if k["n"] > b(kid) and not full:
            stats, _ = _run_once(fn, args, keys, plan | {kid: b(kid) + 1},
                                 sms, roles=roles)
            bumped[kid] = stats
    if len(keys) != len(info):
        raise RuntimeError("a counted run met loops the first one did not "
                           "(a loop's structure depends on its trips)")
    # a count's extra over the base run is linear in each bumped run's
    # difference from it: the loop adds n - b trips, and each loop around
    # it multiplies them by its n over b
    coef = {}
    for kid in bumped:
        c = fractions.Fraction(info[kid]["n"] - b(kid))
        p = info[kid]["parent"]
        while p >= 0:
            c *= fractions.Fraction(info[p]["n"], b(p))
            p = info[p]["parent"]
        coef[kid] = c

    metrics = {m for m in stat0 if not isinstance(m, tuple)}
    for st in bumped.values():
        metrics |= {m for m in st if not isinstance(m, tuple)}
    metrics |= {m for m in stat0 if isinstance(m, tuple)}

    def extrapolate(m):
        # a count sums over every trip of the loops around it; a moment
        # class's highest live bytes is taken in one trip of each (the
        # last: what the earlier trips left live), so each loop adds its
        # own trips' share once, n - b times the bumped run's difference,
        # and a class missing from a bumped run kept its base value
        v0 = stat0.get(m, 0)
        moment = isinstance(m, tuple)
        tot = fractions.Fraction(v0)
        for kid, c in coef.items():
            d = bumped[kid].get(m, v0 if moment else 0) - v0
            if d:
                tot += (info[kid]["n"] - b(kid)) * d if moment else c * d
        return _num(tot)
    total = {m: extrapolate(m) for m in metrics}
    flops = {k.split("/", 1)[1]: v for k, v in total.items()
             if isinstance(k, str) and k.startswith("flops/")}
    coll = {k.split("/", 1)[1]: v for k, v in total.items()
            if isinstance(k, str) and k.startswith("coll/") and v}
    coll["total"] = sum(coll.values())
    launches = {k.split("/", 1)[1]: v for k, v in total.items()
                if isinstance(k, str) and k.startswith("launch/") and v}
    # the peak: the highest of every moment class's own extrapolation (a
    # class's highest live is affine in the trips; the step's, the max
    # over classes, is not), and never below a counted run's
    peak = max([total[m] for m in total if isinstance(m, tuple)]
               + [stat0["peak_bytes"]]
               + [st["peak_bytes"] for st in bumped.values()])
    return {"flops": sum(flops.values()), "bytes": total["bytes"],
            "collectives": coll, "flops_by_class": flops,
            "launches": launches,
            "argument_bytes": total["argument_bytes"],
            "output_bytes": total["output_bytes"],
            "temp_bytes": peak - total["argument_bytes"]
            - total["output_bytes"],
            "peak_bytes": peak,
            "runs": 1 + (not full and plan != c0.used) + len(bumped),
            "loops": [dict(v, id=k, trips=b(k)) for k, v in info.items()]}
