"""PartitionSpec assignment for every tree in the framework, and the
placement of tensors on a mesh's positions (PyTorch port of
`repro/launch/shardings.py`).

Name-driven rules (DESIGN.md §5): "in-projections" shard (reduction dim ->
FSDP, output dim -> model); "out-projections" the reverse; expert stacks
shard experts over model; embeddings shard vocab over model; norms/biases of
O(d) replicate. The same function serves any mesh: specs reference axis
NAMES, and multi-pod meshes bind `fsdp` to ("pod", "data"). Every spec
function returns the reference's spec on the same shapes.

The port's `PartitionSpec` is a tuple of axis names, axis tuples or None
(a one-axis tuple is its name, as in JAX). Trees are the port's dicts,
lists and tuples; a programmed `AimcLinearState` is walked into its
``w_q``/``s_w`` fields (the reference's attribute keys), and an int8
``{"q", "s"}`` pair takes its parent's name (`_name_of`).

In place of ``to_named`` / ``NamedSharding``, `place` splits a tensor into
per-position pieces by a spec (`Placed`: positions holding the same block
on the same device share one tensor, so replication makes no copy there),
and `Placed.gather` puts the pieces back together. ``place(...,
views=True)`` (the training trees: parameters, optimizer state,
batches) keeps the tensor whole as the layout's ``base``
and makes each piece on its device a view of it, so positions folded onto
one device share one tensor and placing copies nothing. `place_aimc_state`
splits a programmed state into column pieces over the model axis only where
its Np divides ``128 * M`` (the kernels need 128-aligned columns; the
reference's rule, `fit_spec`, is ``Np % M == 0``): anywhere else the state
stays whole, with the same results, since column pieces are exact.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.aimc import AimcLinearState, split_columns
from repro_torch.launch import stepstats
from repro_torch.launch.mesh import dp_axes, fsdp_axes

# projection weight names: [..., K(reduce), N(out)]
IN_PROJ = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "cq", "ck", "cv",
           "router", "w_rnn_in", "w_a", "w_x", "w_q", "w_k", "w_v", "w_if",
           "w_zifo", "w_ff_gate", "w_ff_up", "wd_gate", "wd_up", "w_gate"}
OUT_PROJ = {"wo", "w_down", "w_out", "co", "w_ff_down", "wd_down"}
EXPERT_IN = {"we_gate", "we_up"}
EXPERT_OUT = {"we_down"}
MODEL_OUT_BIAS = {"bq", "bk", "bv", "b_in"}   # bias on a model-sharded output
COLUMN_ALIGN = 128                            # the kernels' Np alignment


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, a tuple of axis names, or
    None (replicated). A one-axis tuple normalizes to its name."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class _Attr:
    """Path key of a programmed state's field (the reference's attribute
    key, `jax.tree_util.GetAttrKey`)."""
    name: str


@dataclasses.dataclass(frozen=True)
class _Field:
    """Path key of a named tuple's field (an optimizer state's ``mu``)."""
    name: str


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def tree_map_with_path(fn, tree, *rest, is_leaf=None, path=()):
    """``fn(path, leaf, *rest_leaves)`` over the port's trees: dicts, lists
    and tuples by key/index, named tuples by field (``_Field`` keys), an
    `AimcLinearState` by its ``w_q``/``s_w`` fields (``_Attr`` keys; the
    result keeps the state's other fields)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            tree_map_with_path(fn, getattr(tree, f),
                               *(getattr(r, f) for r in rest),
                               is_leaf=is_leaf, path=path + (_Field(f),))
            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      is_leaf=is_leaf, path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest), is_leaf=is_leaf,
                               path=path + (i,))
            for i, v in enumerate(tree))
    if isinstance(tree, AimcLinearState):
        return dataclasses.replace(tree, **{
            f: tree_map_with_path(fn, getattr(tree, f),
                                  *(getattr(r, f) for r in rest),
                                  is_leaf=is_leaf, path=path + (_Attr(f),))
            for f in ("w_q", "s_w")})
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest, is_leaf=None):
    return tree_map_with_path(lambda _p, *leaves: fn(*leaves), tree, *rest,
                              is_leaf=is_leaf)


def _name_of(path) -> str:
    for k in reversed(path):
        if isinstance(k, str):
            if k in ("q", "s"):      # int8-quantized leaf {q, s} wrapper
                continue
            return k
    return ""


def _in_state(path) -> bool:
    """Whether ``path`` runs inside a programmed `AimcLinearState`."""
    return any(isinstance(k, _Attr) for k in path)


def param_spec(path, leaf, fsdp) -> P:
    name = _name_of(path)
    nd = leaf.ndim
    if _in_state(path):
        # inside a programmed AimcLinearState: crossbar codes/scales
        # replicate (int8 states are small and weights-stationary)
        return P(*([None] * nd))
    if name == "embed":
        return P("model", fsdp)
    if name == "unembed":
        return P(fsdp, "model")
    if name in EXPERT_IN:                      # [L, E, K, N]
        return P(None, "model", fsdp, None)
    if name in EXPERT_OUT:                     # [L, E, N, K]
        return P(None, "model", None, fsdp)
    if name in IN_PROJ and nd >= 2:            # [L, K, N] (or [K, N])
        return P(*([None] * (nd - 2)), fsdp, "model")
    if name in OUT_PROJ and nd >= 2:
        return P(*([None] * (nd - 2)), "model", fsdp)
    if name in MODEL_OUT_BIAS:
        return P(*([None] * (nd - 1)), "model")
    if name == "r_zifo":                       # [L, H, dh, 4dh] small
        return P(None, None, None, None)
    if name == "conv_w":                       # [L, W, D]
        return P(None, None, fsdp)
    # norms, biases, gains: replicate (O(d) each)
    return P(*([None] * nd))


def get_param_specs(params_shape, mesh):
    fsdp = fsdp_axes(mesh)
    return tree_map_with_path(lambda p, leaf: param_spec(p, leaf, fsdp),
                              params_shape)


def _path_str(path):
    return [k.name if isinstance(k, (_Attr, _Field)) else str(k)
            for k in path]


def _flatten_with_path(tree, is_leaf=None):
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree,
                       is_leaf=is_leaf)
    return out


def get_opt_specs(opt_shape, params_shape, mesh):
    """Optimizer state mirrors param specs; Adafactor's factored moments drop
    the corresponding parameter axis (vr: last, vc: second-to-last)."""
    pspecs = get_param_specs(params_shape, mesh)
    flat_p = {"/".join(_path_str(p)): s
              for p, s in _flatten_with_path(pspecs, is_leaf=_is_spec)}

    def spec_for(path, leaf):
        keys = _path_str(path)
        root = keys[0] if keys else ""
        pkey = "/".join(keys[1:])
        if root in ("mu", "nu") and pkey in flat_p:
            return flat_p[pkey]
        if root in ("vr", "vc") and pkey in flat_p:
            base = flat_p[pkey]
            if root == "vr":
                new = tuple(base[:-1]) if len(base) else ()
            else:
                new = (tuple(base[:-2]) + tuple(base[-1:])
                       if len(base) >= 2 else ())
            # factored moments may have fewer dims than the spec suggests
            new = tuple(new[: leaf.ndim])
            new = new + (None,) * (leaf.ndim - len(new))
            return P(*new)
        return P(*([None] * leaf.ndim))

    return tree_map_with_path(spec_for, opt_shape)


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------

def batch_specs(mesh, kind: str = "lm") -> dict:
    dp = dp_axes(mesh)
    if kind == "lm":
        return {"tokens": P(dp, None), "labels": P(dp, None)}
    if kind == "vlm":
        return {"tokens": P(dp, None), "labels": P(dp, None),
                "patch_embeds": P(dp, None, None)}
    if kind == "encdec":
        return {"frames": P(dp, None, None), "tokens": P(dp, None),
                "labels": P(dp, None)}
    raise ValueError(kind)


def cache_specs(cache_shape, mesh) -> dict:
    """Serving caches: batch -> dp axes, long axis (seq / state dim) -> model.

    Transformer/encdec KV: [L, B, S, H, hd]  -> (None, dp, 'model', None, None)
    rglru window KV:       [U, B, W, H, hd]  -> same
    rglru r-state:         [U, B, Dr]        -> (None, dp, 'model')
    rglru conv state:      [U, B, W-1, Dr]   -> (None, dp, None, 'model')
    xlstm matrix memory:   [N, B, H, dh, dh] -> (None, dp, None, 'model', None)
    xlstm scalar states:   [N, B, D]         -> (None, dp, 'model')
    lengths:               [B]               -> (dp,)
    """
    dp = dp_axes(mesh)

    def spec(path, leaf):
        name = _name_of(path)
        nd = leaf.ndim
        if name == "len":
            return P(dp)
        if nd == 5 and name in ("k", "v", "ck", "cv"):
            return P(None, dp, "model", None, None)
        if name == "m_C":
            return P(None, dp, None, "model", None)
        if name in ("m_n",):
            return P(None, dp, None, "model")
        if name in ("r_a", "r_b", "tail_r", "s_c", "s_n", "s_h", "s_m"):
            return P(None, dp, "model")
        if name in ("conv_a", "conv_b", "tail_conv"):
            return P(None, dp, None, "model")
        if name == "m_m":
            return P(None, dp, None)
        return P(*([None] * nd))

    return tree_map_with_path(spec, cache_shape)


def aimc_state_spec(leaf_ndim: int, axis: str = "model") -> P:
    """Column-shard a programmed `AimcLinearState` leaf over ``axis``: the
    last dim of w_q [..., KB, M, Np] and s_w [..., KB, Np] is the bit lines
    (output columns), the dimension `core.schedule` splits across cores."""
    return P(*([None] * (leaf_ndim - 1) + [axis]))


def shard_aimc_states(pspecs, params_shape, mesh, axis: str = "model"):
    """Rewrite the replicated `AimcLinearState` specs of `get_param_specs`
    into column-sharded ones; other leaves keep their specs, and `fit_spec`
    drops the axis wherever Np does not divide."""
    def one(path, spec, leaf):
        if _in_state(path):
            return fit_spec(aimc_state_spec(leaf.ndim, axis), leaf.shape,
                            mesh)
        return spec

    return tree_map_with_path(one, pspecs, params_shape)


def serve_engine_param_specs(params_shape, mesh, axis: str = "model"):
    """Parameter placement for the sharded serving engine (DESIGN.md §11):
    every digital leaf replicates; programmed `AimcLinearState` leaves
    column-shard their bit lines over ``axis``. `fit_spec` drops the axis
    wherever Np does not divide; a mesh without ``axis`` replicates the
    states too."""
    repl = tree_map(lambda leaf: P(*([None] * leaf.ndim)), params_shape)
    if axis not in mesh.axis_names:
        return repl
    return shard_aimc_states(repl, params_shape, mesh, axis)


def slot_cache_specs(cache_shape, batch_axes, mesh):
    """Decode-slot cache placement for the sharded engine: the slot axis
    (``batch_axes``, a matching tree of dims) shards over the data axes and
    every other dimension replicates; `fit_spec` keeps a leaf whole when
    its slot count does not divide."""
    dp = dp_axes(mesh)

    def one(leaf, ax):
        spec = [None] * leaf.ndim
        spec[ax] = dp
        return fit_spec(P(*spec), leaf.shape, mesh)

    return tree_map(one, cache_shape, batch_axes)


def slot_state_specs(state_shape, mesh):
    """Decode-slot retirement-state placement: [n_slots] leaves shard over
    the data axes like the slot cache, anything else replicates."""
    dp = dp_axes(mesh)
    return tree_map(
        lambda leaf: (fit_spec(P(dp), leaf.shape, mesh) if leaf.ndim == 1
                      else P(*([None] * leaf.ndim))),
        state_shape)


def strip_fsdp(specs, mesh):
    """Serving weight placement: keep `model` sharding, drop the FSDP axes
    (weights replicate across data rows)."""
    fsdp = set(fsdp_axes(mesh))

    def one(spec):
        if not _is_spec(spec):
            return spec
        out = []
        for entry in spec:
            if entry is None:
                out.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            kept = tuple(a for a in axes if a not in fsdp)
            out.append(kept if len(kept) > 1 else
                       (kept[0] if kept else None))
        return P(*out)

    return tree_map(one, specs, is_leaf=_is_spec)


# ---------------------------------------------------------------------------
# divisibility fitting
# ---------------------------------------------------------------------------

def fit_spec(spec: P, shape, mesh) -> P:
    """Drop mesh axes a dimension cannot be evenly sharded over. For a
    tuple assignment ('pod','data') the largest dividing prefix is kept."""
    if not _is_spec(spec):
        return spec
    entries = list(spec)
    out = []
    for d, entry in enumerate(entries):
        if entry is None or d >= len(shape):
            out.append(None if d >= len(shape) else entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept, size = [], 1
        for a in axes:
            if shape[d] % (size * mesh.shape[a]) == 0:
                kept.append(a)
                size *= mesh.shape[a]
            else:
                break
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def fit_specs(specs, shapes, mesh):
    """Tree-wise `fit_spec`; ``specs`` and ``shapes`` must be matching
    trees."""
    return tree_map(lambda s, x: fit_spec(s, x.shape, mesh), specs, shapes,
                    is_leaf=_is_spec)


# ---------------------------------------------------------------------------
# placement on the mesh's positions (in place of NamedSharding)
# ---------------------------------------------------------------------------

def _blocks(spec, ndim: int):
    """Per dim: the axes it splits over (() = whole)."""
    out = []
    for d in range(ndim):
        e = spec[d] if d < len(spec) else None
        out.append(() if e is None else (e if isinstance(e, tuple) else (e,)))
    return out


class Placed:
    """A tensor laid out on a mesh by a spec: position ``pos`` holds block
    ``block_of(pos)``, and positions holding the same block on the same
    device share one tensor (``pieces``, keyed by (block, device)).
    ``base`` (views=True layouts) is the whole tensor, of which every
    piece on its device is a view."""

    def __init__(self, spec: P, shape, dtype, mesh, pieces: dict,
                 base=None):
        self.spec, self.shape, self.dtype, self.mesh = spec, tuple(shape), \
            dtype, mesh
        self.pieces = pieces
        self.base = base
        self._axes = _blocks(spec, len(self.shape))
        self.counts = tuple(math.prod(mesh.shape[a] for a in ax)
                            for ax in self._axes)

    @property
    def device(self) -> torch.device:
        """The controller's copy: ``base``'s device, else the first
        position's."""
        if self.base is not None:
            return self.base.device
        return self.mesh.devices[0]

    def whole(self) -> torch.Tensor:
        """The whole tensor on the controller's device (``base``, no copy,
        where there is one)."""
        return self.gather(self.device)

    def block_of(self, pos) -> tuple[int, ...]:
        idx = dict(zip(self.mesh.axis_names, pos))
        out = []
        for ax in self._axes:
            b = 0
            for a in ax:                 # row-major over the dim's axes
                b = b * self.mesh.shape[a] + idx[a]
            out.append(b)
        return tuple(out)

    def piece(self, pos) -> torch.Tensor:
        return self.pieces[(self.block_of(pos), self.mesh.device_at(pos))]

    def block_pieces(self, device=None) -> dict:
        """block -> one piece holding it (on ``device`` where one does)."""
        out = {}
        for (blk, dev), t in self.pieces.items():
            if blk not in out or (device is not None
                                  and torch.device(dev) == device):
                out[blk] = t
        return out

    def block_range(self, dim: int, b: int) -> tuple[int, int]:
        size = self.shape[dim] // self.counts[dim]
        return b * size, (b + 1) * size

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``: the blocks concatenated in
        order (a replicated layout on ``device`` is its own piece, and a
        views=True layout its ``base``: no copy)."""
        device = torch.device(device)
        if self.base is not None and self.base.device == device:
            return self.base
        by = self.block_pieces(device)

        def cat(prefix, d):
            if d == len(self.shape):
                return by[prefix].to(device)
            parts = [cat(prefix + (b,), d + 1) for b in range(self.counts[d])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)
        out = cat((), 0)
        c = stepstats.counting(out)
        if c is not None and math.prod(self.counts) > 1:   # an all-gather
            c.collective("all-gather", out.numel() * out.element_size())
        return out

    def _slices(self, blk):
        return tuple(slice(*self.block_range(d, b)) for d, b in enumerate(blk))

    def scatter_(self, whole: torch.Tensor) -> None:
        """Write ``whole`` back into every piece, in place."""
        for (blk, _dev), t in self.pieces.items():
            t.copy_(whole[self._slices(blk)])

    def rows(self, dim: int, index, device) -> torch.Tensor:
        """Rows ``index`` (global indices, in order) along ``dim`` as one
        tensor on ``device``, each read from a piece that holds it (one on
        ``device`` where there is one). The layout may split ``dim`` only."""
        device = torch.device(device)
        if any(c != 1 for d, c in enumerate(self.counts) if d != dim):
            raise ValueError(f"rows along dim {dim} of a layout split as "
                             f"{self.counts}")
        by = self.block_pieces(device)
        size = self.shape[dim] // self.counts[dim]
        lead = (0,) * dim
        tail = (0,) * (len(self.shape) - dim - 1)
        return torch.cat([by[lead + (i // size,) + tail]
                          .narrow(dim, i % size, 1).to(device)
                          for i in index], dim=dim)

    def put_rows_(self, dim: int, index, values: torch.Tensor) -> None:
        """Write row j of ``values`` along ``dim`` to global row
        ``index[j]``, in every piece that holds it."""
        for j, i in enumerate(index):
            self.write_(dim, i, values.select(dim, j))

    def write_(self, dim: int, index: int, value) -> None:
        """Write ``value`` (the whole row at global ``index`` along
        ``dim``, or a Python scalar) into every piece that holds it."""
        for (blk, _dev), t in self.pieces.items():
            lo, hi = self.block_range(dim, blk[dim])
            if lo <= index < hi:
                row = t.select(dim, index - lo)
                if isinstance(value, torch.Tensor):
                    sl = self._slices(blk)
                    row.copy_(value[sl[:dim] + sl[dim + 1:]].to(t.device))
                else:
                    row.fill_(value)


def place(x: torch.Tensor, spec: P, mesh, views: bool = False) -> Placed:
    """Split ``x`` into per-position pieces by ``spec`` (`fit_spec` first:
    a dim that does not divide stays whole). Each piece is made contiguous
    on its position's device, once per (block, device); a piece that is
    already so (a leading-dim block, or a whole tensor on its own device)
    shares ``x``'s storage. ``views``: ``x`` stays whole as the layout's
    ``base`` and a piece on ``x``'s device is a view of it, contiguous or
    not (only a piece on another device is a copy)."""
    spec = fit_spec(P(*spec), tuple(x.shape), mesh)
    out = Placed(spec, x.shape, x.dtype, mesh, {},
                 base=x if views else None)
    for pos in mesh.positions():
        dev = mesh.device_at(pos)
        blk = out.block_of(pos)
        if (blk, dev) not in out.pieces:
            piece = x[out._slices(blk)]
            out.pieces[(blk, dev)] = (
                piece if views and dev == x.device
                else piece.to(dev).contiguous())
    return out


def place_tree(tree, specs, mesh, views: bool = False):
    """`place` over matching trees of tensors and specs."""
    return tree_map(lambda x, s: place(x, s, mesh, views), tree, specs)


def is_placed(x) -> bool:
    return isinstance(x, Placed)


def whole_tree(tree):
    """A tree of `Placed` layouts (or tensors) as whole tensors on the
    controller's device (`Placed.whole`: no copy for views=True
    layouts)."""
    return tree_map(lambda p: p.whole() if isinstance(p, Placed) else p,
                    tree, is_leaf=is_placed)


def gather_tree(tree, device):
    return tree_map(lambda p: p.gather(device), tree,
                    is_leaf=lambda v: isinstance(v, Placed))


def scatter_tree_(placed, whole) -> None:
    tree_map(lambda p, w: p.scatter_(w), placed, whole,
             is_leaf=lambda v: isinstance(v, Placed))


def state_splits(state: AimcLinearState, spec: P, mesh) -> int:
    """Column pieces a programmed state takes under its w_q ``spec``: the
    spec's model split where the padded Np divides ``128 * M``, else 1
    (the state stays whole)."""
    e = spec[-1] if len(spec) == state.w_q.dim() else None
    if e is None:
        return 1
    m = math.prod(mesh.shape[a] for a in (e if isinstance(e, tuple) else (e,)))
    return m if state.w_q.shape[-1] % (COLUMN_ALIGN * m) == 0 else 1


def place_aimc_state(state: AimcLinearState, spec: P, mesh
                     ) -> AimcLinearState:
    """A programmed state split into column pieces by its w_q ``spec``:
    piece j is column block ``[j * Np / M, (j + 1) * Np / M)``, on the
    device of the first position (row-major) whose model-axis block is j.
    A state whose Np does not divide ``128 * M`` (or whose spec splits
    nothing) comes back whole."""
    m = state_splits(state, spec, mesh)
    if state.pieces or m == 1:
        return state
    e = spec[-1]
    axes = e if isinstance(e, tuple) else (e,)
    first = {}
    for pos in mesh.positions():
        at = dict(zip(mesh.axis_names, pos))
        b = 0
        for a in axes:                   # row-major over the split's axes
            b = b * mesh.shape[a] + at[a]
        first.setdefault(b, mesh.device_at(pos))
    w = state.w_q.shape[-1] // m
    return split_columns(state, [(j * w, (j + 1) * w) for j in range(m)],
                         [first[j] for j in range(m)])


def place_states(params, specs, mesh):
    """``params`` with every programmed state split into column pieces by
    its w_q spec in ``specs`` (`place_aimc_state`); every other leaf as it
    is: the single controller's forward reads it on its own device."""
    def one(leaf, spec):
        if isinstance(leaf, AimcLinearState):
            return place_aimc_state(leaf, spec.w_q, mesh)
        return leaf
    return tree_map(one, params, specs,
                    is_leaf=lambda v: isinstance(v, AimcLinearState))


def place_params(params, mesh, axis: str = "model"):
    """The serving engine's parameter tree on ``mesh``
    (`serve_engine_param_specs`): programmed states become column pieces
    (`place_states`); digital leaves replicate, and the single
    controller's forward reads the replica on its own device, the leaf as
    it is."""
    return place_states(params, serve_engine_param_specs(params, mesh, axis),
                        mesh)
