"""Atomic, resumable checkpointing of tensor trees (port of
`repro/checkpoint/checkpoint.py`), in the reference's on-disk layout.

  * ATOMIC — writes go to a unique ``step_N.<pid>.<thread>.tmp/`` and are
    renamed to ``step_N/`` only after every array and the manifest are
    written; a crash mid-write never corrupts the latest valid step.
  * SELF-DESCRIBING — ``manifest.json`` lists each leaf's tree path name
    (dict keys sorted, NamedTuple fields as ``.field``, list indices: the
    names `jax.tree_util.tree_flatten_with_path` gives), file, shape and
    logical dtype; one ``leaf_NNNNN.npy`` per leaf, bfloat16 (and fp8)
    stored as a same-width unsigned integer view. A directory the JAX
    package wrote restores here, and the other way round.
  * ASYNC — ``save_async`` copies the tensors to host numpy, then writes
    on a thread, so the train loop waits only for the device-to-host copy.
  * Keeps the newest 3 steps (``_gc``).

A tree may hold `launch.shardings.Placed` layouts (a sharded train step's
parameters and optimizer state): each is saved whole. ``restore(...,
mesh=, pspecs=)`` places every restored leaf by its spec on the mesh, as
the reference's ``device_put`` onto ``NamedSharding(mesh, spec)`` does:
the whole on the target leaf's device, each position's piece a view of it
there.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

# np.save has no bfloat16/fp8: store a same-width unsigned view
_VIEW_AS = {"bfloat16": (torch.int16, np.uint16),
            "float8_e4m3fn": (torch.uint8, np.uint8),
            "float8_e5m2": (torch.uint8, np.uint8)}
_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint8): np.uint8}


def _flatten_with_names(tree, prefix=()):
    """[(name, leaf)] in the reference's flatten order and names."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_names(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += _flatten_with_names(getattr(tree, f), prefix + ("." + f,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_names(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _unflatten(tree, it):
    """A tree of ``tree``'s structure with leaves taken from ``it`` in
    `_flatten_with_names` order."""
    if isinstance(tree, dict):
        vals = {k: _unflatten(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), it)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _whole(leaf):
    """A `Placed` layout's whole tensor (the leaf itself otherwise)."""
    return leaf.whole() if hasattr(leaf, "whole") else leaf


def _to_numpy(leaf):
    """(host numpy array as stored, logical dtype name)."""
    if isinstance(leaf, np.ndarray):
        return leaf, str(leaf.dtype)
    t = _whole(leaf).detach().cpu()
    name = _dtype_name(t.dtype)
    if name in _VIEW_AS:
        view_t, view_np = _VIEW_AS[name]
        return t.view(view_t).numpy().view(view_np), name
    return t.numpy(), name


def save(path: str, step: int, tree, extra: dict | None = None) -> str:
    """Blocking atomic save. Returns the final checkpoint directory."""
    final = os.path.join(path, f"step_{step:08d}")
    # unique tmp dir: a concurrent save_async of the same step must not race
    tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
        arr, dtype_name = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"name": name, "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": dtype_name})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    try:
        os.rename(tmp, final)
    except OSError:
        # a concurrent writer won the rename for this step; theirs is valid
        shutil.rmtree(tmp, ignore_errors=True)
    _gc(path, keep=3)
    return final


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return _whole(tree).detach().to("cpu", copy=True)


def save_async(path: str, step: int, tree, extra: dict | None = None):
    """Snapshot to host, then write on a background thread (returned)."""
    t = threading.Thread(target=save, args=(path, step, _host(tree), extra),
                         daemon=True)
    t.start()
    return t


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(path, d, "manifest.json"))]
    return max(steps) if steps else None


def _load_leaf(ckpt: str, entry: dict, like: torch.Tensor) -> torch.Tensor:
    arr = np.load(os.path.join(ckpt, entry["file"]))
    if list(arr.shape) != list(like.shape):
        raise ValueError(f"shape mismatch for {entry['name']}: "
                         f"ckpt {arr.shape} vs target {tuple(like.shape)}")
    device = like.device
    if entry["dtype"] in _VIEW_AS:
        t = torch.from_numpy(arr.view(_SIGNED[arr.dtype])).view(
            getattr(torch, entry["dtype"]))
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=like.dtype)


def restore(path: str, step: int, target_tree, mesh=None, pspecs=None):
    """Restore into the structure, dtypes and devices of ``target_tree``
    (whose leaves may be tensors or `Placed` layouts); with ``mesh`` and
    ``pspecs`` (a matching tree of specs) every leaf is placed by its spec
    (`launch.shardings.place`, views). Returns (tree, extra)."""
    ckpt = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    leaves = [_load_leaf(ckpt, by_name[name], leaf)
              for name, leaf in _flatten_with_names(target_tree)]
    tree = _unflatten(target_tree, iter(leaves))
    if mesh is not None and pspecs is not None:
        from repro_torch.launch.shardings import place_tree
        tree = place_tree(tree, pspecs, mesh, views=True)
    return tree, manifest["extra"]


def restore_latest(path: str, target_tree, mesh=None, pspecs=None):
    step = latest_step(path)
    if step is None:
        return None, None, None
    tree, extra = restore(path, step, target_tree, mesh, pspecs)
    return step, tree, extra


def _gc(path: str, keep: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"), ignore_errors=True)
