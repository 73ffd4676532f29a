"""Carry parameter trees across from the JAX package, and to and from npz.

`params_from_numpy` turns a reference parameter tree already converted to
numpy (``jax.tree.map(np.asarray, params)`` on the JAX side) into the
port's tree on ``device``: nested dicts, lists and tuples keep their
structure (a CNN holds ``"convs": [...]``), arrays become tensors, and any
object with ``w_q``/``s_w``/``k``/``n`` attributes (a
programmed state, matched by duck typing) becomes an `AimcLinearState`.
`load_npz` reads a flat ``{"blocks/wq": array, ...}`` archive, the format
``launch.serve --weights`` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aimc import AimcLinearState


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if all(hasattr(tree, a) for a in ("w_q", "s_w", "k", "n")):
        return AimcLinearState(w_q=_tensor(tree.w_q, device),
                               s_w=_tensor(tree.s_w, device),
                               k=int(tree.k), n=int(tree.n))
    return _tensor(tree, device)


def flatten_to_numpy(params, prefix: str = "") -> dict:
    """``{"a/b": numpy array}`` of a nested dict of arrays or tensors."""
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out |= flatten_to_numpy(v, path)
        else:
            out[path] = np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                   else v)
    return out


def load_npz(path, device="cpu") -> dict:
    """A nested parameter tree from a flat ``"a/b"``-keyed npz archive."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *heads, last = key.split("/")
            for h in heads:
                node = node.setdefault(h, {})
            node[last] = z[key]
    return params_from_numpy(tree, device)
