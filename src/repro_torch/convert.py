"""Carry parameter trees across from the JAX package, and to and from npz.

`params_from_numpy` turns a reference parameter tree already converted to
numpy (``jax.tree.map(np.asarray, params)`` on the JAX side) into the
port's tree on ``device``: nested dicts, lists and tuples keep their
structure (a CNN holds ``"convs": [...]``), arrays become tensors, and any
object with ``w_q``/``s_w``/``k``/``n`` attributes (a
programmed state, matched by duck typing) becomes an `AimcLinearState`.
`load_npz` reads a flat ``{"blocks/wq": array, ...}`` archive, the format
``launch.serve --weights`` takes. `opt_state_from_numpy` carries an AdamW
or Adafactor state from the JAX package (numpy leaves, its NamedTuple
fields ``step, mu, nu`` or ``step, vr, vc``) into the port's state, so
both packages can start training from one state. bfloat16 leaves (the
reference's bf16 parameters) carry across bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aimc import AimcLinearState


def _tensor(a, device) -> torch.Tensor:
    """A tensor of numpy array ``a``; a bfloat16 array (ml_dtypes, which
    numpy and torch.from_numpy do not know) goes across as its 16-bit
    pattern, so bf16 trees carry bit for bit."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a tensor; bf16 widens to f32 exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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
            out[path] = (to_numpy(v) if isinstance(v, torch.Tensor)
                         else np.asarray(v))
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


def opt_state_from_numpy(state, device="cpu"):
    """The port's `AdamWState` / `AdafactorState` of a reference optimizer
    state whose leaves are numpy arrays (matched by its field names)."""
    from repro_torch.optim.adafactor import AdafactorState
    from repro_torch.optim.adamw import AdamWState
    fields = tuple(getattr(state, "_fields", ()))
    cls = {AdamWState._fields: AdamWState,
           AdafactorState._fields: AdafactorState}.get(fields)
    if cls is None:
        raise ValueError(f"not an AdamW or Adafactor state: fields {fields}")
    return cls(*(params_from_numpy(getattr(state, f), device)
                 for f in fields))
