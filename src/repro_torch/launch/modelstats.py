"""Analytic MODEL_FLOPS per (arch x shape) cell (PyTorch port of
`repro/launch/modelstats.py`).

MODEL_FLOPS = 6 * N * D for training (2 forward + 4 backward), 2 * N * D
for inference, with N the matmul-visible parameter count (the embedding
table excluded: lookups are gathers, not FLOPs; the unembed projection
included) and D the tokens processed. For MoE archs N is the active count:
the dense part + the expert part * top_k / n_experts (arctic's dense
residual branch is in the dense part, which every token runs).

Counts come from ``model.init`` on the ``meta`` device: the tree's shapes,
with no weight drawn or allocated.
"""

from __future__ import annotations

import math

from repro_torch.configs import ArchSpec, ShapeCell
from repro_torch.core import prng

_EXPERT_NAMES = {"we_gate", "we_up", "we_down"}


def _leaves(tree, name=""):
    """(leaf name, tensor) pairs; the name is the leaf's own dict key."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, str(k))
    else:
        yield name, tree


def param_counts(spec: ArchSpec) -> dict:
    """-> {'total', 'dense', 'expert', 'embed', 'active'} parameter counts."""
    shape = spec.model_module().init(prng.PRNGKey(0), spec.model_cfg,
                                     device="meta")
    counts = {"total": 0, "dense": 0, "expert": 0, "embed": 0}
    for name, leaf in _leaves(shape):
        n = math.prod(leaf.shape)
        counts["total"] += n
        if name == "embed":
            counts["embed"] += n
        elif name in _EXPERT_NAMES:
            counts["expert"] += n
        else:
            counts["dense"] += n
    if spec.family == "moe" and counts["expert"]:
        frac = spec.model_cfg.top_k / spec.model_cfg.n_experts
        counts["active"] = counts["dense"] + counts["expert"] * frac
    else:
        counts["active"] = counts["dense"] + counts["expert"]
    return counts


def model_flops(spec: ArchSpec, cell: ShapeCell) -> float:
    """Global useful FLOPs of one step of this cell (an enc-dec cell counts
    ``seq_len`` tokens per sequence, as the reference approximates it)."""
    n_active = param_counts(spec)["active"]
    if cell.kind == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch   # decode: one token per row
