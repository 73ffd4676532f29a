"""The weights of a cell, made from the run's seed on the device: one
generator on the card, one draw per leaf in a fixed order, in the dtype
the cell runs them in. The same seed gives the same weights, so the
reference makes them again after the window instead of keeping a copy.

Scales: embeddings N(0, 0.02^2), projections N(0, 2 / (fan_in +
fan_out)), norms one."""

from __future__ import annotations

import torch

from portbench.harness import common
from portbench.reference.model import Model


def shapes(m: Model) -> dict:
    """Leaf name -> (shape, kind) of the transformer's parameters."""
    d, l, hd = m.d_model, m.n_layers, m.head_dim
    q, kv = m.n_heads * hd, m.n_kv_heads * hd
    out = {"embed": ((m.vocab, d), "embed"), "final_norm": ((d,), "one"),
           "blocks/ln1": ((l, d), "one"), "blocks/ln2": ((l, d), "one"),
           "blocks/wq": ((l, d, q), "proj"), "blocks/wk": ((l, d, kv), "proj"),
           "blocks/wv": ((l, d, kv), "proj"),
           "blocks/wo": ((l, q, d), "proj")}
    if m.n_experts:
        e, ff = m.n_experts, m.d_ff
        out |= {"blocks/router": ((l, d, e), "proj"),
                "blocks/we_gate": ((l, e, d, ff), "proj"),
                "blocks/we_up": ((l, e, d, ff), "proj"),
                "blocks/we_down": ((l, e, ff, d), "proj")}
    else:
        out |= {"blocks/w_gate": ((l, d, m.d_ff), "proj"),
                "blocks/w_up": ((l, d, m.d_ff), "proj"),
                "blocks/w_down": ((l, m.d_ff, d), "proj")}
    out["unembed"] = ((d, m.vocab), "proj")
    return out


def leaves(m: Model, seed: int, dtype, device, names=None):
    """Yield (name, tensor) in the fixed order; ``names`` keeps only
    those (the rest are drawn and dropped, so each leaf is the same)."""
    g = torch.Generator(device=device)
    g.manual_seed(common.gen_seed(seed, 1))
    for name, (shape, kind) in shapes(m).items():
        if kind == "one":
            t = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = torch.randn(shape, generator=g, dtype=dtype, device=device)
            std = (0.02 if kind == "embed"
                   else (2.0 / (shape[-2] + shape[-1])) ** 0.5)
            t.mul_(std)
        if names is None or name in names:
            yield name, t
        del t


def make(m: Model, seed: int, dtype, device) -> dict:
    """The whole parameter tree, nested as the port's."""
    from portbench.reference.model import unflatten
    return unflatten(dict(leaves(m, seed, dtype, device)))


def check_against_port(tree: dict, spec) -> None:
    """The port's own parameter tree (on ``meta``) has these names and
    shapes: the benchmark hands it weights it can take."""
    from repro_torch.core.prng import PRNGKey
    from portbench.reference.model import flatten
    want = flatten(spec.model_module().init(PRNGKey(0), spec.model_cfg,
                                            device="meta"))
    got = flatten(tree)
    if ({k: tuple(v.shape) for k, v in want.items()}
            != {k: tuple(v.shape) for k, v in got.items()}):
        raise common.Unfit(
            f"weights differ from the port's tree: "
            f"{sorted(set(want) ^ set(got))} or shapes")
