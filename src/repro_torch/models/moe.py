"""Mixture-of-Experts FFN (arctic-480b: 128e top-2 + dense residual;
olmoe-1b-7b: 64e top-8); PyTorch port of `repro/models/moe.py`.

The router stays digital (an f32 matmul, softmax, top-k, renormalisation
and the Switch load-balancing aux loss); each expert's FFN is stationary
and, once programmed, its own crossbar tenant. Tokens reach the experts
through a capacity-bucketed dispatch, deterministic in shape:

  * ``sort`` (default) — a stable argsort of the assignments by expert,
    capacity ranks from the segment starts, a scatter into [E, C, d]
    buffers and a gather back for the combine; assignments past an
    expert's capacity point at a zero overflow row.
  * ``einsum`` — one-hot dispatch/combine einsums (the reference's
    measured baseline), kept behind ``REPRO_MOE_EINSUM=1`` as there.

A programmed expert stack runs each projection (gate, up, down) as ONE
launch of K2's expert entry over all E experts, each expert on its own
[C, d] input and DAC scale (`layers.linear` -> `aimc_apply_experts`), the
counterpart of the reference's `vmap` over `linear`. Raw expert weights
run three batched matmuls. The reference's `_moe_sharded` (expert
parallelism over a ``model`` mesh axis) has no counterpart on one card.
"""

from __future__ import annotations

import os

import torch

from repro_torch.models.layers import Execution, as_weight, linear


def top_k_stable(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries per row, ties broken
    towards the lower index as `lax.top_k` does (a stable descending sort;
    `torch.topk` promises no tie order on either device)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """The digital router: x [T, d] -> (gate_vals [T, k] renormalised,
    gate_idx [T, k], aux). aux is the Switch load-balancing loss
    E * sum_e f_e * p_e, taken before the capacity cut."""
    e = router_w.shape[1]
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                          # [T, E]
    gate_vals, gate_idx = top_k_stable(probs, top_k)               # [T, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(gate_idx, e).to(torch.float32).sum(
        dim=1).mean(dim=0)
    aux = e * (me * ce).sum()
    return gate_vals, gate_idx, aux


def capacity(t: int, top_k: int, e: int, capacity_factor: float) -> int:
    """Token slots per expert: the reference's
    ``max(1, int(t * top_k / e * capacity_factor))``."""
    return max(1, int(t * top_k / e * capacity_factor))


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, top_k: int,
            capacity_factor: float, exe: Execution, key=None):
    """x: [T, d]. Expert weights: [E, d, ff] / [E, ff, d] tensors or
    programmed `[E, ...]` stacks. Returns ([T, d], aux). ``key`` (read
    noise per expert, the reference's E x 3 split) is not ported: serving
    runs noise off."""
    if key is not None:
        raise NotImplementedError(
            "noise-on experts (a read key per expert) come with the "
            "training slice; see ROADMAP.md")
    t, _ = x.shape
    # an int8 router (--int8 packs "router", an IN_PROJ name) routes on its
    # dequantized f32 weights; the reference raises there
    router_w = as_weight(router_w, torch.float32)
    e = router_w.shape[1]
    cap = capacity(t, top_k, e, capacity_factor)
    gate_vals, gate_idx, aux = route(x, router_w, top_k)
    xd = x.to(exe.cdtype)
    if os.environ.get("REPRO_MOE_EINSUM"):
        xe, combine = _dispatch_einsum(xd, gate_idx, gate_vals, e, cap,
                                       top_k)
        slot_o = None
    else:
        xe, slot_o = _dispatch_sort(xd, gate_idx, e, cap, top_k)
        combine = None
    ye = _experts(xe, w_gate, w_up, w_down, exe)                   # [E, C, d]
    return _combine(ye, gate_vals, slot_o, combine, exe), aux


def _experts(xe, w_gate, w_up, w_down, exe: Execution):
    """The expert FFNs on their [E, C, d] buffers: programmed stacks run
    apply-only, one launch per projection; raw stacks are batched
    matmuls (`layers.linear` dispatches both)."""
    g = linear(xe, w_gate, exe)
    u = linear(xe, w_up, exe)
    return linear(torch.nn.functional.silu(g) * u, w_down, exe)


def _combine(ye, gate_vals, slot_o, combine, exe: Execution):
    e, cap, d = ye.shape
    ye = ye.to(exe.cdtype)
    if combine is not None:                # einsum combine (baseline)
        y = torch.einsum("tec,ecd->td", combine.to(exe.cdtype), ye)
    else:                                  # gather combine (sort dispatch)
        ye_flat = torch.cat([ye.reshape(e * cap, d),
                             ye.new_zeros((1, d))], dim=0)
        y = torch.einsum("tk,tkd->td", gate_vals.to(exe.cdtype),
                         ye_flat[slot_o])
    return y.to(exe.cdtype)


def _dispatch_sort(xd, gate_idx, e: int, cap: int, top_k: int):
    """Sort-based capacity dispatch: ~zero FLOPs, no [T, E, C] tensor.

    Returns (xe [E, C, d], slot_o [T, k]) where slot_o indexes the flattened
    [E*C (+1 overflow)] expert buffer for the combine gather; dropped
    (over-capacity) assignments point at the zero overflow row."""
    t, d = xd.shape
    dev = xd.device
    ids = gate_idx.reshape(-1)                                 # [T*k]
    order = torch.argsort(ids, stable=True)                    # token-major
    sorted_ids = ids[order]
    starts = torch.searchsorted(sorted_ids,
                                torch.arange(e, device=dev, dtype=ids.dtype))
    rank = torch.arange(t * top_k, device=dev) - starts[sorted_ids]
    slot_s = torch.where(rank < cap, sorted_ids * cap + rank,
                         torch.full_like(rank, e * cap))
    tok_s = order // top_k
    xe_flat = xd.new_zeros((e * cap + 1, d))
    xe_flat[slot_s] = xd[tok_s]       # every dropped row lands on row e*cap
    xe = xe_flat[:e * cap].reshape(e, cap, d)
    inv = torch.empty_like(order)                              # original order
    inv[order] = torch.arange(order.shape[0], device=dev)
    slot_o = slot_s[inv].reshape(t, top_k)
    return xe, slot_o


def _dispatch_einsum(xd, gate_idx, gate_vals, e: int, cap: int, top_k: int):
    """One-hot dispatch/combine (t5x style) — the measured baseline."""
    t, _ = xd.shape
    flat_mask = torch.nn.functional.one_hot(
        gate_idx.reshape(-1), e).to(torch.float32)             # [T*k, E]
    pos = torch.cumsum(flat_mask, dim=0) - flat_mask           # arrival rank
    pos = (pos * flat_mask).sum(dim=-1)                        # [T*k]
    keep = flat_mask * (pos < cap)[:, None]                    # [T*k, E]
    # one_hot of a rank >= cap is all zeros, as jax.nn.one_hot gives
    cap_slot = (pos.to(torch.int64)[:, None]
                == torch.arange(cap, device=xd.device)).to(torch.float32)
    keep = keep.reshape(t, top_k, e)
    cap_slot = cap_slot.reshape(t, top_k, cap)
    dispatch = torch.einsum("tke,tkc->tec", keep, cap_slot)    # [T, E, C]
    combine = torch.einsum("tke,tkc,tk->tec", keep, cap_slot,
                           gate_vals.to(torch.float32))
    xe = torch.einsum("tec,td->ecd", dispatch.to(xd.dtype), xd)
    return xe, combine
