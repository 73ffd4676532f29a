"""Decoder-only dense transformer (granite family); PyTorch port of the
dense serving path of `repro/models/transformer.py`.

Parameters are a nested dict of tensors with the reference's keys and a
leading layer axis on every block leaf (``blocks/wq`` is [L, D, Hq*hd]), so
tree paths and programmed names match the JAX package. A Python loop over
layers takes the place of `lax.scan`; `_layer` slices each leaf (tensor or
programmed `AimcLinearState`) to one layer. After
`core.program.AimcProgram.install`, every projection is a programmed state
and runs on the crossbar kernel; `fuse_gate_stacks` then stacks w_gate and
w_up into one `[G=2, ...]` state that runs as ONE kernel launch (K3).

Tied embeddings, QKV biases, MoE, paged serving and the training
`forward` are later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng
from repro_torch.core.aimc import AimcLinearState, stack_states
from repro_torch.models.layers import (Execution, decode_attention,
                                       dense_init, embed_init,
                                       flash_attention, linear, linear_stack,
                                       rmsnorm, rope, swiglu)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    q_chunk: int = 1024
    kv_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads


def _stack_init(key: torch.Tensor, l: int, k: int, n: int, dtype,
                device) -> torch.Tensor:
    """``vmap(dense_init)(split(key, l))``: layer i from ``split(key, l)[i]``,
    drawn one layer at a time into the preallocated [l, k, n] stack."""
    out = torch.empty((l, k, n), dtype=dtype, device=device)
    for i, ki in enumerate(prng.split(key, l)):
        out[i] = dense_init(ki, k, n, dtype, device)
    return out


def init(key: torch.Tensor, cfg: TransformerConfig, dtype=torch.float32,
         device="cuda") -> dict:
    """Random weights from a JAX-compatible key on ``device``, key for key
    the reference's `init` (`repro/models/transformer.py:75`): ``ks =
    split(key, 16)``; embed from ks[0], wq..wo from ks[1..4], w_gate/w_up/
    w_down from ks[9..11], unembed from ks[12]; unit norms. The same key
    gives the reference's weights within a few ulps (`prng.normal`)."""
    for flag in ("qkv_bias", "tie_embeddings", "n_experts"):
        if getattr(cfg, flag, False):
            raise NotImplementedError(
                f"{flag} is not ported yet (dense granite family only)")
    l, d, hq, hkv, hd, ff = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, cfg.d_ff)
    ks = prng.split(key, 16)

    def stack(i, k, n):
        return _stack_init(ks[i], l, k, n, dtype, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params = {
        "embed": embed_init(ks[0], cfg.vocab, d, dtype, device),
        "final_norm": ones(d),
        "blocks": {
            "ln1": ones(l, d),
            "ln2": ones(l, d),
            "wq": stack(1, d, hq * hd),
            "wk": stack(2, d, hkv * hd),
            "wv": stack(3, d, hkv * hd),
            "wo": stack(4, hq * hd, d),
            "w_gate": stack(9, d, ff),
            "w_up": stack(10, d, ff),
            "w_down": stack(11, ff, d),
        },
    }
    params["unembed"] = dense_init(ks[12], d, cfg.vocab, dtype, device)
    return params


def fuse_gate_stacks(params):
    """Post-`install()` rewrite: stack programmed same-shape projection
    groups into `[G, ...]` gate stacks, each run as ONE kernel launch:

      wq + wk + wv     -> wqkv  (MHA only — GQA K/V widths differ)
      w_gate + w_up    -> w_gu  (dense SwiGLU FFN)

    Gates stack at dim=1 (inside the layer dim). Groups that are not all
    programmed states of one shape pass through; outputs are bit-equal to
    the unfused path (noise off). The stack copies the codes, so the
    per-gate states are dropped from the returned tree."""
    blocks = dict(params["blocks"])
    for stacked_name, names in (("wqkv", ("wq", "wk", "wv")),
                                ("w_gu", ("w_gate", "w_up"))):
        leaves = [blocks.get(nm) for nm in names]
        if not all(isinstance(lf, AimcLinearState) for lf in leaves):
            continue
        if len({(lf.k, lf.n, tuple(lf.w_q.shape)) for lf in leaves}) != 1:
            continue
        blocks[stacked_name] = stack_states(
            [blocks.pop(nm) for nm in names], dim=1)
    return dict(params, blocks=blocks)


def _layer(blocks: dict, i: int) -> dict:
    """Layer ``i`` of the stacked block leaves (tensors and states alike)."""
    return {name: leaf[i] for name, leaf in blocks.items()}


def _qkv(h, blk, cfg: TransformerConfig, exe: Execution, positions):
    b, s, _ = h.shape
    if "wqkv" in blk:      # gate-fused stack (fuse_gate_stacks, MHA)
        q, k, v = linear_stack(h, blk["wqkv"], exe)
    else:
        q = linear(h, blk["wq"], exe)
        k = linear(h, blk["wk"], exe)
        v = linear(h, blk["wv"], exe)
    q = rope(q.reshape(b, s, cfg.n_heads, cfg.hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, cfg.n_kv_heads, cfg.hd), positions,
             cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv_heads, cfg.hd)


def _ffn(h2, blk, exe: Execution):
    if "w_gu" in blk:      # gate-fused stack (fuse_gate_stacks)
        g, u = linear_stack(h2, blk["w_gu"], exe)
        return linear(torch.nn.functional.silu(g) * u, blk["w_down"], exe)
    return swiglu(h2, blk["w_gate"], blk["w_up"], blk["w_down"], exe)


def embed_tokens(params, tokens, exe: Execution):
    return params["embed"][tokens].to(exe.cdtype)


def unembed_matrix(params):
    return params["unembed"]


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """KV cache [L, B, S, Hkv, hd] + per-row lengths."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(params, tokens, cfg: TransformerConfig, exe: Execution = None,
            max_seq: int | None = None, cache_dtype=torch.bfloat16,
            valid_len=None):
    """Full-sequence forward that also fills the KV cache.

    ``valid_len`` ([B] int32) serves right-padded ragged prompts at one
    shape: logits are taken at each row's own last valid position and the
    cache lengths are set per row."""
    exe = exe or Execution()
    b, s = tokens.shape
    max_seq = max_seq or s
    dev = tokens.device
    h = embed_tokens(params, tokens, exe)
    positions = torch.arange(s, device=dev).expand(b, s)
    cache = init_cache(cfg, b, max_seq, cache_dtype, dev)
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        q, k, v = _qkv(rmsnorm(h, blk["ln1"], cfg.norm_eps), blk, cfg, exe,
                       positions)
        att = flash_attention(q, k, v, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
        h = h + linear(att.reshape(b, s, -1), blk["wo"], exe)
        ff = _ffn(rmsnorm(h, blk["ln2"], cfg.norm_eps), blk, exe)
        cache["k"][i, :, :s] = k.to(cache_dtype)
        cache["v"][i, :, :s] = v.to(cache_dtype)
        h = h + ff
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if valid_len is None:
        h_last = h[:, -1:]
        cache["len"].fill_(s)
    else:
        lens = valid_len.to(torch.int32)
        idx = (lens - 1).clamp(0, s - 1).long()
        h_last = h[torch.arange(b, device=dev), idx][:, None]     # [B, 1, D]
        cache["len"] = lens
    logits = h_last.to(torch.float32) @ unembed_matrix(params).to(
        torch.float32)
    return logits, cache


def decode_step(params, cache, tokens, cfg: TransformerConfig,
                exe: Execution = None, ragged: bool = False):
    """tokens: [B, 1] one new token per sequence -> (logits [B,1,V], cache).

    ``ragged=False``: every row is at ``cache["len"][0]`` (lockstep).
    ``ragged=True``: each row writes its K/V at its OWN ``cache["len"]``
    and attends over its own valid length (continuous batching). The input
    cache is left untouched; the returned one is a new tensor pair."""
    exe = exe or Execution()
    b = tokens.shape[0]
    dev = tokens.device
    h = embed_tokens(params, tokens, exe)
    lens = cache["len"]
    positions = lens[:, None]
    max_seq = cache["k"].shape[2]
    rows = torch.arange(b, device=dev)
    row_idx = lens.clamp(0, max_seq - 1).long()
    ks, vs = cache["k"].clone(), cache["v"].clone()
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        q, k, v = _qkv(rmsnorm(h, blk["ln1"], cfg.norm_eps), blk, cfg, exe,
                       positions)
        kc, vc = ks[i], vs[i]
        if ragged:
            _scatter_kv(kc, k, rows, row_idx)
            _scatter_kv(vc, v, rows, row_idx)
        else:
            pos0 = row_idx[:1]
            kc.index_copy_(1, pos0, k.to(kc.dtype))
            vc.index_copy_(1, pos0, v.to(vc.dtype))
        att = decode_attention(q, kc, vc, kv_len=lens + 1)
        h = h + linear(att.reshape(b, 1, -1), blk["wo"], exe)
        ff = _ffn(rmsnorm(h, blk["ln2"], cfg.norm_eps), blk, exe)
        h = h + ff
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = h.to(torch.float32) @ unembed_matrix(params).to(
        torch.float32)
    return logits, {"k": ks, "v": vs, "len": lens + 1}


def _scatter_kv(cache_l, new, rows, idx):
    """In place: cache_l [B, S, H, D] row b at position idx[b] <- new
    [B, 1, H, D] (a row scatter, not a rewrite of the whole cache)."""
    cache_l[rows, idx] = new[:, 0].to(cache_l.dtype)
