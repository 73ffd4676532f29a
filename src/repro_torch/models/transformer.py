"""Decoder-only transformer (granite, glm4, llama3.2, qwen1.5, the
internvl2 backbone, and the MoE olmoe and arctic); PyTorch port of the
serving path of `repro/models/transformer.py`.

Parameters are a nested dict of tensors with the reference's keys and a
leading layer axis on every block leaf (``blocks/wq`` is [L, D, Hq*hd]), so
tree paths and programmed names match the JAX package. A Python loop over
layers takes the place of `lax.scan`; `layers.layer_slice` slices each leaf
(tensor or programmed `AimcLinearState`) to one layer. After
`core.program.AimcProgram.install`, every projection is a programmed state
and runs on the crossbar kernel; `fuse_gate_stacks` then stacks w_gate and
w_up into one `[G=2, ...]` state that runs as ONE kernel launch (K3).

Config flags select QKV bias (qwen; the bias rides K2's fused epilogue),
tied embeddings (llama3.2: the vocab head is ``embed.T``), the VLM
patch-embedding stub (internvl2: positions [0, n_patches) carry
precomputed patch embeddings) and the MoE FFN (``n_experts > 0``:
`models/moe.py`, capacity-bucketed routing over programmed expert stacks,
plus arctic's dense residual FFN). Serving drops the MoE aux loss, as the
reference does. The paged KV cache lives here too
(`init_paged_cache`, `paged_view`, `prefill_chunk`; DESIGN.md §15): page
gathers and scatters are plain tensor indexing, and only the projections
inside a prefill leg reach the crossbar kernel.

The training `forward` is a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng
from repro_torch.core.aimc import AimcLinearState, stack_states
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (Execution, as_weight,
                                       decode_attention, dense_init,
                                       embed_init,
                                       expert_stack_init, flash_attention,
                                       linear, linear_stack, layer_slice,
                                       rmsnorm, rope, stack_init, swiglu)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False
    moe_dense_ff: int = 0
    # VLM frontend stub
    n_patches: int = 0
    # attention chunking
    q_chunk: int = 1024
    kv_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


def init(key: torch.Tensor, cfg: TransformerConfig, dtype=torch.float32,
         device="cuda") -> dict:
    """Random weights from a JAX-compatible key on ``device``, key for key
    the reference's `init` (`repro/models/transformer.py:75`): ``ks =
    split(key, 16)``; embed from ks[0], wq..wo from ks[1..4], w_gate/w_up/
    w_down from ks[9..11], unembed from ks[12] (none when the embeddings
    are tied); unit norms; QKV biases (qkv_bias) are zeros and draw no key.
    MoE: the router from ks[5], the expert stacks we_gate/we_up/we_down
    [L, E, ...] from ks[6..8] (`expert_stack_init`), and the dense residual
    wd_* (moe_dense_residual) from ks[9..11]. The same key gives the
    reference's weights within a few ulps (`prng.normal`)."""
    l, d, hq, hkv, hd, ff = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, cfg.d_ff)
    ks = prng.split(key, 16)

    def stack(i, k, n):
        return stack_init(ks[i], l, k, n, dtype, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

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
        },
    }
    if cfg.qkv_bias:
        params["blocks"] |= {"bq": zeros(l, hq * hd),
                             "bk": zeros(l, hkv * hd),
                             "bv": zeros(l, hkv * hd)}
    if cfg.is_moe:
        e = cfg.n_experts

        def estack(i, k, n):
            return expert_stack_init(ks[i], l, e, k, n, dtype, device)

        params["blocks"] |= {
            "router": stack(5, d, e),
            "we_gate": estack(6, d, ff),
            "we_up": estack(7, d, ff),
            "we_down": estack(8, ff, d),
        }
        if cfg.moe_dense_residual:
            dff = cfg.moe_dense_ff or ff
            params["blocks"] |= {"wd_gate": stack(9, d, dff),
                                 "wd_up": stack(10, d, dff),
                                 "wd_down": stack(11, dff, d)}
    else:
        params["blocks"] |= {"w_gate": stack(9, d, ff),
                             "w_up": stack(10, d, ff),
                             "w_down": stack(11, ff, d)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(ks[12], d, cfg.vocab, dtype, device)
    return params


def fuse_gate_stacks(params):
    """Post-`install()` rewrite: stack programmed same-shape projection
    groups into `[G, ...]` gate stacks, each run as ONE kernel launch:

      wq + wk + wv     -> wqkv  (MHA only — GQA K/V widths differ)
      w_gate + w_up    -> w_gu  (dense SwiGLU FFN)

    MoE expert stacks (we_*) and arctic's dense residual (wd_*) never fuse.
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



def _qkv(h, blk, cfg: TransformerConfig, exe: Execution, positions):
    b, s, _ = h.shape
    if "wqkv" in blk:      # gate-fused stack (fuse_gate_stacks, MHA)
        biases = (torch.stack([blk["bq"], blk["bk"], blk["bv"]])
                  if "bq" in blk else None)
        q, k, v = linear_stack(h, blk["wqkv"], exe, biases=biases)
    else:
        q = linear(h, blk["wq"], exe, bias=blk.get("bq"))
        k = linear(h, blk["wk"], exe, bias=blk.get("bk"))
        v = linear(h, blk["wv"], exe, bias=blk.get("bv"))
    q = rope(q.reshape(b, s, cfg.n_heads, cfg.hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, cfg.n_kv_heads, cfg.hd), positions,
             cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv_heads, cfg.hd)


def _ffn(h2, blk, cfg: TransformerConfig, exe: Execution):
    if not cfg.is_moe:
        if "w_gu" in blk:  # gate-fused stack (fuse_gate_stacks)
            g, u = linear_stack(h2, blk["w_gu"], exe)
            return linear(torch.nn.functional.silu(g) * u, blk["w_down"], exe)
        return swiglu(h2, blk["w_gate"], blk["w_up"], blk["w_down"], exe)
    # MoE: every token position of the call (padding and inactive decode
    # lanes included) is routed and takes capacity, as in the reference;
    # serving drops the aux loss
    b, s, d = h2.shape
    y, _ = moe_lib.moe_ffn(
        h2.reshape(b * s, d), blk["router"], blk["we_gate"], blk["we_up"],
        blk["we_down"], top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
        exe=exe)
    y = y.reshape(b, s, d)
    if cfg.moe_dense_residual:
        y = y + swiglu(h2, blk["wd_gate"], blk["wd_up"], blk["wd_down"], exe)
    return y


def embed_tokens(params, tokens, cfg: TransformerConfig, exe: Execution,
                 patch_embeds=None):
    h = params["embed"][tokens].to(exe.cdtype)
    if cfg.n_patches and patch_embeds is not None:
        # VLM frontend stub: positions [0, n_patches) carry precomputed
        # patch embeddings instead of token embeddings
        h = torch.cat([patch_embeds.to(exe.cdtype), h[:, cfg.n_patches:]],
                      dim=1)
    return h


def unembed_matrix(params, cfg: TransformerConfig):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def _logits(params, h, cfg: TransformerConfig):
    return h.to(torch.float32) @ as_weight(unembed_matrix(params, cfg),
                                           torch.float32)


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """KV cache [L, B, S, Hkv, hd] + per-row lengths."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(params, tokens, cfg: TransformerConfig, exe: Execution = None,
            max_seq: int | None = None, patch_embeds=None,
            cache_dtype=torch.bfloat16, valid_len=None):
    """Full-sequence forward that also fills the KV cache.

    ``valid_len`` ([B] int32) serves right-padded ragged prompts at one
    shape: logits are taken at each row's own last valid position and the
    cache lengths are set per row. ``patch_embeds`` ([B, n_patches, D])
    feeds a vlm's patch prefix."""
    exe = exe or Execution()
    b, s = tokens.shape
    max_seq = max_seq or s
    dev = tokens.device
    h = embed_tokens(params, tokens, cfg, exe, patch_embeds)
    positions = torch.arange(s, device=dev).expand(b, s)
    cache = init_cache(cfg, b, max_seq, cache_dtype, dev)
    for i in range(cfg.n_layers):
        blk = layer_slice(params["blocks"], i)
        q, k, v = _qkv(rmsnorm(h, blk["ln1"], cfg.norm_eps), blk, cfg, exe,
                       positions)
        att = flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
        h = h + linear(att.reshape(b, s, -1), blk["wo"], exe)
        ff = _ffn(rmsnorm(h, blk["ln2"], cfg.norm_eps), blk, cfg, exe)
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
    return _logits(params, h_last, cfg), cache


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
    h = params["embed"][tokens].to(exe.cdtype)
    lens = cache["len"]
    positions = lens[:, None]
    max_seq = cache["k"].shape[2]
    rows = torch.arange(b, device=dev)
    row_idx = lens.clamp(0, max_seq - 1).long()
    ks, vs = cache["k"].clone(), cache["v"].clone()
    for i in range(cfg.n_layers):
        blk = layer_slice(params["blocks"], i)
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
        ff = _ffn(rmsnorm(h, blk["ln2"], cfg.norm_eps), blk, cfg, exe)
        h = h + ff
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, h, cfg), {"k": ks, "v": vs, "len": lens + 1}


def _scatter_kv(cache_l, new, rows, idx):
    """In place: cache_l [B, S, H, D] row b at position idx[b] <- new
    [B, 1, H, D] (a row scatter, not a rewrite of the whole cache)."""
    cache_l[rows, idx] = new[:, 0].to(cache_l.dtype)


# ---------------------------------------------------------------------------
# serving: paged KV cache (DESIGN.md §15)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: TransformerConfig, n_pages: int, page_size: int,
                     dtype=torch.float32, device=None) -> dict:
    """Physical K/V page pools [L, n_pages, P, Hkv, hd]. Page 0 is the
    engine's scratch page (`runtime.pages.SCRATCH`): writes for inactive
    lanes land there and are never read unmasked."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def paged_view(kp, vp, pt, max_seq: int):
    """The dense per-slot K/V view gathered out of the page pools.

    kp/vp: [L, n_pages, P, H, hd]; pt: [S, M] page table -> k/v
    [L, S, max_seq, H, hd]. Rows past a slot's length map through whatever
    page the (possibly stale) table names; `decode_attention` masks them
    before the softmax, so they never contribute a bit."""
    l, _, p, h, hd = kp.shape
    s, m = pt.shape
    k = kp[:, pt].reshape(l, s, m * p, h, hd)[:, :, :max_seq]
    v = vp[:, pt].reshape(l, s, m * p, h, hd)[:, :, :max_seq]
    return k, v


def prefill_chunk(params, tokens, cfg: TransformerConfig, exe: Execution,
                  kp, vp, pt_row, pos0: int, span: int, *, page_size: int,
                  context_len: int):
    """One bounded prefill leg writing straight into the page pools.

    tokens: [1, C], the leg's window (rows past ``span`` are padding on the
    final leg); ``pt_row``: [M] this request's page-table row; ``pos0`` /
    ``span``: absolute start and valid width. Earlier legs' K/V are read
    back from the pools (float32, so the readback is bit-identical to what
    the producing leg computed), the leg attends with ``q_offset=pos0`` over
    exactly ``context_len`` rows (the dense engine's prompt_pad, so the
    attention chunks reduce in dense prefill's order), and the touched
    pages [pos0 // P, (pos0 + span - 1) // P] are scattered back in place;
    untouched page indices route to the scratch page 0. Returns
    ``(tok [1, 1], kp, vp)``: tok is the argmax at the leg's last valid
    row, meaningful on the final leg only."""
    b, c = tokens.shape
    m = pt_row.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.hd
    n_rows = m * page_size
    dev = tokens.device
    h = embed_tokens(params, tokens, cfg, exe)
    positions = (pos0 + torch.arange(c, device=dev)).expand(b, c)
    j = torch.arange(m, device=dev)
    touched = (j >= pos0 // page_size) & (j <= (pos0 + span - 1) // page_size)
    pids = torch.where(touched, pt_row, torch.zeros_like(pt_row))
    pad = torch.zeros((c, hkv, hd), dtype=kp.dtype, device=dev)
    for i in range(cfg.n_layers):
        blk = layer_slice(params["blocks"], i)
        q, k, v = _qkv(rmsnorm(h, blk["ln1"], cfg.norm_eps), blk, cfg, exe,
                       positions)
        # extend by C rows so the leg's write never runs past the end
        kx = torch.cat([kp[i][pt_row].reshape(n_rows, hkv, hd), pad])
        vx = torch.cat([vp[i][pt_row].reshape(n_rows, hkv, hd), pad])
        kx[pos0:pos0 + c] = k[0].to(kx.dtype)
        vx[pos0:pos0 + c] = v[0].to(vx.dtype)
        att = flash_attention(q, kx[None, :context_len],
                              vx[None, :context_len], causal=True,
                              q_offset=pos0, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
        h = h + linear(att.reshape(b, c, -1), blk["wo"], exe)
        ff = _ffn(rmsnorm(h, blk["ln2"], cfg.norm_eps), blk, cfg, exe)
        kp[i][pids] = kx[:n_rows].reshape(m, page_size, hkv, hd)
        vp[i][pids] = vx[:n_rows].reshape(m, page_size, hkv, hd)
        h = h + ff
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    idx = min(max(span - 1, 0), c - 1)
    logits = _logits(params, h[:, idx:idx + 1], cfg)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    return tok, kp, vp
