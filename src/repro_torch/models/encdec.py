"""Encoder-decoder transformer backbone (seamless-m4t-large-v2); PyTorch
port of `repro/models/encdec.py`.

The speech/text frontend is a stub, as in the reference: precomputed frame
embeddings [B, S_src, d] feed the encoder directly. Pre-LN transformer
(`layers.layernorm`, eps 1e-5), GeLU FFN with biases (`layers.gelu_mlp`),
RoPE on the self-attention of both stacks, a bidirectional encoder, a
causal decoder with cross-attention over the encoder output. Every
projection (self and cross Q/K/V/O, the FFN) is a stationary weight: in
``aimc`` mode each runs the STE (`core.aimc.aimc_linear_ste`, one K2
launch) under its own key, 6 per encoder and 10 per decoder layer.

Keys follow the reference exactly, quirks included: encoder layer i runs
under ``split(rng, n_enc)[i]``, decoder layer i under
``split(fold_in(rng, 1), n_dec)[i]``; each splits into 7 keys, and in the
decoder the cross-attention's ``ck`` reads under keys[4], the same key as
``cq``, while ``cv`` reads under no key (noise-free, as
`repro/models/encdec.py:176-177` has it). Each layer is a non-reentrant
`torch.utils.checkpoint` region under autograd.

Serving: `prefill` encodes the frames, runs the teacher-forced decoder
and returns the last position's logits with the decode cache (self K/V
rows [0, s) of ``max_seq``, cross K/V from the encoder output, once per
layer); `decode_step` writes one self K/V row per step at ``len`` (the
reference's one-hot select) and attends to the cross K/V whole. No key
reaches a serving `linear`: a programmed projection (cross ``ck``/``cv``
included) runs one K2 launch, 6 per encoder and 10 per decoder layer at
prefill, 8 per decoder layer per decode step. The reference serves this
family only through `launch.steps`' prefill and decode cells; the engine
refuses it. `init_paged_cache` / `paged_view` carry the paged layout of
the growing self K/V (the cross K/V stay dense), as the reference's do.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.core import prng
from repro_torch.launch.stepstats import fill, keep_context, trips
from repro_torch.models.layers import (Execution, as_weight,
                                       decode_attention, dense_init,
                                       embed_init, flash_attention,
                                       gelu_mlp, layer_slice, layernorm,
                                       linear, rope, split_keys, stack_init)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int = 24
    n_dec_layers: int = 24
    d_model: int = 1024
    n_heads: int = 16
    n_kv_heads: int = 16
    d_ff: int = 8192
    vocab: int = 256206
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    q_chunk: int = 1024
    kv_chunk: int = 1024

    @property
    def hd(self):
        return self.d_model // self.n_heads


def _layer_stack(key, cfg: EncDecConfig, n: int, cross: bool, dtype,
                 device) -> dict:
    """``n`` stacked layers, key for key the reference's `_layer_stack`:
    ``ks = split(key, 12)``; wq, wk, wv, wo, w_in, w_out from ks[0..5] and
    the cross projections cq, ck, cv, co from ks[6..9]; norms and biases
    draw no key."""
    d, hq, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.d_ff)
    ks = prng.split(key, 12)

    def stack(i, rows, cols):
        return stack_init(ks[i], n, rows, cols, dtype, device)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    p = {
        "ln1_s": full((n, d), 1.0), "ln1_b": full((n, d), 0.0),
        "wq": stack(0, d, hq * hd), "wk": stack(1, d, hkv * hd),
        "wv": stack(2, d, hkv * hd), "wo": stack(3, hq * hd, d),
        "ln3_s": full((n, d), 1.0), "ln3_b": full((n, d), 0.0),
        "w_in": stack(4, d, ff), "b_in": full((n, ff), 0.0),
        "w_out": stack(5, ff, d), "b_out": full((n, d), 0.0),
    }
    if cross:
        p |= {
            "ln2_s": full((n, d), 1.0), "ln2_b": full((n, d), 0.0),
            "cq": stack(6, d, hq * hd), "ck": stack(7, d, hkv * hd),
            "cv": stack(8, d, hkv * hd), "co": stack(9, hq * hd, d),
        }
    return p


def init(key: torch.Tensor, cfg: EncDecConfig, dtype=torch.float32,
         device="cuda") -> dict:
    """Random weights from a JAX-compatible key, key for key the
    reference's `init` (`repro/models/encdec.py:79`): ``ks = split(key,
    5)``; embed from ks[0], the encoder stack from ks[1], the decoder's
    from ks[2], unembed from ks[3]."""
    ks = prng.split(key, 5)
    d = cfg.d_model

    def full(v):
        return torch.full((d,), v, dtype=dtype, device=device)

    return {
        "embed": embed_init(ks[0], cfg.vocab, d, dtype, device),
        "enc": _layer_stack(ks[1], cfg, cfg.n_enc_layers, False, dtype,
                            device),
        "dec": _layer_stack(ks[2], cfg, cfg.n_dec_layers, True, dtype,
                            device),
        "enc_norm_s": full(1.0), "enc_norm_b": full(0.0),
        "dec_norm_s": full(1.0), "dec_norm_b": full(0.0),
        "unembed": dense_init(ks[3], d, cfg.vocab, dtype, device),
    }


def _self_attn(h, p, cfg: EncDecConfig, exe: Execution, keys, positions,
               causal: bool):
    b, s, _ = h.shape
    hn = layernorm(h, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
    q = rope(linear(hn, p["wq"], exe, keys[0]).reshape(
        b, s, cfg.n_heads, cfg.hd), positions, cfg.rope_theta)
    k = rope(linear(hn, p["wk"], exe, keys[1]).reshape(
        b, s, cfg.n_kv_heads, cfg.hd), positions, cfg.rope_theta)
    v = linear(hn, p["wv"], exe, keys[2]).reshape(b, s, cfg.n_kv_heads,
                                                  cfg.hd)
    att = flash_attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk)
    return h + linear(att.reshape(b, s, -1), p["wo"], exe, keys[3]), (k, v)


def _cross_attn(h, enc_kv, p, cfg: EncDecConfig, exe: Execution, keys):
    b, s, _ = h.shape
    hn = layernorm(h, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
    q = linear(hn, p["cq"], exe, keys[4]).reshape(b, s, cfg.n_heads, cfg.hd)
    ek, ev = enc_kv
    att = flash_attention(q, ek, ev, causal=False, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk)
    return h + linear(att.reshape(b, s, -1), p["co"], exe, keys[5])


def _ffn(h, p, cfg: EncDecConfig, exe: Execution, keys):
    hn = layernorm(h, p["ln3_s"], p["ln3_b"], cfg.norm_eps)
    return h + gelu_mlp(hn, p["w_in"], p["b_in"], p["w_out"], p["b_out"],
                        exe, keys[6])


def _enc_layer(h, blk, cfg: EncDecConfig, exe: Execution, key, positions):
    keys = split_keys(key, 7)
    h, _ = _self_attn(h, blk, cfg, exe, keys, positions, causal=False)
    return _ffn(h, blk, cfg, exe, keys)


def _dec_layer(h, enc_out, blk, cfg: EncDecConfig, exe: Execution, key,
               positions):
    keys = split_keys(key, 7)
    b, se = enc_out.shape[:2]
    h, _ = _self_attn(h, blk, cfg, exe, keys, positions, causal=True)
    # the reference's keys: ck under keys[4] (cq's), cv under none
    ek = linear(enc_out, blk["ck"], exe, keys[4])
    ev = linear(enc_out, blk["cv"], exe, None)
    h = _cross_attn(h, (ek.reshape(b, se, cfg.n_kv_heads, cfg.hd),
                        ev.reshape(b, se, cfg.n_kv_heads, cfg.hd)),
                    blk, cfg, exe, keys)
    return _ffn(h, blk, cfg, exe, keys)


def _run(fn, *args):
    """``fn(*args)``, under autograd as a non-reentrant checkpoint region
    (recomputed in the backward)."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            keep_context(fn), *args, use_reentrant=False,
            preserve_rng_state=False)
    return fn(*args)


def encode(params, frames, cfg: EncDecConfig, exe: Execution = None,
           rng=None):
    """frames [B, S_src, d] (precomputed frontend embeddings) -> the
    final-normed encoder output [B, S_src, d]; layer i under
    ``split(rng, n_enc)[i]``."""
    exe = exe or Execution()
    b, s, _ = frames.shape
    h = frames.to(exe.cdtype)
    positions = torch.arange(s, device=frames.device).expand(b, s)
    n = cfg.n_enc_layers
    lkeys = prng.split(rng, n) if rng is not None else [None] * n
    for i in trips(n, h):
        h = _run(_enc_layer, h, layer_slice(params["enc"], i), cfg, exe,
                 lkeys[i], positions)
    return layernorm(h, params["enc_norm_s"], params["enc_norm_b"],
                     cfg.norm_eps)


def decode_train(params, enc_out, tokens, cfg: EncDecConfig,
                 exe: Execution = None, rng=None,
                 return_hidden: bool = False):
    """Teacher-forced decoder pass: tokens [B, S_tgt] -> (logits
    [B, S_tgt, V], 0.0), or the final-normed hidden states with
    ``return_hidden``; layer i under ``split(fold_in(rng, 1), n_dec)[i]``."""
    exe = exe or Execution()
    b, s = tokens.shape
    h = params["embed"][tokens].to(exe.cdtype)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    n = cfg.n_dec_layers
    lkeys = (prng.split(prng.fold_in(rng, 1), n) if rng is not None
             else [None] * n)
    for i in trips(n, h):
        h = _run(_dec_layer, h, enc_out, layer_slice(params["dec"], i), cfg,
                 exe, lkeys[i], positions)
    h = layernorm(h, params["dec_norm_s"], params["dec_norm_b"],
                  cfg.norm_eps)
    if return_hidden:
        return h, 0.0
    logits = h.to(torch.float32) @ as_weight(params["unembed"], torch.float32)
    return logits, 0.0


def forward(params, batch, cfg: EncDecConfig, exe: Execution = None,
            rng=None, return_hidden: bool = False):
    """batch = {frames [B, S, d], tokens [B, S_tgt]} -> decoder logits (or
    hidden states), 0.0."""
    enc_out = encode(params, batch["frames"], cfg, exe, rng)
    return decode_train(params, enc_out, batch["tokens"], cfg, exe, rng,
                        return_hidden)


def unembed_matrix(params, cfg: EncDecConfig):
    return params["unembed"]


def _dec_cross_kv(params, enc_out, cfg: EncDecConfig, exe: Execution):
    """Per-layer cross K/V from the encoder output (computed once):
    ([n_dec, B, S_src, Hkv, hd], same) in the compute dtype."""
    b, s, _ = enc_out.shape
    ck, cv = [], []
    for i in trips(cfg.n_dec_layers, enc_out):
        blk = layer_slice(params["dec"], i)
        ck.append(linear(enc_out, blk["ck"], exe).reshape(
            b, s, cfg.n_kv_heads, cfg.hd))
        cv.append(linear(enc_out, blk["cv"], exe).reshape(
            b, s, cfg.n_kv_heads, cfg.hd))
    n = cfg.n_dec_layers
    return torch.stack(fill(ck, n)), torch.stack(fill(cv, n))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: EncDecConfig, batch: int, max_seq: int, src_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Self K/V [n_dec, B, max_seq, Hkv, hd], cross K/V ``ck``/``cv``
    [n_dec, B, src_len, Hkv, hd] and per-row lengths ``len`` [B] int32."""
    n, hkv, hd = cfg.n_dec_layers, cfg.n_kv_heads, cfg.hd

    def z(s):
        return torch.zeros((n, batch, s, hkv, hd), dtype=dtype,
                           device=device)

    return {"k": z(max_seq), "v": z(max_seq), "ck": z(src_len),
            "cv": z(src_len),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(params, frames, tokens, cfg: EncDecConfig, exe: Execution = None,
            max_seq: int | None = None, cache_dtype=torch.bfloat16):
    """Encode + teacher-forced decoder prefill -> (logits [B, 1, V] of the
    last position against the f32 unembed, the decode cache): self K/V
    (after RoPE) at rows [0, s) of ``max_seq`` (default s), the cross K/V
    of every layer, ``len`` = s."""
    exe = exe or Execution()
    enc_out = encode(params, frames, cfg, exe)
    b, s = tokens.shape
    max_seq = max_seq or s
    dev = tokens.device
    h = params["embed"][tokens].to(exe.cdtype)
    positions = torch.arange(s, device=dev).expand(b, s)
    ek, ev = _dec_cross_kv(params, enc_out, cfg, exe)
    shape = (cfg.n_dec_layers, b, max_seq, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=cache_dtype, device=dev),
             "v": torch.zeros(shape, dtype=cache_dtype, device=dev),
             "ck": ek.to(cache_dtype), "cv": ev.to(cache_dtype),
             "len": torch.full((b,), s, dtype=torch.int32, device=dev)}
    keys = (None,) * 7
    for i in trips(cfg.n_dec_layers, h):
        blk = layer_slice(params["dec"], i)
        h, (k, v) = _self_attn(h, blk, cfg, exe, keys, positions,
                               causal=True)
        h = _cross_attn(h, (ek[i], ev[i]), blk, cfg, exe, keys)
        h = _ffn(h, blk, cfg, exe, keys)
        cache["k"][i, :, :s] = k.to(cache_dtype)
        cache["v"][i, :, :s] = v.to(cache_dtype)
    h = layernorm(h, params["dec_norm_s"], params["dec_norm_b"],
                  cfg.norm_eps)
    logits = (h[:, -1:].to(torch.float32)
              @ as_weight(params["unembed"], torch.float32))
    return logits, cache


def decode_step(params, cache, tokens, cfg: EncDecConfig,
                exe: Execution = None):
    """tokens [B, 1] -> (logits [B, 1, V], a new cache). Row b writes its
    self K/V at ``len[b]`` as ``kc * (1 - oh) + oh * k`` in the cache dtype
    (the reference's one-hot select), attends to its first ``len[b] + 1``
    rows, then to the whole cross K/V; the input cache is not modified."""
    exe = exe or Execution()
    b = tokens.shape[0]
    h = params["embed"][tokens].to(exe.cdtype)
    lens = cache["len"]
    positions = lens[:, None]
    max_seq = cache["k"].shape[2]
    oh = (torch.arange(max_seq, device=lens.device)[None]
          == lens[:, None].long()).to(cache["k"].dtype)[..., None, None]
    ks, vs = [], []
    for i in trips(cfg.n_dec_layers, h):
        blk = layer_slice(params["dec"], i)
        hn = layernorm(h, blk["ln1_s"], blk["ln1_b"], cfg.norm_eps)
        q = rope(linear(hn, blk["wq"], exe).reshape(
            b, 1, cfg.n_heads, cfg.hd), positions, cfg.rope_theta)
        k = rope(linear(hn, blk["wk"], exe).reshape(
            b, 1, cfg.n_kv_heads, cfg.hd), positions, cfg.rope_theta)
        v = linear(hn, blk["wv"], exe).reshape(b, 1, cfg.n_kv_heads, cfg.hd)
        kc, vc = cache["k"][i], cache["v"][i]
        kc = kc * (1 - oh) + oh * k.to(kc.dtype)
        vc = vc * (1 - oh) + oh * v.to(vc.dtype)
        att = decode_attention(q, kc, vc, kv_len=lens + 1)
        h = h + linear(att.reshape(b, 1, -1), blk["wo"], exe)
        # cross attention against the precomputed encoder K/V
        hn2 = layernorm(h, blk["ln2_s"], blk["ln2_b"], cfg.norm_eps)
        cq = linear(hn2, blk["cq"], exe).reshape(b, 1, cfg.n_heads, cfg.hd)
        catt = decode_attention(cq, cache["ck"][i], cache["cv"][i])
        h = h + linear(catt.reshape(b, 1, -1), blk["co"], exe)
        h = _ffn(h, blk, cfg, exe, (None,) * 7)
        ks.append(kc)
        vs.append(vc)
    h = layernorm(h, params["dec_norm_s"], params["dec_norm_b"],
                  cfg.norm_eps)
    logits = h.to(torch.float32) @ as_weight(params["unembed"], torch.float32)
    n = cfg.n_dec_layers
    return logits, dict(cache, k=torch.stack(fill(ks, n)),
                        v=torch.stack(fill(vs, n)), len=lens + 1)


# ---------------------------------------------------------------------------
# paged decoder self-attention K/V (DESIGN.md §15)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: EncDecConfig, n_pages: int, page_size: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    """Decoder self-attention K/V page pools [n_dec, n_pages, P, Hkv, hd].
    Only the growing part of the cache pages: the cross K/V are written
    once from the encoder output and stay dense per slot. Page 0 is the
    scratch page (`runtime.pages.SCRATCH`)."""
    shape = (cfg.n_dec_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def paged_view(kp, vp, pt, max_seq: int):
    """Dense per-slot decoder K/V [N, S, max_seq, H, hd] gathered out of the
    page pools through the [S, M] page table (`transformer.paged_view`'s
    contract: rows at or past a slot's length are masked by
    `decode_attention` before the softmax)."""
    n, _, p, h, hd = kp.shape
    s, m = pt.shape
    k = kp[:, pt].reshape(n, s, m * p, h, hd)[:, :, :max_seq]
    v = vp[:, pt].reshape(n, s, m * p, h, hd)[:, :, :max_seq]
    return k, v
