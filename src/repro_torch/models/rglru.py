"""RecurrentGemma / Griffin hybrid (recurrentgemma-9b): RG-LRU recurrent
blocks + local (sliding-window, MQA) attention in a 2:1 pattern; PyTorch
port of the serving path of `repro/models/rglru.py`.

  * recurrent block — a GeLU gate branch and a conv1d(4) -> RG-LRU branch
    from the residual stream, merged multiplicatively and projected back:
    r_t = a_t * r_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x + b_a)), c = 8.
  * local attention — a ring buffer of the last ``window`` keys and values
    (MQA, RoPE applied at write time).

Layers run as ``n_layers // 3`` (rec, rec, attn) units and ``n_layers % 3``
trailing recurrent blocks (the ``tail``). Every projection is
crossbar-mapped (K2 after `AimcProgram.install`; ``b_a``/``b_x`` ride K2's
bias epilogue), while the conv kernel, Lambda and the recurrence stay
digital in f32. Serving prefill scans the decode step over the prompt
(`layers.recurrent_prefill`); the reference's associative-scan `forward`
belongs to training and waits for that slice. Norms and the ring-buffer
attention sum in `layers.row_sum`'s fixed order (batch-invariant), so the
engine equals `static_generate` bit for bit on the card, given a fixed DAC
scale.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models.layers import (Execution, as_weight,
                                       decode_attention, dense_init,
                                       embed_init, layer_slice,
                                       linear, recurrent_prefill, rmsnorm,
                                       rope, stack_init)

C_RGLRU = 8.0


@dataclasses.dataclass(frozen=True)
class RglruConfig:
    name: str
    n_layers: int = 38
    d_model: int = 4096
    n_heads: int = 16
    n_kv_heads: int = 1
    d_ff: int = 12288
    vocab: int = 256000
    d_rnn: int = 0                 # 0 -> d_model
    conv_width: int = 4
    window: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    q_chunk: int = 1024
    kv_chunk: int = 1024

    @property
    def hd(self):
        return self.d_model // self.n_heads

    @property
    def drnn(self):
        return self.d_rnn or self.d_model

    @property
    def n_units(self):
        return self.n_layers // 3

    @property
    def n_tail(self):
        return self.n_layers % 3


def _rec_params(key, cfg: RglruConfig, n: int, dtype, device) -> dict:
    """One stack of ``n`` recurrent blocks, key for key the reference's
    `_rec_params`: ``ks = split(key, 8)``, and w_ff_down from
    ``fold_in(key, 99)``."""
    d, dr = cfg.d_model, cfg.drnn
    ks = prng.split(key, 8)

    def stack(k_, rows, cols):
        return stack_init(k_, n, rows, cols, dtype, device)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    return {
        "ln": full((n, d), 1.0),
        "w_gate": stack(ks[0], d, dr),         # GeLU branch
        "w_rnn_in": stack(ks[1], d, dr),       # conv/RG-LRU branch
        "conv_w": prng.normal(ks[2], (n, cfg.conv_width, dr),
                              device=device) * 0.02,
        "conv_b": full((n, dr), 0.0),
        "w_a": stack(ks[3], dr, dr),           # recurrence gate
        "b_a": full((n, dr), 0.0),
        "w_x": stack(ks[4], dr, dr),           # input gate
        "b_x": full((n, dr), 0.0),
        "lam": full((n, dr), 0.649),
        "w_out": stack(ks[5], dr, d),
        "ln2": full((n, d), 1.0),
        "w_ff_gate": stack(ks[6], d, cfg.d_ff),
        "w_ff_up": stack(ks[7], d, cfg.d_ff),
        "w_ff_down": stack(prng.fold_in(key, 99), cfg.d_ff, d),
    }


def _attn_params(key, cfg: RglruConfig, n: int, dtype, device) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ks = prng.split(key, 8)

    def stack(i, rows, cols):
        return stack_init(ks[i], n, rows, cols, dtype, device)

    ones = torch.ones((n, d), dtype=dtype, device=device)
    return {
        "ln": ones,
        "wq": stack(0, d, hq * hd), "wk": stack(1, d, hkv * hd),
        "wv": stack(2, d, hkv * hd), "wo": stack(3, hq * hd, d),
        "ln2": ones.clone(),
        "w_ff_gate": stack(4, d, cfg.d_ff),
        "w_ff_up": stack(5, d, cfg.d_ff),
        "w_ff_down": stack(6, cfg.d_ff, d),
    }


def init(key: torch.Tensor, cfg: RglruConfig, dtype=torch.float32,
         device="cuda") -> dict:
    """Random weights from a JAX-compatible key, key for key the
    reference's `init` (`repro/models/rglru.py:121`): ``ks = split(key,
    6)``; embed from ks[0], the unit stacks rec_a/rec_b/attn from ks[1..3],
    unembed from ks[4] and the tail from ks[5]."""
    ks = prng.split(key, 6)
    params = {
        "embed": embed_init(ks[0], cfg.vocab, cfg.d_model, dtype, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "units": {
            "rec_a": _rec_params(ks[1], cfg, cfg.n_units, dtype, device),
            "rec_b": _rec_params(ks[2], cfg, cfg.n_units, dtype, device),
            "attn": _attn_params(ks[3], cfg, cfg.n_units, dtype, device),
        },
        "unembed": dense_init(ks[4], cfg.d_model, cfg.vocab, dtype, device),
    }
    if cfg.n_tail:
        params["tail"] = _rec_params(ks[5], cfg, cfg.n_tail, dtype, device)
    return params


def _norm(x, scale, eps):
    return rmsnorm(x, scale, eps, batch_invariant=True)



def _rglru_gates(x, p, exe: Execution):
    """x: [B, S, Dr] conv output -> (a [B,S,Dr], gated input [B,S,Dr])."""
    a_logit = linear(x, p["w_a"], exe, bias=p["b_a"]).to(torch.float32)
    i_logit = linear(x, p["w_x"], exe, bias=p["b_x"]).to(torch.float32)
    log_a = -C_RGLRU * F.softplus(p["lam"].to(torch.float32)) \
        * torch.sigmoid(a_logit)
    a = torch.exp(log_a)
    gated = torch.sigmoid(i_logit) * x.to(torch.float32)
    # f32 sqrt taken in f64 and rounded once: the same correctly rounded
    # value on every device (PyTorch's f32 CPU sqrt is not reliably so)
    beta = torch.clamp(1.0 - a * a, min=1e-9).double().sqrt().float()
    return a, beta * gated


def _causal_conv(x, w, b, state):
    """Depthwise temporal conv stepped from ``state``. x: [B,S,D], w: [W,D],
    state: [B,W-1,D]."""
    width = w.shape[0]
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None]
              for i in range(width))
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return out + b[None, None], new_state


def _rec_mix(h, p, cfg: RglruConfig, exe: Execution, conv_state, r_state):
    """Recurrent branch stepped from (conv_state, r_state). Returns (out
    [B,S,D], new conv state, new r state)."""
    gate = F.gelu(linear(h, p["w_gate"], exe), approximate="tanh")
    xr = linear(h, p["w_rnn_in"], exe)
    xc, conv_state = _causal_conv(xr, p["conv_w"], p["conv_b"], conv_state)
    a, bx = _rglru_gates(xc, p, exe)
    r = r_state.to(torch.float32)
    rs = []
    for t in range(a.shape[1]):
        r = a[:, t] * r + bx[:, t]
        rs.append(r)
    out = linear((gate.to(torch.float32) * torch.stack(rs, dim=1))
                 .to(exe.cdtype), p["w_out"], exe)
    return out, conv_state, r


def _ffn(h, p, exe: Execution):
    g = linear(h, p["w_ff_gate"], exe)
    u = linear(h, p["w_ff_up"], exe)
    return linear(F.gelu(g, approximate="tanh") * u, p["w_ff_down"], exe)


def _rec_block(h, p, cfg: RglruConfig, exe: Execution, conv_state, r_state):
    mix, conv_state, r_state = _rec_mix(_norm(h, p["ln"], cfg.norm_eps), p,
                                        cfg, exe, conv_state, r_state)
    h = h + mix
    h = h + _ffn(_norm(h, p["ln2"], cfg.norm_eps), p, exe)
    return h, conv_state, r_state


def unembed_matrix(params, cfg: RglruConfig):
    return params["unembed"]


def init_cache(cfg: RglruConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """RG-LRU state (f32) + conv window + ring-buffer window KV + lengths."""
    w = min(cfg.window, max_seq)
    nu, dr, cw = cfg.n_units, cfg.drnn, cfg.conv_width

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    cache = {
        "r_a": zeros((nu, batch, dr), torch.float32),
        "r_b": zeros((nu, batch, dr), torch.float32),
        "conv_a": zeros((nu, batch, cw - 1, dr)),
        "conv_b": zeros((nu, batch, cw - 1, dr)),
        "k": zeros((nu, batch, w, cfg.n_kv_heads, cfg.hd)),
        "v": zeros((nu, batch, w, cfg.n_kv_heads, cfg.hd)),
        "len": zeros((batch,), torch.int32),
    }
    if cfg.n_tail:
        cache |= {"tail_r": zeros((cfg.n_tail, batch, dr), torch.float32),
                  "tail_conv": zeros((cfg.n_tail, batch, cw - 1, dr))}
    return cache


def _ring_write(cache, new, pos):
    """cache [B, W, H, D] with row b's slot ``pos[b] % W`` replaced by
    new [B, 1, H, D]: the reference's one-hot blend, bit for bit (signed
    zeros included: -0.0 written over a nonzero lands as +0.0)."""
    w = cache.shape[1]
    oh = F.one_hot((pos % w).long(), w).to(cache.dtype)[..., None, None]
    return cache * (1 - oh) + oh * new.to(cache.dtype)


def _local_attention(h, pa, cfg: RglruConfig, exe: Execution, kc, vc, pos):
    """The attention block of one unit against its ring buffer: write this
    step's K/V at slot ``pos % w``, attend over the min(pos + 1, w) written
    slots, then the FFN. Returns (h, kc, vc)."""
    b = h.shape[0]
    w = kc.shape[1]
    hn = _norm(h, pa["ln"], cfg.norm_eps)
    q = rope(linear(hn, pa["wq"], exe).reshape(b, 1, cfg.n_heads, cfg.hd),
             pos[:, None], cfg.rope_theta)
    k = rope(linear(hn, pa["wk"], exe).reshape(b, 1, cfg.n_kv_heads, cfg.hd),
             pos[:, None], cfg.rope_theta)
    v = linear(hn, pa["wv"], exe).reshape(b, 1, cfg.n_kv_heads, cfg.hd)
    kc, vc = _ring_write(kc, k, pos), _ring_write(vc, v, pos)
    att = decode_attention(q, kc, vc, kv_len=torch.clamp(pos + 1, max=w),
                           batch_invariant=True)
    h = h + linear(att.reshape(b, 1, -1), pa["wo"], exe)
    h = h + _ffn(_norm(h, pa["ln2"], cfg.norm_eps), pa, exe)
    return h, kc, vc


def decode_step(params, cache, tokens, cfg: RglruConfig,
                exe: Execution = None):
    """tokens [B, 1] -> (logits [B, 1, V], new cache); the input cache is
    left untouched."""
    exe = exe or Execution()
    h = params["embed"][tokens].to(exe.cdtype)
    pos = cache["len"]
    names = ("conv_a", "conv_b", "r_a", "r_b", "k", "v")
    outs = {name: [] for name in names}
    units = params["units"]
    for i in range(cfg.n_units):
        ca, cb, ra, rb, kc, vc = (cache[name][i] for name in names)
        h, ca, ra = _rec_block(h, layer_slice(units["rec_a"], i), cfg, exe,
                               ca, ra)
        h, cb, rb = _rec_block(h, layer_slice(units["rec_b"], i), cfg, exe,
                               cb, rb)
        h, kc, vc = _local_attention(h, layer_slice(units["attn"], i), cfg,
                                     exe, kc, vc, pos)
        for name, t in zip(names, (ca, cb, ra, rb, kc, vc)):
            outs[name].append(t)
    new_cache = {name: torch.stack(ts) for name, ts in outs.items()}
    new_cache["len"] = pos + 1
    if cfg.n_tail:
        tc, tr = [], []
        for i in range(cfg.n_tail):
            h, cs, rs = _rec_block(h, layer_slice(params["tail"], i), cfg,
                                   exe, cache["tail_conv"][i],
                                   cache["tail_r"][i])
            tc.append(cs)
            tr.append(rs)
        new_cache |= {"tail_conv": torch.stack(tc),
                      "tail_r": torch.stack(tr)}
    h = _norm(h, params["final_norm"], cfg.norm_eps)
    logits = h.to(torch.float32) @ as_weight(params["unembed"], torch.float32)
    return logits, new_cache


def prefill(params, tokens, cfg: RglruConfig, exe: Execution = None,
            max_seq: int | None = None, cache_dtype=torch.bfloat16,
            valid_len=None):
    """Prompt ingestion for serving: the decode recurrence (conv window,
    RG-LRU state, ring-buffer window cache) scanned over a right-padded
    prompt from a fresh cache, each row frozen past its own ``valid_len``.
    Returns (last-valid logits [B, 1, V], decode cache)."""
    exe = exe or Execution()
    cache0 = init_cache(cfg, tokens.shape[0], max_seq or tokens.shape[1],
                        cache_dtype, tokens.device)
    return recurrent_prefill(
        lambda cache, tok: decode_step(params, cache, tok, cfg, exe),
        cache0, tokens, cfg.vocab, valid_len)


def prefill_chunk(params, cache, tokens, cfg: RglruConfig,
                  exe: Execution = None, span=None):
    """One bounded prefill leg from an arbitrary carried state; rows past
    ``span`` are frozen. Returns (last-valid logits [B, 1, V], carried
    cache)."""
    exe = exe or Execution()
    return recurrent_prefill(
        lambda c, t: decode_step(params, c, t, cfg, exe),
        cache, tokens, cfg.vocab, span)
