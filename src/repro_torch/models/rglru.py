"""RecurrentGemma / Griffin hybrid (recurrentgemma-9b): RG-LRU recurrent
blocks + local (sliding-window, MQA) attention in a 2:1 pattern; PyTorch
port of `repro/models/rglru.py`: the training `forward` and the serving
path.

  * recurrent block — a GeLU gate branch and a conv1d(4) -> RG-LRU branch
    from the residual stream, merged multiplicatively and projected back:
    r_t = a_t * r_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x + b_a)), c = 8.
    Training runs the recurrence as the reference's associative scan
    (`associative_scan`, the same odd/even recursion, log depth); decode
    steps it from the carried r.
  * local attention — sliding window ``cfg.window``, MQA, RoPE: chunked
    flash attention in training, a ring buffer of the last ``window``
    keys and values (RoPE applied at write time) in decode.

Layers run as ``n_layers // 3`` (rec, rec, attn) units and ``n_layers % 3``
trailing recurrent blocks (the ``tail``). Every projection is
crossbar-mapped (K2 after `AimcProgram.install`; ``b_a``/``b_x`` ride K2's
bias epilogue; in the training forward's ``aimc`` mode each runs the STE
under its own key), while the conv kernel, Lambda and the recurrence stay
digital in f32. Serving prefill scans the decode step over the prompt
(`layers.recurrent_prefill`); its norms and ring-buffer attention sum in
`layers.row_sum`'s fixed order (batch-invariant), so the engine equals
`static_generate` bit for bit on the card, given a fixed DAC scale. The
training forward uses torch's reductions.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core import prng
from repro_torch.launch.stepstats import fill, keep_context, trips
from repro_torch.models.layers import (Execution, as_weight,
                                       decode_attention, dense_init,
                                       embed_init, flash_attention,
                                       layer_slice, linear,
                                       recurrent_prefill, rmsnorm, rope,
                                       split_keys, stack_init)

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


_NO_KEYS = (None,) * 8


def _rglru_gates(x, p, exe: Execution, keys=_NO_KEYS):
    """x: [B, S, Dr] conv output -> (a [B,S,Dr], gated input [B,S,Dr])."""
    a_logit = linear(x, p["w_a"], exe, keys[0], p["b_a"]).to(torch.float32)
    i_logit = linear(x, p["w_x"], exe, keys[1], p["b_x"]).to(torch.float32)
    log_a = -C_RGLRU * F.softplus(p["lam"].to(torch.float32)) \
        * torch.sigmoid(a_logit)
    a = torch.exp(log_a)
    gated = torch.sigmoid(i_logit) * x.to(torch.float32)
    # f32 sqrt taken in f64 and rounded once: the same correctly rounded
    # value on every device (PyTorch's f32 CPU sqrt is not reliably so)
    beta = torch.clamp(1.0 - a * a, min=1e-9).double().sqrt().float()
    return a, beta * gated


def _causal_conv(x, w, b, state=None):
    """Depthwise temporal conv stepped from ``state`` (None: zeros).
    x: [B,S,D], w: [W,D], state: [B,W-1,D]."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None]
              for i in range(width))
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return out + b[None, None], new_state


def _combine(left, right):
    """The linear recurrence's monoid: (a1, b1) then (a2, b2) is
    (a1 a2, a2 b1 + b2)."""
    return left[0] * right[0], right[0] * left[1] + right[1]


def _interleave(even, odd):
    """Alternate ``even`` and ``odd`` along dim 1 (even first; ``even`` may
    hold one more). `jax.lax` interleaves by adding zero-padded halves, so
    a -0.0 comes out +0.0: so here."""
    out = even.new_zeros((even.shape[0], even.shape[1] + odd.shape[1],
                          *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out + 0.0


def associative_scan(a, b):
    """Inclusive scan of `_combine` over dim 1 of (a, b), the recursion of
    `jax.lax.associative_scan` step for step (combine adjacent pairs,
    recurse on the half, combine the odd results with the even inputs,
    interleave): log depth, and the reference's association of every
    product and sum. Returns (A, r) with r_t = a_t r_{t-1} + b_t."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1),
            torch.cat([b[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def _rec_mix(h, p, cfg: RglruConfig, exe: Execution, keys=_NO_KEYS,
             conv_state=None, r_state=None):
    """Recurrent branch. ``r_state=None``: the training form (zero conv
    state, the associative scan over the sequence); else stepped from
    (conv_state, r_state). Returns (out [B,S,D], new conv state, new r
    state)."""
    gate = F.gelu(linear(h, p["w_gate"], exe, keys[2]), approximate="tanh")
    xr = linear(h, p["w_rnn_in"], exe, keys[3])
    xc, conv_state = _causal_conv(xr, p["conv_w"], p["conv_b"], conv_state)
    a, bx = _rglru_gates(xc, p, exe, keys)
    if r_state is None:
        rs = associative_scan(a, bx)[1]
        r = rs[:, -1]
    else:
        r = r_state.to(torch.float32)
        steps = []
        for t in trips(a.shape[1], a):
            r = a[:, t] * r + bx[:, t]
            steps.append(r)
        rs = torch.stack(fill(steps, a.shape[1]), dim=1)
    out = linear((gate.to(torch.float32) * rs).to(exe.cdtype), p["w_out"],
                 exe, keys[4])
    return out, conv_state, r


def _ffn(h, p, exe: Execution, keys=_NO_KEYS):
    g = linear(h, p["w_ff_gate"], exe, keys[5])
    u = linear(h, p["w_ff_up"], exe, keys[6])
    return linear(F.gelu(g, approximate="tanh") * u, p["w_ff_down"], exe,
                  keys[7])


def _rec_block(h, p, cfg: RglruConfig, exe: Execution, key=None,
               conv_state=None, r_state=None):
    """One recurrent block -> (h, conv state, r state): the training form
    when ``r_state`` is None (torch's reductions), else stepped
    (batch-invariant). ``key`` splits into 8: w_a, w_x, w_gate, w_rnn_in,
    w_out and the FFN's three."""
    keys = split_keys(key, 8)
    bi = r_state is not None
    mix, conv_state, r_state = _rec_mix(
        rmsnorm(h, p["ln"], cfg.norm_eps, batch_invariant=bi), p, cfg, exe,
        keys, conv_state, r_state)
    h = h + mix
    h = h + _ffn(rmsnorm(h, p["ln2"], cfg.norm_eps, batch_invariant=bi), p,
                 exe, keys)
    return h, conv_state, r_state


def _attn_block(h, p, cfg: RglruConfig, exe: Execution, key, positions):
    """The training local-attention block: sliding-window flash attention
    over h [B, S, D], then the FFN. ``key`` splits into 8: wq, wk, wv, wo
    and the FFN's three."""
    keys = split_keys(key, 8)
    b, s, _ = h.shape
    hn = rmsnorm(h, p["ln"], cfg.norm_eps)
    q = rope(linear(hn, p["wq"], exe, keys[0]).reshape(
        b, s, cfg.n_heads, cfg.hd), positions, cfg.rope_theta)
    k = rope(linear(hn, p["wk"], exe, keys[1]).reshape(
        b, s, cfg.n_kv_heads, cfg.hd), positions, cfg.rope_theta)
    v = linear(hn, p["wv"], exe, keys[2]).reshape(b, s, cfg.n_kv_heads,
                                                  cfg.hd)
    att = flash_attention(q, k, v, causal=True, window=cfg.window,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    h = h + linear(att.reshape(b, s, -1), p["wo"], exe, keys[3])
    return h + _ffn(rmsnorm(h, p["ln2"], cfg.norm_eps), p, exe, keys)


def _unit(h, ps, cfg: RglruConfig, exe: Execution, ka, kb, kc, positions):
    h = _rec_block(h, ps["rec_a"], cfg, exe, ka)[0]
    h = _rec_block(h, ps["rec_b"], cfg, exe, kb)[0]
    return _attn_block(h, ps["attn"], cfg, exe, kc, positions)


def _tail_block(h, p, cfg: RglruConfig, exe: Execution, key):
    return _rec_block(h, p, cfg, exe, key)[0]


def forward(params, tokens, cfg: RglruConfig, exe: Execution = None,
            rng=None, return_hidden: bool = False):
    """tokens [B, S] -> (logits [B, S, V], 0.0): the training forward.

    Unit i runs rec_a, rec_b and attn under ``split(rng, 3 n_units)[3i],
    [3i + 1], [3i + 2]``; tail block j under ``split(fold_in(rng, 7),
    n_tail)[j]`` (no keys when ``rng`` is None). Under autograd each unit
    and each tail block is a non-reentrant `torch.utils.checkpoint`
    region, recomputed in the backward (the reference's `jax.checkpoint`
    of its two scan bodies). ``return_hidden`` returns the final-normed
    hidden states [B, S, D] in place of the logits."""
    exe = exe or Execution()
    b, s = tokens.shape
    h = params["embed"][tokens].to(exe.cdtype)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    nu, nt = cfg.n_units, cfg.n_tail
    unit_keys = (prng.split(rng, 3 * nu) if rng is not None
                 else [None] * (3 * nu))
    remat = torch.is_grad_enabled()

    def run(fn, *args):
        if remat:
            return torch.utils.checkpoint.checkpoint(
                keep_context(fn), *args, use_reentrant=False,
                preserve_rng_state=False)
        return fn(*args)

    for i in trips(nu, h):
        ps = {name: layer_slice(params["units"][name], i)
              for name in ("rec_a", "rec_b", "attn")}
        h = run(_unit, h, ps, cfg, exe, *unit_keys[3 * i:3 * i + 3],
                positions)
    if nt:
        tail_keys = (prng.split(prng.fold_in(rng, 7), nt)
                     if rng is not None else [None] * nt)
        for j in trips(nt, h):
            h = run(_tail_block, h, layer_slice(params["tail"], j), cfg, exe,
                    tail_keys[j])
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return h, 0.0
    logits = h.to(torch.float32) @ as_weight(params["unembed"], torch.float32)
    return logits, 0.0


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
    hn = rmsnorm(h, pa["ln"], cfg.norm_eps, batch_invariant=True)
    q = rope(linear(hn, pa["wq"], exe).reshape(b, 1, cfg.n_heads, cfg.hd),
             pos[:, None], cfg.rope_theta)
    k = rope(linear(hn, pa["wk"], exe).reshape(b, 1, cfg.n_kv_heads, cfg.hd),
             pos[:, None], cfg.rope_theta)
    v = linear(hn, pa["wv"], exe).reshape(b, 1, cfg.n_kv_heads, cfg.hd)
    kc, vc = _ring_write(kc, k, pos), _ring_write(vc, v, pos)
    att = decode_attention(q, kc, vc, kv_len=torch.clamp(pos + 1, max=w),
                           batch_invariant=True)
    h = h + linear(att.reshape(b, 1, -1), pa["wo"], exe)
    h = h + _ffn(rmsnorm(h, pa["ln2"], cfg.norm_eps, batch_invariant=True),
                 pa, exe)
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
    for i in trips(cfg.n_units, h):
        ca, cb, ra, rb, kc, vc = (cache[name][i] for name in names)
        h, ca, ra = _rec_block(h, layer_slice(units["rec_a"], i), cfg, exe,
                               None, ca, ra)
        h, cb, rb = _rec_block(h, layer_slice(units["rec_b"], i), cfg, exe,
                               None, cb, rb)
        h, kc, vc = _local_attention(h, layer_slice(units["attn"], i), cfg,
                                     exe, kc, vc, pos)
        for name, t in zip(names, (ca, cb, ra, rb, kc, vc)):
            outs[name].append(t)
    new_cache = {name: torch.stack(fill(ts, cfg.n_units))
                 for name, ts in outs.items()}
    new_cache["len"] = pos + 1
    if cfg.n_tail:
        tc, tr = [], []
        for i in trips(cfg.n_tail, h):
            h, cs, rs = _rec_block(h, layer_slice(params["tail"], i), cfg,
                                   exe, None, cache["tail_conv"][i],
                                   cache["tail_r"][i])
            tc.append(cs)
            tr.append(rs)
        new_cache |= {"tail_conv": torch.stack(fill(tc, cfg.n_tail)),
                      "tail_r": torch.stack(fill(tr, cfg.n_tail))}
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps, batch_invariant=True)
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
