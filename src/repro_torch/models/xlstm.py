"""xLSTM (xlstm-350m): alternating mLSTM and sLSTM blocks; PyTorch port of
the serving path of `repro/models/xlstm.py`.

  * mLSTM — matrix-memory LSTM with exponential gating, here in its O(1)
    per-step recurrence (decode); the reference's chunkwise-parallel form
    serves its training `forward` and waits for the training slice.
  * sLSTM — scalar-memory LSTM with exponential gating and block-diagonal
    recurrent weights ``r_zifo``, stepped over time.

The gate pre-projections (W_z/i/f/o, q/k/v, up/gate, the FFN) are the
stationary matrices: after `core.program.AimcProgram.install` each runs on
the crossbar kernel K2, and `fuse_gate_stacks` stacks the shared-input
groups (w_up + w_gate, w_q + w_k + w_v, w_ff_gate + w_ff_up) so each runs
as ONE K3 launch. The recurrences themselves are element-wise and stay
digital, in f32, as do ``r_zifo`` and the gate biases (the default
`MappingPlan` excludes them).

Serving prefill scans the decode step over the prompt
(`layers.recurrent_prefill`), so `prefill`, `decode_step` and
`prefill_chunk` share one recurrence. Cache leaves carry the pair stack on
dim 0 and batch on dim 1; ``"len"`` is [B]. Every sum across features
(norms, the mLSTM memory read-out, the sLSTM recurrent product) runs in
`layers.row_sum`'s fixed order, so a row's state does not depend on what
shares its batch: the engine (prefills at batch 1) equals
`static_generate` (one batched prefill) bit for bit on the card as on the
CPU, given a fixed DAC scale.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.aimc import AimcLinearState, stack_states
from repro_torch.models.layers import (Execution, as_weight, dense_init,
                                       embed_init, layer_slice, linear,
                                       linear_stack, recurrent_prefill,
                                       rmsnorm, row_sum, stack_init)


@dataclasses.dataclass(frozen=True)
class XlstmConfig:
    name: str
    n_layers: int = 24              # alternating mLSTM, sLSTM
    d_model: int = 1024
    n_heads: int = 4
    vocab: int = 50304
    proj_factor_m: int = 2          # mLSTM inner width multiplier
    ff_factor_s: float = 4 / 3      # sLSTM block FFN multiplier
    chunk: int = 512                # mLSTM chunkwise-parallel chunk length
    norm_eps: float = 1e-6

    @property
    def n_pairs(self):
        return self.n_layers // 2

    @property
    def d_inner(self):
        return self.proj_factor_m * self.d_model

    @property
    def hd_m(self):
        return self.d_inner // self.n_heads

    @property
    def hd_s(self):
        return self.d_model // self.n_heads

    @property
    def d_ff_s(self):
        return int(self.ff_factor_s * self.d_model)


def init(key: torch.Tensor, cfg: XlstmConfig, dtype=torch.float32,
         device="cuda") -> dict:
    """Random weights from a JAX-compatible key, key for key the
    reference's `init` (`repro/models/xlstm.py:70`): ``ks = split(key,
    16)``; mLSTM w_up..w_down from ks[0..6], sLSTM w_zifo from ks[7],
    ``r_zifo = normal(ks[8]) * 0.02``, the FFN from ks[9..11], embed from
    ks[12], unembed from ks[13]; norms, biases and ``b_if`` (zeros, then 3.0
    for the forget gates) draw no key."""
    n, d, di, h = cfg.n_pairs, cfg.d_model, cfg.d_inner, cfg.n_heads
    ks = prng.split(key, 16)

    def stack(i, k, n_):
        return stack_init(ks[i], n, k, n_, dtype, device)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    mlstm = {
        "ln": full((n, d), 1.0),
        "w_up": stack(0, d, di),
        "w_gate": stack(1, d, di),
        "w_q": stack(2, di, di),
        "w_k": stack(3, di, di),
        "w_v": stack(4, di, di),
        "w_if": stack(5, di, 2 * h),
        "b_if": torch.cat([full((n, h), 0.0), full((n, h), 3.0)], -1),
        "gn": full((n, di), 1.0),
        "w_down": stack(6, di, d),
    }
    slstm = {
        "ln": full((n, d), 1.0),
        "w_zifo": stack(7, d, 4 * d),
        "r_zifo": prng.normal(ks[8], (n, h, cfg.hd_s, 4 * cfg.hd_s),
                              device=device) * 0.02,
        "b_zifo": full((n, 4 * d), 0.0),
        "gn": full((n, d), 1.0),
        "ln2": full((n, d), 1.0),
        "w_ff_gate": stack(9, d, cfg.d_ff_s),
        "w_ff_up": stack(10, d, cfg.d_ff_s),
        "w_ff_down": stack(11, cfg.d_ff_s, d),
    }
    return {
        "embed": embed_init(ks[12], cfg.vocab, d, dtype, device),
        "final_norm": full((d,), 1.0),
        "pairs": {"mlstm": mlstm, "slstm": slstm},
        "unembed": dense_init(ks[13], d, cfg.vocab, dtype, device),
    }


def fuse_gate_stacks(params):
    """Post-`install()` rewrite: stack programmed same-shape gate
    projections into `[G, ...]` stacks, each run as ONE K3 launch:

      mLSTM  w_up + w_gate        -> w_ug   (shared input hn)
             w_q + w_k + w_v      -> w_qkv  (shared input up)
      sLSTM  w_ff_gate + w_ff_up  -> w_ff_gu

    Gates stack at dim 1 (inside the pair dim), so a pair's slice is a
    contiguous `[G, ...]` stack. Groups that are not all programmed states
    of one shape pass through; outputs are bit-equal to the unfused path
    (noise off). The stack copies the codes, so the per-gate states are
    dropped from the returned tree."""
    def fuse(tree, groups):
        tree = dict(tree)
        for stacked_name, names in groups:
            leaves = [tree.get(nm) for nm in names]
            if not all(isinstance(lf, AimcLinearState) for lf in leaves):
                continue
            if len({(lf.k, lf.n, tuple(lf.w_q.shape)) for lf in leaves}) != 1:
                continue
            tree[stacked_name] = stack_states(
                [tree.pop(nm) for nm in names], dim=1)
        return tree

    pairs = dict(params["pairs"])
    pairs["mlstm"] = fuse(pairs["mlstm"], [("w_ug", ("w_up", "w_gate")),
                                           ("w_qkv", ("w_q", "w_k", "w_v"))])
    pairs["slstm"] = fuse(pairs["slstm"],
                          [("w_ff_gu", ("w_ff_gate", "w_ff_up"))])
    return dict(params, pairs=pairs)


def _norm(x, scale, eps):
    return rmsnorm(x, scale, eps, batch_invariant=True)



def _groupnorm(x, scale, n_heads, eps=1e-6):
    """Per-head groupnorm over the trailing dim (population variance, as
    `jnp.var`). x: [..., H*dh]."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], n_heads, shp[-1] // n_heads).to(torch.float32)
    n = xh.shape[-1]
    mu = (row_sum(xh) / n)[..., None]
    c = xh - mu
    var = (row_sum(c * c) / n)[..., None]
    y = (c * torch.rsqrt(var + eps)).reshape(shp)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _mlstm_step(q, k, v, li, lf, state):
    """Single-step recurrence. q,k,v: [B,H,dh]; li/lf: [B,H]."""
    C, n, m = state
    m_new = torch.maximum(lf + m, li)
    f_ = torch.exp(lf + m - m_new)
    i_ = torch.exp(li - m_new)
    C = f_[..., None, None] * C + i_[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_[..., None] * n + i_[..., None] * k
    num = row_sum(q[..., :, None] * C, dim=-2)          # q . C over d
    den = row_sum(q * n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, (C, n, m_new)


def _mlstm_qkvif(hn, p, cfg: XlstmConfig, exe: Execution):
    b, s, _ = hn.shape
    h_, dh = cfg.n_heads, cfg.hd_m
    if "w_ug" in p:        # gate-fused stack (fuse_gate_stacks)
        up, gate = linear_stack(hn, p["w_ug"], exe)
        gate = F.silu(gate)
    else:
        up = linear(hn, p["w_up"], exe)
        gate = F.silu(linear(hn, p["w_gate"], exe))
    if "w_qkv" in p:
        q, k, v = linear_stack(up, p["w_qkv"], exe)
    else:
        q = linear(up, p["w_q"], exe)
        k = linear(up, p["w_k"], exe)
        v = linear(up, p["w_v"], exe)
    q = q.reshape(b, s, h_, dh) / (dh ** 0.5)
    k = k.reshape(b, s, h_, dh)
    v = v.reshape(b, s, h_, dh)
    if_ = (linear(up, p["w_if"], exe) + p["b_if"]).to(torch.float32)
    li = if_[..., :h_]
    lf = F.logsigmoid(if_[..., h_:])
    f32 = torch.float32
    return q.to(f32), k.to(f32), v.to(f32), li, lf, gate


def mlstm_block(h, p, cfg: XlstmConfig, exe: Execution, state):
    """One mLSTM block stepped from ``state`` = (C, n, m); h: [B, 1, D]."""
    hn = _norm(h, p["ln"], cfg.norm_eps)
    q, k, v, li, lf, gate = _mlstm_qkvif(hn, p, cfg, exe)
    # recurrent states compute in f32 regardless of the cache dtype
    state = tuple(x.to(torch.float32) for x in state)
    ho, new_state = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], li[:, 0],
                                lf[:, 0], state)
    b, s = h.shape[:2]
    ho = _groupnorm(ho[:, None].reshape(b, s, -1).to(exe.cdtype), p["gn"],
                    cfg.n_heads, cfg.norm_eps)
    out = linear(ho * gate, p["w_down"], exe)
    return h + out, new_state


def _slstm_seq(zifo, r, hd, n_heads, state):
    """zifo: [B,S,4d] input-side pre-activations; r: [H, dh, 4dh] recurrent
    weights. state: (c, n, h, m) each [B, d]. Returns ([B,S,d], state)."""
    b, s, d4 = zifo.shape
    d = d4 // 4
    c, n, h, m = state
    hs = []
    for t in range(s):
        x_t = zifo[:, t]
        rec = row_sum(h.reshape(b, n_heads, hd)[..., None] * r,
                      dim=-2).reshape(b, 4 * d)
        pre = x_t + rec
        zt = torch.tanh(pre[:, :d])
        it = pre[:, d:2 * d]
        ft = pre[:, 2 * d:3 * d]
        ot = torch.sigmoid(pre[:, 3 * d:])
        lf = F.logsigmoid(ft)
        m_new = torch.maximum(lf + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(lf + m - m_new)
        c = f_ * c + i_ * zt
        n = f_ * n + i_
        h = ot * (c / torch.clamp(n, min=1e-6))
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


def slstm_block(h, p, cfg: XlstmConfig, exe: Execution, state):
    """One sLSTM block (and its gated FFN) stepped from ``state`` =
    (c, n, h, m)."""
    hn = _norm(h, p["ln"], cfg.norm_eps)
    zifo = (linear(hn, p["w_zifo"], exe) + p["b_zifo"]).to(torch.float32)
    state = tuple(x.to(torch.float32) for x in state)
    hs, new_state = _slstm_seq(zifo, p["r_zifo"].to(torch.float32),
                               cfg.hd_s, cfg.n_heads, state)
    hs = _groupnorm(hs.to(exe.cdtype), p["gn"], cfg.n_heads, cfg.norm_eps)
    h = h + hs
    hn2 = _norm(h, p["ln2"], cfg.norm_eps)
    if "w_ff_gu" in p:     # gate-fused stack (fuse_gate_stacks)
        g, u = linear_stack(hn2, p["w_ff_gu"], exe)
    else:
        g = linear(hn2, p["w_ff_gate"], exe)
        u = linear(hn2, p["w_ff_up"], exe)
    ff = linear(F.gelu(g, approximate="tanh") * u, p["w_ff_down"], exe)
    return h + ff, new_state


def unembed_matrix(params, cfg: XlstmConfig):
    return params["unembed"]


_STATE = ("m_C", "m_n", "m_m", "s_c", "s_n", "s_h", "s_m")


def init_cache(cfg: XlstmConfig, batch: int, max_seq: int = 0,
               dtype=torch.float32, device=None) -> dict:
    """O(1) recurrent state (matrix memory + sLSTM scalars + lengths)."""
    n, h, dh, d = cfg.n_pairs, cfg.n_heads, cfg.hd_m, cfg.d_model

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    return {
        "m_C": full((n, batch, h, dh, dh), 0.0),
        "m_n": full((n, batch, h, dh), 0.0),
        "m_m": full((n, batch, h), -1e30),
        "s_c": full((n, batch, d), 0.0),
        "s_n": full((n, batch, d), 0.0),
        "s_h": full((n, batch, d), 0.0),
        "s_m": full((n, batch, d), -1e30),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params, cache, tokens, cfg: XlstmConfig,
                exe: Execution = None):
    """tokens [B, 1] -> (logits [B, 1, V], new cache); the input cache is
    left untouched. States are stored back at the cache dtype per pair."""
    exe = exe or Execution()
    h = params["embed"][tokens].to(exe.cdtype)
    cdt = cache["m_C"].dtype
    outs = {name: [] for name in _STATE}
    for i in range(cfg.n_pairs):
        st = [cache[name][i] for name in _STATE]
        pair = {blk: layer_slice(params["pairs"][blk], i)
                for blk in ("mlstm", "slstm")}
        h, m_state = mlstm_block(h, pair["mlstm"], cfg, exe, st[:3])
        h, s_state = slstm_block(h, pair["slstm"], cfg, exe, st[3:])
        for name, t in zip(_STATE, m_state + s_state):
            outs[name].append(t.to(cdt))
    new_cache = {name: torch.stack(ts) for name, ts in outs.items()}
    new_cache["len"] = cache["len"] + 1
    h = _norm(h, params["final_norm"], cfg.norm_eps)
    logits = h.to(torch.float32) @ as_weight(params["unembed"], torch.float32)
    return logits, new_cache


def prefill(params, tokens, cfg: XlstmConfig, exe: Execution = None,
            max_seq: int | None = None, cache_dtype=torch.float32,
            valid_len=None):
    """Prompt ingestion for serving: the decode recurrence scanned over a
    right-padded prompt from a fresh cache, each row frozen past its own
    ``valid_len``. Returns (last-valid logits [B, 1, V], decode cache)."""
    exe = exe or Execution()
    cache0 = init_cache(cfg, tokens.shape[0], max_seq or tokens.shape[1],
                        cache_dtype, tokens.device)
    return recurrent_prefill(
        lambda cache, tok: decode_step(params, cache, tok, cfg, exe),
        cache0, tokens, cfg.vocab, valid_len)


def prefill_chunk(params, cache, tokens, cfg: XlstmConfig,
                  exe: Execution = None, span=None):
    """One bounded prefill leg from an arbitrary carried state (the previous
    leg's, or a restored prefix snapshot); rows past ``span`` (int or [B])
    are frozen as `prefill` freezes padding. Returns (last-valid logits
    [B, 1, V], carried cache)."""
    exe = exe or Execution()
    return recurrent_prefill(
        lambda c, t: decode_step(params, c, t, cfg, exe),
        cache, tokens, cfg.vocab, span)
