"""Shared model layers, AIMC-capable (PyTorch port of
`repro/models/layers.py`).

Every stationary-weight projection routes through `linear()`, which runs
one of three ways: digitally (a plain matmul, the paper's CPU+SIMD
baseline); apply-only on the crossbar kernel when the weight arrives as a
programmed `AimcLinearState` (installed by
`core.program.AimcProgram.install`); or, in ``aimc`` mode on raw weights,
through `core.aimc.aimc_linear_ste`, which programs with a fresh noise
draw on every call and backpropagates straight through (noise-aware
training; an `[E, K, N]` expert stack runs the expert STE, one launch).

Attention is plain tensor ops following the reference's algorithm: a
chunked online softmax for prefill and training (causal or bidirectional,
with a sliding window for rglru's local attention and a query offset for
prefill legs; under autograd each chunk pair is recomputed in the
backward, the reference's `jax.checkpoint`) and a masked softmax against
the KV cache for decode. `recurrent_prefill` scans a model's decode step
over a prompt (xlstm, rglru). `layernorm` and the GeLU FFN (`gelu_mlp`)
serve the enc-dec model. Activation sharding hints (`shard_act`) have no
counterpart on one card.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import compat
from repro_torch.core import prng
from repro_torch.core.aimc import (AimcConfig, AimcLinearState, aimc_apply,
                                   aimc_apply_experts, aimc_apply_stacked,
                                   aimc_linear_ste, aimc_linear_ste_experts)
from repro_torch.kernels.ref import EPILOGUE_FNS
from repro_torch.launch import stepstats


@dataclasses.dataclass(frozen=True)
class Execution:
    """Execution choices threaded through every model call. ``programmed``
    declares that an AimcProgram has been installed: projections that stay
    raw (plan-excluded) then run digitally, never re-programming per call."""
    mode: str = "digital"                  # digital | aimc
    aimc: AimcConfig = AimcConfig()
    compute_dtype: str = "bfloat16"
    # int8-native serving: projection weights arrive as {"q", "s"} int8
    # codes + per-channel scales (`core.quant.quantize_params_int8`) and
    # are dequantized per call (`as_weight`)
    serve_int8: bool = False
    programmed: bool = False

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def layer_slice(tree: dict, i: int) -> dict:
    """Layer ``i`` of a dict of stacked leaves (tensors, programmed states
    and int8 {"q", "s"} pairs alike): the eager counterpart of
    `lax.scan`'s per-layer slice."""
    return {name: ({k: v[i] for k, v in leaf.items()}
                   if isinstance(leaf, dict) else leaf[i])
            for name, leaf in tree.items()}


def _bf16_scatter_add(tok, rows, shape, dtype):
    """A zero ``shape`` table plus ``rows`` at ``tok``, added in ``tok``
    order with a rounding to ``dtype`` after every add, as XLA adds a
    bf16 scatter's updates one by one. The adds run one occurrence rank
    at a time: rank k holds each token's k-th position, so no two updates
    of one pass hit the same row. One host read (the ranks' sizes); under
    a step counter on ``meta`` (`launch.stepstats`) the table's shape,
    counted as XLA's one scatter."""
    c = stepstats.counting(rows)
    if c is not None:
        acc = torch.empty(shape, dtype=dtype, device=rows.device)
        c.scatter((tok, rows), acc)
        return acc
    order = torch.argsort(tok, stable=True)
    st = tok[order]
    pos = torch.arange(st.numel(), device=tok.device)
    first = torch.ones_like(st, dtype=torch.bool)
    first[1:] = st[1:] != st[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = order[torch.argsort(rank, stable=True)]
    acc = torch.zeros(shape, dtype=dtype, device=rows.device)
    lo = 0
    for n in torch.bincount(rank).tolist():
        sel = by_rank[lo:lo + n]
        lo += n
        t = tok[sel]
        acc[t] = (acc[t].to(torch.float32)
                  + rows[sel].to(torch.float32)).to(dtype)
    return acc


class _EmbedLookup(torch.autograd.Function):
    """Rows ``tokens`` of a bf16 table, as ``dtype``; the backward is the
    reference's bf16 scatter-add: each row gradient rounded to bf16 (the
    gather's own dtype, as the reference's cast does), then added to its
    table row in token order in bf16 (`_bf16_scatter_add`). Under an
    ambient mesh with ``ndp`` data positions dividing the batch, each data
    shard's rows make their own table, and the shards' tables are added
    in shard order in bf16, as XLA partitions the scatter over the data
    axes."""

    @staticmethod
    def forward(ctx, table, tokens, dtype):
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[tokens].to(dtype)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        mesh = compat.current_mesh()
        ndp = 1 if mesh is None else math.prod(
            mesh.shape[a] for a in mesh.axis_names if a != "model")
        if tokens.dim() < 2 or tokens.shape[0] % ndp:
            ndp = 1
        rows = g.to(ctx.table_dtype)
        acc = None
        for tk, rw in zip(tokens.chunk(ndp), rows.chunk(ndp)):
            part = _bf16_scatter_add(tk.reshape(-1).long(),
                                     rw.reshape(-1, ctx.table_shape[-1]),
                                     ctx.table_shape, ctx.table_dtype)
            acc = part if acc is None else (
                acc.to(torch.float32) + part.to(torch.float32)).to(
                    ctx.table_dtype)
        return acc, None, None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """``table[tokens].to(dtype)``; a bf16 table that needs a gradient
    takes `_EmbedLookup`, whose backward adds a repeated token's row
    gradients in bf16 in token order, per data shard under a mesh, as the
    reference's scatter does (the same forward bits)."""
    if table.dtype == torch.bfloat16 and table.requires_grad:
        return _EmbedLookup.apply(table, tokens, dtype)
    return table[tokens].to(dtype)


def as_weight(w, dtype: torch.dtype) -> torch.Tensor:
    """A weight that may be stored as int8 codes + scales, materialised in
    ``dtype``: ``q * s`` in ``dtype``, as the reference dequantizes (a
    copy of the projection per call; a fused dequant is later work)."""
    if isinstance(w, dict) and "q" in w:
        return w["q"].to(dtype) * w["s"].to(dtype)
    return w.to(dtype)


def mask_batch_select(new, old, active, dim: int = 0):
    """Per-request freeze: ``new`` where ``active`` ([B] bool), else
    ``old``; ``dim`` is the batch dim of the same-shape tensors."""
    shape = [1] * new.dim()
    shape[dim] = active.shape[0]
    return torch.where(active.reshape(shape), new, old)


def recurrent_prefill(decode_fn, cache0, tokens, n_vocab, valid_len=None):
    """Serving prefill for the O(1)-state archs (xlstm, rglru): run the
    single-token decode step over a right-padded prompt batch.

    ``decode_fn(cache, tok [B, 1]) -> (logits [B, 1, V], new_cache)``; the
    cache is a flat dict whose leaves carry batch on dim 1, except
    ``"len"`` (dim 0). Steps at positions >= ``valid_len`` are padding: the
    cache is frozen through them (`mask_batch_select`), and the returned
    logits are each row's own last valid step. ``valid_len`` is [B], one
    int for every row, or None (the whole width)."""
    b, s = tokens.shape
    dev = tokens.device
    vl = torch.as_tensor(s if valid_len is None else valid_len,
                         dtype=torch.int32, device=dev).expand(b)
    cache = cache0
    last = torch.zeros((b, 1, n_vocab), dtype=torch.float32, device=dev)
    for t in range(s):
        logits, new_cache = decode_fn(cache, tokens[:, t:t + 1])
        active = t < vl
        cache = {k: mask_batch_select(new_cache[k], cache[k], active,
                                      0 if k == "len" else 1)
                 for k in new_cache}
        last = torch.where((vl - 1 == t)[:, None, None],
                           logits.to(torch.float32), last)
    return last, cache


def linear(x, w, exe: Execution, key=None, bias=None,
           activation: str = "none"):
    """The AIMC-or-digital projection. x: [..., K]; w: [K, N] or a
    programmed `AimcLinearState`, whose epilogue runs inside the kernel;
    ``key`` draws read noise (and, on the fly, programming noise). An
    `[E, ...]` expert stack takes x [E, C, K] and ``key`` [E, 2], one key
    per expert (expert e on x[e], the reference's `vmap` of `linear`): a
    programmed stack runs as one launch, a raw [E, K, N] stack in ``aimc``
    mode runs the expert STE (one launch), digitally it multiplies
    batched."""
    if isinstance(w, AimcLinearState):
        if w.stack_shape:
            if bias is not None or activation != "none":
                raise ValueError("expert stacks carry no epilogue")
            return aimc_apply_experts(w, x, exe.aimc, key).to(exe.cdtype)
        return aimc_apply(w, x, exe.aimc, key, bias=bias,
                          activation=activation).to(exe.cdtype)
    if exe.mode == "aimc" and not exe.programmed:
        wf = as_weight(w, torch.float32)
        ste = aimc_linear_ste_experts if wf.dim() == 3 else aimc_linear_ste
        y = ste(x, wf, key, exe.aimc).to(exe.cdtype)
    else:
        y = x.to(exe.cdtype) @ as_weight(w, exe.cdtype)
    if bias is not None:
        y = y + bias.to(exe.cdtype)
    return EPILOGUE_FNS[activation](y)


def linear_stack(x, ws: AimcLinearState, exe: Execution, key=None,
                 biases=None, activations="none"):
    """Gate-fused multi-MVM: a `[G, ...]` programmed stack (built by a
    model's `fuse_gate_stacks`) sharing one input runs as ONE kernel launch
    (K3) -> tuple of G outputs; ``key`` draws read noise (gate g under
    `cprng.stack_seed`)."""
    y = aimc_apply_stacked(ws, x, exe.aimc, key, biases=biases,
                           activations=activations).to(exe.cdtype)
    return tuple(y[i] for i in range(ws.stack_shape[-1]))


def row_sum(x, dim: int = -1):
    """Sum over ``dim`` in one fixed pairwise order of elementwise adds
    (zero-padded to a power of two). Each output's bits depend on its own
    row alone: torch's reductions on the card pick their summation order
    by the number of outputs, so a row summed in a batch of 4 can differ
    by an ulp from the same row alone, and through the DAC that becomes a
    different token. Batch-invariant serving (engine == `static_generate`)
    takes this in every cross-feature sum."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def rmsnorm(x, scale, eps: float = 1e-6, batch_invariant: bool = False):
    x32 = x.to(torch.float32)
    if batch_invariant:
        var = (row_sum(x32 * x32) / x.shape[-1])[..., None]
    else:
        var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the trailing dim in f32 (population variance, as
    `jnp.var`), cast back to x's dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    c = x32 - mu
    var = (c * c).mean(dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding. x: [B, S, H, D] (D even), positions: [B, S]."""
    half = x.shape[-1] // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].to(torch.float32) * freqs      # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


NEG_INF = -1e30


def _attn_chunk(q, k, v, q_pos, kv_pos, carry, scale, causal, window,
                kv_valid):
    """One (q-chunk x kv-chunk) online-softmax update.
    q: [B, Hq, qc, D]; k/v: [B, Hkv, kc, D];
    carry = (m [B,Hq,qc], l [B,Hq,qc], acc [B,Hq,qc,D])."""
    m, l, acc = carry
    b, hq, qc, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, qc, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    mask = (kv_pos[None, :] < kv_valid).expand(qc, -1)        # pad mask
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    s = s.reshape(b, hq, qc, -1)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a fully-masked chunk (past the window, or after the causal edge)
    # would give exp(NEG_INF - NEG_INF) = 1: re-mask
    p = torch.exp(s - m_new[..., None])
    p = torch.where(mask.reshape(1, 1, qc, -1), p, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.reshape(b, hkv, g * qc, -1),
                      v.to(torch.float32)).reshape(b, hq, qc, d)
    return m_new, l_new, acc * corr[..., None] + pv


def flash_attention(q, k, v, *, causal=True, window=None, q_offset: int = 0,
                    q_chunk=1024, kv_chunk=1024):
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] -> [B, Sq, Hq, D], a
    chunked online softmax (memory O(qc*kc)), GQA-aware. Query row i sits
    at absolute position ``q_offset + i`` (a prefill leg attends over the
    earlier legs' keys); ``window`` keeps only keys at positions
    ``> q_pos - window``. The kv chunks reduce in the same order whatever
    the query chunking, so a leg's rows equal dense prefill's. Under
    autograd each chunk pair runs under `torch.utils.checkpoint`, so the
    backward recomputes its scores (the reference's `jax.checkpoint` of the
    kv body) instead of keeping them."""
    b, sq0, hq, d = q.shape
    _, skv0, hkv, _ = k.shape
    qc = min(q_chunk, sq0)
    kc = min(kv_chunk, skv0)
    sq = -(-sq0 // qc) * qc
    skv = -(-skv0 // kc) * kc
    pad = torch.nn.functional.pad
    if sq != sq0:
        q = pad(q, (0, 0, 0, 0, 0, sq - sq0))
    if skv != skv0:
        k = pad(k, (0, 0, 0, 0, 0, skv - skv0))
        v = pad(v, (0, 0, 0, 0, 0, skv - skv0))
    scale = 1.0 / (d ** 0.5)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
    dev = q.device
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for qi in stepstats.trips(sq // qc, q):
        q_blk = qh[:, :, qi * qc:(qi + 1) * qc]
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        carry = (torch.full((b, hq, qc), NEG_INF, device=dev),
                 torch.zeros((b, hq, qc), device=dev),
                 torch.zeros((b, hq, qc, d), device=dev))
        for j in stepstats.trips(skv // kc, k):
            kv_pos = j * kc + torch.arange(kc, device=dev)
            args = (q_blk, kh[:, :, j * kc:(j + 1) * kc],
                    vh[:, :, j * kc:(j + 1) * kc], q_pos, kv_pos, carry,
                    scale, causal, window, skv0)
            if remat:
                carry = torch.utils.checkpoint.checkpoint(
                    _attn_chunk, *args, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                carry = _attn_chunk(*args)
        _, l, acc = carry
        outs.append((acc / l.clamp_min(1e-20)[..., None]).to(q.dtype))
    o = torch.cat(stepstats.fill(outs, sq // qc), dim=2)  # [B, Hq, Sq, D]
    return o.transpose(1, 2)[:, :sq0]


def decode_attention(q, k_cache, v_cache, kv_len=None,
                     batch_invariant: bool = False):
    """Single-token attention against a KV cache.
    q: [B, 1, Hq, D]; caches: [B, Skv, Hkv, D]; kv_len: [B] valid lengths,
    or None for the whole cache (the enc-dec cross-attention).
    ``batch_invariant`` contracts with `row_sum` (products, then a fixed
    pairwise sum; softmax as exp(s - max) / row_sum) instead of einsum and
    softmax, so a row's bits do not depend on the batch."""
    b, _, hq, d = q.shape
    _, skv, hkv, _ = k_cache.shape
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    # operands round to the cache dtype, products accumulate in f32 (the
    # reference's preferred_element_type=f32)
    qg = q.reshape(b, hkv, g, d).to(k_cache.dtype).to(torch.float32)
    kf = k_cache.to(torch.float32)
    mask = (torch.ones((b, skv), dtype=torch.bool, device=q.device)
            if kv_len is None else
            torch.arange(skv, device=q.device)[None] < kv_len[:, None])
    if batch_invariant:
        # [B, Hkv, G, 1, D] x [B, Hkv, 1, Skv, D] -> [B, Hkv, G, Skv]
        s = row_sum(qg[:, :, :, None] * kf.permute(0, 2, 1, 3)[:, :, None])
        s = torch.where(mask[:, None, None], s * scale, NEG_INF)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / row_sum(e)[..., None]
        pv = p.to(v_cache.dtype).to(torch.float32)
        vf = v_cache.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
        o = row_sum(pv[..., None] * vf, dim=-2)          # over Skv
        return o.reshape(b, 1, hq, d).to(q.dtype)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kf) * scale
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).to(torch.float32),
                     v_cache.to(torch.float32))
    return o.reshape(b, 1, hq, d).to(q.dtype)


def split_keys(key, n: int) -> tuple:
    """``split(key, n)`` as a tuple of n keys, or n Nones (no noise)."""
    if key is None:
        return (None,) * n
    return tuple(prng.split(key, n))


def swiglu(x, w_gate, w_up, w_down, exe: Execution, key=None):
    k1, k2, k3 = split_keys(key, 3)
    g = linear(x, w_gate, exe, k1)
    u = linear(x, w_up, exe, k2)
    return linear(torch.nn.functional.silu(g) * u, w_down, exe, k3)


def gelu_mlp(x, w_in, b_in, w_out, b_out, exe: Execution, key=None):
    """The enc-dec FFN: ``gelu(x W_in + b_in) W_out + b_out``, GeLU in its
    tanh form (`jax.nn.gelu`'s default); ``split(key)`` keys the two
    linears."""
    k1, k2 = split_keys(key, 2)
    h = F.gelu(linear(x, w_in, exe, k1, b_in), approximate="tanh")
    return linear(h, w_out, exe, k2, b_out)


def dense_init(key: torch.Tensor, k: int, n: int, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """N(0, 2/(k+n)) weights [k, n] from a JAX-compatible key
    (`core.prng`), the reference's draw and f32 scaling, rounded to
    ``dtype`` (bf16 parameters: the reference's ``astype`` after its f32
    init, one matrix at a time)."""
    w = prng.normal(key, (k, n), device=device) * (2.0 / (k + n)) ** 0.5
    return w if dtype == torch.float32 else w.to(dtype)


def embed_init(key: torch.Tensor, v: int, d: int, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """N(0, 0.02^2) embeddings [v, d] from a JAX-compatible key, rounded
    to ``dtype``."""
    w = prng.normal(key, (v, d), device=device) * 0.02
    return w if dtype == torch.float32 else w.to(dtype)


def stack_init(key: torch.Tensor, l: int, k: int, n: int,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``vmap(dense_init)(split(key, l))``: layer i from ``split(key, l)[i]``,
    drawn one layer at a time into the preallocated [l, k, n] stack (on
    the ``meta`` device, the shape alone)."""
    out = torch.empty((l, k, n), dtype=dtype, device=device)
    if out.is_meta:
        return out
    for i, ki in enumerate(prng.split(key, l)):
        out[i] = dense_init(ki, k, n, dtype, device)
    return out


def expert_stack_init(key: torch.Tensor, l: int, e: int, k: int, n: int,
                      dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``vmap(vmap(dense_init))``: expert j of layer i from
    ``split(split(key, l)[i], e)[j]``, the reference's MoE ``estack``
    (`repro/models/transformer.py:103-108`), drawn one [k, n] matrix at a
    time into the preallocated [l, e, k, n] stack (a whole-stack draw would
    hold its bits and its floats at once; on the ``meta`` device, the
    shape alone)."""
    out = torch.empty((l, e, k, n), dtype=dtype, device=device)
    if out.is_meta:
        return out
    for i, ki in enumerate(prng.split(key, l)):
        for j, kj in enumerate(prng.split(ki, e)):
            out[i, j] = dense_init(kj, k, n, dtype, device)
    return out
