"""Shared model layers, AIMC-capable (PyTorch port of
`repro/models/layers.py`).

Every stationary-weight projection routes through `linear()`, which runs
either digitally (a plain matmul, the paper's CPU+SIMD baseline) or, when
the weight arrives as a programmed `AimcLinearState` (installed by
`core.program.AimcProgram.install`), apply-only on the crossbar kernel.
The reference's third way, on-the-fly programming with a straight-through
backward (noise-aware training), waits for the training slice.

Attention is plain tensor ops following the reference's algorithm: a
chunked online softmax for prefill (causal, with a query offset for
prefill legs; the sliding window serves only the reference's training
`forward` of rglru and waits for that slice) and a masked softmax against
the KV cache for decode. `recurrent_prefill` scans a model's decode step
over a prompt (xlstm, rglru). Activation sharding hints (`shard_act`) have
no counterpart on one card.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng
from repro_torch.core.aimc import (AimcConfig, AimcLinearState, aimc_apply,
                                   aimc_apply_experts, aimc_apply_stacked)
from repro_torch.kernels.ref import EPILOGUE_FNS


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


def linear(x, w, exe: Execution, bias=None, activation: str = "none"):
    """The AIMC-or-digital projection. x: [..., K]; w: [K, N] or a
    programmed `AimcLinearState`, whose epilogue runs inside the kernel
    (serving runs noise-off: no read-noise generator is passed). An
    `[E, ...]` programmed expert stack takes x [E, C, K] (expert e on x[e],
    the reference's `vmap` of `linear`) and runs as one launch; a raw
    [E, K, N] stack multiplies batched."""
    if isinstance(w, AimcLinearState):
        if w.stack_shape:
            if bias is not None or activation != "none":
                raise ValueError("expert stacks carry no epilogue")
            return aimc_apply_experts(w, x, exe.aimc).to(exe.cdtype)
        return aimc_apply(w, x, exe.aimc, bias=bias,
                          activation=activation).to(exe.cdtype)
    if exe.mode == "aimc" and not exe.programmed:
        raise NotImplementedError(
            "on-the-fly AIMC programming (aimc_linear_ste, noise-aware "
            "training) is not ported yet; install an AimcProgram "
            "(programmed=True) or run digital — see ROADMAP.md")
    y = x.to(exe.cdtype) @ as_weight(w, exe.cdtype)
    if bias is not None:
        y = y + bias.to(exe.cdtype)
    return EPILOGUE_FNS[activation](y)


def linear_stack(x, ws: AimcLinearState, exe: Execution, biases=None,
                 activations="none"):
    """Gate-fused multi-MVM: a `[G, ...]` programmed stack (built by a
    model's `fuse_gate_stacks`) sharing one input runs as ONE kernel launch
    (K3) -> tuple of G outputs."""
    y = aimc_apply_stacked(ws, x, exe.aimc, biases=biases,
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


def _attn_chunk(q, k, v, q_pos, kv_pos, carry, scale, causal, kv_valid):
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
    s = torch.where(mask[None, None, None], s, NEG_INF)
    s = s.reshape(b, hq, qc, -1)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a fully-masked chunk would give exp(NEG_INF - NEG_INF) = 1: re-mask
    p = torch.exp(s - m_new[..., None])
    p = torch.where(mask.reshape(1, 1, qc, -1), p, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.reshape(b, hkv, g * qc, -1),
                      v.to(torch.float32)).reshape(b, hq, qc, d)
    return m_new, l_new, acc * corr[..., None] + pv


def flash_attention(q, k, v, *, causal=True, q_offset: int = 0,
                    q_chunk=1024, kv_chunk=1024):
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] -> [B, Sq, Hq, D], a
    chunked online softmax (memory O(qc*kc)), GQA-aware. Query row i sits
    at absolute position ``q_offset + i`` (a prefill leg attends over the
    earlier legs' keys). The kv chunks reduce in the same order whatever
    the query chunking, so a leg's rows equal dense prefill's."""
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
    outs = []
    for qi in range(sq // qc):
        q_blk = qh[:, :, qi * qc:(qi + 1) * qc]
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        carry = (torch.full((b, hq, qc), NEG_INF, device=dev),
                 torch.zeros((b, hq, qc), device=dev),
                 torch.zeros((b, hq, qc, d), device=dev))
        for j in range(skv // kc):
            kv_pos = j * kc + torch.arange(kc, device=dev)
            carry = _attn_chunk(q_blk, kh[:, :, j * kc:(j + 1) * kc],
                                vh[:, :, j * kc:(j + 1) * kc], q_pos, kv_pos,
                                carry, scale, causal, skv0)
        _, l, acc = carry
        outs.append((acc / l.clamp_min(1e-20)[..., None]).to(q.dtype))
    o = torch.cat(outs, dim=2)                            # [B, Hq, Sq, D]
    return o.transpose(1, 2)[:, :sq0]


def decode_attention(q, k_cache, v_cache, kv_len,
                     batch_invariant: bool = False):
    """Single-token attention against a KV cache.
    q: [B, 1, Hq, D]; caches: [B, Skv, Hkv, D]; kv_len: [B] valid lengths.
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
    mask = torch.arange(skv, device=q.device)[None] < kv_len[:, None]
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


def swiglu(x, w_gate, w_up, w_down, exe: Execution):
    g = linear(x, w_gate, exe)
    u = linear(x, w_up, exe)
    return linear(torch.nn.functional.silu(g) * u, w_down, exe)


def _f32_only(dtype):
    if dtype != torch.float32:
        raise NotImplementedError(
            f"weight init draws f32 normals on JAX's keys; {dtype} is not "
            f"ported yet")


def dense_init(key: torch.Tensor, k: int, n: int, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """N(0, 2/(k+n)) weights [k, n] from a JAX-compatible key
    (`core.prng`), the reference's draw and f32 scaling."""
    _f32_only(dtype)
    return prng.normal(key, (k, n), device=device) * (2.0 / (k + n)) ** 0.5


def embed_init(key: torch.Tensor, v: int, d: int, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """N(0, 0.02^2) embeddings [v, d] from a JAX-compatible key."""
    _f32_only(dtype)
    return prng.normal(key, (v, d), device=device) * 0.02


def stack_init(key: torch.Tensor, l: int, k: int, n: int,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``vmap(dense_init)(split(key, l))``: layer i from ``split(key, l)[i]``,
    drawn one layer at a time into the preallocated [l, k, n] stack."""
    out = torch.empty((l, k, n), dtype=dtype, device=device)
    for i, ki in enumerate(prng.split(key, l)):
        out[i] = dense_init(ki, k, n, dtype, device)
    return out


def expert_stack_init(key: torch.Tensor, l: int, e: int, k: int, n: int,
                      dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``vmap(vmap(dense_init))``: expert j of layer i from
    ``split(split(key, l)[i], e)[j]``, the reference's MoE ``estack``
    (`repro/models/transformer.py:103-108`), drawn one [k, n] matrix at a
    time into the preallocated [l, e, k, n] stack (a whole-stack draw would
    hold its bits and its floats at once)."""
    out = torch.empty((l, e, k, n), dtype=dtype, device=device)
    for i, ki in enumerate(prng.split(key, l)):
        for j, kj in enumerate(prng.split(ki, e)):
            out[i, j] = dense_init(kj, k, n, dtype, device)
    return out
