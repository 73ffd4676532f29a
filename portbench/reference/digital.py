"""The digital stages of a step recomputed in f64 from the inputs the stage
received, and the gap of the stage's own output to that recomputation.

The crossbar's 8-bit ADC turns any rounding difference upstream into a
whole code a few projections later, so a comparison of the network's
outputs cannot tell digital precisions apart (f32 from TF32, bf16 from
e4m3). A stage compared on its own inputs can: its gap is the rounding of
the precision it computed in. Each function returns the squared norms
(of the difference, of the recomputation) as 0-d f64 tensors on the
stage's device, accumulated in blocks of at most ``BLOCK`` elements, so
that a check neither synchronises nor holds a second copy of a large
operand in f64."""

from __future__ import annotations

import torch

BLOCK = 1 << 24          # f64 elements held at once by a recomputation


def _acc(dev):
    z = torch.zeros((), dtype=torch.float64, device=dev)
    return z, z.clone()


def _add(acc, out, ref):
    d = out.to(torch.float64) - ref
    acc[0].add_((d * d).sum())
    acc[1].add_((ref * ref).sum())


def rmsnorm(x, scale, eps: float, out):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis."""
    x2 = x.reshape(-1, x.shape[-1])
    o2 = out.reshape(-1, x.shape[-1])
    s = scale.to(torch.float64)
    acc = list(_acc(x.device))
    rows = max(1, BLOCK // x2.shape[1])
    for r0 in range(0, x2.shape[0], rows):
        xb = x2[r0:r0 + rows].to(torch.float64)
        ref = xb * torch.rsqrt((xb * xb).mean(-1, keepdim=True) + eps) * s
        _add(acc, o2[r0:r0 + rows], ref)
    return acc


def attention(q, k, v, out, q_offset: int = 0, kv_len=None):
    """Softmax attention of q [B, Sq, Hq, D] over k, v [B, Skv, Hkv, D]
    (grouped heads): causal at absolute query positions ``q_offset + i``,
    or, with ``kv_len`` [B], over each row's first ``kv_len`` keys."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    acc = list(_acc(q.device))
    heads = max(1, min(hkv, BLOCK // max(1, g * sq * skv)))
    kpos = torch.arange(skv, device=q.device)
    qpos = q_offset + torch.arange(sq, device=q.device)
    for bi in range(b):
        if kv_len is None:
            mask = kpos[None, :] <= qpos[:, None]                 # [Sq, Skv]
        else:
            mask = (kpos < kv_len[bi])[None, :].expand(sq, skv)
        for h0 in range(0, hkv, heads):
            h1 = min(hkv, h0 + heads)
            qb = q[bi, :, h0 * g:h1 * g].to(torch.float64)
            qb = qb.reshape(sq, h1 - h0, g, d).permute(1, 2, 0, 3)
            kb = k[bi, :, h0:h1].to(torch.float64).permute(1, 2, 0)
            vb = v[bi, :, h0:h1].to(torch.float64).permute(1, 0, 2)
            s = (qb @ kb[:, None]) * scale                  # [h, g, Sq, Skv]
            s = s.masked_fill(~mask, float("-inf"))
            p = torch.softmax(s, dim=-1)
            del s
            o = p @ vb[:, None]                             # [h, g, Sq, D]
            del p
            o = o.permute(2, 0, 1, 3).reshape(sq, (h1 - h0) * g, d)
            _add(acc, out[bi, :, h0 * g:h1 * g], o)
    return acc


def product(a, w, out):
    """``a [..., K] @ w [K, N]``, in blocks of columns."""
    a2 = a.reshape(-1, a.shape[-1]).to(torch.float64)
    o2 = out.reshape(-1, w.shape[-1])
    acc = list(_acc(a.device))
    cols = max(1, BLOCK // w.shape[0])
    for c0 in range(0, w.shape[-1], cols):
        ref = a2 @ w[:, c0:c0 + cols].to(torch.float64)
        _add(acc, o2[:, c0:c0 + cols], ref)
    return acc


def ste_backward(g, x, w, dx, dw):
    """The straight-through backward of ``y = x @ w``: ``dx = g w^T`` and
    ``dw = x^T g``, for one matrix (x [..., K], w [K, N]) or a stack (x
    [E, C, K], w [E, K, N]); (dx pair, dw pair)."""
    if w.dim() == 2:
        gx = g.reshape(-1, g.shape[-1])
        xx = x.reshape(-1, x.shape[-1])
        return (product(gx, w.T, dx.reshape(-1, x.shape[-1])),
                product(xx.T, gx, dw))
    ax, aw = list(_acc(x.device)), list(_acc(x.device))
    e, c, k = x.shape
    n = w.shape[-1]
    per = max(1, BLOCK // max(c * k + k * n + c * n, 1))
    for e0 in range(0, e, per):
        sl = slice(e0, e0 + per)
        gb = g[sl].to(torch.float64)
        _add(ax, dx[sl], gb @ w[sl].to(torch.float64).transpose(1, 2))
        _add(aw, dw[sl], x[sl].to(torch.float64).transpose(1, 2) @ gb)
    return ax, aw
