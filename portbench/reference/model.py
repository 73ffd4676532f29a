"""The transformer of the benchmark's configurations, written plainly:
pre-norm blocks of RMSNorm, rotary grouped-query attention with a full
softmax, and a SwiGLU feed-forward network or a top-k mixture of SwiGLU
experts with capacity-bucketed dispatch and the Switch load-balancing
loss; a final RMSNorm and an untied output projection.

Every projection is a crossbar (`aimc`): in training it programs its
weight on every call under the call's key and backpropagates straight
through; in serving it applies codes programmed once, noise off. The
router and the output projection are digital f32 matrix products.

`Precision` says how a step rounds: activations to the configuration's
compute dtype; for the training control one step below it, every
digital product (attention, the router, the output projection, the
straight-through backward) on e4m3 operands, as an fp8 GEMM takes them.
`train_step` is one optimizer step of AdamW over f32-accumulated
microbatch gradients.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import aimc, prng

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class Model:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class Precision:
    """How a step rounds: ``act`` the activations' dtype; ``fp8``: each
    operand of a digital product is rounded to e4m3 first, per tensor
    scaled to its max-abs (the training control, one step below bf16)."""

    act: torch.dtype = torch.bfloat16
    fp8: bool = False

    def a(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.act)

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a digital product."""
        return _e4m3(x) if self.fp8 else x


class _RoundE4M3(torch.autograd.Function):
    """Round to e4m3 by a per-tensor scale; gradients pass straight (and
    are rounded the same way on their way back)."""

    @staticmethod
    def forward(ctx, x):
        return aimc.e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return aimc.e4m3(g)


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    return _RoundE4M3.apply(x)


def rmsnorm(x, scale, eps):
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(
        x.dtype)


def rope(x, positions, theta):
    """x [B, S, H, D], positions [B, S]: rotate the two halves."""
    half = x.shape[-1] // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def attention(q, k, v, q_block: int = 1024, fp8: bool = False):
    """Causal softmax attention in f32, GQA: q [B, S, Hq, D], k/v [B, S,
    Hkv, D] -> [B, S, Hq, D] in q's dtype, ``q_block`` query rows at a
    time; ``fp8`` takes both products on e4m3 operands."""
    dtype = q.dtype
    op = _e4m3 if fp8 else (lambda t: t)
    q, k, v = op(q), op(k), op(v)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    kf = k.to(torch.float32).permute(0, 2, 3, 1)[:, :, None]   # B,Hkv,1,D,S
    vf = v.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]   # B,Hkv,1,S,D
    scale = 1.0 / (d ** 0.5)
    outs = []
    for q0 in range(0, s, q_block):
        q1 = min(s, q0 + q_block)
        qb = q[:, q0:q1].to(torch.float32).reshape(b, q1 - q0, hkv, g, d)
        qb = qb.permute(0, 2, 3, 1, 4)                     # B,Hkv,G,Q,D
        sc = (qb @ kf) * scale                              # B,Hkv,G,Q,S
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        mask = torch.arange(s, device=q.device)[None, :] <= qpos
        sc = torch.where(mask, sc, NEG)
        p = op(torch.softmax(sc, dim=-1))
        o = p @ vf                                          # B,Hkv,G,Q,D
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, q1 - q0, hq, d))
    return torch.cat(outs, dim=1).to(dtype)


class Projections:
    """How a block's projections run: in training the straight-through
    crossbar over raw weights, under keys; in serving the programmed
    codes (``states``: name -> (codes [L, KB, M, Np], scales, n))."""

    def __init__(self, xb: aimc.Crossbar, prec: Precision, states=None):
        self.xb, self.prec, self.states = xb, prec, states

    def linear(self, x, w, key, name=None, layer=None):
        if self.states is not None:
            codes, s_w, n = self.states[name]
            lead = x.shape[:-1]
            y = aimc.mvm(x.reshape(-1, x.shape[-1]), codes[layer],
                         s_w[layer], n, self.xb)
            return self.prec.a(y.reshape(*lead, n))
        return self.prec.a(aimc.ste(x, w.to(torch.float32), key, self.xb,
                                    self.prec.fp8))

    def experts(self, x, w, keys):
        return self.prec.a(aimc.ste_experts(
            x, w.to(torch.float32), keys, self.xb, self.prec.fp8))


def _keys(key, n):
    return [None] * n if key is None else list(prng.split(key, n))


def moe(x, blk, m: Model, proj: Projections, key):
    """x [T, d] -> ([T, d], aux): route in f32, keep each expert's first
    ``capacity`` assignments in token order, run the experts on their
    buffers, combine with the renormalised gate values."""
    t, d = x.shape
    e, k = m.n_experts, m.top_k
    router = proj.prec.op(blk["router"].to(torch.float32))
    probs = torch.softmax(proj.prec.op(x.to(torch.float32)) @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    vals = vals / vals.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(idx, e).to(torch.float32)
    aux = e * (probs.mean(dim=0) * onehot.sum(dim=1).mean(dim=0)).sum()
    cap = max(1, int(t * k / e * m.capacity_factor))
    flat = idx.reshape(-1)
    rank = (torch.cumsum(torch.nn.functional.one_hot(flat, e), dim=0)
            .gather(1, flat[:, None])[:, 0] - 1)
    keep = rank < cap
    slot = torch.where(keep, flat * cap + rank, torch.full_like(rank, e * cap))
    xd = proj.prec.a(x)
    buf = xd.new_zeros((e * cap + 1, d))
    tok = torch.arange(t * k, device=x.device) // k
    buf = buf.index_put((slot,), xd[tok])
    xe = buf[:e * cap].reshape(e, cap, d)
    if key is None:
        kg = ku = kd = None
    else:
        ks = prng.split(key, e * 3).reshape(e, 3, 2)
        kg, ku, kd = ks[:, 0], ks[:, 1], ks[:, 2]
    g = proj.experts(xe, blk["we_gate"], kg)
    u = proj.experts(xe, blk["we_up"], ku)
    ye = proj.experts(proj.prec.a(torch.nn.functional.silu(g) * u),
                      blk["we_down"], kd)
    ye = proj.prec.a(ye)
    rows = torch.cat([ye.reshape(e * cap, d), ye.new_zeros((1, d))], dim=0)
    y = torch.einsum("tk,tkd->td", vals.to(ye.dtype),
                     rows[slot].reshape(t, k, d))
    return proj.prec.a(y), aux


def block(h, blk, m: Model, proj: Projections, key, positions, layer):
    b, s, _ = h.shape
    ks = _keys(key, 6)
    x = rmsnorm(h, blk["ln1"], m.norm_eps)
    q = proj.linear(x, blk.get("wq"), ks[0], "wq", layer)
    kk = proj.linear(x, blk.get("wk"), ks[1], "wk", layer)
    v = proj.linear(x, blk.get("wv"), ks[2], "wv", layer)
    q = rope(q.reshape(b, s, m.n_heads, m.head_dim), positions, m.rope_theta)
    kk = rope(kk.reshape(b, s, m.n_kv_heads, m.head_dim), positions,
              m.rope_theta)
    att = proj.prec.a(attention(q, kk, v.reshape(b, s, m.n_kv_heads,
                                                 m.head_dim),
                                fp8=proj.prec.fp8))
    h = h + proj.linear(att.reshape(b, s, -1), blk.get("wo"), ks[3], "wo",
                        layer)
    x2 = rmsnorm(h, blk["ln2"], m.norm_eps)
    if m.n_experts:
        y, aux = moe(x2.reshape(b * s, -1), blk, m, proj, ks[4])
        y = y.reshape(b, s, -1)
    else:
        k1, k2, k3 = _keys(ks[4], 3)
        g = proj.linear(x2, blk.get("w_gate"), k1, "w_gate", layer)
        u = proj.linear(x2, blk.get("w_up"), k2, "w_up", layer)
        y = proj.linear(proj.prec.a(torch.nn.functional.silu(g) * u),
                        blk.get("w_down"), k3, "w_down", layer)
        aux = 0.0
    return h + y, aux


def hidden(params, tokens, m: Model, proj: Projections, rng=None):
    """tokens [B, S] -> (final-normed hidden [B, S, D], aux summed over
    layers); layer i runs under ``split(rng, L)[i]``."""
    b, s = tokens.shape
    h = proj.prec.a(params["embed"][tokens])
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    keys = _keys(rng, m.n_layers)
    aux = 0.0
    for i in range(m.n_layers):
        blk = {n: v[i] for n, v in params["blocks"].items()}
        h, a = block(h, blk, m, proj, keys[i], positions, i)
        aux = aux + a
    return rmsnorm(h, params["final_norm"], m.norm_eps), aux


def logits(params, h, proj: Projections):
    return proj.prec.op(h.to(torch.float32)) @ proj.prec.op(
        params["unembed"].to(torch.float32))


def loss_of(params, batch, m: Model, proj: Projections, key,
            chunk: int = 512):
    """Mean next-token cross entropy (labels < 0 masked), plus 0.01 times
    the aux loss in the returned objective: (objective, loss)."""
    h, aux = hidden(params, batch["tokens"], m, proj, key)
    labels = batch["labels"]
    c = min(chunk, h.shape[1])
    total, count = 0.0, 0.0
    for i in range(h.shape[1] // c):
        hx = h[:, i * c:(i + 1) * c]
        lx = labels[:, i * c:(i + 1) * c]
        lg = logits(params, hx, proj)
        gold = lg.gather(-1, lx.clamp_min(0).long()[..., None])[..., 0]
        mask = (lx >= 0).to(torch.float32)
        total = total + ((torch.logsumexp(lg, -1) - gold) * mask).sum()
        count = count + mask.sum()
    loss = total / torch.clamp_min(torch.as_tensor(count), 1.0)
    return loss + 0.01 * aux, loss


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params):
    return {"step": 0,
            "mu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}}


def adamw_update(grads, state, params, opt: AdamW):
    """Clip by the global norm, then decoupled AdamW in f32 (weight decay
    on matrices only); parameters keep their dtype."""
    norm = torch.sqrt(torch.stack([(g.to(torch.float32) ** 2).sum()
                                   for g in grads.values()]).sum())
    scale = torch.clamp_max(opt.grad_clip / torch.clamp_min(norm, 1e-9), 1.0)
    step = state["step"] + 1
    bc1 = 1 - opt.b1 ** step
    bc2 = 1 - opt.b2 ** step
    new_p, mu, nu = {}, {}, {}
    for n, p in params.items():
        g = grads[n].to(torch.float32) * scale
        mu[n] = opt.b1 * state["mu"][n] + (1 - opt.b1) * g
        nu[n] = opt.b2 * state["nu"][n] + (1 - opt.b2) * g * g
        upd = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + opt.eps)
        p32 = p.to(torch.float32)
        if p.dim() >= 2:
            upd = upd + opt.weight_decay * p32
        new_p[n] = (p32 - opt.lr * upd).to(p.dtype)
    return new_p, {"step": step, "mu": mu, "nu": nu}


def flatten(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = v
    return out


def unflatten(flat):
    out = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def train_step(flat, state, batch, key, m: Model, proj: Projections,
               microbatch: int, opt: AdamW):
    """One step: microbatch i of the batch's rows under ``fold_in(key,
    i)``, gradients accumulated in f32 as ``acc + g / n``, then AdamW.
    ``flat`` maps leaf names to parameters. Returns (params, state,
    loss)."""
    rows = batch["tokens"].shape[0]
    n_micro = max(1, rows // microbatch)
    mb = rows // n_micro
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in flat.items()}
    loss_acc = 0.0
    for i in range(n_micro):
        live = {n: p.detach().requires_grad_(True) for n, p in flat.items()}
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        obj, loss = loss_of(unflatten(live), part, m, proj,
                            prng.fold_in(key, i))
        names = list(live)
        grads = torch.autograd.grad(obj, [live[n] for n in names],
                                    allow_unused=True)
        for n, g in zip(names, grads):
            if g is not None:
                acc[n].add_(g.to(torch.float32) / n_micro)
        loss_acc = loss_acc + float(loss.detach()) / n_micro
        del live, grads, obj, loss
    new, state = adamw_update(acc, state, flat, opt)
    return new, state, loss_acc


def serve_logits(states, digital, tokens, m: Model, xb: aimc.Crossbar,
                 prec: Precision, block_rows: int = 1024):
    """Logits [S, V] in f32 at every position of one sequence ``tokens``
    [S] through programmed ``states`` (name -> (codes, scales, n)) and
    the digital leaves (embed, norms, unembed)."""
    proj = Projections(xb, prec, states)
    params = dict(digital)
    params["blocks"] = {n: v for n, v in digital["blocks"].items()}
    h, _ = hidden(params, tokens[None], m, proj)
    out = []
    for r0 in range(0, h.shape[1], block_rows):
        out.append(logits(params, h[0, r0:r0 + block_rows], proj))
    return torch.cat(out)
