"""The paper's exploration networks (§VII-IX) in PyTorch; port of
`repro/models/paper_nets.py`.

MLP (1024, 1024) + ReLU, the PTB character LSTM and CNN-F/M/S, each in
digital fp32 and on programmed AIMC crossbars through `core.aimclib`:
  * MLP: both layer matrices mapped; the relus ride kernel K2's epilogue.
  * LSTM: the four gate matrices side by side, so ONE queue + process
    computes every gate pre-activation (§VIII-D); or, ``fuse_gates=True``,
    a `[4, ...]` stack on kernel K3 with the per-gate `LSTM_GATE_ACTS`
    epilogue. The softmax head is a mapped matrix too.
  * CNN: conv kernels flattened into crossbar columns (im2col), patches
    queued per output position, relu in K2's epilogue; LRN, pooling and the
    dense head stay digital (`torch.matmul`, as the reference leaves them
    to XLA outside any kernel).

Weights are drawn with the reference's keys (`core.prng`), so the same key
gives the same weights as the JAX package, bit for bit. The
``*_init`` functions place them on ``device``, the card unless the caller
asks for the CPU; every forward runs where its inputs lie.

The ``*_forward_multicore`` variants execute the paper's multi-core
mappings (MLP cases 3/4, LSTM cases 3/4, the pipelined CNN) through
`core.schedule.CoreSchedule`: column-split crossbar shards per core, one K2
launch per shard, with per-core CM_*/comm ledgers; noise off they equal
the single-core programmed path bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core import schedule as schedule_lib
from repro_torch.core.aimc import AimcConfig
from repro_torch.core.aimclib import AimcContext

# ---------------------------------------------------------------------------
# MLP (paper Fig. 6)
# ---------------------------------------------------------------------------


def mlp_init(key, n: int = 1024, device="cuda"):
    k1, k2 = prng.split(key)
    s = (2.0 / n) ** 0.5
    return {"w1": prng.normal(k1, (n, n), device=device) * s,
            "w2": prng.normal(k2, (n, n), device=device) * s}


def mlp_forward_digital(params, x):
    h = torch.relu(x @ params["w1"])
    return torch.relu(h @ params["w2"])


def mlp_forward_aimc(params, x, cfg: AimcConfig, key=None, ctx=None):
    """Pass a previously returned `ctx` to run program-once/apply-many:
    CM_INITIALIZE happens on the first call only (paper §IV-B)."""
    if ctx is None:
        ctx = AimcContext(cfg, key)
        ctx.map_matrix("fc1", params["w1"])
        ctx.map_matrix("fc2", params["w2"])
    h = ctx.linear("fc1", x, activation="relu")
    return ctx.linear("fc2", h, activation="relu"), ctx


def mlp_program(params, cfg: AimcConfig, key=None):
    """Program the two MLP matrices (entries fc1/fc2): the registry both the
    single-core ctx path and the multi-core schedules execute from."""
    ctx = AimcContext(cfg, key)
    ctx.map_matrix("fc1", params["w1"])
    ctx.map_matrix("fc2", params["w2"])
    return ctx.program()


def mlp_forward_multicore(params, x, cfg: AimcConfig, cores: int = 1,
                          key=None, schedule=None):
    """Paper Fig. 6 multi-core mappings through `core.schedule`: cores=1 ->
    case 1, cores=2 -> case 3 (layer per core), cores=4 -> case 4 (each
    layer column-split over two cores). Reuse the returned schedule across
    calls for program-once semantics."""
    if schedule is None:
        schedule = schedule_lib.mlp_schedule(mlp_program(params, cfg, key),
                                             cores)
    h = torch.relu(schedule.apply("fc1", x))
    return torch.relu(schedule.apply("fc2", h)), schedule


# ---------------------------------------------------------------------------
# LSTM (paper Fig. 9): one cell layer + dense softmax head
# ---------------------------------------------------------------------------


def lstm_init(key, nh: int, x_dim: int = 50, y_dim: int = 50,
              device="cuda"):
    ks = prng.split(key, 5)
    kin = nh + x_dim
    s = (1.0 / kin) ** 0.5
    out = {name: prng.normal(ks[i], (kin, nh), device=device) * s
           for i, name in enumerate(("w_f", "w_i", "w_g", "w_o"))}
    out["w_y"] = (prng.normal(ks[4], (nh, y_dim), device=device)
                  * (1.0 / nh) ** 0.5)
    return out


def _lstm_cell_math(gates, c_prev, nh):
    f = torch.sigmoid(gates[..., :nh])
    i = torch.sigmoid(gates[..., nh:2 * nh])
    g = torch.tanh(gates[..., 2 * nh:3 * nh])
    o = torch.sigmoid(gates[..., 3 * nh:])
    c = f * c_prev + i * g
    return o * torch.tanh(c), c


# Per-gate epilogues of the f/i/g/o stack, applied inside kernel K3
LSTM_GATE_ACTS = ("sigmoid", "sigmoid", "tanh", "sigmoid")


def _lstm_cell_from_activated(f, i, g, o, c_prev):
    """Cell update on gate values the fused epilogue already activated."""
    c = f * c_prev + i * g
    return o * torch.tanh(c), c


def lstm_forward_digital(params, xs, nh: int):
    """xs: [T, B, x_dim] -> softmax outputs [T, B, y]."""
    w_cell = torch.cat([params["w_f"], params["w_i"], params["w_g"],
                        params["w_o"]], dim=1)
    b = xs.shape[1]
    h = torch.zeros((b, nh), device=xs.device)
    c = torch.zeros((b, nh), device=xs.device)
    ys = []
    for x_t in xs:
        gates = torch.cat([h, x_t], dim=-1) @ w_cell
        h, c = _lstm_cell_math(gates, c, nh)
        ys.append(torch.softmax(h @ params["w_y"], dim=-1))
    return torch.stack(ys)


def lstm_forward_aimc(params, xs, nh: int, cfg: AimcConfig, key=None,
                      ctx=None, fuse_gates: bool | None = None):
    """The §VIII-D mapping: gate matrices side by side -> one CM_PROCESS
    (kernel K2) per step; ``fuse_gates=True`` maps them as a `[4, ...]`
    stack run by kernel K3 with the per-gate epilogue, bit-equal with noise
    off. Reuse a returned `ctx` to keep the gates stationary; a reused ctx
    fixes the layout, and a contradicting ``fuse_gates`` raises."""
    if ctx is None:
        ctx = AimcContext(cfg, key)
        gates_w = [params["w_f"], params["w_i"], params["w_g"], params["w_o"]]
        if fuse_gates:
            ctx.map_gate_stack("cell", gates_w)
        else:
            ctx.map_gates("cell", gates_w)
        ctx.map_matrix("dense", params["w_y"])
    fused = ctx._state("cell").stack_shape != ()
    if fuse_gates is not None and fuse_gates != fused:
        raise ValueError(
            f"ctx maps 'cell' {'stacked' if fused else 'side-by-side'} but "
            f"fuse_gates={fuse_gates} was requested; map a fresh ctx")
    b = xs.shape[1]
    h = torch.zeros((b, nh), device=xs.device)
    c = torch.zeros((b, nh), device=xs.device)
    ys = []
    for x_t in xs:               # python loop: ctx counts CM_* per step
        hx = torch.cat([h, x_t], dim=-1)
        if fused:
            f, i, g, o = ctx.linear_stack("cell", hx,
                                          activations=LSTM_GATE_ACTS)
            h, c = _lstm_cell_from_activated(f, i, g, o, c)
        else:
            h, c = _lstm_cell_math(ctx.linear("cell", hx), c, nh)
        ys.append(torch.softmax(ctx.linear("dense", h), dim=-1))
    return torch.stack(ys), ctx


def lstm_program(params, cfg: AimcConfig, key=None):
    """Program the §VIII-D mapping (gates side by side + dense head)."""
    ctx = AimcContext(cfg, key)
    ctx.map_gates("cell", [params["w_f"], params["w_i"], params["w_g"],
                           params["w_o"]])
    ctx.map_matrix("dense", params["w_y"])
    return ctx.program()


def lstm_forward_multicore(params, xs, nh: int, cfg: AimcConfig,
                           cores: int = 1, key=None, schedule=None):
    """Paper Table II-B multi-core mappings through `core.schedule`:
    cores=1 -> case 1/2, cores=2 -> case 3 (cell core + dense core),
    cores=5 -> case 4 (cell gate-sliced over four cores + a dense core).
    Gate slices reassemble to the full pre-activation vector, so the cell
    math and the whole sequence output match single-core exactly."""
    if schedule is None:
        schedule = schedule_lib.lstm_schedule(
            lstm_program(params, cfg, key), cores, nh,
            x_dim=xs.shape[-1], y_dim=params["w_y"].shape[1])
    b = xs.shape[1]
    h = torch.zeros((b, nh), device=xs.device)
    c = torch.zeros((b, nh), device=xs.device)
    ys = []
    for x_t in xs:
        gates = schedule.apply("cell", torch.cat([h, x_t], dim=-1))
        h, c = _lstm_cell_math(gates, c, nh)
        ys.append(torch.softmax(schedule.apply("dense", h), dim=-1))
    return torch.stack(ys), schedule


# ---------------------------------------------------------------------------
# CNN-F/M/S (paper Fig. 12): conv layers on crossbars via im2col
# ---------------------------------------------------------------------------

CNN_SPECS = {
    # (cin, k, cout, stride, pad, lrn, pool)
    "F": [(3, 11, 64, 4, 0, True, 2), (64, 5, 256, 1, 2, True, 2),
          (256, 3, 256, 1, 1, False, 1), (256, 3, 256, 1, 1, False, 1),
          (256, 3, 256, 1, 1, False, 2)],
    "M": [(3, 7, 96, 2, 0, True, 2), (96, 5, 256, 1, 2, True, 2),
          (256, 3, 512, 1, 1, False, 1), (512, 3, 512, 1, 1, False, 1),
          (512, 3, 512, 1, 1, False, 2)],
    "S": [(3, 7, 96, 2, 0, True, 3), (96, 5, 256, 1, 1, True, 2),
          (256, 3, 512, 1, 1, False, 1), (512, 3, 512, 1, 1, False, 1),
          (512, 3, 512, 1, 1, False, 3)],
}


def cnn_init(key, variant: str, img: int = 224, n_classes: int = 1000,
             device="cuda"):
    spec = CNN_SPECS[variant]
    params = {"convs": [], "dense": []}
    hw = img
    ks = prng.split(key, len(spec) + 3)
    for i, (cin, k, cout, stride, pad, _lrn, pool) in enumerate(spec):
        fan = k * k * cin
        params["convs"].append(
            prng.normal(ks[i], (k, k, cin, cout), device=device)
            * (2.0 / fan) ** 0.5)
        hw = (hw + 2 * pad - k) // stride + 1
        hw = hw // pool
    flat = hw * hw * spec[-1][2]
    dims = [flat, 4096, 4096, n_classes]
    for j in range(3):
        params["dense"].append(
            prng.normal(ks[len(spec) + j], (dims[j], dims[j + 1]),
                        device=device) * (2.0 / dims[j]) ** 0.5)
    return params


def _lrn(x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    sq = x * x
    pads = n // 2
    acc = sum(torch.roll(sq, s, dims=-1) for s in range(-pads, pads + 1))
    return x / (k + alpha * acc) ** beta


def _pool(x, p):
    if p == 1:
        return x
    b, h, w, c = x.shape
    h2, w2 = h // p * p, w // p * p
    x = x[:, :h2, :w2].reshape(b, h2 // p, p, w2 // p, p, c)
    return x.amax(dim=(2, 4))


def _im2col(x, k, stride, pad):
    """x: [B,H,W,C] -> patches [B, Ho*Wo, k*k*C] in (kh, kw, c) order."""
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    b, h, w, c = x.shape
    ho = (h - k) // stride + 1
    wo = (w - k) // stride + 1
    ar = torch.arange(k, device=x.device)
    idx_h = (torch.arange(ho, device=x.device) * stride)[:, None] + ar[None]
    idx_w = (torch.arange(wo, device=x.device) * stride)[:, None] + ar[None]
    patches = x[:, idx_h[:, None, :, None], idx_w[None, :, None, :], :]
    return patches.reshape(b, ho * wo, k * k * c), ho, wo


def _dense_head(params, x):
    """The digital dense head (paper §IX-A): relu, relu, softmax."""
    h = x.reshape(x.shape[0], -1)
    for j, w in enumerate(params["dense"]):
        h = h @ w
        h = torch.relu(h) if j < 2 else torch.softmax(h, dim=-1)
    return h


def cnn_forward(params, x, variant: str, cfg: AimcConfig | None = None,
                key=None, ctx=None):
    """x: [B, H, W, 3]. cfg=None -> digital; else conv layers on AIMC.
    Pass a returned `ctx` back in to skip re-programming the conv kernels."""
    spec = CNN_SPECS[variant]
    if cfg is not None and ctx is None:
        ctx = AimcContext(cfg, key)
    for i, (_cin, k, cout, stride, pad, lrn, pool) in enumerate(spec):
        patches, ho, wo = _im2col(x, k, stride, pad)
        b, npos, kdim = patches.shape
        wmat = params["convs"][i].reshape(kdim, cout)
        if ctx is not None:
            name = f"conv{i}"
            if name not in ctx:
                ctx.map_matrix(name, wmat)
            y = ctx.linear(name, patches.reshape(b * npos, kdim),
                           activation="relu")
            x = y.reshape(b, ho, wo, cout)
        else:
            y = patches.reshape(b * npos, kdim) @ wmat
            x = torch.relu(y.reshape(b, ho, wo, cout))
        if lrn:
            x = _lrn(x)
        x = _pool(x, pool)
    h = _dense_head(params, x)
    return (h, ctx) if ctx is not None else h


def cnn_program(params, variant: str, cfg: AimcConfig, key=None):
    """Program every conv kernel (im2col-flattened) as entries conv0..4."""
    ctx = AimcContext(cfg, key)
    for i, w in enumerate(params["convs"]):
        ctx.map_matrix(f"conv{i}", w.reshape(-1, w.shape[-1]))
    return ctx.program()


def cnn_pipeline_stages(params, variant: str, cfg: AimcConfig, schedule):
    """Per-core stage callables of the §IX-A pipeline: stage i runs conv
    layer i on core i (im2col -> crossbar -> relu/lrn/pool); the final
    digital stage runs the dense head. Feed to `core.schedule.pipeline_run`
    to measure per-stage times, or chain them: values are identical either
    way (pipelining changes timing, not math)."""
    spec = CNN_SPECS[variant]

    def make(i, row):
        _cin, k, cout, stride, pad, lrn, pool = row

        def stage(x):
            patches, ho, wo = _im2col(x, k, stride, pad)
            b, npos, kdim = patches.shape
            y = schedule.apply(f"conv{i}", patches.reshape(b * npos, kdim))
            x2 = torch.relu(y.reshape(b, ho, wo, cout))
            if lrn:
                x2 = _lrn(x2)
            return _pool(x2, pool)

        return stage

    return ([make(i, row) for i, row in enumerate(spec)]
            + [lambda x: _dense_head(params, x)])


def cnn_forward_multicore(params, x, variant: str, cfg: AimcConfig,
                          key=None, schedule=None):
    """The pipelined CNN mapping executed through `core.schedule`: one conv
    layer per core, position-level pipelined in the timing model (the
    schedule's `pipelined_latency` law); dense head digital."""
    if schedule is None:
        schedule = schedule_lib.cnn_schedule(
            cnn_program(params, variant, cfg, key), CNN_SPECS[variant],
            img=x.shape[1])
    for stage in cnn_pipeline_stages(params, variant, cfg, schedule):
        x = stage(x)
    return x, schedule
