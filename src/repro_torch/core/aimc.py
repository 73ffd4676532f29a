"""The AIMC tile model: programming and inference (PyTorch port of
`repro/core/aimc.py`).

A dense weight matrix is *programmed* (CM_INITIALIZE) onto crossbar row
blocks (`program_linear`); activations then flow through the fused
DAC -> crossbar -> ADC pipeline (`aimc_apply` = CM_QUEUE/PROCESS/DEQUEUE),
which on a CUDA tensor is the hand-written kernel K2 and, for a gate stack
(`aimc_apply_stacked`), K3; an MoE expert stack (`aimc_apply_experts`,
the reference's `vmap` of `aimc_apply`) runs as one launch of K2's expert
entry, each expert with its own read seed. The DAC scale ``s_x`` stays a
device tensor: no projection waits on the host.

Column pieces (sharded serving and training): a state placed over a
mesh's ``model`` axis carries one `ColumnPiece` per model position,
columns ``[c0, c1)`` of its padded Np (`split_columns`). On the whole's
own device a piece is a view of the whole's codes and scales; only a
piece on another device is a contiguous copy. `aimc_apply`,
`aimc_apply_stacked` and `aimc_apply_experts` then compute the DAC scale
once from the whole x, launch one kernel per piece on its device (the
bias cut per piece; the kernel reads a view at the whole's row stride and
draws the whole's read noise for the piece's columns, ``col0 = c0`` and
``nc`` = the whole's Np) and concatenate the outputs in column order on
x's device. Column pieces are exact, noise on or off: the ADC, dequant,
bias and activation act per column and the row-block sum runs over k in
k order, so the result equals the whole launch bit for bit.

Noise-aware training: `aimc_linear_ste` (a `torch.autograd.Function`)
programs W on the fly with a fresh programming-noise draw and applies it
with per-call read noise; its backward is straight-through (y = x @ W).
`aimc_linear_ste_experts` is the same over an `[E, K, N]` expert stack
with a key per expert (the reference's `vmap` of the STE): one
expert-entry launch forward, batched matmuls backward. Under an ambient
mesh with a ``model`` axis (`compat.use_mesh`), each model position does
its own share: the STE programs the whole W under its key (so the
programming noise is the unsplit draw) and launches one K2 per column
piece where Np divides ``128 * M`` (`mesh_pieces`); its backward is the
whole ``g W^T``, ``x^T g`` on W's device, where the pieces' columns
live. The expert STE launches the expert entry once per position over its
``E / M`` experts, each with its own seeds. Keys are host values (`core/prng.py`), so a recompute under `torch.utils.checkpoint`
draws the same noise without touching any global generator.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import compat
from repro_torch.core import noise as noise_lib
from repro_torch.core import prng
from repro_torch.core.quant import QMAX, adc_step_lsb, sym_scale
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import stepstats


@dataclasses.dataclass(frozen=True)
class AimcConfig:
    """Static configuration of the simulated AIMC tile."""

    tile_rows: int = 512           # M word lines (crossbar inputs)
    tile_cols: int = 512           # N bit lines (crossbar outputs)
    adc_alpha: float = 1.0         # ADC full-scale factor (quant.adc_step_lsb)
    input_scale: float = 0.0       # 0.0 = dynamic (max-abs); >0 = fixed scale
    noise: noise_lib.NoiseModel = noise_lib.DISABLED
    # apply bias + activation inside the kernel's last row-block step
    # (False = the same math as separate ops after the kernel)
    fuse_epilogue: bool = True
    # read-noise generator inside the kernel: "counter" (kernels/cprng,
    # equal to the reference's bits) or "hw" (Philox on the card, held to
    # the noise moments; no CPU version, as the reference's oracle has none)
    noise_source: str = "counter"

    @property
    def adc_step(self) -> float:
        return adc_step_lsb(self.tile_rows, self.adc_alpha)


@dataclasses.dataclass(frozen=True)
class ColumnPiece:
    """Columns ``[c0, c1)`` of a programmed state's padded Np on one mesh
    position's device (``c1 - c0`` a multiple of 128, the kernels' column
    alignment): a view of the whole's codes on the whole's device, a
    contiguous copy elsewhere."""

    c0: int
    c1: int
    w_q: torch.Tensor   # int8 [..., KB, M, c1 - c0]
    s_w: torch.Tensor   # f32  [..., KB, c1 - c0]

    def __getitem__(self, i) -> "ColumnPiece":
        return ColumnPiece(self.c0, self.c1, self.w_q[i], self.s_w[i])

    def scaled(self, gain: float) -> "ColumnPiece":
        return ColumnPiece(self.c0, self.c1, self.w_q, self.s_w * gain)


@dataclasses.dataclass(frozen=True)
class AimcLinearState:
    """A programmed linear layer: int8 conductance codes + output scales.
    Leading dims of ``w_q``/``s_w`` are layer/gate stacks. ``pieces``
    (empty unless the state was placed over a mesh's model axis,
    `split_columns`) are its column pieces, which the apply functions
    launch in place of the whole."""

    w_q: torch.Tensor   # int8 [..., KB, M, Np]
    s_w: torch.Tensor   # f32  [..., KB, Np] (drift gain folded in)
    k: int              # logical in_features
    n: int              # logical out_features
    pieces: tuple = dataclasses.field(default=(), compare=False, repr=False)

    @property
    def stack_shape(self) -> tuple[int, ...]:
        return tuple(self.w_q.shape[:-3])

    @property
    def instances(self) -> int:
        out = 1
        for d in self.stack_shape:
            out *= d
        return out

    def with_gain(self, gain) -> "AimcLinearState":
        """Conductance drift as data: scale the output scales, keep the
        codes (and every shape) untouched."""
        return AimcLinearState(
            w_q=self.w_q, s_w=self.s_w * float(gain), k=self.k, n=self.n,
            pieces=tuple(p.scaled(float(gain)) for p in self.pieces))

    def __getitem__(self, i) -> "AimcLinearState":
        """The state of stack entry ``i`` (a layer of a layer stack)."""
        if not self.stack_shape:
            raise IndexError("a single programmed matrix has no stack dim")
        return AimcLinearState(w_q=self.w_q[i], s_w=self.s_w[i],
                               k=self.k, n=self.n,
                               pieces=tuple(p[i] for p in self.pieces))


def split_columns(state: AimcLinearState, bounds, devices
                  ) -> AimcLinearState:
    """``state`` carrying one `ColumnPiece` per ``(c0, c1)`` of ``bounds``
    (a cover of ``0..Np`` in order, each width a multiple of 128), piece j
    on ``devices[j]``. The whole ``w_q``/``s_w`` stay as they are (the
    program's own tensors, which the health probes, recalibration and the
    books read): a piece on their device is a view of its columns, so the
    codes are stored once; a piece on another device is a contiguous copy
    there."""
    np_ = state.w_q.shape[-1]
    edges = [c for b in bounds for c in b]
    if (not bounds or edges[0] != 0 or edges[-1] != np_
            or any(a != b for a, b in zip(edges[1:-1:2], edges[2::2]))):
        raise ValueError(f"column pieces {list(bounds)} are not an ordered "
                         f"cover of 0..{np_}")
    if any((c1 - c0) % 128 or c1 <= c0 for c0, c1 in bounds):
        raise ValueError(f"column pieces {list(bounds)} are not 128-aligned")
    def cols(t, c0, c1, dev):
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:    # the current card
            dev = torch.device("cuda", torch.cuda.current_device())
        view = t[..., c0:c1]
        return view if dev == t.device else view.to(dev).contiguous()
    pieces = tuple(ColumnPiece(c0, c1, cols(state.w_q, c0, c1, dev),
                               cols(state.s_w, c0, c1, dev))
                   for (c0, c1), dev in zip(bounds, devices))
    return dataclasses.replace(state, pieces=pieces)


def _model_devices(mesh, axis: str = "model") -> list:
    """The device of each block of ``axis``: the first position
    (row-major) whose ``axis`` index is j, for j in order."""
    first = {}
    for pos in mesh.positions():
        j = dict(zip(mesh.axis_names, pos))[axis]
        first.setdefault(j, mesh.device_at(pos))
    return [first[j] for j in range(mesh.shape[axis])]


def mesh_pieces(state: AimcLinearState, mesh=None) -> AimcLinearState:
    """``state`` split into one column piece per position of the ambient
    mesh's ``model`` axis (`compat.current_mesh`, or ``mesh``) where its Np
    divides ``128 * M``; whole otherwise (no mesh, no ``model`` axis, M = 1
    or a width that does not divide). The rule `launch.shardings`'
    `place_aimc_state` applies to served states."""
    if mesh is None:
        mesh = compat.current_mesh()
    if mesh is None or "model" not in mesh.axis_names or state.pieces:
        return state
    m = mesh.shape["model"]
    np_ = state.w_q.shape[-1]
    if m == 1 or np_ % (128 * m):
        return state
    w = np_ // m
    return split_columns(state, [(j * w, (j + 1) * w) for j in range(m)],
                         _model_devices(mesh))


def _over_pieces(state: AimcLinearState, x: torch.Tensor, s_x, launch):
    """Run ``launch(piece, x, s_x, nc)`` on each column piece's device (x
    and the one DAC scale copied there; ``nc`` the whole's Np, for the
    noise counters) and concatenate the outputs in column order on x's
    device."""
    nc = state.w_q.shape[-1]
    outs = []
    for p in state.pieces:
        dev = p.w_q.device
        outs.append(launch(p, x.to(dev), s_x.to(dev), nc).to(x.device))
    y = torch.cat(outs, dim=-1)
    c = stepstats.counting(y)
    if c is not None:                    # the pieces' join over ``model``
        c.collective("all-gather", y.numel() * y.element_size())
    return y


def _pad_to(v: int, m: int) -> int:
    return (v + m - 1) // m * m


# float elements of one programming group's temporaries: instances of a
# stack are programmed this many weights at a time (at least one matrix)
PROGRAM_GROUP_ELEMS = 1 << 26


def _program_group(w, cfg: AimcConfig, keys, w_q_out, s_w_out) -> None:
    """CM_INITIALIZE of g [K, N] matrices (w [g, K, N]) into preallocated
    outputs [g, KB, M, Np] / [g, KB, Np]; instance j draws its programming
    noise under ``keys[j]`` (``keys`` None: no noise)."""
    g, k, n = w.shape
    _, kb, m, np_ = w_q_out.shape
    w_blocks = torch.zeros((g, kb * m, np_), dtype=torch.float32,
                           device=w.device)
    w_blocks[:, :k, :n] = w
    w_blocks = w_blocks.reshape(g, kb, m, np_)
    s_w = sym_scale(w_blocks, dim=2).reshape(g, kb, np_)
    codes = w_blocks / s_w[:, :, None, :]
    if cfg.noise.enabled and keys is not None:
        codes = codes + noise_lib.programming_noise_batch(keys, codes,
                                                          cfg.noise)
    w_q_out.copy_(torch.round(codes).clamp(-QMAX, QMAX).to(torch.int8))
    gain = cfg.noise.drift_gain() * cfg.noise.compensation_gain()
    s_w_out.copy_(s_w * gain if gain != 1.0 else s_w)


def program_stacked(w: torch.Tensor, cfg: AimcConfig,
                    key: torch.Tensor | None = None, *,
                    keys=None) -> AimcLinearState:
    """CM_INITIALIZE for a [..., K, N] weight. Leading dims (layer and
    expert stacks) are programmed in groups of instances whose float
    temporaries stay within PROGRAM_GROUP_ELEMS (one matrix at least), so
    they are never a large stack's size. Instance i of a stack draws its
    programming noise from ``split(key, instances)[i]``, as the reference
    does; a single matrix draws from ``key`` itself. ``keys`` (one key per
    instance, in place of ``key``) gives instance i ``keys[i]`` itself: the
    reference's `vmap` of `program_linear` over per-expert keys. Grouping
    moves no value: every op is elementwise or an exact max."""
    *lead, k, n = w.shape
    m = cfg.tile_rows
    kb = _pad_to(k, m) // m
    np_ = _pad_to(n, 128)     # lane padding kept from the reference layout
    w_q = torch.empty((*lead, kb, m, np_), dtype=torch.int8, device=w.device)
    s_w = torch.empty((*lead, kb, np_), dtype=torch.float32, device=w.device)
    flat_w = w.reshape(-1, k, n)
    flat_q = w_q.reshape(-1, kb, m, np_)
    flat_s = s_w.reshape(-1, kb, np_)
    count = flat_w.shape[0]
    if keys is not None:
        if key is not None or len(keys) != count:
            raise ValueError(f"keys= takes one key per instance "
                             f"({count}) and no key=")
        keys = list(keys)
    elif key is not None:
        keys = list(prng.split(key, count)) if lead else [key]
    if not (cfg.noise.enabled and keys is not None):
        keys = None
    step = max(1, PROGRAM_GROUP_ELEMS // (kb * m * np_))
    for a in range(0, count, step):
        b = min(a + step, count)
        _program_group(flat_w[a:b], cfg, None if keys is None else keys[a:b],
                       flat_q[a:b], flat_s[a:b])
    return AimcLinearState(w_q=w_q, s_w=s_w, k=k, n=n)


def program_linear(w: torch.Tensor, cfg: AimcConfig,
                   key: torch.Tensor | None = None) -> AimcLinearState:
    """CM_INITIALIZE: quantize + (noisily) program a [K, N] weight."""
    if w.dim() != 2:
        raise ValueError(f"program_linear takes [K, N], got {tuple(w.shape)}")
    return program_stacked(w, cfg, key)


def _flatten_pad_input(x: torch.Tensor, state: AimcLinearState,
                       cfg: AimcConfig):
    """CM_QUEUE front end: flatten leading dims, pad K to whole row blocks,
    compute the DAC scale on the device. Returns (xf [B, KB*M], s_x, lead)."""
    *lead, k = x.shape
    if k != state.k:
        raise ValueError(f"in_features mismatch: {k} != {state.k}")
    kb, m, _ = state.w_q.shape[-3:]
    xf = x.reshape(-1, k).to(torch.float32)
    if k != kb * m:
        xf = torch.nn.functional.pad(xf, (0, kb * m - k))
    xf = xf.contiguous()
    if cfg.input_scale > 0.0:
        s_x = torch.full((1, 1), cfg.input_scale, dtype=torch.float32,
                         device=x.device)
    else:
        s_x = sym_scale(xf).reshape(1, 1)
    return xf, s_x, lead


def _noise_args(cfg: AimcConfig, key, active_rows: int):
    """(seed, sigma) for the in-kernel PRNG; (None, 0.0) turns noise off."""
    if cfg.noise.enabled and key is not None and cfg.noise.sigma_read > 0.0:
        return (noise_lib.derive_read_seed(key),
                noise_lib.read_sigma_lsb(active_rows, cfg.noise))
    return None, 0.0


def _pad_bias(bias, n: int, np_: int):
    if bias is None:
        return None
    bias = bias.reshape(-1).to(torch.float32)
    if bias.shape[0] != n:
        raise ValueError(f"bias has {bias.shape[0]} features, layer has {n}")
    return torch.nn.functional.pad(bias, (0, np_ - n)) if np_ != n else bias


def aimc_apply(state: AimcLinearState, x: torch.Tensor, cfg: AimcConfig,
               key: torch.Tensor | None = None, *, bias=None,
               activation: str = "none") -> torch.Tensor:
    """CM_QUEUE + CM_PROCESS + CM_DEQUEUE on a programmed layer:
    x [..., K] -> [..., N]. The epilogue runs inside the kernel when
    ``cfg.fuse_epilogue``, as the same f32 ops after it otherwise."""
    kb, m, np_ = state.w_q.shape
    xf, s_x, lead = _flatten_pad_input(x, state, cfg)
    seed, sigma = _noise_args(cfg, key, m)
    fuse = cfg.fuse_epilogue
    bias_p = _pad_bias(bias, state.n, np_) if fuse else None
    act = activation if fuse else "none"

    def launch(w_q, s_w, xf, s_x, bias_p, col0=0, nc=None):
        return kernel_ops.aimc_matmul_v2(
            xf, w_q, s_w, s_x, seed, bias_p, adc_step=cfg.adc_step,
            sigma=sigma, activation=act, noise_source=cfg.noise_source,
            **kernel_ops._cols(col0, nc))

    if state.pieces:
        y = _over_pieces(state, xf, s_x, lambda p, xp, sp, nc: launch(
            p.w_q, p.s_w, xp, sp, None if bias_p is None
            else bias_p[p.c0:p.c1].to(xp.device), p.c0, nc))
    else:
        y = launch(state.w_q, state.s_w, xf, s_x, bias_p)
    y = y[:, :state.n]
    if not fuse:
        if bias is not None:
            y = y + bias.reshape(1, -1).to(torch.float32)
        y = kernel_ops.EPILOGUE_FNS[activation](y)
    return y.reshape(*lead, state.n)


def stack_states(states, dim: int = 0) -> AimcLinearState:
    """Stack same-shape programmed states into one gate stack (copies the
    codes once, at install time). ``dim`` places the gate dim inside
    existing stack dims: layer stacks `[L, ...]` stack at dim=1."""
    sts = list(states)
    if len(sts) < 2:
        raise ValueError("a gate stack needs at least two states")
    first = sts[0]
    if not 0 <= dim <= len(first.stack_shape):
        raise ValueError(f"dim {dim} outside stack dims {first.stack_shape}")
    for st in sts[1:]:
        if (st.k, st.n) != (first.k, first.n) or st.w_q.shape != first.w_q.shape:
            raise ValueError(
                f"gate stack shape mismatch: {tuple(st.w_q.shape)} "
                f"({st.k},{st.n}) vs {tuple(first.w_q.shape)} "
                f"({first.k},{first.n})")
    return AimcLinearState(w_q=torch.stack([st.w_q for st in sts], dim),
                           s_w=torch.stack([st.s_w for st in sts], dim),
                           k=first.k, n=first.n)


def aimc_apply_stacked(stack: AimcLinearState, x: torch.Tensor,
                       cfg: AimcConfig, key: torch.Tensor | None = None, *,
                       biases=None, activations="none") -> torch.Tensor:
    """Gate-fused multi-MVM on a `[G, ...]` stack: x [..., K] ->
    [G, ..., N] in ONE kernel launch sharing x and its DAC scale. Noise off,
    the outputs are bit-equal to per-gate `aimc_apply` calls."""
    if len(stack.stack_shape) != 1:
        raise ValueError(f"aimc_apply_stacked needs one leading gate dim, "
                         f"got stack shape {stack.stack_shape}")
    g_ = stack.stack_shape[0]
    kb, m, np_ = stack.w_q.shape[-3:]
    xf, s_x, lead = _flatten_pad_input(x, stack, cfg)
    seed, sigma = _noise_args(cfg, key, m)
    if isinstance(activations, str):
        activations = (activations,) * g_
    activations = tuple(activations)
    fuse = cfg.fuse_epilogue
    if biases is not None:
        biases = biases.reshape(g_, -1).to(torch.float32)
        if biases.shape[1] != stack.n:
            raise ValueError(f"biases have {biases.shape[1]} features, "
                             f"layer has {stack.n}")
    bias_arg = None
    if fuse and biases is not None:
        bias_arg = (torch.nn.functional.pad(biases, (0, np_ - stack.n))
                    if np_ != stack.n else biases).contiguous()
    acts = activations if fuse else "none"

    def launch(w_q, s_w, xf, s_x, bias_arg, col0=0, nc=None):
        return kernel_ops.aimc_matmul_stacked(
            xf, w_q, s_w, s_x, seed, bias_arg, adc_step=cfg.adc_step,
            sigma=sigma, activations=acts, noise_source=cfg.noise_source,
            **kernel_ops._cols(col0, nc))

    if stack.pieces:
        y = _over_pieces(stack, xf, s_x, lambda p, xp, sp, nc: launch(
            p.w_q, p.s_w, xp, sp, None if bias_arg is None
            else bias_arg[:, p.c0:p.c1].contiguous().to(xp.device), p.c0,
            nc))
    else:
        y = launch(stack.w_q, stack.s_w, xf, s_x, bias_arg)
    y = y[:, :, :stack.n]
    if not fuse:
        if biases is not None:
            y = y + biases[:, None, :]
        y = torch.stack([kernel_ops.EPILOGUE_FNS[a](y[g])
                         for g, a in enumerate(activations)])
    return y.reshape(g_, *lead, stack.n)


def aimc_apply_experts(state: AimcLinearState, x: torch.Tensor,
                       cfg: AimcConfig, keys=None) -> torch.Tensor:
    """`aimc_apply` on each expert of an `[E, ...]` programmed stack, each
    on its own input, in ONE kernel launch: x [E, C, K] -> [E, C, N]. As
    under the reference's `vmap`, expert e takes its own DAC scale
    ``sym_scale(x[e])`` (an expert that got no token sees zeros and the
    floor scale 1e-12 / 127), computed on the device, and its own read
    key ``keys[e]`` (``keys``: [E, 2] or None), whose read seed reaches the
    kernel as one of E seeds."""
    if len(state.stack_shape) != 1:
        raise ValueError(f"aimc_apply_experts needs one leading expert dim, "
                         f"got stack shape {state.stack_shape}")
    e = state.stack_shape[0]
    if x.dim() != 3 or x.shape[0] != e:
        raise ValueError(f"expert inputs must be [{e}, C, K], got "
                         f"{tuple(x.shape)}")
    _, c, k = x.shape
    if k != state.k:
        raise ValueError(f"in_features mismatch: {k} != {state.k}")
    kb, m, _ = state.w_q.shape[-3:]
    seeds, sigma = None, 0.0
    if keys is not None:
        if len(keys) != e:
            raise ValueError(f"{len(keys)} read keys for E={e} experts")
        sigma = _noise_args(cfg, keys[0], m)[1]
        if sigma > 0.0:
            seeds = [noise_lib.derive_read_seed(kk) for kk in keys]
    xf = x.to(torch.float32)
    if k != kb * m:
        xf = torch.nn.functional.pad(xf, (0, kb * m - k))
    xf = xf.contiguous()
    if cfg.input_scale > 0.0:
        s_x = torch.full((e,), cfg.input_scale, dtype=torch.float32,
                         device=x.device)
    else:
        s_x = sym_scale(xf.reshape(e, c * kb * m), dim=1).reshape(e)
    def launch(w_q, s_w, xf, s_x, col0=0, nc=None):
        return kernel_ops.aimc_matmul_experts(xf, w_q, s_w, s_x, seeds,
                                              adc_step=cfg.adc_step,
                                              sigma=sigma,
                                              **kernel_ops._cols(col0, nc))

    if state.pieces:
        y = _over_pieces(state, xf, s_x, lambda p, xp, sp, nc: launch(
            p.w_q, p.s_w, xp, sp, p.c0, nc))
    else:
        y = launch(state.w_q, state.s_w, xf, s_x)
    return y[:, :, :state.n]


# ---------------------------------------------------------------------------
# Noise-aware training: straight-through estimator.
# ---------------------------------------------------------------------------

def _split_key(key):
    """(programming key, read key) of an STE call: ``split(key)``."""
    if key is None:
        return None, None
    kp, kr = prng.split(key)
    return kp, kr


class _AimcLinearSTE(torch.autograd.Function):
    """y = AIMC(x, W) forward, y = x @ W backward (the reference's
    `custom_vjp`, `repro/core/aimc.py:298-331`). Under an ambient mesh the
    forward launches one K2 per column piece (`mesh_pieces`); the backward
    is the whole ``g W^T`` and ``x^T g`` on W's device, where every piece's
    columns live, so a sharded step's gradients are the one-device step's
    bit for bit."""

    @staticmethod
    def forward(ctx, x, w, key, cfg):
        kp, kr = _split_key(key)
        state = mesh_pieces(program_linear(w.detach(), cfg, kp))
        ctx.save_for_backward(x, w)
        return aimc_apply(state, x.detach(), cfg, kr)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.to(torch.float32)
        dx = gf @ w.T.to(torch.float32)
        xl = x.reshape(-1, x.shape[-1]).to(torch.float32)
        dw = xl.T @ gf.reshape(-1, g.shape[-1])
        return (dx.to(x.dtype).reshape(x.shape), dw.to(w.dtype), None, None)


class _AimcLinearSTEExperts(torch.autograd.Function):
    """The STE over an `[E, K, N]` expert stack, expert e under its own key
    (the reference's `vmap` of `aimc_linear_ste`): programming per expert
    from ``split(keys[e])[0]``, one expert-entry launch reading with
    ``split(keys[e])[1]``, and a batched straight-through backward."""

    @staticmethod
    def forward(ctx, x, w, keys, cfg):
        e = w.shape[0]
        kp = kr = None
        if keys is not None:
            pairs = [_split_key(keys[i]) for i in range(e)]
            kp = [p for p, _ in pairs]
            kr = [r for _, r in pairs]
        state = program_stacked(w.detach(), cfg, keys=kp)
        ctx.save_for_backward(x, w)
        return _experts_over_positions(state, x.detach(), cfg, kr)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.to(torch.float32)
        dx = gf @ w.transpose(1, 2).to(torch.float32)
        dw = x.to(torch.float32).transpose(1, 2) @ gf
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def _experts_over_positions(state: AimcLinearState, x: torch.Tensor,
                            cfg: AimcConfig, keys) -> torch.Tensor:
    """`aimc_apply_experts`, split over the ambient mesh's ``model`` axis
    where M divides E: position j launches the expert entry on experts
    ``[j E/M, (j+1) E/M)`` (views of the stack on its device), each with
    its own read key, and the outputs are concatenated in expert order.
    Exact: every expert has its own DAC scale and seed."""
    mesh = compat.current_mesh()
    e = state.stack_shape[0]
    m = mesh.shape["model"] if (mesh is not None
                                and "model" in mesh.axis_names) else 1
    if m == 1 or e % m:
        return aimc_apply_experts(state, x, cfg, keys)
    el = e // m
    outs = []
    for j, dev in enumerate(_model_devices(mesh)):
        sl = slice(j * el, (j + 1) * el)
        part = AimcLinearState(w_q=state.w_q[sl].to(dev),
                               s_w=state.s_w[sl].to(dev), k=state.k,
                               n=state.n)
        outs.append(aimc_apply_experts(
            part, x[sl].to(dev), cfg,
            None if keys is None else keys[sl]).to(x.device))
    return torch.cat(outs, dim=0)


def aimc_linear_ste(x: torch.Tensor, w: torch.Tensor, key,
                    cfg: AimcConfig) -> torch.Tensor:
    """Differentiable AIMC linear: x [..., K], w [K, N] -> f32 [..., N].
    The forward programs W with a fresh programming-noise draw under
    ``split(key)[0]`` and reads with ``split(key)[1]`` (noise-injection
    training [16]); the backward is ``dx = g W^T``, ``dw = x^T g`` in f32,
    cast to x's and w's dtypes. ``key`` gets no gradient."""
    return _AimcLinearSTE.apply(x, w, key, cfg)


def aimc_linear_ste_experts(x: torch.Tensor, w: torch.Tensor, keys,
                            cfg: AimcConfig) -> torch.Tensor:
    """`aimc_linear_ste` over an expert stack: x [E, C, K], w [E, K, N],
    ``keys`` [E, 2] (or None) -> f32 [E, C, N], as `vmap` of the STE."""
    if w.dim() != 3 or x.dim() != 3 or x.shape[0] != w.shape[0]:
        raise ValueError(f"expert STE takes x [E, C, K] and w [E, K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    return _AimcLinearSTEExperts.apply(x, w, keys, cfg)


def aimc_linear(x, w, cfg: AimcConfig, key=None,
                state: AimcLinearState | None = None):
    """Low-level front door (models route through `models.layers.linear`):
    on the fly ``aimc_linear(x, w, cfg, key)`` (the STE); pre-programmed
    ``aimc_linear(x, None, cfg, key, state)`` or a state in place of ``w``
    (apply only)."""
    if state is not None:
        return aimc_apply(state, x, cfg, key)
    if isinstance(w, AimcLinearState):
        return aimc_apply(w, x, cfg, key)
    return aimc_linear_ste(x, w, key, cfg)
