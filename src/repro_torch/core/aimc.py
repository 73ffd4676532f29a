"""The AIMC tile model: programming and inference (PyTorch port of
`repro/core/aimc.py`).

A dense weight matrix is *programmed* (CM_INITIALIZE) onto crossbar row
blocks (`program_linear`); activations then flow through the fused
DAC -> crossbar -> ADC pipeline (`aimc_apply` = CM_QUEUE/PROCESS/DEQUEUE),
which on a CUDA tensor is the hand-written kernel K2 and, for a gate stack
(`aimc_apply_stacked`), K3. The DAC scale ``s_x`` stays a device tensor:
no projection waits on the host.

Noise-aware training (`aimc_linear_ste`) waits for the training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import noise as noise_lib
from repro_torch.core import prng
from repro_torch.core.quant import QMAX, adc_step_lsb, sym_scale
from repro_torch.kernels import ops as kernel_ops


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
class AimcLinearState:
    """A programmed linear layer: int8 conductance codes + output scales.
    Leading dims of ``w_q``/``s_w`` are layer/gate stacks."""

    w_q: torch.Tensor   # int8 [..., KB, M, Np]
    s_w: torch.Tensor   # f32  [..., KB, Np] (drift gain folded in)
    k: int              # logical in_features
    n: int              # logical out_features

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
        return AimcLinearState(w_q=self.w_q, s_w=self.s_w * float(gain),
                               k=self.k, n=self.n)

    def __getitem__(self, i) -> "AimcLinearState":
        """The state of stack entry ``i`` (a layer of a layer stack)."""
        if not self.stack_shape:
            raise IndexError("a single programmed matrix has no stack dim")
        return AimcLinearState(w_q=self.w_q[i], s_w=self.s_w[i],
                               k=self.k, n=self.n)


def _pad_to(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _program_into(w, cfg: AimcConfig, key, w_q_out, s_w_out) -> None:
    """CM_INITIALIZE of one [K, N] matrix into preallocated outputs."""
    k, n = w.shape
    kb, m, np_ = w_q_out.shape
    w_blocks = torch.zeros((kb * m, np_), dtype=torch.float32,
                           device=w.device)
    w_blocks[:k, :n] = w
    w_blocks = w_blocks.reshape(kb, m, np_)
    s_w = sym_scale(w_blocks, dim=1).reshape(kb, np_)
    codes = w_blocks / s_w[:, None, :]
    if cfg.noise.enabled and key is not None:
        codes = codes + noise_lib.programming_noise(key, codes, cfg.noise)
    w_q_out.copy_(torch.round(codes).clamp(-QMAX, QMAX).to(torch.int8))
    gain = cfg.noise.drift_gain() * cfg.noise.compensation_gain()
    s_w_out.copy_(s_w * gain if gain != 1.0 else s_w)


def program_stacked(w: torch.Tensor, cfg: AimcConfig,
                    key: torch.Tensor | None = None) -> AimcLinearState:
    """CM_INITIALIZE for a [..., K, N] weight; leading dims (layer stacks)
    are programmed one instance at a time, so the float temporaries are one
    matrix large, never one stack large. Instance i of a stack draws its
    programming noise from ``split(key, instances)[i]``, as the reference
    does; a single matrix draws from ``key`` itself."""
    *lead, k, n = w.shape
    m = cfg.tile_rows
    kb = _pad_to(k, m) // m
    np_ = _pad_to(n, 128)     # lane padding kept from the reference layout
    w_q = torch.empty((*lead, kb, m, np_), dtype=torch.int8, device=w.device)
    s_w = torch.empty((*lead, kb, np_), dtype=torch.float32, device=w.device)
    flat_w = w.reshape(-1, k, n)
    flat_q = w_q.reshape(-1, kb, m, np_)
    flat_s = s_w.reshape(-1, kb, np_)
    keys = [key] * flat_w.shape[0]
    if lead and key is not None:
        keys = prng.split(key, flat_w.shape[0])
    for i in range(flat_w.shape[0]):
        _program_into(flat_w[i], cfg, keys[i], flat_q[i], flat_s[i])
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
    y = kernel_ops.aimc_matmul_v2(
        xf, state.w_q, state.s_w, s_x, seed,
        _pad_bias(bias, state.n, np_) if fuse else None,
        adc_step=cfg.adc_step, sigma=sigma,
        activation=activation if fuse else "none",
        noise_source=cfg.noise_source)
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
    y = kernel_ops.aimc_matmul_stacked(
        xf, stack.w_q, stack.s_w, s_x, seed, bias_arg,
        adc_step=cfg.adc_step, sigma=sigma,
        activations=activations if fuse else "none",
        noise_source=cfg.noise_source)
    y = y[:, :, :stack.n]
    if not fuse:
        if biases is not None:
            y = y + biases[:, None, :]
        y = torch.stack([kernel_ops.EPILOGUE_FNS[a](y[g])
                         for g, a in enumerate(activations)])
    return y.reshape(g_, *lead, stack.n)
