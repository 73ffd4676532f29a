"""The simulated crossbar, written out plainly: programming a weight onto
512-row blocks of int8 conductance codes (with programming noise), the
DAC, the exact integer multiply-accumulate of each block, read noise on
the bit line, the ADC, and the dequantised sum over blocks.

What the configuration states, and nothing of the port, fixes each rule:
symmetric [-127, 127] codes rounded half to even, one weight scale per
block column, a DAC scale per call (the input's max-abs over 127, or a
fixed scale), an ADC step of ``adc_alpha * sqrt(M) * 127`` accumulator
LSBs, programming noise ``(s_min + (s_max - s_min) |code| / 127) * 127``
codes drawn under the weight's key, read noise ``sigma_read * 127 *
sqrt(M)`` LSBs drawn per output element from a counter under the call's
read seed.

A block's products are integers below 2^24 in magnitude, so an f32
matrix product of the codes is exact in any order and in TF32 too: codes
fit in 11 bits. Read noise moves an ADC code only where the accumulator
lies within a few sigma of a rounding edge, so it is drawn for those
elements alone (`READ_MARGIN` sigma); the rest round the same either way.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import cprng, prng

QMAX = 127
READ_MARGIN = 9.0          # sigma: |noise| beyond it has p < 3e-19
M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Crossbar:
    """The tile as a configuration states it."""

    tile_rows: int = 512
    qmax: int = 127                # code range [-qmax, qmax] (7: int4)
    adc_alpha: float = 1.0
    input_scale: float = 0.0       # 0: the call's max-abs over 127
    noise: bool = False
    sigma_prog_min: float = 0.010
    sigma_prog_max: float = 0.025
    sigma_read: float = 0.005

    @property
    def lsb(self) -> float:
        """Accumulator LSBs per 8-bit-code LSB: the bit line's full scale
        is ``sqrt(M) qmax^2``; an 8-bit ADC keeps 127 steps over it."""
        return self.qmax * self.qmax / QMAX

    @property
    def adc_step(self) -> float:
        return float(max(1.0, self.adc_alpha * (self.tile_rows ** 0.5)
                         * self.lsb))

    @property
    def dac_scale(self) -> float:
        """A fixed DAC scale for this code range (the same input range)."""
        if self.qmax == QMAX:
            return self.input_scale
        return self.input_scale * QMAX / self.qmax

    @property
    def read_sigma(self) -> float:
        """Read-noise standard deviation in accumulator LSBs."""
        if not self.noise:
            return 0.0
        return float(self.sigma_read * self.lsb * (self.tile_rows ** 0.5))


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """IEEE ``x / d`` (a division by a Python float may run as a
    multiply by its reciprocal on the card)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def max_abs_scale(x: torch.Tensor, dim=None, qmax: int = QMAX
                  ) -> torch.Tensor:
    ax = x.abs()
    amax = ax.amax() if dim is None else ax.amax(dim=dim, keepdim=True)
    return true_div(amax.clamp_min(1e-12), qmax)


def padded(k: int, n: int, xb: Crossbar) -> tuple[int, int]:
    """(row blocks KB, padded columns Np) of a [k, n] weight."""
    return -(-k // xb.tile_rows), -(-n // 128) * 128


def read_seed(key) -> int:
    """The scalar read seed of a key: the xor of the words of its hash
    of counter 0."""
    k0, k1 = prng.key_words(key)
    y0, y1 = prng.threefry2x32(k0, k1, 0, 0)
    return y0 ^ y1


def program(w: torch.Tensor, xb: Crossbar, keys=None, group: int = 16):
    """Codes and scales of g matrices ``w`` [g, K, N] (f32): codes [g, KB,
    M, Np] as f32 integers, scales [g, KB, Np]. Matrix j draws its
    programming noise under ``keys[j]`` (None: none), ``group`` matrices
    a draw."""
    g, k, n = w.shape
    m = xb.tile_rows
    kb, np_ = padded(k, n, xb)
    blocks = torch.zeros((g, kb * m, np_), dtype=torch.float32,
                         device=w.device)
    blocks[:, :k, :n] = w
    blocks = blocks.reshape(g, kb, m, np_)
    q = xb.qmax
    s_w = max_abs_scale(blocks, dim=2, qmax=q).reshape(g, kb, np_)
    codes = blocks / s_w[:, :, None, :]
    del blocks
    if xb.noise and keys is not None:
        for a in range(0, g, group):
            part = codes[a:a + group]
            level = part.abs() / q
            sigma = (xb.sigma_prog_min
                     + (xb.sigma_prog_max - xb.sigma_prog_min) * level) * q
            codes[a:a + group] = part + sigma * prng.normal_batch(
                list(keys[a:a + group]), (kb, m, np_), device=w.device)
    codes = torch.round(codes).clamp_(-q, q)
    return codes, s_w


def _adc(acc: torch.Tensor, xb: Crossbar, seeds) -> torch.Tensor:
    """ADC codes of accumulators [G, KB, B, Np] (f32 integers), with the
    read noise of ``seeds[j]`` (one per leading entry; None: none) added
    where it can move a code; entry j's element (k, b, c) has counter
    ``(k B + b) Np + c``."""
    step = xb.adc_step
    sigma = xb.read_sigma
    if sigma > 0.0 and seeds is not None:
        r = true_div(acc, step)
        edge = (r - torch.floor(r) - 0.5).abs() * step
        del r
        idx = torch.nonzero((edge < READ_MARGIN * sigma + 1.0).reshape(-1))
        del edge
        idx = idx[:, 0]
        if idx.numel():
            per = acc[0].numel()
            seed = torch.tensor([int(s) & M32 for s in seeds],
                                dtype=torch.int64, device=acc.device)
            flat = acc.reshape(-1)
            g = cprng.gauss_from_counter(seed[idx // per], (idx % per) & M32)
            flat[idx] = flat[idx] + sigma * g
    return torch.round(true_div(acc, step)).clamp_(-QMAX, QMAX)


def mvm(x: torch.Tensor, codes: torch.Tensor, s_w: torch.Tensor, n: int,
        xb: Crossbar, seed=None) -> torch.Tensor:
    """One crossbar call: x [B, K] -> f32 [B, n] through codes [KB, M,
    Np] and scales [KB, Np]."""
    return mvm_experts(x[None], codes[None], s_w[None], n, xb,
                       None if seed is None else [seed])[0]


def mvm_experts(x: torch.Tensor, codes: torch.Tensor, s_w: torch.Tensor,
                n: int, xb: Crossbar, seeds=None) -> torch.Tensor:
    """E crossbar calls at once: x [E, C, K] -> [E, C, n], each on its own
    input with its own DAC scale (fixed, or the max-abs of its own input:
    an expert that got no token sees zeros) and its own read seed."""
    e, c, k = x.shape
    kb, m, np_ = codes.shape[1:]
    xf = x.to(torch.float32)
    if k != kb * m:
        xf = torch.nn.functional.pad(xf, (0, kb * m - k))
    if xb.input_scale > 0.0:
        s_x = torch.full((e,), xb.dac_scale, dtype=torch.float32,
                         device=x.device)
    else:
        s_x = max_abs_scale(xf.reshape(e, c * kb * m), dim=1,
                            qmax=xb.qmax).reshape(e)
    x_q = torch.round(xf.reshape(e, c, kb, m) / s_x[:, None, None, None])
    x_q = x_q.clamp_(-xb.qmax, xb.qmax).transpose(1, 2)    # [E, KB, C, M]
    acc = torch.bmm(x_q.reshape(e * kb, c, m),
                    codes.reshape(e * kb, m, np_))
    del x_q, xf
    adc = _adc(acc.reshape(e, kb, c, np_), xb, seeds)
    del acc
    y = (adc * s_w[:, :, None, :]).sum(1) * (s_x * xb.adc_step)[:, None,
                                                                None]
    return y[..., :n]


def split2(key):
    """(programming key, read key) of a call's key."""
    if key is None:
        return None, None
    kp, kr = prng.split(key)
    return kp, kr


class _STE(torch.autograd.Function):
    """Crossbar forward, straight-through backward: ``y = x @ W`` in f32
    for the gradients, cast to x's and W's dtypes (``fp8``: the products
    on e4m3 operands)."""

    @staticmethod
    def forward(ctx, x, w, key, xb, fp8=False):
        kp, kr = split2(key)
        codes, s_w = program(w.detach().to(torch.float32)[None], xb,
                             None if kp is None else [kp])
        ctx.save_for_backward(x, w)
        ctx.fp8 = fp8
        seed = read_seed(kr) if (xb.read_sigma > 0 and kr is not None) \
            else None
        lead = x.shape[:-1]
        y = mvm(x.detach().reshape(-1, x.shape[-1]), codes[0], s_w[0],
                w.shape[1], xb, seed)
        return y.reshape(*lead, w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        op = _operand(ctx.fp8)
        gf = op(g.to(torch.float32))
        dx = gf @ op(w.to(torch.float32)).T
        xl = op(x.reshape(-1, x.shape[-1]).to(torch.float32))
        dw = xl.T @ gf.reshape(-1, g.shape[-1])
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


class _STEExperts(torch.autograd.Function):
    """`_STE` over an expert stack, expert e under ``keys[e]``."""

    @staticmethod
    def forward(ctx, x, w, keys, xb, fp8=False):
        e = w.shape[0]
        kp = kr = None
        if keys is not None:
            pairs = [split2(keys[i]) for i in range(e)]
            kp = [p for p, _ in pairs]
            kr = [r for _, r in pairs]
        codes, s_w = program(w.detach().to(torch.float32), xb, kp)
        ctx.save_for_backward(x, w)
        ctx.fp8 = fp8
        seeds = ([read_seed(r) for r in kr]
                 if (xb.read_sigma > 0 and kr is not None) else None)
        return mvm_experts(x.detach(), codes, s_w, w.shape[2], xb, seeds)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        op = _operand(ctx.fp8)
        gf = op(g.to(torch.float32))
        dx = gf @ op(w.to(torch.float32)).transpose(1, 2)
        dw = op(x.to(torch.float32)).transpose(1, 2) @ gf
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def ste(x, w, key, xb: Crossbar, fp8: bool = False):
    """``fp8`` (the control): the backward's products on e4m3 operands."""
    return _STE.apply(x, w, key, xb, fp8)


def ste_experts(x, w, keys, xb: Crossbar, fp8: bool = False):
    return _STEExperts.apply(x, w, keys, xb, fp8)


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one scale, its max-abs to 448."""
    xf = x.to(torch.float32)
    s = 448.0 / xf.abs().amax().clamp_min(1e-30)
    return ((xf * s).to(torch.float8_e4m3fn).to(torch.float32) / s).to(
        x.dtype)


def _operand(fp8: bool):
    return e4m3 if fp8 else (lambda t: t)


def sigma_check(xb: Crossbar) -> None:
    """The noise margin is only sound while sigma is far below a step."""
    if xb.read_sigma and READ_MARGIN * xb.read_sigma > xb.adc_step / 4:
        raise ValueError(f"read sigma {xb.read_sigma:.3g} LSB is too wide "
                         f"for the ADC step {xb.adc_step:.3g}")
