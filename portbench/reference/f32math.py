"""Frozen copy of the port's `src/repro_torch/core/f32math.py`, so that the benchmark's
reference draws the same noise without importing the program.
Change nothing here: the draws must stay those of the port's
configuration as the benchmark defined it.

The reference's f32 ``log``, ``log1p`` and ``cos``, bit for bit, in torch
ops: the functions its draws go through (`prng.erf_inv`, the threefry
normal; `kernels/cprng.box_muller`, the counter read noise).

On the CPU the reference computes them as XLA:CPU compiles them, and
PyTorch's `log`, `log1p` and `cos` are other functions (they differ from
the reference on 14% of a Box-Muller draw's `log` arguments). So:

  * `log` and `log1p` are XLA:CPU's f32 ones (jax 0.9.0 on an x86-64 host
    with FMA): Cephes' `logf` polynomial, which XLA inlines into every
    fusion, and Cephes' `log1pf` rational approximation for
    ``|x| < sqrt(2) - 1``. The operation sequence is the one XLA emits
    (its optimized LLVM IR); which multiply-adds are fused is read off the
    object code it compiles (`vfmadd`). XLA:CPU runs with subnormals
    flushed (DAZ/FTZ), so a subnormal input counts as zero here too.
  * `cos` is glibc 2.36's `cosf`, which XLA:CPU calls: the argument
    widened to double, reduced by the nearest multiple of pi/2
    (``x - n pi/2`` as one fused multiply-add), a polynomial of the
    quadrant, in double, rounded once to f32.

A fused multiply-add is one rounding (`fma`): the f64 product of two f32
values is exact, and the f64 sum is rounded to f32. The sum's own f64
rounding could land it on an f32 midpoint where the exact sum is not; on
every argument a draw gives, that never happens
(`tests/test_torch_f32math.py` holds each fused operation to a
round-to-odd sum, which cannot). glibc's polynomial multiply-adds are in
double; computed unfused here, their f32 result is the same on every
argument a draw gives (the tests compare all of them with the reference).

Each function is exact on the arguments a draw gives: ``log`` on
``u1 = (n + 1) 2^-24``, ``cos`` on ``2 pi u2`` with ``u2 = n 2^-24``, for
every 24-bit n, and ``log1p`` on ``-x * x`` for every input ``x`` of
`prng.erf_inv`. `cos` reduces every argument the same way; glibc reduces
``|x| >= 120`` differently, and no draw gives one. The tests compare with
live JAX, so a JAX or glibc version that moves either sequence fails the
test of that function. The card computes the same operations
(`kernels/csrc/f32math.cuh`).
"""

from __future__ import annotations

import functools
import math

import torch

FLT_MIN = 2.0 ** -126

_h = float.fromhex

# Cephes logf (XLA's f32 log): x = m 2^e with m in [sqrt(1/2), sqrt(2)),
# log x = x1 - x1^2 / 2 + x1^3 P(x1) + e ln 2, ln 2 = Q2 - Q1 (two parts)
_LOG_P = (_h('0x1.204376p-4'), -_h('0x1.d7a37p-4'),
          _h('0x1.de4a34p-4'), -_h('0x1.fcba9ep-4'),
          _h('0x1.23d37ep-3'), -_h('0x1.555cap-3'),
          _h('0x1.999d58p-3'), -_h('0x1.fffff8p-3'),
          _h('0x1.555554p-2'))
_LOG_Q1 = -_h('0x1.bd0106p-13')     # -2.12194440e-4
_LOG_Q2 = _h('0x1.63p-1')           # 0.693359375
_SQRTHF = _h('0x1.6a09e6p-1')       # f32 sqrt(1/2)
# Cephes log1pf for |x| < sqrt(2) - 1: x - x^2 / 2 + x^3 P(x) / Q(x),
# Q monic
_LOG1P_P = (_h('0x1.7bc096p-15'), _h('0x1.fe818ap-2'),
            _h('0x1.a509f4p+2'), _h('0x1.de9738p+4'),
            _h('0x1.e798ecp+5'), _h('0x1.c8e75ap+5'),
            _h('0x1.40a202p+4'))
_LOG1P_Q = (_h('0x1.e2035ap+3'), _h('0x1.4c30b6p+6'),
            _h('0x1.bb865ap+7'), _h('0x1.351946p+8'),
            _h('0x1.b0db14p+7'), _h('0x1.e0f304p+5'))
_LOG1P_SMALL = _h('0x1.a8279ap-2')  # f32 sqrt(2) - 1

# glibc's sincosf table (sysdeps/ieee754/flt-32/sincosf_data.c)
_HPI_INV = _h('0x1.45f306dc9c883p+23')  # 2 / pi * 2^24
_HPI_HI = _h('0x1.921fb54442dp+0')      # pi / 2 = _HPI_HI + _HPI_LO,
_HPI_LO = _h('0x1.8p-48')               # _HPI_HI of 45 bits
_COS_C = (1.0, -_h('0x1.ffffffd0c621cp-2'), _h('0x1.55553e1068f19p-5'),
          -_h('0x1.6c087e89a359dp-10'), _h('0x1.99343027bf8c3p-16'))
_SIN_S = (-_h('0x1.555545995a603p-3'), _h('0x1.1107605230bc4p-7'),
          -_h('0x1.994eb3774cf24p-13'))


@functools.lru_cache(maxsize=256)
def _k(value: float, device: torch.device) -> torch.Tensor:
    """A 0-d f64 constant on ``device``."""
    return torch.tensor(value, dtype=torch.float64, device=device)


def fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """The f32 ``fma(a, b, c)`` of f32 values, one op: ``a`` is a tensor
    and ``a`` or ``b`` an f64 one (so the product is formed in f64,
    exactly), the other an f32 or f64 tensor or an f64 constant; ``c`` an
    f32 tensor or a float."""
    if not isinstance(c, torch.Tensor):
        c = _k(c, a.device)
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape)
    return torch.addcmul(c, a, b, out=torch.empty(shape, dtype=torch.float32,
                                                  device=a.device))


def flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values to zero of their sign (XLA:CPU's DAZ/FTZ)."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


@functools.lru_cache(maxsize=16)
def _nan_bits(device: torch.device) -> torch.Tensor:
    """XLA's NaN of a log out of its domain: all bits set."""
    return torch.tensor(-1, dtype=torch.int32, device=device).view(
        torch.float32)


def _log_poly(x: torch.Tensor) -> torch.Tensor:
    """Cephes' logf on max(x, FLT_MIN), with XLA's multiply-adds fused."""
    dev = x.device
    bits = torch.clamp(x, min=FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRTHF
    x1 = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.float()
    x2 = x1 * x1
    x3 = x2 * x1
    w1, w3 = x1.double(), x3.double()
    p = _LOG_P
    y = fma(w1, _k(p[0], dev), p[1])
    y1 = fma(w1, _k(p[3], dev), p[4])
    y2 = fma(w1, _k(p[6], dev), p[7])
    y = fma(y, w1, p[2])
    y1 = fma(y1, w1, p[5])
    y2 = fma(y2, w1, p[8])
    y = fma(y, w3, y1)
    y = fma(y, w3, y2)
    y = fma(y, w3, e * _LOG_Q1)
    # fused too in XLA, but x2 / 2 and e * Q2 (|e| <= 2^8, Q2 9 bits) are
    # exact, so one rounding each either way
    r = (x1 - x2 * 0.5) + y
    return r + e * _LOG_Q2


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log``: -inf at zero and at subnormals, inf at inf,
    NaN (all bits set) below zero and at NaN."""
    r = torch.where(x > 0.0, _log_poly(x), _nan_bits(x.device))
    r = torch.where(x.abs() < FLT_MIN, -math.inf, r)
    return torch.where(x == math.inf, math.inf, r)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log1p``: for ``|x| < sqrt(2) - 1``
    ``x - x^2 / 2 + x^3 P(x) / Q(x)`` (Horner steps fused), else
    ``log(1 + x)``; a subnormal ``x`` counts as zero of its sign."""
    x = flush(x)
    dev = x.device
    wx = x.double()
    x2 = x * x
    q = x + _LOG1P_Q[0]                 # Q's leading 1 times x: exact
    for c in _LOG1P_Q[1:]:
        q = fma(q, wx, c)
    p = fma(wx, _k(_LOG1P_P[0], dev), _LOG1P_P[1])
    for c in _LOG1P_P[2:]:
        p = fma(p, wx, c)
    small = x + ((x * x2) * (p / q) - x2 * 0.5)   # x2 / 2 exact: fused alike
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + 1.0))


def cos(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``cosf``: in double, ``x`` reduced to ``r = x - n pi/2``,
    ``|r| <= pi/4``, then cos or sin of r by the quadrant n, rounded once
    to f32; 1 where ``|x| < 2^-12``."""
    top = (x.view(torch.int32) >> 20) & 0x7FF     # glibc's abstop12
    xd = x.double()
    n = ((xd * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    n = torch.where(top < 0x3F4, 0, n)            # |x| < pi/4: n = 0
    nd = n.double()
    # fma(-n, pi/2, x) exactly: n pi_hi (|n| < 2^7) and n pi_lo are exact,
    # and so is x - n pi_hi (within a factor 2 of each other)
    r = (xd - nd * _HPI_HI) - nd * _HPI_LO
    r2 = r * r
    r4 = r2 * r2
    c = _COS_C
    cos_p = ((c[0] + r2 * c[1]) + r4 * c[2]) + (r2 * r4) * (c[3] + r2 * c[4])
    r3 = r2 * r
    s = _SIN_S
    sin_p = (r + r3 * s[0]) + (r3 * r2) * (s[1] + r2 * s[2])
    # quadrant n: cos r, -sin r, -cos r, sin r
    out = torch.where((n & 1) == 0, cos_p, sin_p)
    out = torch.where(((n + 1) & 2) == 0, out, -out).float()
    return torch.where(top < 0x398, 1.0, out)
