"""JAX-compatible PRNG keys in PyTorch: the parts of `jax.random` that the
reference package draws from (`PRNGKey`, `split`, `fold_in`, `bits`,
`uniform`, `normal`), bit for bit with jax's default threefry2x32 generator
in its partitionable mode (`jax_threefry_partitionable=True`, jax >= 0.5's
default) and 64-bit mode off.

A key is the pair of uint32 words ``[k0, k1]`` held in an int64 tensor of
shape ``[2]`` (``[n, 2]`` for `split`'s result). Keys are control values: the
word arithmetic of `split`/`fold_in` runs on Python ints, so a key on the
CPU never waits for a device. Draws (`bits`/`uniform`/`normal`) run on
``device`` (default: the key's own device).

Element ``i`` of any draw, in row-major order, is
``threefry2x32(key, (i >> 32, i & 0xffffffff))``; `bits` returns the xor of
the two output words. Since the counter is the flat index, a draw is
computed in chunks with no change to any value (a full-width CNN-M dense
layer is 86528 x 4096 draws): `CHUNK[device type]` elements, sized to stay
in cache on the CPU and to amortise kernel launches on the card.

PyTorch has no uint32 right shift on the CPU, so the words live in int64
masked to 32 bits. Threefry needs only add, xor and rotate, so one
`threefry2x32` serves Python ints and int64 tensors alike.

`normal` is ``sqrt(2) * erf_inv(u)`` on ``u ~ U(nextafter(-1, 0), 1)``
with XLA's f32 `erf_inv` polynomial written in torch ops (`torch.erfinv`
differs from it by tens of ulps). XLA's `log1p` is not PyTorch's, so
`normal` agrees with jax within a few ulps, not bit for bit. The `log1p` and
the `sqrt` inside `erf_inv` run in f64 and round to f32 once: PyTorch's f32
CPU kernels for them do not give the same bits on every call (a first call
of f32 `torch.sqrt` was seen 1e-4 off), and a draw must.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
CHUNK = {"cpu": 1 << 18, "cuda": 1 << 24}
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's f32 ErfInv (xla/client/lib/math.cc, ErfInv32): Horner coefficients
# for w = -log1p(-x^2) < 5 (in w - 2.5) and >= 5 (in sqrt(w) - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 2.1858087e-04, -1.25372503e-03,
               -4.17768164e-03, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-2.00214257e-04, 1.00950558e-04, 1.34934322e-03,
               -3.67342844e-03, 5.73950773e-03, -7.6224613e-03,
               9.43887047e-03, 1.00167406, 2.83297682)


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 with 20 rounds (jax's `_threefry2x32_lowering`) on
    uint32 words held in Python ints or int64 tensors; returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key_words(key: torch.Tensor) -> tuple[int, int]:
    """The key's two uint32 words as Python ints."""
    if tuple(key.shape) != (2,):
        raise ValueError(f"a key is a [2] tensor of uint32 words, got "
                         f"{tuple(key.shape)}")
    k0, k1 = key.tolist()
    return int(k0) & M32, int(k1) & M32


def _key(w0: int, w1: int, device) -> torch.Tensor:
    return torch.tensor([w0, w1], dtype=torch.int64, device=device)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:  # noqa: N802
    """`jax.random.PRNGKey(seed)`, 64-bit mode off: ``[0, seed mod 2^32]``."""
    return _key(0, int(seed) & M32, device)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split(key, n)`: ``[n, 2]`` keys; key i hashes counter i."""
    k0, k1 = key_words(key)
    out = [threefry2x32(k0, k1, i >> 32, i & M32) for i in range(int(n))]
    return torch.tensor(out, dtype=torch.int64, device=key.device).reshape(
        int(n), 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: the hash of counter ``(0, data)``."""
    k0, k1 = key_words(key)
    return _key(*threefry2x32(k0, k1, 0, int(data) & M32), key.device)


def _draw(key: torch.Tensor, shape, device, fn, dtype) -> torch.Tensor:
    """``fn(bits)`` over the flat draw of ``shape``, CHUNK elements at a
    time; ``bits`` are the uint32 draws (int64) of one chunk."""
    k0, k1 = key_words(key)
    shape = tuple(int(d) for d in shape)
    device = key.device if device is None else torch.device(device)
    total = math.prod(shape)
    out = torch.empty(total, dtype=dtype, device=device)
    chunk = CHUNK.get(device.type, CHUNK["cuda"])
    for start in range(0, total, chunk):
        i = torch.arange(start, min(start + chunk, total), dtype=torch.int64,
                         device=device)
        y0, y1 = threefry2x32(k0, k1, i >> 32, i & M32)
        out[start:start + i.numel()] = fn(y0 ^ y1)
    return out.reshape(shape)


def bits(key: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)`, as int64 values in [0, 2^32)."""
    return _draw(key, shape, device, lambda b: b, torch.int64)


def _unit(b: torch.Tensor) -> torch.Tensor:
    """[1, 2) from the top 23 bits, minus 1: jax's mantissa trick."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _uniform_fn(lo: float, hi: float, device):
    """``max(lo, u * (hi - lo) + lo)`` in f32 with the multiply-add fused,
    as XLA's CPU backend contracts it: the f64 product of two f32 values is
    exact and, for the ranges used here, so is the f64 sum, which then
    rounds to f32 once."""
    lo_t, hi_t = _f32(lo, device), _f32(hi, device)
    span, lo64 = (hi_t - lo_t).double(), lo_t.double()

    def fn(b):
        return torch.maximum(lo_t, (_unit(b).double() * span + lo64).float())
    return fn


def uniform(key: torch.Tensor, shape=(), lo: float = 0.0, hi: float = 1.0,
            device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, lo, hi)`, bit for bit."""
    dev = key.device if device is None else torch.device(device)
    return _draw(key, shape, dev, _uniform_fn(lo, hi, dev), torch.float32)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ErfInv polynomial; ``+-inf`` at ``|x| == 1``."""
    w = -torch.log1p((-x * x).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0], x.device),
                    _f32(_ERFINV_GE5[0], x.device))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, _f32(c_lt, x.device),
                        _f32(c_ge, x.device)) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NEXT_M1 = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))


def normal(key: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """`jax.random.normal(key, shape, float32)` within a few ulps."""
    dev = key.device if device is None else torch.device(device)
    unif = _uniform_fn(_NEXT_M1, 1.0, dev)
    sqrt2 = _f32(_SQRT2, dev)
    return _draw(key, shape, dev, lambda b: sqrt2 * erf_inv(unif(b)),
                 torch.float32)
