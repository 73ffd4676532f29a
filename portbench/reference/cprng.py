"""Frozen copy of the port's `src/repro_torch/kernels/cprng.py`, so that the benchmark's
reference draws the same noise without importing the program.
Change nothing here: the draws must stay those of the port's
configuration as the benchmark defined it.

Counter-based Gaussian PRNG shared by the CUDA kernel and its plain
version (PyTorch port of `repro/kernels/cprng.py`).

Every noise element is a pure function of (seed, global element counter): a
lowbias32 integer hash feeding a Box-Muller transform, so the kernel (which
draws per tile, `csrc/cprng.cuh`) and the plain version (which draws in
bulk, here) read the same values whatever the block shape. Box-Muller's
`log` and `cos` are `core.f32math`'s (XLA:CPU's f32 `log`, glibc's `cosf`),
so every draw equals the reference's bit for bit.

The uint32 arithmetic runs in int64 tensors masked to 32 bits: PyTorch on
the CPU has no uint32 right shift. Multiplies split the 32-bit constant in
16-bit halves so no int64 product overflows; the low 32 bits are exact.

The element counter of a `[KB, B, Np]` noise tensor is the row-major flat
index ``(k * B + b) * Np + c`` in wrapping uint32 arithmetic; gate ``g`` of
a stacked multi-MVM re-seeds via `stack_seed(seed, g)`. A column piece
``[col0, col0 + Np)`` of a state ``nc`` columns wide draws the whole's
counters, ``(k * B + b) * nc + col0 + c``.
"""

from __future__ import annotations

import torch

from portbench.reference import f32math

GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF
_U24 = float(2 ** -24)
_TWO_PI = 6.283185307179586


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & _M32


def _u32(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _M32
    return torch.tensor(int(v) & _M32, dtype=torch.int64, device=device)


def mix32(x) -> torch.Tensor:
    """lowbias32 avalanche hash on uint32 values held in int64."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def stack_seed(seed: int, g: int) -> int:
    """Per-gate seed of slice ``g`` in a stacked multi-MVM (a host int)."""
    v = (int(seed) & _M32) ^ (((int(g) + 1) * GOLDEN) & _M32)
    return int(mix32(torch.tensor(v, dtype=torch.int64)))


def radius(n: torch.Tensor) -> torch.Tensor:
    """Box-Muller's radius ``sqrt(-2 log u1)`` of ``u1 = (n + 1) 2^-24``
    in (0, 1], for the top 24 bits ``n`` of the first hash word.

    The square root is taken in f64 and rounded once to f32: that is the
    correctly rounded f32 root (53 >= 2 * 24 + 2 bits, so the double
    rounding is exact), which XLA and the card's `sqrtf` give too, and it
    keeps off PyTorch's f32 CPU `sqrt`, whose first call in a process has
    returned values 1e-4 off."""
    u1 = (n.to(torch.float32) + 1.0) * _U24
    return torch.sqrt((-2.0 * f32math.log(u1)).double()).to(torch.float32)


def angle_cos(n: torch.Tensor) -> torch.Tensor:
    """Box-Muller's ``cos(2 pi u2)`` of ``u2 = n 2^-24`` in [0, 1), for the
    top 24 bits ``n`` of the second hash word."""
    return f32math.cos(_TWO_PI * (n.to(torch.float32) * _U24))


def box_muller(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Standard-normal f32 draws from two uint32 words per element (the
    reference kernel's own mapping), bit for bit with the reference's
    ``sqrt(-2 log u1) cos(2 pi u2)`` as XLA:CPU computes it: its `log` and
    `cos` are `f32math`'s."""
    return radius(h1 >> 8) * angle_cos(h2 >> 8)


def gauss_from_counter(seed, ctr: torch.Tensor) -> torch.Tensor:
    """Standard-normal f32 draws, one per uint32 counter element: two
    chained hash streams feed Box-Muller."""
    h1 = mix32(_u32(ctr) ^ _u32(seed, ctr.device))
    h2 = mix32((h1 + GOLDEN) & _M32)
    return box_muller(h1, h2)


def noise_tile(seed, k: int, row0: int, col0: int, bb: int, bn: int,
               b_total: int, n_total: int, device=None) -> torch.Tensor:
    """One `[bb, bn]` tile of the virtual `[KB, B, Np]` noise tensor, its
    counters addressing the LOGICAL tensor (``b_total`` unpadded rows)."""
    rows = row0 + torch.arange(bb, dtype=torch.int64, device=device)[:, None]
    cols = col0 + torch.arange(bn, dtype=torch.int64, device=device)[None, :]
    ctr = ((k * b_total + rows) & _M32) * n_total + cols
    return gauss_from_counter(seed, ctr & _M32)


def read_noise_array(seed, kb: int, b: int, np_: int, device=None, *,
                     col0: int = 0, nc: int | None = None) -> torch.Tensor:
    """The full `[KB, B, Np]` standard-normal tensor, counter-addressed.
    ``col0``/``nc``: the tensor is columns ``[col0, col0 + Np)`` of a
    ``[KB, B, nc]`` one (a column piece of a wider state), counters
    ``(k * B + b) * nc + col0 + c``."""
    if col0 == 0 and nc in (None, np_):
        ctr = torch.arange(kb * b * np_, dtype=torch.int64, device=device)
        return gauss_from_counter(seed, ctr & _M32).reshape(kb, b, np_)
    ks = torch.arange(kb, dtype=torch.int64, device=device)[:, None, None]
    rows = torch.arange(b, dtype=torch.int64, device=device)[None, :, None]
    cols = torch.arange(np_, dtype=torch.int64, device=device)[None, None]
    ctr = (ks * b + rows) * nc + col0 + cols
    return gauss_from_counter(seed, ctr & _M32)
