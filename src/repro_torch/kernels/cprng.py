"""Counter-based Gaussian PRNG shared by the CUDA kernel and its plain
version (PyTorch port of `repro/kernels/cprng.py`).

Every noise element is a pure function of (seed, global element counter): a
lowbias32 integer hash feeding a Box-Muller transform, so the kernel (which
draws per tile, `csrc/cprng.cuh`) and the plain version (which draws in
bulk, here) read the same values whatever the block shape.

The uint32 arithmetic runs in int64 tensors masked to 32 bits: PyTorch on
the CPU has no uint32 right shift. Multiplies split the 32-bit constant in
16-bit halves so no int64 product overflows; the low 32 bits are exact.

The element counter of a `[KB, B, Np]` noise tensor is the row-major flat
index ``(k * B + b) * Np + c`` in wrapping uint32 arithmetic; gate ``g`` of
a stacked multi-MVM re-seeds via `stack_seed(seed, g)`.
"""

from __future__ import annotations

import torch

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


def box_muller(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Standard-normal f32 draws from two uint32 words per element (the
    reference kernel's own mapping): u1 in (0, 1], u2 in [0, 1).

    The square root is taken in f64 and rounded once to f32: that is the
    correctly rounded f32 root (53 >= 2 * 24 + 2 bits, so the double
    rounding is exact), which the card's `sqrtf` gives too, and it keeps
    off PyTorch's f32 CPU `sqrt`, whose first call in a process has
    returned values 1e-4 off."""
    u1 = ((h1 >> 8).to(torch.float32) + 1.0) * _U24
    u2 = (h2 >> 8).to(torch.float32) * _U24
    r = torch.sqrt((-2.0 * torch.log(u1)).double()).to(torch.float32)
    return r * torch.cos(_TWO_PI * u2)


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


def read_noise_array(seed, kb: int, b: int, np_: int,
                     device=None) -> torch.Tensor:
    """The full `[KB, B, Np]` standard-normal tensor, counter-addressed."""
    ctr = torch.arange(kb * b * np_, dtype=torch.int64, device=device)
    return gauss_from_counter(seed, ctr & _M32).reshape(kb, b, np_)
