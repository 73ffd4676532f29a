"""Parity of the port's f32 `log`, `log1p` and `cos` (`core/f32math.py`)
and of the draws built on them with the JAX reference, bit for bit, on
every argument a draw can give, on the CPU:

  * `log` on every ``u1 = (n + 1) 2^-24`` (n < 2^24) against jitted
    `jnp.log`; Box-Muller's radius ``sqrt(-2 log u1)`` against the
    reference's expression, jitted;
  * `cos` on every ``2 pi u2``, ``u2 = n 2^-24``, against jitted `jnp.cos`
    (glibc's `cosf`);
  * ``sqrt(2) erf_inv(u)`` (`prng.erf_inv`, through `log1p`) on all 2^23
    uniforms `jax.random.normal` draws from, against jitted
    ``sqrt(2) * lax.erf_inv``;
  * `prng.normal` against `jax.random.normal` (2^20 draws under 5 keys),
    `cprng.read_noise_array` and `noise_tile` against
    `repro.kernels.cprng` (2^20 counters);
  * 0, 1, subnormals and the other special values of each function
    (XLA:CPU flushes subnormals, so they count as zero).

Every fused multiply-add of `log` and `log1p` (`f32math.fma`: an f64 sum
rounded to f32) is held, on the same arguments, to a round-to-odd f64 sum
rounded to f32, which is the correctly rounded fma: the f64 sum never
double-rounds there. The exhaustive checks run in parts (2^21 to 2^22
arguments each), to stay well under 1 GB and a few seconds a test.
"""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.kernels import cprng as jc
from repro_torch.core import f32math, prng
from repro_torch.kernels import cprng as tc

N24 = 1 << 24
U24 = np.float32(2.0 ** -24)
TWO_PI = np.float32(6.283185307179586)
SQRT2 = np.float32(np.sqrt(2.0))
FLT_MIN = np.float32(2.0 ** -126)
SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 1.4e-45, -1.4e-45,
                    FLT_MIN, -FLT_MIN, 0.5, 2.0, 1e30, 3.4e38, -3.4e38,
                    np.inf, -np.inf, np.nan], np.float32)

_log = jax.jit(jnp.log)
_log1p = jax.jit(jnp.log1p)
_cos = jax.jit(jnp.cos)
_radius = jax.jit(lambda u: jnp.sqrt(-2.0 * jnp.log(u)))
_normal_of = jax.jit(lambda u: SQRT2 * lax.erf_inv(u))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _equal(got: torch.Tensor, want) -> None:
    """Bit for bit (NaNs and the signs of zeros included)."""
    g, w = _bits(got.numpy()), _bits(want)
    assert g.shape == w.shape
    bad = np.flatnonzero(g != w)
    assert bad.size == 0, (f"{bad.size} differ, first at {bad[:4]}: "
                           f"{g[bad[:4]]} vs {w[bad[:4]]}")


def _fma_rounded_once(a, b, c) -> torch.Tensor:
    """The correctly rounded f32 fma: the f64 sum of the exact product
    rounded to odd (TwoSum's error term says where it was inexact), then
    to f32 once (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double() if isinstance(c, torch.Tensor) else torch.tensor(
        c, dtype=torch.float64)
    s = p + c
    t = s - p
    err = (c - t) + (p - (s - t))
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return odd.view(torch.float64).float()


@pytest.fixture
def fma_once(monkeypatch):
    """`f32math.fma` held to `_fma_rounded_once` on every call."""
    orig, seen = f32math.fma, {"calls": 0, "differ": 0}

    def checked(a, b, c):
        got = orig(a, b, c)
        want = _fma_rounded_once(a, b, c)
        seen["calls"] += 1
        seen["differ"] += int((got.view(torch.int32)
                               != want.view(torch.int32)).sum())
        return got

    monkeypatch.setattr(f32math, "fma", checked)
    yield seen
    assert seen["calls"] > 0 and seen["differ"] == 0, seen


def _part(i: int, parts: int, total: int) -> np.ndarray:
    step = total // parts
    return np.arange(i * step, (i + 1) * step, dtype=np.uint32)


def _u1(n: np.ndarray) -> np.ndarray:
    return (n.astype(np.float32) + np.float32(1.0)) * U24


def _angle(n: np.ndarray) -> np.ndarray:
    return TWO_PI * (n.astype(np.float32) * U24)


def _uniforms(k: np.ndarray) -> np.ndarray:
    """The uniforms `jax.random.normal` feeds erf_inv for mantissas ``k``:
    jax's ``max(lo, f (1 - lo) + lo)``, lo = nextafter(-1, 0), as it
    computes them."""
    f = (k.astype(np.uint32) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.asarray(jax.jit(lambda f: lax.max(
        lo, f * (np.float32(1.0) - lo) + lo))(f))


@pytest.mark.parametrize("part", range(4))
def test_log_every_u1(part, fma_once):
    u1 = _u1(_part(part, 4, N24))
    _equal(f32math.log(torch.from_numpy(u1)), _log(u1))


@pytest.mark.parametrize("part", range(4))
def test_radius_every_u1(part, fma_once):
    n = _part(part, 4, N24)
    _equal(tc.radius(torch.from_numpy(n.astype(np.int64))), _radius(_u1(n)))


@pytest.mark.parametrize("part", range(4))
def test_cos_every_angle(part):
    n = _part(part, 4, N24)
    x = _angle(n)
    _equal(f32math.cos(torch.from_numpy(x)), _cos(x))
    _equal(tc.angle_cos(torch.from_numpy(n.astype(np.int64))), _cos(x))


@pytest.mark.parametrize("part", range(4))
def test_erf_inv_every_uniform(part, fma_once):
    u = _uniforms(_part(part, 4, 1 << 23))
    got = torch.tensor(SQRT2) * prng.erf_inv(torch.from_numpy(u))
    _equal(got, _normal_of(u))


def test_uniforms_are_prngs():
    """The erf_inv inputs above are `prng`'s own uniforms, all 2^23 of
    them."""
    k = np.arange(1 << 23, dtype=np.int64)
    got = prng._uniform_fn(prng._NEXT_M1, 1.0, "cpu")(
        torch.from_numpy(k << 9))
    want = _uniforms(k.astype(np.uint32))
    _equal(got, want)
    assert np.unique(want).size == 1 << 23


@pytest.mark.parametrize("fn,ref", [(f32math.log, _log),
                                    (f32math.log1p, _log1p)],
                         ids=["log", "log1p"])
def test_special_values(fn, ref):
    _equal(fn(torch.from_numpy(SPECIAL)), ref(SPECIAL))


def test_cos_special_values():
    """|x| < 120, where glibc reduces as the port does."""
    x = np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 1.4e-45, FLT_MIN,
                  2.0 ** -12, -(2.0 ** -13), 0.7853981, 0.7853982, 3.1415927,
                  -3.1415927, 6.2831855, 100.0, -119.99], np.float32)
    _equal(f32math.cos(torch.from_numpy(x)), _cos(x))


def test_erf_inv_special_values():
    x = np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, FLT_MIN, -FLT_MIN,
                  0.5, -0.5, 0.6436, np.nextafter(np.float32(-1), 0),
                  np.nextafter(np.float32(1), 0)], np.float32)
    _equal(prng.erf_inv(torch.from_numpy(x)), jax.jit(lax.erf_inv)(x))


@pytest.mark.parametrize("seed", [0, 7, 123456, 2**31 + 5, 2**32 - 1])
def test_normal_matches_jax(seed):
    want = jax.random.normal(jax.random.PRNGKey(seed), (1 << 20,))
    _equal(prng.normal(prng.PRNGKey(seed), (1 << 20,)), want)


@pytest.mark.parametrize("seed", [0, 0xC0FFEE, 2**32 - 1])
def test_read_noise_array_matches_reference(seed):
    want = jax.jit(jc.read_noise_array, static_argnums=(1, 2, 3))(
        jnp.uint32(seed), 4, 16, 1 << 14)
    _equal(tc.read_noise_array(seed, 4, 16, 1 << 14), want)


def test_noise_tile_matches_reference():
    args = (5, 1, 256, 4096, 256, 4096, 1000, 8192)   # 2^20 counters
    want = jax.jit(jc.noise_tile, static_argnums=range(4, 8))(
        jnp.uint32(args[0]), *args[1:])
    _equal(tc.noise_tile(*args), want)
