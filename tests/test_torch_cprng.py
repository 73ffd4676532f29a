"""Parity of the port's counter PRNG (`repro_torch/kernels/cprng.py`) with
the JAX reference (`repro/kernels/cprng.py`).

Tolerances: none. The uint32 hashes (`mix32`, `stack_seed`) and the
Gaussians are bit-exact: Box-Muller's log and cos are the reference's
(`core.f32math`: XLA:CPU's f32 log, glibc's cosf; their exhaustive checks
are tests/test_torch_f32math.py).
"""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cprng as jc
from repro_torch.core import f32math
from repro_torch.kernels import cprng as tc

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix32_bit_exact(seed):
    x = np.random.default_rng(seed).integers(0, 2**32, 4096, dtype=np.uint64)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    h_j = np.asarray(jc.mix32(jnp.asarray(x.astype(np.uint32))))
    h_t = tc.mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(h_t.astype(np.uint32), h_j)
    assert h_t.min() >= 0 and h_t.max() < 2**32


@pytest.mark.parametrize("seed", [0, 7, 0xC0FFEE, 2**32 - 1])
def test_stack_seed_bit_exact(seed):
    for g in range(5):
        want = int(jc.stack_seed(jnp.uint32(seed), g))
        assert tc.stack_seed(seed, g) == want


@pytest.mark.parametrize("seed", [0, 123, 0xDEADBEEF])
def test_read_noise_array_bit_exact(seed):
    """The bulk draw equals the reference's bit for bit."""
    z_j = np.asarray(jc.read_noise_array(jnp.uint32(seed), 3, 5, 256))
    z_t = tc.read_noise_array(seed, 3, 5, 256).numpy()
    assert z_t.shape == z_j.shape == (3, 5, 256)
    np.testing.assert_array_equal(z_t.view(np.int32), z_j.view(np.int32))


def test_noise_tile_addresses_the_logical_tensor():
    """A tile reads exactly the bulk tensor's draws at its offsets (the
    kernel's per-tile counters), and matches the reference's tile."""
    full = tc.read_noise_array(9, 2, 6, 384)
    tile = tc.noise_tile(9, 1, 2, 128, 3, 128, 6, 384)
    assert torch.equal(tile, full[1, 2:5, 128:256])
    ref_tile = np.asarray(jc.noise_tile(jnp.uint32(9), 1, 2, 128, 3, 128,
                                        6, 384))
    np.testing.assert_array_equal(tile.numpy().view(np.int32),
                                  ref_tile.view(np.int32))


def test_counter_noise_moments():
    z = tc.read_noise_array(123, 8, 64, 512)
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.std()) - 1.0) < 0.01
    z2 = tc.read_noise_array(124, 8, 64, 512)
    corr = float((z * z2).mean() / (z.std() * z2.std()))
    assert abs(corr) < 0.01


def test_box_muller_sqrt_is_correctly_rounded():
    """The plain Box-Muller's radius is the correctly rounded f32 square
    root (what `sqrtf` gives on the card): over 2^16 draws, `box_muller`
    equals an oracle that takes the root in f64 and rounds once, the log
    and cos being the same f32 functions (`f32math`)."""
    rng = np.random.default_rng(2024)
    h = rng.integers(0, 2**32, (2, 2**16), dtype=np.uint64).astype(np.int64)
    h1, h2 = torch.from_numpy(h[0]), torch.from_numpy(h[1])
    z = tc.box_muller(h1, h2).numpy()
    u1 = ((h1 >> 8).to(torch.float32) + 1.0) * float(2 ** -24)
    u2 = (h2 >> 8).to(torch.float32) * float(2 ** -24)
    t = (-2.0 * f32math.log(u1)).numpy()
    r = np.sqrt(t.astype(np.float64)).astype(np.float32)
    c = f32math.cos(6.283185307179586 * u2).numpy()
    want = r * c
    assert z.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(z, want)
