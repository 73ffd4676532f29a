"""Parity of the port's noise draws (`repro_torch/core/noise.py`) with the
JAX reference on the same keys, and of the "hw" read-noise generator's
plain version (`repro_torch/kernels/ref.py`, Philox4x32-10) with the
published algorithm.

Tolerances: `derive_read_seed` is exact (threefry bits); programming and
read noise are bit-exact (sigma times `prng.normal`, see
tests/test_torch_prng.py); the Philox words equal Random123's known-answer
vectors exactly; the "hw" Gaussians are held to their moments (mean within
4/sqrt(n), std within 1%, |lag-1 correlation| < 0.01).
"""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as jn
from repro_torch.core import noise as tn
from repro_torch.core import prng
from repro_torch.kernels import ref

# Random123 kat_vectors, philox4x32 with 10 rounds: (ctr, key) -> out
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("seed", [0, 1, 42, 2**32 - 1])
def test_derive_read_seed_exact(seed):
    for fold in (0, 3):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
        tk = prng.fold_in(prng.PRNGKey(seed), fold)
        assert tn.derive_read_seed(tk) == int(jn.derive_read_seed(jk))


@pytest.mark.parametrize("seed", [0, 9])
def test_programming_noise_bit_exact(seed):
    """Equal to the reference's draw bit for bit."""
    codes = np.random.default_rng(seed).integers(
        -127, 128, (3, 64, 256)).astype(np.float32)
    nm_j, nm_t = jn.NoiseModel(), tn.NoiseModel()
    want = jn.programming_noise(jax.random.PRNGKey(seed), jnp.asarray(codes),
                                nm_j)
    got = tn.programming_noise(prng.PRNGKey(seed), torch.from_numpy(codes),
                               nm_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows", [64, 512])
def test_read_noise_bit_exact(rows):
    """Equal to the reference's draw bit for bit."""
    nm_j = jn.NoiseModel(sigma_read=0.003)
    nm_t = tn.NoiseModel(sigma_read=0.003)
    shape = (2, 5, 384)
    want = jn.read_noise(jax.random.PRNGKey(rows), shape, rows, nm_j)
    got = tn.read_noise(prng.PRNGKey(rows), shape, rows, nm_t)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    off = tn.read_noise(prng.PRNGKey(0), shape, rows, tn.DISABLED)
    assert torch.equal(off, torch.zeros(shape))


@pytest.mark.parametrize("ctr,key,out", PHILOX_KAT)
def test_philox_known_answers(ctr, key, out):
    assert ref.philox4x32(ctr, key) == out
    words = ref.philox4x32(tuple(torch.tensor([c], dtype=torch.int64)
                                 for c in ctr), key)
    assert tuple(int(w) for w in words) == out


def test_philox_noise_is_addressed_by_logical_element():
    full = ref.philox_read_noise_array(5, 2, 7, 256)
    assert torch.equal(ref.philox_read_noise_array(5, 2, 3, 256), full[:, :3])
    w = ref.philox4x32((3, 50, 0, 0), (5, 1))   # row 3, columns 100 and 101
    pair = torch.tensor([[w[0], w[2]], [w[1], w[3]]], dtype=torch.int64)
    from repro_torch.kernels import cprng
    assert torch.equal(full[1, 3, 100:102], cprng.box_muller(pair[0], pair[1]))
    assert not torch.equal(ref.philox_read_noise_array(6, 2, 7, 256), full)


def test_philox_noise_moments():
    z = ref.philox_read_noise_array(0x5EED, 4, 256, 1024).double().flatten()
    n = z.numel()
    assert abs(float(z.mean())) < 4.0 / n ** 0.5
    assert abs(float(z.std()) - 1.0) < 0.01
    lag1 = float(torch.corrcoef(torch.stack([z[:-1], z[1:]]))[0, 1])
    assert abs(lag1) < 0.01
