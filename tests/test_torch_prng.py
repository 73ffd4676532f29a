"""Parity of the port's JAX-compatible keys (`repro_torch/core/prng.py`) with
`jax.random` (threefry2x32, partitionable mode, 64-bit mode off).

Tolerances: `PRNGKey`, `split`, `fold_in`, `bits` and `uniform` are
bit-exact. `normal` is within 4 ulps: it runs XLA's f32 erf_inv polynomial,
but PyTorch's `log1p` is not XLA's (measured: at most 3 ulps, on under 5%
of 2^22 draws). A draw computed in chunks equals one computed whole.
"""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 7, 123456, 2**31 + 5, 2**32 - 1]


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_pinned_vectors():
    k = prng.PRNGKey(7)
    assert k.tolist() == [0, 7]
    assert prng.split(k).tolist() == [[3625411723, 1954958720],
                                      [195045567, 4062205631]]
    assert prng.fold_in(k, 2).tolist() == [966301609, 1948237315]
    assert int(prng.bits(k)) == 2895194379


@pytest.mark.parametrize("seed", SEEDS + [-1, 2**32 + 3])
def test_prng_key_split_fold_in_bit_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for n in (1, 2, 5):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      np.asarray(jax.random.split(jk, n)))
    for data in (0, 1, 41, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(tk, data).numpy(),
            np.asarray(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (7,), (3, 5, 11), (300, 301)])
def test_bits_bit_exact(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                      jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(prng.bits(prng.PRNGKey(seed), shape).numpy(),
                                  want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.3, 7.1), (2.0, 2.5),
                                   (prng._NEXT_M1, 1.0)])
def test_uniform_bit_exact(seed, lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (4099,),
                                         jnp.float32, lo, hi))
    got = prng.uniform(prng.PRNGKey(seed), (4099,), lo, hi).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3, 2**32 - 1])
def test_normal_within_4_ulps(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1 << 17,)))
    got = prng.normal(prng.PRNGKey(seed), (1 << 17,)).numpy()
    assert np.isfinite(got).all()
    assert _ulps(got, want).max() <= 4


def test_chunked_draw_equals_whole(monkeypatch):
    key = prng.PRNGKey(11)
    whole = prng.normal(key, (3, 1000))
    bits = prng.bits(key, (3, 1000))
    monkeypatch.setitem(prng.CHUNK, "cpu", 97)
    assert torch.equal(prng.normal(key, (3, 1000)), whole)
    assert torch.equal(prng.bits(key, (3, 1000)), bits)


def test_erf_inv_edges_and_keys_must_be_pairs():
    x = torch.tensor([-1.0, 0.0, 1.0, 0.5])
    y = prng.erf_inv(x)
    assert y[0] == -float("inf") and y[2] == float("inf") and y[1] == 0.0
    np.testing.assert_allclose(float(y[3]), 0.4769362762044699, rtol=1e-6)
    with pytest.raises(ValueError):
        prng.split(prng.split(prng.PRNGKey(0), 3))
