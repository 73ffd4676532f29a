"""Tight vs loose coupling in the port (`repro_torch/core/coupling.py`)
against the JAX reference (`repro/core/coupling.py`) on the CPU.

Tolerances: at the reference's four shapes (`tests/test_coupling.py:17-22`)
the port's `tight_forward` equals its `loose_forward` within atol 1e-5 (the
reference's bar), and each equals the reference's within the
kernel-vs-oracle atol 1e-5 * max(1, max|y|). The byte counts are integers
and are pinned exactly."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coupling as jc
from repro.core.aimc import AimcConfig as JConfig
from repro.core.aimc import program_linear as jprogram
from repro_torch.core import coupling as tc
from repro_torch.core.aimc import AimcConfig as TConfig
from repro_torch.core.aimc import program_linear as tprogram

SHAPES = [(256, 128, 256, 8), (300, 200, 128, 16), (1024, 512, 512, 4),
          (700, 130, 512, 1)]


def _inputs(k, n, batch, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((batch, k)).astype(np.float32)
    return w, x


def _close(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= atol


@pytest.mark.parametrize("k,n,tile_rows,batch", SHAPES)
def test_tight_equals_loose_and_reference(k, n, tile_rows, batch):
    w, x = _inputs(k, n, batch)
    jcfg = JConfig(tile_rows=tile_rows, impl="ref")
    tcfg = TConfig(tile_rows=tile_rows)
    jst = jprogram(jnp.asarray(w), jcfg)
    tst = tprogram(torch.from_numpy(w), tcfg)
    xt = torch.from_numpy(x)
    y_t = tc.tight_forward(tst, xt, tcfg)
    y_l = tc.loose_forward(tst, xt, tcfg)
    assert tuple(y_t.shape) == (batch, n)
    _close(y_t.numpy(), y_l.numpy(), 1e-5)
    y_jt = jc.tight_forward(jst, jnp.asarray(x), jcfg)
    y_jl = jc.loose_forward(jst, jnp.asarray(x), jcfg)
    bar = 1e-5 * max(1.0, float(np.abs(np.asarray(y_jt)).max()))
    _close(y_t.numpy(), y_jt, bar)
    _close(y_l.numpy(), y_jl, bar)


def test_loose_mac_is_exact_at_full_scale_codes():
    """Worst-case bit lines (every code +-127, M = 1024): the staged MAC's
    f64 product holds every partial sum exactly, so loose == tight."""
    k = n = 1024
    tcfg = TConfig(tile_rows=1024, adc_alpha=32.0)
    st = tprogram(torch.full((k, n), 0.5), tcfg)
    x = torch.ones((2, k))
    x[1, ::2] = -1.0
    y_t = tc.tight_forward(st, x, tcfg)
    assert torch.equal(y_t, tc.loose_forward(st, x, tcfg))
    assert float(y_t[0].abs().min()) > 0.0


def test_byte_counts_at_the_reference_canonical_shape():
    """The port's own loose/tight ratio at the reference's canonical shape
    (1024 x 1024, tile 512, B 128), with the plan the launcher takes there
    on a 132-SM H100 (16 rows per block: ceil(128/64) x 8 column blocks =
    16 tiles < 132 SMs; unsplit: 8 * B > M). It is 0.614, not the
    reference's 3.49: the tight kernel requests each weight panel once per
    16-row block of the batch (eight times, L2 hits included), while the
    staged path's own counts take w_q once and its intermediates, f32 and
    int32 [KB, B, Np], cost less than those re-reads. At B 1 both request
    the panel once and the ratio is 1.008."""
    st = tprogram(torch.full((1024, 1024), 0.02), TConfig(tile_rows=512))
    tight = tc.hbm_bytes_tight(st, 128, rows_per_block=16, split=False)
    loose = tc.hbm_bytes_loose(st, 128)
    assert (tight, loose) == (10682368, 6561792)
    assert round(loose / tight, 4) == 0.6143
    tight1 = tc.hbm_bytes_tight(st, 1, rows_per_block=16, split=True)
    assert (tight1, tc.hbm_bytes_loose(st, 1)) == (1090560, 1099776)


def test_byte_count_terms():
    """Each term of the tight count, at a shape where each is visible."""
    st = tprogram(torch.zeros((700, 130)), TConfig(tile_rows=512))
    kb, m, np_ = st.w_q.shape
    assert (kb, m, np_) == (2, 512, 256)
    base = tc.hbm_bytes_tight(st, 4, rows_per_block=16, split=False)
    split = tc.hbm_bytes_tight(st, 4, rows_per_block=16, split=True)
    assert split - base == 2 * kb * 4 * np_ * 4      # scratch out and back
    wide = tc.hbm_bytes_tight(st, 20, rows_per_block=16, split=False)
    one = tc.hbm_bytes_tight(st, 20, rows_per_block=64, split=False)
    assert wide - one == kb * m * np_ + kb * np_ * 4  # one more panel read
    m700 = tprogram(torch.zeros((700, 128)), TConfig(tile_rows=700))
    # codes rows pad 700 -> 768: written once, read by the one column block
    assert tc.hbm_bytes_tight(m700, 1, rows_per_block=16, split=False) == (
        700 * 4 + 768 + 768 + 700 * 128 + 128 * 4 + 128 * 4)
