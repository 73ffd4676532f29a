"""Parity of the port's noise model and fault-tolerance helpers
(`repro_torch/core/noise.py`, `repro_torch/runtime/fault_tolerance.py`)
with the JAX reference. Tolerance: exact (plain Python arithmetic)."""

import numpy as np
import pytest
import torch

from repro.core import noise as jn
from repro.runtime import fault_tolerance as jf
from repro_torch.core import noise as tn
from repro_torch.core.prng import PRNGKey
from repro_torch.runtime import fault_tolerance as tf


@pytest.mark.parametrize("kw", [
    {}, {"drift_t_ratio": 100.0}, {"drift_t_ratio": 10.0,
                                   "drift_compensate": False},
    {"drift_core_spread": 0.3, "drift_t0": 2.0}, {"enabled": False}])
def test_noise_model_methods_equal(kw):
    a, b = tn.NoiseModel(**kw), jn.NoiseModel(**kw)
    assert a.drift_gain() == b.drift_gain()
    assert a.compensation_gain() == b.compensation_gain()
    for t in (0.5, 3.0, 1e4):
        assert a.drift_gain_at(t) == b.drift_gain_at(t)
        assert a.compensation_gain_at(t) == b.compensation_gain_at(t)
    for core in range(3):
        assert a.per_core_nu(core, seed=5) == b.per_core_nu(core, seed=5)
    for rows in (1, 64, 512):
        assert tn.read_sigma_lsb(rows, a) == jn.read_sigma_lsb(rows, b)


def test_drift_only_and_unit_hash_equal():
    assert (tn.drift_only(0.1, 2.0, 0.2, True).__dict__
            == jn.drift_only(0.1, 2.0, 0.2, True).__dict__)
    for ints in ((0,), (1, 2), (7, 2**40, 3)):
        assert tn.unit_hash(*ints) == jn.unit_hash(*ints)


def test_programming_noise_level_dependent_sigma():
    codes = torch.tensor([[0.0] * 4000, [127.0] * 4000])
    key = PRNGKey(0)
    z = tn.programming_noise(key, codes, tn.NoiseModel())
    std = z.std(dim=1).numpy()
    np.testing.assert_allclose(std, [0.010 * 127, 0.025 * 127], rtol=0.05)
    assert torch.equal(tn.programming_noise(key, codes, tn.DISABLED),
                       torch.zeros_like(codes))
    seed = tn.derive_read_seed(PRNGKey(1))
    assert 0 <= seed < 2**32


@pytest.mark.parametrize("msg,exc", [
    ("UNAVAILABLE: socket closed", RuntimeError),
    ("RESOURCE_EXHAUSTED: out of memory", RuntimeError),
    ("plain bug", RuntimeError), ("disk", OSError), ("x", ValueError)])
def test_is_transient_equal(msg, exc):
    assert tf.is_transient(exc(msg)) == jf.is_transient(exc(msg))


def test_backoff_and_straggler_monitor_equal():
    assert tf.backoff_schedule(5, seed=3) == jf.backoff_schedule(5, seed=3)
    mons = (tf.StragglerMonitor(threshold=2.0), jf.StragglerMonitor(
        threshold=2.0))
    for step, dt in enumerate([1.0, 1.2, 0.9, 5.0, 1.0, 3.0, 1.1]):
        assert mons[0].record(step, dt) == mons[1].record(step, dt)
    assert mons[0].flagged == mons[1].flagged
    assert mons[0].ewma == mons[1].ewma


def test_resilient_step_retries_transient_only(tmp_path):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError("UNAVAILABLE: transient")
        return "ok"

    step = tf.resilient_step(flaky, max_retries=2, sleep=lambda s: None)
    assert step() == "ok" and len(calls) == 2
    with pytest.raises(RuntimeError):
        tf.resilient_step(lambda: (_ for _ in ()).throw(
            RuntimeError("INVALID_ARGUMENT")), sleep=lambda s: None)()
    hb = tf.Heartbeat(str(tmp_path / "hb.json"))
    hb.beat(3, slots_busy=2)
    assert hb.read()["step"] == 3 and hb.read()["slots_busy"] == 2
