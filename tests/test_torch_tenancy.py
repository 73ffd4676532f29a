"""Parity of the port's tenant policy layer (`repro_torch/runtime/tenancy.py`)
with the JAX reference's `repro/runtime/tenancy.py`: every function on the
same inputs in both packages.

Host-only: policies, quota picks, fair shares, Jain's index, per-tenant
stats from request records, per-tenant CM_* ledgers through a real
programmed model (granite-8b's smoke config in both packages) and the mixed
Poisson trace. Tolerance: exact (the same floats, the same strings)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses
import math
import random

import jax
import numpy as np
import pytest

from repro.configs import get_arch
from repro.core import aimc as ja
from repro.core import program as jp
from repro.runtime import batcher as jb
from repro.runtime import tenancy as jt
from repro_torch.convert import params_from_numpy
from repro_torch.core import aimc as ta
from repro_torch.core import program as tp
from repro_torch.runtime import batcher as tb
from repro_torch.runtime import tenancy as tt

POLICY_ARGS = [("premium", "m1", 2.0, "fifo", 0.05, None, None),
               ("standard", "m1", 1.0, "sjf", None, 0.02, None),
               ("batch", "m2", 1.0, "fifo", None, None, 4),
               ("bulk", "m2", 0.5, "sjf", 0.5, 0.5, None)]


def _policies(mod):
    return {a[0]: mod.TenantPolicy(*a) for a in POLICY_ARGS}


def _fields(x):
    return dataclasses.astuple(x)


@pytest.mark.parametrize("args", [
    ("", "m1"), ("t", ""), ("t", "m1", 0.0), ("t", "m1", -1.0),
    ("t", "m1", 1.0, "priority"), ("t", "m1", 1.0, "fifo", None, None, 0)],
    ids=["name", "model", "weight0", "weight-", "admission", "max_pages"])
def test_policy_validation_matches_reference(args):
    with pytest.raises(ValueError) as want:
        jt.TenantPolicy(*args)
    with pytest.raises(ValueError) as got:
        tt.TenantPolicy(*args)
    assert str(got.value) == str(want.value)


def test_policies_and_fair_shares_match_reference():
    jpol, tpol = _policies(jt), _policies(tt)
    for name in jpol:
        assert _fields(tpol[name]) == _fields(jpol[name])
    for model in ("m1", "m2", "none"):
        for n in (1, 3, 4, 8):
            assert (tt.fair_shares(list(tpol.values()), model, n)
                    == jt.fair_shares(list(jpol.values()), model, n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pick_tenant_matches_reference(seed):
    """Random candidate sets and in-flight counts: the same pick; and a
    simulated admit/retire loop picks the same sequence."""
    jpol, tpol = _policies(jt), _policies(tt)
    rng = random.Random(seed)
    names = sorted(jpol)
    for _ in range(200):
        cands = rng.sample(names, rng.randint(1, len(names)))
        flight = {n: rng.randint(0, 4) for n in names if rng.random() < 0.8}
        assert (tt.pick_tenant(cands, flight, tpol)
                == jt.pick_tenant(cands, flight, jpol))
    seqs = []
    for mod, pol in ((jt, jpol), (tt, tpol)):
        flight, seq = {n: 0 for n in names}, []
        r = random.Random(seed)
        for _ in range(100):
            t = mod.pick_tenant(names, flight, pol)
            seq.append(t)
            flight[t] += 1
            if r.random() < 0.5:
                busy = [n for n in names if flight[n]]
                flight[r.choice(busy)] -= 1
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    with pytest.raises(ValueError):
        tt.pick_tenant([], {}, tpol)


@pytest.mark.parametrize("xs", [[], [0.0, 0.0], [1.0], [1.0, 1.0, 1.0],
                                [4.0, 0.0, 0.0], [1.0, 2.0, 3.5, 0.25],
                                [1e-9, 3.0]])
def test_jains_index_matches_reference(xs):
    assert tt.jains_index(xs) == jt.jains_index(xs)


def _records(mod, batcher, seed):
    """A synthetic set of request records (some prefill-only, one with no
    tokens) drawn from ``seed``."""
    rng = random.Random(seed)
    out = {}
    for rid in range(rng.randint(1, 9)):
        arrival = rng.uniform(0.0, 0.1)
        rec = batcher.RequestRecord(
            request=batcher.Request(rid=rid, prompt=(1, 2, 3),
                                    max_new=rng.randint(1, 8),
                                    arrival=arrival),
            t_admit=arrival + rng.uniform(0.0, 0.01))
        rec.t_first = rec.t_admit + rng.uniform(0.001, 0.05)
        rec.t_done = rec.t_first + rng.uniform(0.0, 0.2)
        rec.tokens = list(range(rng.randint(0, 6)))
        rec.prefill_vectors = rng.randint(1, 12)
        rec.decode_vectors = rng.choice([0, rng.randint(1, 7)])
        out[rid] = rec
    return out


def _stats_tuple(st):
    return tuple("nan" if isinstance(v, float) and math.isnan(v) else v
                 for v in dataclasses.astuple(st))


@pytest.mark.parametrize("seed", range(6))
def test_tenant_stats_match_reference(seed):
    jpol, tpol = _policies(jt), _policies(tt)
    jrec, trec = _records(jt, jb, seed), _records(tt, tb, seed)
    for name in jpol:
        for makespan in (0.0, 0.37):
            want = jt.tenant_stats(jpol[name], jrec, makespan)
            got = tt.tenant_stats(tpol[name], trec, makespan)
            assert _stats_tuple(got) == _stats_tuple(want)
            assert got.row() == want.row()
    empty = tt.tenant_stats(tpol["premium"], {}, 1.0)
    assert _stats_tuple(empty) == _stats_tuple(
        jt.tenant_stats(jpol["premium"], {}, 1.0))


@pytest.fixture(scope="module")
def programs():
    """granite-8b's smoke weights programmed in both packages."""
    spec = get_arch("granite-8b")
    jparams = spec.model_module().init(jax.random.PRNGKey(0), spec.smoke_cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return (jp.program_model(jparams, None, ja.AimcConfig()),
            tp.program_model(tparams, None, ta.AimcConfig()))


@pytest.mark.parametrize("seed", range(4))
def test_tenant_ledgers_and_reconcile_match_reference(programs, seed):
    jprog, tprog = programs
    jrec, trec = _records(jt, jb, seed), _records(tt, tb, seed)
    rng = random.Random(seed)
    tenant_of = {rid: rng.choice(["a", "b", "c"]) for rid in jrec}
    want = jt.tenant_ledgers(jprog, jrec, tenant_of)
    got = tt.tenant_ledgers(tprog, trec, tenant_of)
    assert ({t: _fields(cm) for t, cm in got.items()}
            == {t: _fields(cm) for t, cm in want.items()})
    n = sum(r.vectors for r in trec.values())
    for observed in (None, n, n + 1):
        jsum, jstatic = jt.reconcile_tenants(jprog, jrec, tenant_of, observed)
        tsum, tstatic = tt.reconcile_tenants(tprog, trec, tenant_of, observed)
        assert (_fields(tsum), _fields(tstatic)) == (_fields(jsum),
                                                     _fields(jstatic))
        assert (tsum == tstatic) == (jsum == jstatic) == (observed != n + 1)


@pytest.mark.parametrize("seed,n,rate", [(0, 8, 200.0), (3, 40, 100.0),
                                         (7, 25, 5.0)])
def test_mixed_poisson_trace_matches_reference(seed, n, rate):
    jpol, tpol = _policies(jt), _policies(tt)
    vocab_of = {"m1": 64, "m2": 16}
    kw = dict(vocab_of=vocab_of, seed=seed, prompt_len=(2, 9), max_new=(1, 5))
    want = jt.mixed_poisson_trace(list(jpol.values()), n, rate, **kw)
    got = tt.mixed_poisson_trace(list(tpol.values()), n, rate, **kw)
    assert ([(r.tenant, dataclasses.astuple(r.request)) for r in got]
            == [(r.tenant, dataclasses.astuple(r.request)) for r in want])


@pytest.mark.parametrize("pols,rate,vocab", [
    (True, 0.0, {"m1": 8, "m2": 8}), (True, 10.0, {"m1": 8}),
    (False, 10.0, {})], ids=["rate", "vocab", "empty"])
def test_mixed_poisson_trace_validation_matches_reference(pols, rate, vocab):
    with pytest.raises(ValueError) as want:
        jt.mixed_poisson_trace(list(_policies(jt).values()) if pols else [],
                               4, rate, vocab_of=vocab)
    with pytest.raises(ValueError) as got:
        tt.mixed_poisson_trace(list(_policies(tt).values()) if pols else [],
                               4, rate, vocab_of=vocab)
    assert str(got.value) == str(want.value)
