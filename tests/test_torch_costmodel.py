"""Parity of the port's cost model and paper workloads
(`repro_torch/core/costmodel.py`, `core/workloads.py`, copies of the
framework-free reference modules) with `repro/core/costmodel.py` and
`core/workloads.py`.

Tolerance: none. Every `evaluate()` result (time, energy, LLC-miss proxy,
breakdown, stage times, DRAM bytes) equals the reference's field for field
with ``==``: the two run the same float64 Python arithmetic in the same
order, so any difference is a fault of the copy."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses

import pytest

from repro.core import costmodel as jcm
from repro.core import workloads as jwl
from repro_torch.core import costmodel as tcm
from repro_torch.core import workloads as twl

SYSTEMS = ("HIGH_POWER", "LOW_POWER")


def _suites():
    out = [("mlp1024", "mlp_workloads", (1024,))]
    out += [(f"lstm{nh}", "lstm_workloads", (nh,)) for nh in (256, 512, 750)]
    out += [(f"cnn{v}", "cnn_workloads", (v,)) for v in "FMS"]
    return out


def _as_tuple(res):
    return dataclasses.astuple(res)


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("coupling", ["tight", "loose"])
@pytest.mark.parametrize("suite,builder,args", _suites(),
                         ids=[s[0] for s in _suites()])
def test_evaluate_equals_reference(suite, builder, args, coupling, system):
    jw = getattr(jwl, builder)(*args)
    tw = getattr(twl, builder)(*args)
    assert list(jw) == list(tw)
    for case in jw:
        jwork = dataclasses.replace(jw[case], coupling=coupling)
        twork = dataclasses.replace(tw[case], coupling=coupling)
        assert _as_tuple(twork) == _as_tuple(jwork), case
        rj = jcm.evaluate(jwork, getattr(jcm, system))
        rt = tcm.evaluate(twork, getattr(tcm, system))
        assert _as_tuple(rt) == _as_tuple(rj), f"{suite} {case}"


def test_speedup_and_split_workload_equal_reference():
    for builder, args in (("mlp_workloads", (1024,)),
                          ("cnn_workloads", ("M",))):
        jw, tw = getattr(jwl, builder)(*args), getattr(twl, builder)(*args)
        dig = "dig_1c" if "dig_1c" in jw else "dig"
        ana = "ana_case1" if "ana_case1" in jw else "ana"
        sj = jcm.speedup(jcm.evaluate(jw[dig], jcm.HIGH_POWER),
                         jcm.evaluate(jw[ana], jcm.HIGH_POWER))
        st = tcm.speedup(tcm.evaluate(tw[dig], tcm.HIGH_POWER),
                         tcm.evaluate(tw[ana], tcm.HIGH_POWER))
        assert st == sj
    layers = [("a", 512, 1024, 2), ("b", 1024, 256, 1), ("c", 256, 64, 3)]
    for analog in ({"a"}, {"a", "c"}, set()):
        rj = jcm.evaluate(jcm.split_workload("s", layers, analog, 512),
                          jcm.LOW_POWER)
        rt = tcm.evaluate(tcm.split_workload("s", layers, analog, 512),
                          tcm.LOW_POWER)
        assert _as_tuple(rt) == _as_tuple(rj)


def test_shared_accounting_functions_equal_reference():
    from repro.core import isa as jisa
    from repro_torch.core import isa as tisa
    for k, n, rows in ((1024, 1024, 1024), (800, 3000, 700), (363, 64, 512)):
        cj, ct = jisa.mvm_counts(k, n, rows), tisa.mvm_counts(k, n, rows)
        for coupling in ("tight", "loose"):
            assert (tcm.aimc_mvm_time(ct, tcm.LOW_POWER, coupling=coupling)
                    == jcm.aimc_mvm_time(cj, jcm.LOW_POWER,
                                         coupling=coupling))
        for fn in ("relu", "sigmoid", "tanh"):
            assert (tcm.fused_epilogue_time(n, fn, ct.dequeue, tcm.HIGH_POWER)
                    == jcm.fused_epilogue_time(n, fn, cj.dequeue,
                                               jcm.HIGH_POWER))
    assert dataclasses.astuple(tcm.CALIB) == dataclasses.astuple(jcm.CALIB)
    assert tcm.AIMC_TILE.mvm_energy_j(512, 256, 5.3) == \
        jcm.AIMC_TILE.mvm_energy_j(512, 256, 5.3)
