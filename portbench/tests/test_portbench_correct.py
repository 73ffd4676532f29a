"""The comparison that decides `correct`, on the CPU at a size a test run
can hold: a sound run of each driver agrees with the reference within
the cell's limits; the controls (one precision step below what the
configuration states: its digital products, its crossbar codes) and
each fault planted under the timed path come out as not correct. The
harness's look for a card is skipped: the drivers run on the CPU, where
the port takes its kernels' plain versions."""

from __future__ import annotations

import pytest
import torch

from portbench.tests.tiny import serve_cell, train_cell
from portbench.harness import faults, judge, serve, train

CPU = torch.device("cpu")
SEED = 2**31 + 977


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _verdict(driver, cell, wrap=None, seconds=1.0):
    got = driver.program_side(cell, SEED, seconds, False, CPU, wrap=wrap)
    readings, _ = judge.readings_of(driver, cell, SEED, got, CPU)
    checks = judge.checks(readings, cell.limits)
    return all(c["ok"] for c in checks), readings


def test_train_window_counts_every_step_it_sent():
    cell = train_cell(noise=False)
    got = train.program_side(cell, SEED, 0.3, False, CPU)
    t = cell.traffic
    assert got["steps"] >= 1 and got["nonfinite"] == 0
    assert got["tokens"] == got["steps"] * t["global_batch"] * t["seq_len"]
    assert got["window_s"] >= 0.3


def test_train_sound_run_is_correct():
    ok, readings = _verdict(train, train_cell(), seconds=0.0)
    assert ok, readings


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_fault_is_not_correct(fault):
    ok, readings = _verdict(train, train_cell(), wrap=faults.TRAIN[fault],
                            seconds=0.0)
    assert not ok, readings


@pytest.mark.parametrize("control,number", [("fp8", "digital_gap"),
                                            ("int4", "grad_gap")])
def test_train_control_is_not_correct(control, number):
    """The reference in the program's place, on e4m3 digital products or
    int4 crossbar codes, fails the cell's limit of ``number``."""
    cell = train_cell()
    ref = train.reference_side(cell, SEED, CPU)
    ctl = train.reference_side(cell, SEED, CPU, control)
    readings = judge.train_readings(ctl, ref)
    lim = cell.limits["limits"][number]
    assert readings[number] > lim, readings


def test_train_stages_are_all_checked():
    """Every digital stage of the checked steps is checked on its inputs:
    RMSNorm, attention and each crossbar linear's backward."""
    got = train.program_side(train_cell(), SEED, 0.0, False, CPU)
    kinds = got["stages"]["digital"]
    assert set(kinds) == {"rmsnorm", "attention", "ste"}, kinds
    assert all(n > 0 and gap is not None for gap, n, _ in kinds.values())


def test_serve_sound_run_is_correct():
    ok, readings = _verdict(serve, serve_cell())
    assert ok, readings


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serve_fault_is_not_correct(fault):
    ok, readings = _verdict(serve, serve_cell(), wrap=faults.SERVE[fault])
    assert not ok, readings


def test_serve_tf32_control_is_not_correct():
    """The program with TF32 products fails the digital-gap limit that
    the program in f32 keeps."""
    cell = serve_cell()
    lim = cell.limits["limits"]["digital_gap"]
    ok, readings = _verdict(serve, cell)
    assert ok and readings["digital_gap"] <= lim, readings
    got = serve.program_side(cell, SEED, 1.0, False, CPU, tf32=True)
    readings, _ = judge.readings_of(serve, cell, SEED, got, CPU)
    assert readings["digital_gap"] > lim, readings
    assert {"logits", "attention"} <= {
        k for k, (gap, n, _) in readings["where"]["digital"].items() if n}


def test_serve_int4_control_is_not_correct():
    """The reference with int4 crossbar codes, read at every position of
    the served prompts and tokens, fails the token-gap limit that the
    program's own tokens keep."""
    cell = serve_cell()
    got = serve.program_side(cell, SEED, 1.0, False, CPU)
    out = serve.int4_readings(cell, SEED, got, CPU)
    assert out["token_gap"] > cell.limits["limits"]["token_gap"], out


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_traced_run_reads_its_per_layer_metrics(kind):
    """A ``--trace 1`` run's readers find the window and return numbers
    (on the CPU no kernel reaches the card, so the device ones read idle
    or nothing), and the run is still judged."""
    import json

    from portbench import run as bench_run
    from portbench.harness import counts
    from portbench.tests.tiny import ROOT
    driver, cell = ((train, train_cell()) if kind == "train"
                    else (serve, serve_cell()))
    got = driver.program_side(cell, SEED, 0.5, True, CPU)
    assert got["window_s"] > 0 and "trace" in got
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell.name = next(w["name"] for w in bench["workloads"]
                     if w["traffic"].startswith(kind))
    ctx = {"kind": kind, "cell": cell, "got": got,
           "peaks": counts.peaks("NVIDIA H100 80GB HBM3")}
    metrics = bench_run.per_layer(bench, cell, ctx)
    assert metrics and all(v == v and v >= 0 for v, _ in metrics.values())
    readings, _ = judge.readings_of(driver, cell, SEED, got, CPU)
    assert all(c["ok"] for c in judge.checks(readings, cell.limits))
