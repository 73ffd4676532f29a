"""The port's recurrent serving CLI (`repro_torch.launch.serve` on
``--device cpu``) on the xlstm-350m and recurrentgemma-9b smoke configs,
against the JAX package's CLI (`repro.launch.serve.main`) with the same
arguments: weights from ``--seed`` on JAX's keys, programmed, synchronized
arrivals.

Pinned: the engine's and ``--static``'s tokens and per-request books equal
the reference CLI's; the snapshot-paged CLI (``--page-size 2
--prefix-cache --shared-prefix 4 --paged-verify``) emits the dense CLI's
tokens with the reference's hits; xlstm's ``--fuse-gates`` emits the
unfused tokens through K3's stacks, rglru refuses it (no gate stacks);
``--static`` refuses traces, paging and chunked decode; ``--layers`` keeps
rglru's unit structure.

Tolerance: tokens equal; vector books equal (integers)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses

import numpy as np
import pytest

from repro.launch import serve as jserve
from repro_torch.configs import get_arch
from repro_torch.launch import serve as tserve

ARCHS = ("xlstm-350m", "recurrentgemma-9b")


def _books(rec):
    return (rec.tokens, rec.finish_reason, rec.prefill_vectors,
            rec.decode_vectors, rec.pad_vectors)


def _same_records(rep_t, rep_j):
    assert set(rep_t.records) == set(rep_j.records)
    for rid, rec in rep_j.records.items():
        assert _books(rep_t.records[rid]) == _books(rec), f"request {rid}"


def _cli(arch, *extra):
    return ["--arch", arch, "--smoke", "--exec", "aimc", "--requests", "3",
            "--prompt-len", "6", "--gen", "4", "--seed", "0", *extra]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_matches_reference_cli(arch):
    """The engine and --static emit the reference CLI's tokens and books;
    the snapshot-paged CLI emits the dense one's tokens, each follower
    restoring the 4-token shared prefix (the reference's rule; the engine
    test holds these books to the JAX engine's). (Engine and --static
    differ from each other here: the CLI's DAC scale is dynamic, and
    --static prefills the whole batch in one call.)"""
    rj = jserve.main(_cli(arch))
    rt = tserve.main(_cli(arch, "--device", "cpu", "--shared-prefix", "4"))
    rp = tserve.main(_cli(arch, "--device", "cpu", "--shared-prefix", "4",
                          "--page-size", "2", "--prefix-cache",
                          "--paged-verify"))
    for r in rt.requests:
        assert rp.report.tokens(r.rid) == rt.report.tokens(r.rid)
    assert rp.report.prefix_hits == 2
    assert rp.report.prefix_hit_vectors == 2 * 4
    rt = tserve.main(_cli(arch, "--device", "cpu"))
    _same_records(rt.report, rj)
    gj = jserve.main(_cli(arch, "--static"))
    st = tserve.main(_cli(arch, "--device", "cpu", "--static"))
    assert st.report is None and st.engine is None
    np.testing.assert_array_equal(st.static_tokens.numpy(), np.asarray(gj))


def test_serve_main_fuse_gates_and_refusals():
    """xlstm's --fuse-gates serves the unfused tokens through K3's stacks
    (w_ug, w_qkv, w_ff_gu); rglru has no gate stacks and refuses; --static
    refuses traces, paging and chunked decode, as the reference does."""
    un = tserve.main(_cli("xlstm-350m", "--device", "cpu"))
    fu = tserve.main(_cli("xlstm-350m", "--device", "cpu", "--fuse-gates"))
    assert "w_qkv" in fu.engine.params["pairs"]["mlstm"]
    for r in un.requests:
        assert fu.report.tokens(r.rid) == un.report.tokens(r.rid)
    with pytest.raises(SystemExit, match="no gate stacks"):
        tserve.main(_cli("recurrentgemma-9b", "--device", "cpu",
                         "--fuse-gates"))
    for extra in (("--trace", "poisson:100"), ("--page-size", "2"),
                  ("--decode-chunk", "2")):
        with pytest.raises(SystemExit):
            tserve.parse_args(_cli("xlstm-350m", "--static", *extra))


def test_layers_cut_keeps_unit_structure():
    """--layers N on rglru serves N // 3 units and N % 3 tail blocks."""
    run = tserve.main(_cli("recurrentgemma-9b", "--device", "cpu",
                           "--layers", "4"))
    cfg = run.engine.cfg
    assert (cfg.n_units, cfg.n_tail) == (1, 1)
    assert "tail" in run.engine.params
    assert dataclasses.replace(cfg, n_layers=5) == \
        get_arch("recurrentgemma-9b").smoke_cfg
    assert run.report.observed_vectors == run.report.useful_vectors
