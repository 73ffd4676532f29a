"""The port's ``serve --reprogram`` (the per-call STE path: nothing is
programmed before serving, every forward re-programs each projection)
against the JAX package's CLI with the same flag, on the granite smoke
config, ``--exec aimc``, 4 synchronized requests.

Pinned: the tokens and per-request books equal the reference CLI's and
the port's program-once run's (noise off: per-call programming is
program-once); every projection runs through `core.aimc.aimc_linear_ste`
and the engine holds no programmed state; each of the reference's four
refusals (--placement, --drift, --models, --cores) exits with the
reference's message, and the port's --fuse-gates refuses too.

The reference's CLI enters a 1x1 mesh whose axes this jax makes
``Explicit``, under which its activation constraints assert; its own
switch ``REPRO_NO_ACTSHARD`` turns them off (on one position they place
nothing). Tolerance: tokens and books equal."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import pytest

from repro.launch import serve as jserve
from repro_torch.core.program import installed_entries
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tl

ARGV = ["--arch", "granite-8b", "--smoke", "--exec", "aimc", "--requests",
        "4", "--prompt-len", "8", "--gen", "6", "--seed", "0"]


def _books(report):
    return {rid: (rec.tokens, rec.finish_reason, rec.prefill_vectors,
                  rec.decode_vectors) for rid, rec in report.records.items()}


def test_reprogram_matches_reference_cli_and_program_once(monkeypatch):
    monkeypatch.setenv("REPRO_NO_ACTSHARD", "1")
    want = jserve.main(ARGV + ["--reprogram"])
    calls = []
    real = tl.aimc_linear_ste
    monkeypatch.setattr(tl, "aimc_linear_ste",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    run = tserve.main(ARGV + ["--reprogram", "--device", "cpu"])
    assert _books(run.report) == _books(want)
    assert run.program is None and not run.engine.exe.programmed
    assert not installed_entries(run.engine.params)
    # 7 projections x 2 layers per pass
    assert len(calls) == 14 * run.engine.forward_passes > 0
    once = tserve.main(ARGV + ["--device", "cpu"])
    assert once.program is not None
    assert {r: b[0] for r, b in _books(once.report).items()} == {
        r: b[0] for r, b in _books(run.report).items()}


@pytest.mark.parametrize("extra", [
    ["--placement", "auto"], ["--drift", "0.3"],
    ["--models", "granite-8b:aimc"], ["--cores", "2"]])
def test_reprogram_refusals_match_reference(extra, capsys):
    argv = ARGV + ["--reprogram", *extra]
    msgs = []
    for parse in (jserve.parse_args, tserve.parse_args):
        with pytest.raises(SystemExit) as exc:
            parse(argv)
        assert exc.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1]
                    .split("error: ", 1)[1])
    assert msgs[0] == msgs[1] and "--reprogram" in msgs[1], msgs
    with pytest.raises(SystemExit):
        tserve.parse_args(ARGV + ["--reprogram", "--fuse-gates"])
