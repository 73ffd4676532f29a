"""The port's admission policy (`ServeEngine(admission=...)`,
`launch.serve --admission`) against the JAX engine's: one ragged Poisson
trace on the granite-8b smoke config (weights carried across with
`params_from_numpy`), 2 slots for 8 requests, digital, served under sjf
and fifo by both engines.

Pinned: the admission order (requests sorted by their admission clock),
and per request the tokens, finish reason and vector books, are the JAX
engine's; sjf reorders this trace (so the test can tell the policies
apart); the CLI flag reaches the engine.

Tolerance: exact (orders, tokens and integer books). The trace arrives
within microseconds, so after the first admission every request is ready
and the order depends only on the policy and on when slots free, which the
(equal) tokens decide."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch
from repro.models.layers import Execution as JExe
from repro.runtime import batcher as jb
from repro.runtime.engine import ServeEngine as JEngine
from repro_torch.configs import get_arch as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models.layers import Execution as TExe
from repro_torch.runtime import batcher as tb
from repro_torch.runtime.engine import ServeEngine as TEngine

SPEC = get_arch("granite-8b")
CFG = SPEC.smoke_cfg
N_REQ, PROMPT, GEN, SLOTS = 8, 8, 7, 2


def _trace(module=jb):
    return module.poisson_trace(N_REQ, 1e7, seed=3,
                                prompt_len=(PROMPT // 2, PROMPT),
                                max_new=(1, GEN), vocab=CFG.vocab)


@pytest.fixture(scope="module")
def weights():
    return SPEC.model_module().init(jax.random.PRNGKey(0), CFG)


def _order(report):
    return [rid for rid, _ in sorted(report.records.items(),
                                     key=lambda kv: kv[1].t_admit)]


def _books(rec):
    return (rec.tokens, rec.finish_reason, rec.prefill_vectors,
            rec.decode_vectors, rec.pad_vectors)


@pytest.mark.parametrize("policy", ["sjf", "fifo"])
def test_admission_matches_reference(weights, policy):
    jeng = JEngine(SPEC.model_module(), CFG, JExe(compute_dtype="float32"),
                   weights, n_slots=SLOTS, prompt_pad=PROMPT,
                   max_seq=PROMPT + GEN, cache_dtype=jnp.float32,
                   admission=policy)
    jeng.warmup()
    rep_j = jeng.serve(_trace())
    tm = tget("granite-8b")
    teng = TEngine(tm.model_module(), tm.smoke_cfg,
                   TExe(compute_dtype="float32"),
                   params_from_numpy(jax.tree.map(np.asarray, weights)),
                   n_slots=SLOTS, prompt_pad=PROMPT, max_seq=PROMPT + GEN,
                   admission=policy)
    teng.warmup()
    rep_t = teng.serve(_trace(tb))
    assert teng.admission == policy
    assert _order(rep_t) == _order(rep_j)
    for rid, rec in rep_j.records.items():
        assert _books(rep_t.records[rid]) == _books(rec), f"request {rid}"
    arrival = [r.rid for r in sorted(_trace(tb), key=lambda r: r.arrival)]
    assert (_order(rep_t) != arrival) == (policy == "sjf")


def test_serve_cli_admission_flag(weights, tmp_path):
    from repro_torch.convert import flatten_to_numpy
    path = tmp_path / "granite_smoke.npz"
    np.savez(path, **flatten_to_numpy(jax.tree.map(np.asarray, weights)))
    argv = ["--arch", "granite-8b", "--smoke", "--requests", str(N_REQ),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--slots",
            str(SLOTS), "--trace", "poisson:1e7", "--seed", "3", "--device",
            "cpu", "--weights", str(path)]
    runs = {p: tserve.main(argv + ["--admission", p]) for p in ("fifo", "sjf")}
    assert runs["sjf"].engine.admission == "sjf"
    assert runs["fifo"].engine.admission == "fifo"
    assert _order(runs["sjf"].report) != _order(runs["fifo"].report)
    with pytest.raises(SystemExit):
        tserve.parse_args(["--admission", "lifo"])
