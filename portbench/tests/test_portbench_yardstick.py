"""The benchmark's yardstick on the CPU: the FLOP, MAC and byte counters
against hand counts, the traffic generator per seed, the names and units
of BENCHMARK.json and the files each entry needs, and the modules a run
loads."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from portbench.tests.tiny import ROOT
from portbench.harness import counts, traffic

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
GRANITE = json.loads((ROOT / "portbench/configs/granite-8b.json")
                     .read_text())
OLMOE = json.loads((ROOT / "portbench/configs/olmoe-1b-7b-4l.json")
                   .read_text())


def test_token_flops_by_hand():
    c = {"hidden_size": 8, "head_dim": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 16,
         "num_hidden_layers": 3, "vocab_size": 10}
    # wq 8x8, wk/wv 8x4 each, wo 8x8; swiglu 3 x 8x16; scores 2 x 8 x ctx
    per_layer = 2 * (64 + 32 + 32 + 64) + 2 * 3 * 128 + 2 * 2 * 8 * 5
    assert counts.token_flops(c, 5) == 3 * per_layer + 2 * 8 * 10
    moe = dict(c, num_experts=4, num_experts_per_tok=2)
    per_layer = 2 * (64 + 32 + 32 + 64) + 2 * 8 * 4 + 2 * 3 * 2 * 128
    assert counts.token_flops(moe, 0) == 3 * per_layer + 2 * 8 * 10


def test_sequence_flops_sums_positions():
    c = GRANITE
    want = sum(counts.token_flops(c, p + 1) for p in range(100, 107))
    assert counts.sequence_flops(c, 100, 7) == pytest.approx(want, rel=1e-12)
    assert counts.train_step_flops(c, 2, 5) == pytest.approx(
        3 * 2 * sum(counts.token_flops(c, p + 1) for p in range(5)))


def test_olmoe_step_flops_magnitude():
    # ~0.78 GFLOP a token forward at 4 layers, 2048 positions
    per_tok = counts.train_step_flops(OLMOE, 1, 2048) / 3 / 2048
    assert 0.7e9 < per_tok < 0.85e9


def test_call_macs_and_bytes_by_hand():
    macs, nbytes = counts.k2_call((3, 1024), (2, 512, 256))
    assert macs == 3 * 1024 * 256
    assert nbytes == 3 * 1024 * 4 + 1024 * 256 + 2 * 256 * 4 + 4 + 3 * 256 * 4
    macs, nbytes = counts.expert_call((4, 5, 512), (4, 1, 512, 128))
    assert macs == 4 * 5 * 512 * 128
    assert nbytes == (4 * 5 * 512 * 4 + 4 * (512 * 128 + 128 * 4) + 16
                      + 4 * 5 * 128 * 4)
    pk = counts.peaks("NVIDIA H100 80GB HBM3")
    assert counts.bound_s(1e12, 1.0, pk) == pytest.approx(2e12 / 1.979e15)
    assert counts.bound_s(1.0, 3.35e9, pk) == pytest.approx(1e-3)


def test_serve_traffic_is_fixed_by_the_seed():
    t = json.loads((ROOT / "portbench/traffic/serve.long_prompt.json")
                   .read_text())
    a = traffic.serve_requests(t, 49152, 2**31 + 12345)
    b = traffic.serve_requests(t, 49152, 2**31 + 12345)
    c = traffic.serve_requests(t, 49152, 7)
    assert a == b and a != c and len(a) == t["backlog"]
    blk = t["prompt"]["block"]
    for i in range(0, len(a), blk):         # every block: the same sizes
        assert (sorted(len(p) for p, _ in a[i:i + blk])
                == sorted(len(p) for p, _ in c[i:i + blk]))
        assert (sorted(n for _, n in a[i:i + blk])
                == sorted(n for _, n in c[i:i + blk]))
    lens = [len(p) for p, _ in a]
    assert min(lens) >= t["prompt"]["min"] and max(lens) <= t["prompt"]["max"]
    assert all(0 < x < 49152 for p, _ in a[:4] for x in p)


def test_train_batches_are_fixed_by_the_seed():
    import torch
    t = {"global_batch": 4, "seq_len": 16}
    dev = torch.device("cpu")
    a = traffic.train_batch(t, 100, 2**33 + 5, 3, dev)
    b = traffic.train_batch(t, 100, 2**33 + 5, 3, dev)
    c = traffic.train_batch(t, 100, 2**33 + 5, 4, dev)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert len({tuple(r) for r in a["tokens"].tolist()}) == 4


def test_benchmark_names_units_and_files():
    allowed = {"command", "paths", "run_seconds", "configs", "workloads",
               "end_to_end", "per_layer"}
    assert set(BENCH) == allowed
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists()
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "portbench/limits" / f"{w['name']}.json").exists()
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").exists()
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for text in [c["why"] for c in BENCH["configs"]] + [
            w["why"] for w in BENCH["workloads"]] + [
            m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        bad = _imports(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, f"{path}: {bad}"
    ref = set()
    for path in (ROOT / "portbench/reference").glob("*.py"):
        ref |= _imports(path)
    assert "repro_torch" not in ref          # the reference is the program's
    assert "jax" not in ref                  # neither


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r];"
        "from portbench.harness import serve, train, judge, trace, readers;"
        "import repro_torch.launch.steps, repro_torch.runtime.engine;"
        "import repro_torch.core.program, repro_torch.core.schedule;"
        "from portbench.harness import common;"
        "print(common.forbidden_loaded())" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert run.returncode != 0 and run.stdout.strip() == ""
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    bare = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert bare.returncode != 0 and bare.stdout.strip() == ""
