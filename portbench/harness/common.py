"""What every cell shares: the files of the benchmark, the device check,
the guard against the JAX package, keys from the run's seed, and the
result line."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]       # the checkout
BENCH = ROOT / "portbench"
T0 = time.perf_counter()                         # process start, near enough
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
M32 = 0xFFFFFFFF


class Unfit(SystemExit):
    """A run that must print no result (exit code 2)."""

    def __init__(self, msg: str):
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)
        super().__init__(2)


def use_checkout_caches() -> None:
    """Build and kernel caches of the program at fixed paths inside the
    checkout (the kernels build into ``src/repro_torch/kernels/build``
    themselves), and the port's package on the path."""
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise Unfit(f"no {path.name} at {ROOT}")
    return json.loads(path.read_text())


def data_file(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    path = BENCH / kind / f"{name}.json"
    if not path.exists():
        raise Unfit(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def require_cuda(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise Unfit("torch.cuda.is_available() is false: the benchmark "
                    "measures the card")
    if torch.cuda.device_count() < chips:
        raise Unfit(f"the cell needs {chips} card(s), "
                    f"{torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def card_info(dev) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(dev.index or 0)], capture_output=True, text=True,
            timeout=30).stdout.strip()
        info["power_limit"] = out
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unknown"
    return info


def key_words(seed: int, step: int) -> tuple[int, int]:
    """The two uint32 words of the key of ``step`` in a run of ``seed``
    (seeds past 32 bits keep their high bits in the second word)."""
    return seed & M32, (((seed >> 32) << 20) ^ step) & M32


def step_key(seed: int, step: int):
    import torch
    return torch.tensor(key_words(seed, step), dtype=torch.int64)


def gen_seed(seed: int, what: int) -> int:
    """A torch generator seed for part ``what`` of a run."""
    return (seed * 1_000_003 + what * 7919) % (1 << 63)


def result(correct: bool, attempted: int, failed: int, metrics: dict,
           device: dict, checks: list, breakdown=None) -> None:
    """The run's result: the numbers compared, each beside its limit, as
    the last lines of standard error, then one JSON line as the last line
    of standard output with the checks under the last key."""
    for c in checks:
        print(f"[check] {c['name']} = {c['value']!r} limit {c['limit']!r}"
              f" {'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed),
            "metrics": {k: {"value": v[0], "unit": v[1]}
                        for k, v in metrics.items()},
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    print(json.dumps(line), flush=True)
