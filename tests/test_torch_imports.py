"""Import hygiene of the port: a fresh interpreter imports every module of
`repro_torch` and the repo-root `chip_smoke.py`, and neither `jax` nor the
JAX package `repro` ends up in `sys.modules`."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_module_is_listed():
    mods = _modules()
    for must in ("repro_torch.kernels.aimc_mvm", "repro_torch.runtime.engine",
                 "repro_torch.launch.serve", "repro_torch.convert",
                 "repro_torch.core.prng", "repro_torch.core.aimclib",
                 "repro_torch.models.paper_nets",
                 "repro_torch.core.costmodel", "repro_torch.core.workloads",
                 "repro_torch.core.schedule", "repro_torch.core.coupling"):
        assert must in mods


@pytest.mark.parametrize("extra", [[], ["chip_smoke"]], ids=["package",
                                                              "chip_smoke"])
def test_fresh_interpreter_imports_no_jax(extra):
    code = ("import importlib, sys\n"
            f"for m in {_modules() + extra!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env_path = f"{ROOT / 'src'}:{ROOT}"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=env_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
