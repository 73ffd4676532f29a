"""Torch's CPU thread budget for the port's tests under pytest-xdist.

Every ``tests/test_torch_*.py`` imports this module first. Under xdist
(``PYTEST_XDIST_WORKER_COUNT`` set) each of the N workers would otherwise
run torch with one intra-op thread per CPU, N times more threads than the
machine has; each worker gets ``cpu_count // N`` (at least 1) instead. A
serial run keeps torch's default. Inter-op threads are left alone:
``torch.set_num_interop_threads`` raises once inter-op work has started.
"""

import os

import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_WORKERS)))
