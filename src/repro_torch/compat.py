"""The ambient mesh (PyTorch port of `repro/compat.py`).

The reference funnels its version-sensitive JAX API through this module.
Two of its names carry over:

  * ``use_mesh(mesh)`` — a context manager that makes ``mesh`` (a
    `launch.mesh.Mesh`) the ambient mesh for the duration of a ``with``
    block; blocks nest, and leaving one restores the mesh before it.
  * ``current_mesh()`` — the ambient mesh, or None outside any block.

Code that the reference shards through ``with_sharding_constraint`` or
``shard_map`` under the active mesh reads `current_mesh` here: the MoE
FFN's per-data-shard dispatch (`models.moe._moe_sharded`) and the STE's
per-position column pieces (`core.aimc`).

Two of the reference's names have no counterpart. ``shard_map`` runs a
function per device of an SPMD program; the port's positions run in one
process, which loops over them itself. ``cost_analysis`` reads an XLA
executable's cost model; eager PyTorch compiles no such executable.

The ambient mesh is one per process, not per thread: PyTorch runs a
CUDA backward, and with it every checkpointed block's recompute, on its
own autograd thread, and the recompute must see the mesh its forward saw.
"""

from __future__ import annotations

import contextlib

_STACK: list = []


def current_mesh():
    """The ambient mesh, or None when no `use_mesh` block is active."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh for the duration of a ``with``
    block."""
    _STACK.append(mesh)
    try:
        yield mesh
    finally:
        _STACK.pop()
