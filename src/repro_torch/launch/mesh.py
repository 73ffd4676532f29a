"""Mesh construction (PyTorch port of `repro/launch/mesh.py`).

The reference's mesh is a grid of JAX devices driven by one process. The
port's `Mesh` is a single-controller grid of *positions*, each naming a
`torch.device`: ``make_mesh(shape, axes, devices)`` folds the positions
round-robin onto the physical devices given, so ``data:2,model:2`` on a
host with one card is four positions on ``cuda:0``, and in the CPU tests
every position is ``cpu`` (the counterpart of the reference's forced
host-platform device count). The fold is never hidden: `Mesh.fold()` says
how many positions sit on which devices, and every mesh report prints it.
Code that moves a piece to its position calls ``tensor.to(device)``, a
no-op when the device is the one it is on, so a host with more cards runs
the same code.

As in the reference these are functions, never module-level constants, so
importing this module touches no device.

Axis semantics (DESIGN.md §5):
  pod    — inter-pod data parallelism
  data   — in-pod data parallel / FSDP axis
  model  — tensor parallel axis (also: MoE experts, crossbar bit lines)

`fsdp_axes` returns the axes the parameter/optimizer shards span in
addition to ``model``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of positions: ``sizes`` along ``axis_names``, and one
    `torch.device` per position in row-major order (``devices``)."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.sizes} vs axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate mesh axis in {self.axis_names}")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")
        if len(self.devices) != math.prod(self.sizes):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{math.prod(self.sizes)} positions")

    @property
    def shape(self) -> dict[str, int]:
        """axis name -> size, in axis order (the reference's
        ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    def positions(self) -> list[tuple[int, ...]]:
        """Every position's index tuple, in row-major order."""
        return list(itertools.product(*(range(s) for s in self.sizes)))

    def device_at(self, pos: Sequence[int]) -> torch.device:
        flat = 0
        for i, s in zip(pos, self.sizes):
            flat = flat * s + i
        return self.devices[flat]

    def physical_devices(self) -> list[torch.device]:
        """The distinct devices the positions fold onto, in first-use
        order."""
        return list(dict.fromkeys(self.devices))

    def fold(self) -> str:
        """How the positions sit on physical devices, e.g. "4 positions
        on 1 device (cuda:0)" or "4 positions on 2 devices (cuda:0 x2,
        cuda:1 x2)"."""
        phys = self.physical_devices()
        n = len(self.devices)
        if len(phys) == 1:
            where = str(phys[0])
        else:
            where = ", ".join(f"{d} x{self.devices.count(d)}" for d in phys)
        return (f"{n} position{'s' * (n != 1)} on {len(phys)} "
                f"device{'s' * (len(phys) != 1)} ({where})")

    def describe(self) -> str:
        axes = ",".join(f"{a}:{s}" for a, s in zip(self.axis_names,
                                                    self.sizes))
        return f"mesh {axes}: {self.fold()}"


def visible_devices(kind: str = "cuda") -> list[torch.device]:
    """The physical devices a mesh folds onto: ``"cuda"`` is every visible
    card (raises without one), ``"cpu"`` the CPU, and a single device
    (``"cuda:1"``) is itself."""
    dev = torch.device(kind)
    if dev.type != "cuda":
        return [dev]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available for the mesh (pass "
                           "cpu devices to run on the CPU)")
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` whose positions fold round-robin
    onto ``devices`` (torch devices or names; default: every visible
    card). Position i (row-major) sits on ``devices[i % len(devices)]``."""
    if devices is None:
        devices = visible_devices("cuda")
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    n = math.prod(shape)
    return Mesh(tuple(int(s) for s in shape), tuple(axes),
                tuple(devs[i % len(devs)] for i in range(n)))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def fsdp_axes(mesh) -> tuple[str, ...]:
    """Parameter-sharding (FSDP) axes = every non-'model' axis."""
    return tuple(a for a in mesh.axis_names if a != "model")


def dp_axes(mesh) -> tuple[str, ...]:
    """Batch-sharding axes (same set as FSDP for this framework)."""
    return fsdp_axes(mesh)


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return n
