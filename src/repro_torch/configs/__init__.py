"""Architecture registry (PyTorch port of `repro/configs/__init__.py`).

Each ``configs/<arch>.py`` exports an ``ARCH: ArchSpec`` with the published
configuration and a reduced same-family smoke config. Only granite-8b is
ported; the reference's other nine architectures raise a clear error that
points at ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    module: str                    # repro_torch.models.<module>
    model_cfg: Any
    smoke_cfg: Any
    source: str                    # provenance of the published config

    def model_module(self):
        return importlib.import_module(f"repro_torch.models.{self.module}")


PORTED = ("granite_8b",)
# the reference's registry; everything not in PORTED is later work
_ARCH_IDS = (
    "internvl2_1b", "granite_8b", "llama32_3b", "qwen15_110b", "glm4_9b",
    "arctic_480b", "olmoe_1b_7b", "recurrentgemma_9b", "xlstm_350m",
    "seamless_m4t_large_v2",
)
ALIASES = {i.replace("_", "-"): i for i in _ARCH_IDS}
ALIASES |= {"internvl2-1b": "internvl2_1b", "llama3.2-3b": "llama32_3b",
            "qwen1.5-110b": "qwen15_110b", "olmoe-1b-7b": "olmoe_1b_7b",
            "seamless-m4t-large-v2": "seamless_m4t_large_v2"}


def list_archs() -> list[str]:
    return list(PORTED)


def get_arch(arch_id: str) -> ArchSpec:
    key = ALIASES.get(arch_id, arch_id)
    if key not in _ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_ARCH_IDS)}")
    if key not in PORTED:
        raise NotImplementedError(
            f"arch {key!r} is not ported to PyTorch yet (ported: "
            f"{list(PORTED)}); ROADMAP.md queues the rest of the zoo")
    return importlib.import_module(f"repro_torch.configs.{key}").ARCH
