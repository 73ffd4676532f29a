"""Architecture registry (PyTorch port of `repro/configs/__init__.py`).

Each ``configs/<arch>.py`` exports an ``ARCH: ArchSpec`` with the published
configuration and a reduced same-family smoke config, copied field for
field from the reference. Every arch of the reference's registry is
ported: the dense decoders (granite-8b, glm4-9b, llama3.2-3b,
qwen1.5-110b, and internvl2-1b's language backbone behind its
patch-embedding stub), the recurrent xlstm-350m and recurrentgemma-9b,
the MoE olmoe-1b-7b and arctic-480b, and the enc-dec
seamless-m4t-large-v2 (served through `launch.steps`' prefill and decode
cells only; the engine refuses the audio family, as the reference's does).

Input-shape cells (the reference's):
  train_4k     seq 4,096   global batch 256   (training)
  prefill_32k  seq 32,768  global batch 32    (inference prefill)
  decode_32k   seq 32,768  global batch 128   (one token vs KV cache)
  long_500k    seq 524,288 global batch 1     (long-context decode;
               sub-quadratic state only: rglru + xlstm)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One input shape: a training, prefill or decode batch."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    module: str                    # repro_torch.models.<module>
    model_cfg: Any
    smoke_cfg: Any
    source: str                    # provenance of the published config
    supports_long: bool = False    # long_500k: sub-quadratic archs only
    supports_decode: bool = True
    cache_dtype: str = "bfloat16"  # KV cache dtype for serving
    optimizer: str = "adamw"       # adamw | adafactor (giant models)
    param_dtype: str = "float32"   # bfloat16 for the largest models
    microbatch: int = 1            # per-data-shard microbatch (grad accum)
    # enc-dec / vlm frontend metadata
    tgt_ratio: int = 0             # enc-dec: tgt_len = seq_len // tgt_ratio
    n_patches: int = 0             # vlm: image patch positions (stub embeds)

    def model_module(self):
        return importlib.import_module(f"repro_torch.models.{self.module}")


PORTED = ("granite_8b", "glm4_9b", "llama32_3b", "qwen15_110b",
          "internvl2_1b", "xlstm_350m", "recurrentgemma_9b", "olmoe_1b_7b",
          "arctic_480b", "seamless_m4t_large_v2")
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


def cells(arch_id: str) -> list[tuple[str, str]]:
    """All (arch, shape) cells for an arch, honouring the skip rules."""
    spec = get_arch(arch_id)
    out = []
    for name, cell in SHAPES.items():
        if cell.kind == "decode" and not spec.supports_decode:
            continue
        if name == "long_500k" and not spec.supports_long:
            continue
        out.append((spec.arch_id, name))
    return out


def all_cells() -> list[tuple[str, str]]:
    return [c for a in _ARCH_IDS for c in cells(a)]
