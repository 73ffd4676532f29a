"""The port's architecture registry (`repro_torch/configs`) against the
reference's (`repro/configs`): every ported arch's published and smoke
configs equal the reference's field for field, its serving metadata
(family, module, cache dtype, patch positions, source) too, the aliases
resolve alike, and the architectures that are not ported raise a clear
error. Tolerance: exact equality (configs are plain values)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses

import pytest

from repro.configs import get_arch as jget
from repro_torch import configs as tconfigs

PORTED = ("granite_8b", "glm4_9b", "llama32_3b", "qwen15_110b",
          "internvl2_1b", "xlstm_350m", "recurrentgemma_9b", "olmoe_1b_7b",
          "arctic_480b")
UNPORTED = ("seamless_m4t_large_v2",)


def test_ported_list():
    assert tuple(tconfigs.list_archs()) == PORTED
    assert set(PORTED) | set(UNPORTED) == set(tconfigs._ARCH_IDS)


@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_reference_field_for_field(arch):
    j, t = jget(arch), tconfigs.get_arch(arch)
    for which in ("model_cfg", "smoke_cfg"):
        jc, tc = getattr(j, which), getattr(t, which)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), which
        # derived widths too (hd, n_units, d_ff_s, ...): every property
        props = [n for n in dir(type(jc))
                 if isinstance(getattr(type(jc), n), property)]
        assert props and props == [
            n for n in dir(type(tc))
            if isinstance(getattr(type(tc), n), property)]
        for name in props:
            assert getattr(tc, name) == getattr(jc, name), (which, name)
        assert getattr(tc, "is_moe", False) is (j.family == "moe")
    for field in ("arch_id", "family", "module", "source", "cache_dtype",
                  "n_patches"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.model_module().__name__ == f"repro_torch.models.{j.module}"


@pytest.mark.parametrize("alias,arch", [
    ("glm4-9b", "glm4_9b"), ("llama3.2-3b", "llama32_3b"),
    ("qwen1.5-110b", "qwen15_110b"), ("internvl2-1b", "internvl2_1b"),
    ("granite-8b", "granite_8b"), ("llama32-3b", "llama32_3b"),
    ("xlstm-350m", "xlstm_350m"), ("recurrentgemma-9b", "recurrentgemma_9b"),
    ("olmoe-1b-7b", "olmoe_1b_7b"), ("arctic-480b", "arctic_480b")])
def test_aliases_resolve_like_reference(alias, arch):
    assert tconfigs.get_arch(alias).arch_id == jget(alias).arch_id == arch


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tconfigs.get_arch(arch)
    with pytest.raises(NotImplementedError):
        tconfigs.get_arch(arch.replace("_", "-"))


def test_head_dim_overrides_d_model_split():
    cfg = dataclasses.replace(tconfigs.get_arch("glm4-9b").smoke_cfg,
                              head_dim=32)
    assert cfg.hd == 32
