"""The port's architecture registry (`repro_torch/configs`) against the
reference's (`repro/configs`): every ported arch's published and smoke
configs equal the reference's field for field, its serving metadata
(family, module, cache dtype, patch positions, source) too, the aliases
resolve alike; every arch of the reference's registry is ported, the
enc-dec seamless-m4t-large-v2 (its training fields) included; an unknown
arch raises; the shape cells (`SHAPES`, `cells`, `all_cells`) and
`launch.modelstats`' parameter counts and MODEL_FLOPS of every (arch,
shape) equal the reference's. Tolerance: exact equality (configs and
counts are plain values; the FLOPs are the same float expressions)."""

import torch_threads  # noqa: F401  (first: torch's thread budget)

import dataclasses

import pytest

from repro import configs as jconfigs
from repro.configs import get_arch as jget
from repro.launch import modelstats as jstats
from repro_torch import configs as tconfigs
from repro_torch.launch import modelstats as tstats

PORTED = ("granite_8b", "glm4_9b", "llama32_3b", "qwen15_110b",
          "internvl2_1b", "xlstm_350m", "recurrentgemma_9b", "olmoe_1b_7b",
          "arctic_480b", "seamless_m4t_large_v2")


def test_ported_list():
    assert tuple(tconfigs.list_archs()) == PORTED
    assert set(PORTED) == set(tconfigs._ARCH_IDS)


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
                  "n_patches", "supports_long", "supports_decode"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.model_module().__name__ == f"repro_torch.models.{j.module}"


@pytest.mark.parametrize("alias,arch", [
    ("glm4-9b", "glm4_9b"), ("llama3.2-3b", "llama32_3b"),
    ("qwen1.5-110b", "qwen15_110b"), ("internvl2-1b", "internvl2_1b"),
    ("granite-8b", "granite_8b"), ("llama32-3b", "llama32_3b"),
    ("xlstm-350m", "xlstm_350m"), ("recurrentgemma-9b", "recurrentgemma_9b"),
    ("olmoe-1b-7b", "olmoe_1b_7b"), ("arctic-480b", "arctic_480b"),
    ("seamless-m4t-large-v2", "seamless_m4t_large_v2")])
def test_aliases_resolve_like_reference(alias, arch):
    assert tconfigs.get_arch(alias).arch_id == jget(alias).arch_id == arch


def test_seamless_config_equals_reference_field_for_field():
    """The enc-dec arch the port refused until its training half: published
    and smoke `EncDecConfig`s field for field (with ``hd``), the audio
    family, the encdec module, ``tgt_ratio`` 4 and the training fields the
    train step reads; an unknown arch still raises."""
    j, t = jget("seamless_m4t_large_v2"), tconfigs.get_arch(
        "seamless-m4t-large-v2")
    for which in ("model_cfg", "smoke_cfg"):
        jc, tc = getattr(j, which), getattr(t, which)
        assert type(tc).__name__ == "EncDecConfig"
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), which
        assert tc.hd == jc.hd
    for field in ("family", "module", "tgt_ratio", "optimizer",
                  "param_dtype", "microbatch", "cache_dtype", "source"):
        assert getattr(t, field) == getattr(j, field), field
    assert (t.family, t.module, t.tgt_ratio) == ("audio", "encdec", 4)
    with pytest.raises(KeyError):
        tconfigs.get_arch("no-such-arch")


def test_head_dim_overrides_d_model_split():
    cfg = dataclasses.replace(tconfigs.get_arch("glm4-9b").smoke_cfg,
                              head_dim=32)
    assert cfg.hd == 32


def test_shape_cells_defined():
    """The reference's `test_shape_cells_defined` on the port: four shapes,
    32 cells (10 archs x 4 shapes less 8 long_500k skips: only rglru and
    xlstm run it), and every cell the reference's."""
    assert set(tconfigs.SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                                    "long_500k"}
    for name, cell in tconfigs.SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(
            jconfigs.SHAPES[name])
    cells = tconfigs.all_cells()
    assert len(cells) == 32
    assert cells == jconfigs.all_cells()
    longs = [a for (a, s) in cells if s == "long_500k"]
    assert sorted(longs) == ["recurrentgemma_9b", "xlstm_350m"]
    for arch in PORTED:
        assert tconfigs.cells(arch) == jconfigs.cells(arch)


@pytest.mark.parametrize("arch", PORTED)
def test_modelstats_match_reference(arch):
    """`param_counts` (total, dense, expert, embed, active) and
    `model_flops` of each of the four shape cells equal the reference's,
    from a shape-only walk (nothing allocated)."""
    j, t = jget(arch), tconfigs.get_arch(arch)
    counts = tstats.param_counts(t)
    assert counts == jstats.param_counts(j)
    assert counts["total"] == (counts["dense"] + counts["expert"]
                               + counts["embed"])
    for name, cell in tconfigs.SHAPES.items():
        assert tstats.model_flops(t, cell) == jstats.model_flops(
            j, jconfigs.SHAPES[name]), name
