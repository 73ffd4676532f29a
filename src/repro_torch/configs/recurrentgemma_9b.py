"""recurrentgemma-9b — RG-LRU + local attention hybrid (Griffin), 2:1.

[arXiv:2402.19427; unverified]. 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, window 2048. O(1) recurrent state + a bounded window cache.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.rglru import RglruConfig

ARCH = ArchSpec(
    arch_id="recurrentgemma_9b",
    family="hybrid",
    module="rglru",
    model_cfg=RglruConfig(
        name="recurrentgemma_9b", n_layers=38, d_model=4096, n_heads=16,
        n_kv_heads=1, d_ff=12288, vocab=256000, window=2048),
    smoke_cfg=RglruConfig(
        name="recurrentgemma_9b_smoke", n_layers=5, d_model=48, n_heads=4,
        n_kv_heads=1, d_ff=96, vocab=128, window=16, conv_width=4,
        q_chunk=16, kv_chunk=16),
    source="arXiv:2402.19427; unverified",
    supports_long=True,
)
