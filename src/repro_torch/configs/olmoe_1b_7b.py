"""olmoe-1b-7b — 64-expert top-8 MoE.

[arXiv:2409.02060; hf]. 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8. Each expert's FFN is its own programmed
crossbar tenant; one launch of K2 over the [64, ...] expert stack runs a
projection of all 64 (`models/moe.py`).
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchSpec(
    arch_id="olmoe_1b_7b",
    family="moe",
    module="transformer",
    model_cfg=TransformerConfig(
        name="olmoe_1b_7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1024, vocab=50304, n_experts=64, top_k=8,
        rope_theta=1e4),
    smoke_cfg=TransformerConfig(
        name="olmoe_1b_7b_smoke", n_layers=2, d_model=48, n_heads=4,
        n_kv_heads=4, d_ff=32, vocab=128, n_experts=8, top_k=2,
        q_chunk=16, kv_chunk=16),
    source="arXiv:2409.02060; hf",
    microbatch=4,
)
