"""arctic-480b — 128-expert top-2 MoE with dense residual FFN.

[hf:Snowflake/snowflake-arctic-base; hf]. 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2 + dense residual. One layer is
14.07e9 f32 parameters (56.3 GB) plus 13.8 GB of int8 codes once
programmed, so one card serves it at its published widths with the depth
cut to one layer (chip_smoke.py; two layers need ~84 GB of f32 alone).
Serving draws f32 weights, as the reference's serving path does; the
reference's bf16 training init belongs to the training slice.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchSpec(
    arch_id="arctic_480b",
    family="moe",
    module="transformer",
    model_cfg=TransformerConfig(
        name="arctic_480b", n_layers=35, d_model=7168, n_heads=56,
        n_kv_heads=8, d_ff=4864, vocab=32000, n_experts=128, top_k=2,
        moe_dense_residual=True, moe_dense_ff=4864, rope_theta=1e6),
    smoke_cfg=TransformerConfig(
        name="arctic_480b_smoke", n_layers=2, d_model=56, n_heads=7,
        n_kv_heads=1, d_ff=64, vocab=128, n_experts=8, top_k=2,
        moe_dense_residual=True, moe_dense_ff=64, q_chunk=16, kv_chunk=16),
    source="hf:Snowflake/snowflake-arctic-base; hf",
    optimizer="adafactor",
    param_dtype="bfloat16",
    microbatch=2,
)
