"""llama3.2-3b — small llama3 dense decoder with tied embeddings.

[hf:meta-llama/Llama-3.2-1B; unverified]. 28L d_model=3072 24H (GQA kv=8)
d_ff=8192 vocab=128256.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchSpec(
    arch_id="llama32_3b",
    family="dense",
    module="transformer",
    model_cfg=TransformerConfig(
        name="llama32_3b", n_layers=28, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=8192, vocab=128256, rope_theta=5e5,
        tie_embeddings=True),
    smoke_cfg=TransformerConfig(
        name="llama32_3b_smoke", n_layers=2, d_model=48, n_heads=6,
        n_kv_heads=2, d_ff=128, vocab=128, tie_embeddings=True,
        q_chunk=16, kv_chunk=16),
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)
