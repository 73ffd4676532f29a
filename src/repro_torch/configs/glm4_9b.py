"""glm4-9b — dense decoder, RoPE, aggressive GQA (kv=2).

[hf:THUDM/glm-4-9b; hf]. 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchSpec(
    arch_id="glm4_9b",
    family="dense",
    module="transformer",
    model_cfg=TransformerConfig(
        name="glm4_9b", n_layers=40, d_model=4096, n_heads=32,
        n_kv_heads=2, d_ff=13696, vocab=151552, rope_theta=1e4),
    smoke_cfg=TransformerConfig(
        name="glm4_9b_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=160, vocab=128, q_chunk=16, kv_chunk=16),
    source="hf:THUDM/glm-4-9b; hf",
)
