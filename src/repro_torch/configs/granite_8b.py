"""granite-8b (code) — llama-architecture dense decoder.

[arXiv:2405.04324; hf]. 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchSpec(
    arch_id="granite_8b",
    family="dense",
    module="transformer",
    model_cfg=TransformerConfig(
        name="granite_8b", n_layers=36, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=49152, rope_theta=1e7),
    smoke_cfg=TransformerConfig(
        name="granite_8b_smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=128, q_chunk=16, kv_chunk=16),
    source="arXiv:2405.04324; hf",
)
