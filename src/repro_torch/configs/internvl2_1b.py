"""internvl2-1b — InternViT frontend (STUB) + InternLM2-1B LM backbone.

[arXiv:2404.16821; hf]. 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655. The vision frontend supplies 256 precomputed patch embeddings
per sample (positions [0, 256) of the sequence), per the frontend-stub rule;
the engine serves the text path with zero patch embeddings.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchSpec(
    arch_id="internvl2_1b",
    family="vlm",
    module="transformer",
    model_cfg=TransformerConfig(
        name="internvl2_1b", n_layers=24, d_model=896, n_heads=14,
        n_kv_heads=2, d_ff=4864, vocab=151655, rope_theta=1e6,
        n_patches=256),
    smoke_cfg=TransformerConfig(
        name="internvl2_1b_smoke", n_layers=2, d_model=56, n_heads=7,
        n_kv_heads=1, d_ff=112, vocab=128, n_patches=8,
        q_chunk=16, kv_chunk=16),
    source="arXiv:2404.16821; hf",
    n_patches=256,
)
