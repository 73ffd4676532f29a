"""qwen1.5-110b — dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]. 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064. Its int8 codes alone (~111 GB) exceed one H100, so the card
serves it at its published widths with the depth cut (chip_smoke.py).
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import TransformerConfig

ARCH = ArchSpec(
    arch_id="qwen15_110b",
    family="dense",
    module="transformer",
    model_cfg=TransformerConfig(
        name="qwen15_110b", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=49152, vocab=152064, qkv_bias=True,
        rope_theta=1e6),
    smoke_cfg=TransformerConfig(
        name="qwen15_110b_smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=192, vocab=128, qkv_bias=True,
        q_chunk=16, kv_chunk=16),
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    optimizer="adafactor",
)
