"""seamless-m4t-large-v2 — encoder-decoder multimodal transformer backbone.

[arXiv:2308.11596; hf]. 24(+24)L d_model=1024 16H d_ff=8192 vocab=256206.
Audio frontend is a STUB: precomputed frame embeddings feed the encoder.
Shape policy (the reference's DESIGN.md §4): train/prefill cells use
seq_len encoder frames and seq_len/4 decoder tokens; decode cells use a
seq_len decoder cache with cross-attention K/V from seq_len/4 encoder
frames.
"""
from repro_torch.configs import ArchSpec
from repro_torch.models.encdec import EncDecConfig

ARCH = ArchSpec(
    arch_id="seamless_m4t_large_v2",
    family="audio",
    module="encdec",
    model_cfg=EncDecConfig(
        name="seamless_m4t_large_v2", n_enc_layers=24, n_dec_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192, vocab=256206),
    smoke_cfg=EncDecConfig(
        name="seamless_smoke", n_enc_layers=2, n_dec_layers=2, d_model=32,
        n_heads=4, n_kv_heads=4, d_ff=64, vocab=128, q_chunk=16, kv_chunk=16),
    source="arXiv:2308.11596; hf",
    tgt_ratio=4,
)
