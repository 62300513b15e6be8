"""seamless-m4t-medium [audio]: enc-dec, 12L each, d_model=1024 16H
d_ff=4096 vocab=256206.  Backbone only: the speech frontend is a stub --
input_specs provides precomputed frame embeddings (B, S_src, d).
[arXiv:2308.11596; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    enc_layers=12, dec_layers=12,
    remat="dots",
)

SMOKE = ModelConfig(
    name="seamless-m4t-smoke", family="audio",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    enc_layers=2, dec_layers=2, attn_chunk=32,
)
