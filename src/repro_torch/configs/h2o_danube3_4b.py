"""h2o-danube-3-4b [dense, SWA]: 24L d_model=3840 32H (GQA kv=8)
d_ff=10240 vocab=32000; llama+mistral mix with sliding-window attention
(window 4096).  [arXiv:2401.16818; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    d_ff=10240, vocab_size=32000, head_dim=120,
    window=4096,
    remat="dots",
)

SMOKE = ModelConfig(
    name="h2o-danube-3-4b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    window=16, attn_chunk=32,
)
