"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152.  [arXiv:2405.04324; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    remat="dots",
)

SMOKE = ModelConfig(
    name="granite-20b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=192, vocab_size=256, head_dim=16, attn_chunk=32,
)
