"""zamba2-2.7b [hybrid]: 54L d_model=2560 d_ff=10240 vocab=32000,
Mamba2 backbone (state 64) + one shared attention block (32H) applied every
6 layers on concat(hidden, embedding).  [arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    shared_attn_every=6,
    remat="dots",
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=16,
    shared_attn_every=2, attn_chunk=32,
)
