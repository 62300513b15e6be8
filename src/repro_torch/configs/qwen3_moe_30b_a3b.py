"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768
vocab=151936; 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    num_experts=128, top_k=8, moe_d_ff=768,
    remat="dots",
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=96, vocab_size=256, head_dim=16,
    num_experts=8, top_k=2, moe_d_ff=96, moe_group_size=32, attn_chunk=32,
)
