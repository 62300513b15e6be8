"""deepseek-moe-16b [moe]: 28L d_model=2048 16H d_ff(expert)=1408
vocab=102400; 2 shared + 64 routed experts top-6, fine-grained; first layer
dense (d_ff 10944).  [arXiv:2401.06066; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400, head_dim=128,
    num_experts=64, num_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1,
    remat="dots",
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    num_experts=8, num_shared_experts=1, top_k=2, moe_d_ff=48,
    first_dense_layers=1, moe_group_size=32, attn_chunk=32,
)
