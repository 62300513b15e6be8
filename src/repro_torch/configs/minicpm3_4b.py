"""minicpm3-4b [dense, MLA]: 62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA latent attention: q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32,
v_head 64.  [hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448, head_dim=64,
    attn_type="mla", q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    remat="dots",
)

SMOKE = ModelConfig(
    name="minicpm3-4b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    attn_type="mla", q_lora_rank=32, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, attn_chunk=32,
)
