"""deepseek-v2-lite [moe, MLA]: 27L d_model=2048 16H vocab=102400; the
first layer dense (d_ff 10944), then 64 routed experts of width 1408 top-6
and 2 shared; latent attention with a direct query projection (q_lora_rank
null), kv_lora 512, qk_nope 128, qk_rope 64, v_head 128; YaRN RoPE (theta
1e4, factor 40 over an original 4096 positions, beta 32 / 1, mscale and
mscale_all_dim 0.707); softmax routing, top-6 gates not renormalised
(norm_topk_prob false, routed_scaling_factor 1); rms_norm_eps 1e-6.
[arXiv:2405.04434;
hf:deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json]

A port-only configuration: the reference package has no counterpart.

Departures from the published model:

* RoPE rotates halves (``layers.rope``), not DeepSeek's interleaved pairs:
  with seeded weights a fixed permutation of the rope columns of ``wq``
  and ``wkv_a``.
* Routing keeps the repository's capacity: 1.25 x the mean load per
  GShard group of ``moe_group_size`` (256) tokens, past which a choice is
  dropped (the published model drops none); at decode nothing drops.
"""
from repro_torch.models.config import ModelConfig, Yarn

_YARN = dict(rope_theta=10000.0, yarn=Yarn(factor=40.0, original_max_pos=4096, beta_fast=32.0,
                                           beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707))

CONFIG = ModelConfig(
    name="deepseek-v2-lite", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400, head_dim=128,
    attn_type="mla", q_lora_rank=0, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    num_experts=64, num_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1, moe_renormalize=False, norm_eps=1e-6,
    remat="dots", **_YARN,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    attn_type="mla", q_lora_rank=0, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    num_experts=8, num_shared_experts=1, top_k=2, moe_d_ff=48,
    first_dense_layers=1, moe_group_size=32, moe_renormalize=False, norm_eps=1e-6,
    attn_chunk=16, **_YARN,
)
