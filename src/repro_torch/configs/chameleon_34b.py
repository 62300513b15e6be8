"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early-fusion -- image VQ tokens share the text vocabulary, so
the backbone is a plain decoder and the modality frontend (VQ tokenizer) is
a stub: input_specs supplies interleaved text+image token ids.
[arXiv:2405.09818; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536, head_dim=128,
    remat="dots",
)

SMOKE = ModelConfig(
    name="chameleon-34b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=512, head_dim=16, attn_chunk=32,
)
