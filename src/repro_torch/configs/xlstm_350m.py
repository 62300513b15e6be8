"""xlstm-350m [ssm]: 24L d_model=1024 4H vocab=50304; sLSTM + mLSTM blocks
(pattern mmm-s), no FFN.  [arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=256,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ssm_chunk=256, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke", family="ssm",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=256, head_dim=16,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ssm_chunk=16, tie_embeddings=True,
)
