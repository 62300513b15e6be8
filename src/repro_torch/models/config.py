"""Model configuration (the port's own copy of ``repro.models.config``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN RoPE as DeepSeek-V2 defines it (``layers.rope``): the scaling
    ``factor`` over ``original_max_pos`` positions, the correction range's
    ``beta_fast`` / ``beta_slow`` and the two mscales."""
    factor: float
    original_max_pos: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # attention flavour
    attn_type: str = "gqa"       # gqa | mla | none
    window: int = 0              # sliding-window size (0 = full)
    rope_theta: float = 10000.0
    attn_impl: str = "xla"       # xla (chunked masked einsum) | flash (K2, CUDA, uncached)
    attn_chunk: int = 1024       # q-chunk for the xla impl
    yarn: Optional[Yarn] = None  # None: plain RoPE; a dict is read as a Yarn

    # MLA (minicpm3; DeepSeek-V2-Lite with q_lora_rank 0: a direct query
    # projection ``wq``, no query norm)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # deepseek-moe: leading dense layers
    moe_group_size: int = 256    # GShard routing-group size
    moe_renormalize: bool = True  # False: the top-k probabilities as gates (DeepSeek-V2)

    # SSM / hybrid / xlstm
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    block_pattern: Tuple[str, ...] = ()   # e.g. ("m","m","m","s") per group
    shared_attn_every: int = 0            # zamba2: shared attn period

    # encoder-decoder (seamless)
    enc_layers: int = 0
    dec_layers: int = 0

    # numerics / memory
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: str = "none"          # none | full | dots
    tie_embeddings: bool = False
    attn_probs_dtype: str = "fp32"   # fp32 | bf16: P matrix of softmax(QK)V
    gate_dtype: str = "fp32"         # fp32 | bf16: SSD/mLSTM decay matrices

    # distribution
    matmul_strategy: str = "xla"  # xla | auto | ring_ag | ring_rs

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if isinstance(self.yarn, dict):
            object.__setattr__(self, "yarn", Yarn(**self.yarn))

    @property
    def group_size(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def param_count(self) -> int:
        """Total parameters (exact for the implemented modules)."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += d * v  # lm head
        n += d  # final norm
        per_layer = self._per_layer_params()
        n += per_layer
        if self.family == "audio":
            pass  # enc/dec accounted inside _per_layer_params
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts only)."""
        if self.num_experts == 0:
            return self.param_count()
        d = self.d_model
        expert = 3 * d * self.moe_d_ff
        inactive = (self.num_experts - self.top_k) * expert
        moe_layers = self.num_layers - self.first_dense_layers
        return self.param_count() - inactive * moe_layers

    def _attn_params(self) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        if self.attn_type == "mla":
            qr, kvr = self.q_lora_rank, self.kv_lora_rank
            nope, rope, vh = self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim
            if qr:
                n = d * qr + qr * h * (nope + rope) + qr  # q down+up, q norm
            else:
                n = d * h * (nope + rope)                  # direct q
            n += d * (kvr + rope)                          # kv down (+ shared rope k)
            n += kvr * h * (nope + vh)                     # kv up
            n += h * vh * d                                # o proj
            n += kvr                                       # kv norm
            return n
        return d * h * hd + 2 * d * kv * hd + h * hd * d  # q, k, v, o

    def _mlp_params(self, ff: int) -> int:
        return 3 * self.d_model * ff

    def _per_layer_params(self) -> int:
        d = self.d_model
        if self.family in ("dense", "vlm"):
            per = self._attn_params() + self._mlp_params(self.d_ff) + 2 * d
            return per * self.num_layers
        if self.family == "moe":
            expert = 3 * d * self.moe_d_ff
            moe = (self.num_experts + self.num_shared_experts) * expert
            moe += d * self.num_experts  # router
            per_moe = self._attn_params() + moe + 2 * d
            per_dense = self._attn_params() + self._mlp_params(self.d_ff) + 2 * d
            nd = self.first_dense_layers
            return per_dense * nd + per_moe * (self.num_layers - nd)
        if self.family == "audio":
            enc = (self._attn_params() + self._mlp_params(self.d_ff) + 2 * d)
            dec = (2 * self._attn_params() + self._mlp_params(self.d_ff) + 3 * d)
            return enc * self.enc_layers + dec * self.dec_layers
        if self.family == "ssm":  # xlstm: mLSTM + sLSTM mix
            # approximation using the mLSTM block shape for both
            hd = d // self.num_heads
            m = 3 * d * d + d * d + self._mlp_params(self.d_ff) if self.d_ff else 4 * d * d + 2 * d
            return m * self.num_layers
        if self.family == "hybrid":  # zamba2: mamba-only blocks + one shared
            din = self.ssm_expand * d
            nheads = din // self.ssm_headdim
            conv_ch = din + 2 * self.ssm_state
            mamba = (d * (2 * din + 2 * self.ssm_state + nheads)  # in_proj
                     + conv_ch * self.conv_kernel + conv_ch       # conv w+b
                     + 3 * nheads                                  # A, D, dt_bias
                     + din * d + din)                              # out_proj, norm
            per = mamba + d  # + block norm; no per-layer MLP in zamba blocks
            total = per * self.num_layers
            if self.shared_attn_every:
                total += (self._attn_params() + self._mlp_params(self.d_ff)
                          + 2 * d                # shared block norms
                          + 2 * d * d)           # concat down-projection
            return total
        raise ValueError(self.family)


# the fields the reference's ModelConfig lacks: DeepSeek-V2's YaRN and gates
PORT_ONLY_FIELDS = ("yarn", "moe_renormalize")


def port_only_defaults() -> dict:
    """Each of ``PORT_ONLY_FIELDS`` at its default, the reference's
    behaviour: plain RoPE, renormalised gates."""
    return {f.name: f.default for f in dataclasses.fields(ModelConfig)
            if f.name in PORT_ONLY_FIELDS}
