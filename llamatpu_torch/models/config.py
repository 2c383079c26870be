"""Model family configs: the port's own copy of the JAX package's
`models/config.py` (`Family`, `ModelConfig`).

Every architectural delta is a field on ONE config consumed by ONE
transformer graph (models/transformer.py), which runs every family of the
JAX package; the configs compare field for field with the JAX package's.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, replace


class Family(str, enum.Enum):
    LLAMA_3 = "llama3"
    MISTRAL = "mistral"
    DEVSTRAL_2 = "devstral2"
    QWEN_2 = "qwen2"
    QWEN_2_MOE = "qwen2moe"
    QWEN_3 = "qwen3"
    DEEPSEEK_R1_DISTILL_QWEN = "deepseek_r1_distill_qwen"
    PHI_3 = "phi3"
    GRANITE = "granite"


@dataclass(frozen=True)
class ModelConfig:
    family: Family
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    context_length: int
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0

    # head geometry (decoupled for Devstral/Qwen3; defaults to dim // n_heads)
    head_dim: int = 0       # q/k head size
    v_head_dim: int = 0     # v head size (Qwen3 value_length)

    # architectural deltas
    rope_style: str = "interleaved"   # "interleaved" | "neox"
    qkv_bias: bool = False            # Qwen2
    qk_norm: bool = False             # Qwen3
    tied_embeddings: bool = False     # wcls = token embedding

    # Granite µP scales (identity defaults)
    embedding_scale: float = 1.0
    residual_scale: float = 1.0
    attention_scale: float = 0.0      # 0 => use 1/sqrt(head_dim)
    logit_scale: float = 1.0          # multiplied into logits

    # RoPE scaling: None | "llama3" | "yarn"
    rope_scaling: str | None = None
    rope_scale_factor: float = 1.0
    rope_lo_freq_factor: float = 1.0       # llama3 low_freq_factor
    rope_hi_freq_factor: float = 4.0       # llama3 high_freq_factor
    rope_original_context: int = 8192
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_log_multiplier: float = 0.0

    # MoE (Qwen2-MoE); n_experts == 0 => dense FFN
    n_experts: int = 0
    n_experts_used: int = 0
    moe_hidden_dim: int = 0
    shared_expert_hidden_dim: int = 0

    # original model context (before any --max-tokens clamp)
    model_context_length: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.dim // self.n_heads)
        if self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)
        if self.model_context_length == 0:
            object.__setattr__(self, "model_context_length", self.context_length)

    # derived sizes -------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def v_dim(self) -> int:
        return self.n_kv_heads * self.v_head_dim

    @property
    def gqa_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_score_scale(self) -> float:
        """Score multiplier: Granite's custom attention_scale or 1/sqrt(head_dim)."""
        if self.attention_scale:
            return self.attention_scale
        return 1.0 / (self.head_dim ** 0.5)

    def with_context_length(self, n: int) -> "ModelConfig":
        """Clamp runtime context (reference: Configuration.withContextLength)."""
        if n <= 0:
            return self
        return replace(self, context_length=min(n, self.model_context_length))
