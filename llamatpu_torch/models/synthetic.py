"""Synthetic random-weight models with real production shapes.

The port's copy of the JAX package's `models/synthetic.py`. It draws from the
numpy RNG stream in the same order, so the same preset and seed give arrays
identical to the JAX package's (tests/test_torch_weights.py). It skips
`prepare_qtensor`'s column interleave and row padding, which are Mosaic
layouts: the port's tensors stay canonical and unpadded. bf16 embeddings are
rounded from the same float64 draws by torch (round to nearest even, as
ml_dtypes does).
"""
from __future__ import annotations

import numpy as np
import torch

from llamatpu_torch.models.config import Family, ModelConfig
from llamatpu_torch.models.loader import LoadedModel
from llamatpu_torch.models.weights import QTensor, pack4_pairs
from llamatpu_torch.ops.rope import precompute_rope_tables

# geometry sources: the models' published GGUF metadata (same keys the
# reference loaders read, SURVEY.md §2.3)
PRESETS: dict[str, dict] = {
    "llama32-1b": dict(family=Family.LLAMA_3, dim=2048, hidden_dim=8192, n_layers=16,
                       n_heads=32, n_kv_heads=8, head_dim=64, vocab_size=128256,
                       context_length=4096, rope_theta=500000.0, rms_norm_eps=1e-5,
                       tied_embeddings=True),
    "llama3-8b": dict(family=Family.LLAMA_3, dim=4096, hidden_dim=14336, n_layers=32,
                      n_heads=32, n_kv_heads=8, head_dim=128, vocab_size=128256,
                      context_length=4096, rope_theta=500000.0, rms_norm_eps=1e-5),
    "qwen3-0.6b": dict(family=Family.QWEN_3, dim=1024, hidden_dim=3072, n_layers=28,
                       n_heads=16, n_kv_heads=8, head_dim=128, vocab_size=151936,
                       context_length=4096, rope_theta=1000000.0, rms_norm_eps=1e-6,
                       rope_style="neox", qk_norm=True, tied_embeddings=True),
    "qwen25-1.5b": dict(family=Family.QWEN_2, dim=1536, hidden_dim=8960, n_layers=28,
                        n_heads=12, n_kv_heads=2, head_dim=128, vocab_size=151936,
                        context_length=4096, rope_theta=1000000.0, rms_norm_eps=1e-6,
                        rope_style="neox", qkv_bias=True, tied_embeddings=True),
    "phi3-mini": dict(family=Family.PHI_3, dim=3072, hidden_dim=8192, n_layers=32,
                      n_heads=32, n_kv_heads=32, head_dim=96, vocab_size=32064,
                      context_length=4096, rope_theta=10000.0, rms_norm_eps=1e-5,
                      rope_style="neox"),
    "mistral-7b": dict(family=Family.MISTRAL, dim=4096, hidden_dim=14336, n_layers=32,
                       n_heads=32, n_kv_heads=8, head_dim=128, vocab_size=32768,
                       context_length=4096, rope_theta=1000000.0, rms_norm_eps=1e-5),
    "granite-3.2-2b": dict(family=Family.GRANITE, dim=2048, hidden_dim=8192, n_layers=40,
                           n_heads=32, n_kv_heads=8, head_dim=64, vocab_size=49155,
                           context_length=4096, rope_theta=5000000.0, rms_norm_eps=1e-5,
                           embedding_scale=12.0, residual_scale=0.22,
                           attention_scale=0.015625, logit_scale=0.125,
                           tied_embeddings=True),
    # Granite-4.0-1B (BASELINE.md publishes reference rows for it): µP scales
    # are the reference GraniteLoader defaults (GraniteLoader.java:55-58 —
    # embedding 12.0, residual 0.22, attention 0.0078125, logit 1/16);
    # geometry approximated to the model's ~1.2B dense budget over the
    # Granite-4 100k vocab (zero egress — swap in GGUF metadata when a real
    # checkpoint is reachable)
    "granite-4.0-1b": dict(family=Family.GRANITE, dim=2048, hidden_dim=6144,
                           n_layers=20, n_heads=32, n_kv_heads=8, head_dim=64,
                           vocab_size=100352, context_length=4096,
                           rope_theta=10000000.0, rms_norm_eps=1e-5,
                           embedding_scale=12.0, residual_scale=0.22,
                           attention_scale=0.0078125, logit_scale=0.0625,
                           tied_embeddings=True),
    # Devstral Small 2 (24B, Mistral-Small-3.1 base: DevstralModelLoader.java;
    # Tekken 131k vocab). Fits one 16G chip only as q4_0 packed (~12 GiB).
    "devstral-small-2": dict(family=Family.DEVSTRAL_2, dim=5120, hidden_dim=32768,
                             n_layers=40, n_heads=32, n_kv_heads=8, head_dim=128,
                             vocab_size=131072, context_length=4096,
                             rope_theta=1000000000.0, rms_norm_eps=1e-5),
    # DeepSeek-R1-Distill-Qwen-1.5B: Qwen2.5-1.5B geometry under the distill
    # chat format (forced <think>, format/chat_format.py)
    "deepseek-r1-distill-1.5b": dict(family=Family.DEEPSEEK_R1_DISTILL_QWEN,
                                     dim=1536, hidden_dim=8960, n_layers=28,
                                     n_heads=12, n_kv_heads=2, head_dim=128,
                                     vocab_size=151936, context_length=4096,
                                     rope_theta=1000000.0, rms_norm_eps=1e-6,
                                     rope_style="neox", qkv_bias=True,
                                     tied_embeddings=True),
    # Qwen1.5-MoE-A2.7B: the reference's Qwen 2 MoE target geometry
    # (model/qwen2/Qwen2MoEConfiguration.java; 60 experts, top-4 w/o renorm,
    # always-on shared expert)
    "qwen15-moe-a2.7b": dict(family=Family.QWEN_2_MOE, dim=2048, hidden_dim=5632,
                             n_layers=24, n_heads=16, n_kv_heads=16, head_dim=128,
                             vocab_size=151936, context_length=4096,
                             rope_theta=1000000.0, rms_norm_eps=1e-6,
                             rope_style="neox", qkv_bias=True,
                             n_experts=60, n_experts_used=4, moe_hidden_dim=1408),
}


def _rand_qtensor(rng: np.random.Generator, shape: tuple[int, ...], kind: str = "q8_0",
                  pack4: bool = False) -> QTensor:
    """Random values of `kind` from raw bytes (values need only be in range:
    Q8_0 [-127, 127], Q4_0 / Q4_K [-8, 7], Q5_K [-16, 15]) plus f32 block
    scales in [0.0005, 0.0015) and, for the native K-quants, f32 per-32
    offsets in [-0.001, 0.001). pack4 packs Q4_0 / Q4_K two values a byte."""
    if kind not in ("q8_0", "q4_0", "q4_k", "q5_k"):
        raise ValueError(f"synthetic weights of kind {kind!r}")
    n = int(np.prod(shape))
    raw = np.frombuffer(rng.bytes(n), dtype=np.uint8)
    if kind in ("q4_0", "q4_k"):
        qs = ((raw & 0x0F).astype(np.int8) - 8).reshape(shape)
    elif kind == "q5_k":
        qs = ((raw & 0x1F).astype(np.int8) - 16).reshape(shape)
    else:
        qs = np.maximum(raw.view(np.int8), -127).reshape(shape)
    scales = (rng.random(size=(*shape[:-1], shape[-1] // 32), dtype=np.float32)
              * 0.001 + 0.0005)
    offs = None
    if kind in ("q4_k", "q5_k"):
        offs = (rng.random(size=scales.shape, dtype=np.float32) - 0.5) * 0.002
    if pack4 and kind in ("q4_0", "q4_k"):
        return QTensor(pack4_pairs(qs), scales, kind, layout="packed4", offs=offs)
    return QTensor(qs, scales, kind, offs=offs)


def _rand_dense(rng, shape, dtype):
    torch_dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    scale = 1.0 / np.sqrt(shape[-1])
    v = rng.standard_normal(size=shape, dtype=np.float32) * scale  # float64
    return torch.from_numpy(v).to(torch_dtype)


def build_synthetic_model(preset: str, quant: str = "q8_0", seed: int = 0,
                          dtype: str = "bf16", context_length: int | None = None,
                          n_layers: int | None = None, pack4: bool = False,
                          overrides: dict | None = None) -> LoadedModel:
    """Random block-quant weights (`quant` q8_0, q4_0, q4_k or q5_k; pack4
    packs the 4-bit kinds) at a preset's geometry. An MoE preset draws the
    dense FFN too, as the JAX package does before it replaces it by the
    routed experts and the shared expert, so the stream stays the same."""
    kw = dict(PRESETS[preset])
    if context_length:
        kw["context_length"] = context_length
    if n_layers:
        kw["n_layers"] = n_layers
    if overrides:
        kw.update(overrides)
    cfg = ModelConfig(**kw)
    rng = np.random.default_rng(seed)

    def mat(out_dim, in_dim):
        return _rand_qtensor(rng, (cfg.n_layers, out_dim, in_dim), quant, pack4)

    layers = {
        "attn_norm": np.ones((cfg.n_layers, cfg.dim), np.float32),
        "ffn_norm": np.ones((cfg.n_layers, cfg.dim), np.float32),
        "wq": mat(cfg.q_dim, cfg.dim),
        "wk": mat(cfg.kv_dim, cfg.dim),
        "wv": mat(cfg.v_dim, cfg.dim),
        "wo": mat(cfg.dim, cfg.q_dim),
        "w1": mat(cfg.hidden_dim, cfg.dim),
        "w2": mat(cfg.dim, cfg.hidden_dim),
        "w3": mat(cfg.hidden_dim, cfg.dim),
    }
    if cfg.qkv_bias:
        layers["q_bias"] = np.zeros((cfg.n_layers, cfg.q_dim), np.float32)
        layers["k_bias"] = np.zeros((cfg.n_layers, cfg.kv_dim), np.float32)
        layers["v_bias"] = np.zeros((cfg.n_layers, cfg.v_dim), np.float32)
    if cfg.qk_norm:
        layers["q_norm"] = np.ones((cfg.n_layers, cfg.head_dim), np.float32)
        layers["k_norm"] = np.ones((cfg.n_layers, cfg.head_dim), np.float32)

    if cfg.is_moe:
        def emat(out_dim, in_dim):
            return _rand_qtensor(rng, (cfg.n_layers, cfg.n_experts, out_dim, in_dim), quant,
                                 pack4)

        del layers["w1"], layers["w2"], layers["w3"]
        layers["router"] = _rand_dense(rng, (cfg.n_layers, cfg.n_experts, cfg.dim), "f32")
        layers["gate_exps"] = emat(cfg.moe_hidden_dim, cfg.dim)
        layers["up_exps"] = emat(cfg.moe_hidden_dim, cfg.dim)
        layers["down_exps"] = emat(cfg.dim, cfg.moe_hidden_dim)
        layers["shared_gate"] = mat(cfg.hidden_dim, cfg.dim)
        layers["shared_up"] = mat(cfg.hidden_dim, cfg.dim)
        layers["shared_down"] = mat(cfg.dim, cfg.hidden_dim)
        layers["shared_gate_inp"] = _rand_dense(rng, (cfg.n_layers, cfg.dim), "f32")

    cos, sin = precompute_rope_tables(cfg)
    wcls = _rand_qtensor(rng, (cfg.vocab_size, cfg.dim), quant, pack4)
    weights = {
        "tok_emb": _rand_dense(rng, (cfg.vocab_size, cfg.dim), dtype),
        "final_norm": np.ones((cfg.dim,), np.float32),
        "wcls": wcls,
        "rope_cos": cos,
        "rope_sin": sin,
        "layers": layers,
    }
    return LoadedModel(cfg=cfg, weights=weights,
                       metadata={"general.name": f"synthetic-{preset}"},
                       family=cfg.family, quant_label=quant)
