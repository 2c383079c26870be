"""GGUF -> (ModelConfig, weights tree) loader: the port's copy of
llamatpu/models/loader.py.

- config keys use the GGUF `<arch>.` prefix (llama./qwen2./qwen3./phi3./
  granite./qwen2moe.); tensor names follow llama.cpp (blk.N.attn_q.weight,
  ...); Phi-3's fused attn_qkv / ffn_up (gate||up) split by rows at load.
- weights mode "quant": Q8_0 and Q4_0 become int8 + f32-scale QTensors
  (canonical columns; `pack4` packs Q4_0 two values per byte), Q6_K is
  requantized to Q8_0, F32/F16/BF16 load dense. Native Q4_K/Q5_K raise: they
  are the quant-breadth slice of the port.
- the vocab head: `output.weight`, or `token_embd` when the checkpoint ties
  them (Llama-3.2-1B ships that way); the embedding is the dequantized
  `token_embd` cast to the parameter dtype.

The tree stays on the host (numpy, with torch CPU tensors where the dtype is
bf16) unless `device` is given; `Engine` moves it to its device. Every
family's config and tensors load, but only the dense Llama 3 family has a
tokenizer and chat format in this slice (the others keep None there), and
`forward_tokens` raises on what it does not run yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from llamatpu_torch.gguf import GGUFReader, quants
from llamatpu_torch.gguf.ggml_type import GGMLType
from llamatpu_torch.models.config import Family, ModelConfig
from llamatpu_torch.models.detect import detect_family
from llamatpu_torch.models.weights import QTensor, pack4_pairs
from llamatpu_torch.ops.rope import precompute_rope_tables

_QWEN_FAMILIES = (Family.QWEN_2, Family.QWEN_2_MOE, Family.DEEPSEEK_R1_DISTILL_QWEN)


@dataclass
class LoadedModel:
    """A config plus its load-time weights tree (and, from a GGUF, its
    tokenizer and chat format)."""

    cfg: ModelConfig
    weights: dict
    metadata: dict
    family: Family
    tokenizer: Any = None
    chat_format: Any = None
    quant_label: str = "f16"


def _arch_prefix(md: dict) -> str:
    return md.get("general.architecture", "llama")


def config_from_metadata(family: Family, md: dict, max_tokens: int = 0) -> ModelConfig:
    p = _arch_prefix(md) + "."

    def get(key, default=None):
        v = md.get(p + key, default)
        if v is None:
            raise KeyError(p + key)
        return v

    dim = int(get("embedding_length"))
    n_heads = int(get("attention.head_count"))
    n_kv = int(md.get(p + "attention.head_count_kv", n_heads))
    vocab = int(md.get(p + "vocab_size", md.get("tokenizer.ggml.tokens.length", 0)))
    head_dim = int(md.get(p + "attention.key_length", dim // n_heads))
    v_head_dim = int(md.get(p + "attention.value_length", head_dim))

    kw: dict[str, Any] = dict(
        family=family,
        dim=dim,
        hidden_dim=int(get("feed_forward_length")),
        n_layers=int(get("block_count")),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        vocab_size=vocab,
        context_length=int(get("context_length")),
        rms_norm_eps=float(md.get(p + "attention.layer_norm_rms_epsilon", 1e-5)),
        rope_theta=float(md.get(p + "rope.freq_base", 10000.0)),
        head_dim=head_dim,
        v_head_dim=v_head_dim,
    )

    if family in (Family.QWEN_2, Family.QWEN_2_MOE, Family.QWEN_3,
                  Family.DEEPSEEK_R1_DISTILL_QWEN, Family.PHI_3):
        kw["rope_style"] = "neox"
    if family in _QWEN_FAMILIES:
        kw["qkv_bias"] = True
    if family == Family.QWEN_3:
        kw["qk_norm"] = True
    if family == Family.GRANITE:
        kw.update(
            embedding_scale=float(md.get("granite.embedding_scale", 12.0)),
            residual_scale=float(md.get("granite.residual_scale", 0.22)),
            attention_scale=float(md.get("granite.attention.scale", 0.0078125)),
            logit_scale=1.0 / float(md.get("granite.logit_scale", 16.0)),
        )
    if family == Family.QWEN_2_MOE:
        kw.update(
            n_experts=int(get("expert_count")),
            n_experts_used=int(get("expert_used_count")),
            shared_expert_hidden_dim=int(get("feed_forward_length")),
            # the expert hidden dim comes from the expert tensor's shape
            # (filled by load_model)
        )
    if family == Family.DEVSTRAL_2 and md.get(p + "rope.scaling.type") == "yarn":
        kw.update(
            rope_scaling="yarn",
            rope_scale_factor=float(md[p + "rope.scaling.factor"]),
            yarn_beta_fast=float(md[p + "rope.scaling.yarn_beta_fast"]),
            yarn_beta_slow=float(md[p + "rope.scaling.yarn_beta_slow"]),
            yarn_log_multiplier=float(md.get(p + "rope.scaling.yarn_log_multiplier", 0.0)),
            rope_original_context=int(md[p + "rope.scaling.original_context_length"]),
        )

    cfg = ModelConfig(**kw)
    if max_tokens:
        cfg = cfg.with_context_length(max_tokens)
    return cfg


# ---------------------------------------------------------------------------
# Weight loading
# ---------------------------------------------------------------------------

def _load_dense(reader: GGUFReader, name: str, dtype: torch.dtype):
    """Dequantized tensor in `dtype`: f32 as numpy, bf16/f16 as a CPU torch
    tensor (torch rounds f32 to bf16 to nearest even, as ml_dtypes does)."""
    v = reader.tensor_f32(name)
    if dtype == torch.float32:
        return v
    return torch.from_numpy(v).to(dtype)


def _load_matmul(reader: GGUFReader, name: str, dtype: torch.dtype, pack4: bool):
    info = reader.tensor_infos[name]
    t = info.ggml_type
    if not (t.is_quantized and t.supported):
        return _load_dense(reader, name, dtype)
    if t in (GGMLType.Q4_K, GGMLType.Q5_K):
        raise NotImplementedError(
            f"{name}: native {t.name} (values + per-32 offsets) is the quant-breadth "
            "slice of the port")
    n, shape = info.n_elements, info.shape
    raw = reader.tensor_raw(name)
    if t == GGMLType.Q6_K:  # requantized to Q8_0, as the JAX package does
        raw, t = quants.requantize_to_q8_0(t, raw, n), GGMLType.Q8_0
    views = quants.q8_0_views if t == GGMLType.Q8_0 else quants.q4_0_views
    qs, scales = views(np.asarray(raw, np.uint8), n)
    qs = np.ascontiguousarray(qs).reshape(shape)
    scales = np.ascontiguousarray(scales).astype(np.float32).reshape(*shape[:-1], shape[-1] // 32)
    if t == GGMLType.Q4_0 and pack4:
        return QTensor(pack4_pairs(qs), scales, "q4_0", layout="packed4")
    return QTensor(qs, scales, "q8_0" if t == GGMLType.Q8_0 else "q4_0")


def _row_slice(w, a: int, b: int):
    if isinstance(w, QTensor):
        return QTensor(w.qs[a:b], w.scales[a:b], w.kind, layout=w.layout)
    return w[a:b]


def _stack(ws: list):
    if isinstance(ws[0], QTensor):
        return QTensor(np.stack([t.qs for t in ws]), np.stack([t.scales for t in ws]),
                       ws[0].kind, layout=ws[0].layout)
    if isinstance(ws[0], torch.Tensor):
        return torch.stack(ws)
    return np.stack(ws)


def load_model(path: str, max_tokens: int = 0, param_dtype: torch.dtype = torch.bfloat16,
               pack4: bool = False, device: str | torch.device | None = None,
               load_tokenizer: bool = True) -> LoadedModel:
    """Load a GGUF checkpoint into a config + stacked weights tree.

    pack4: store Q4_0 tensors two values per byte (layout "packed4"); other
    tensors are unaffected. device: None keeps the tree on the host (what
    `Engine` takes); a device moves it there as torch tensors."""
    reader = GGUFReader(path)
    md = reader.metadata
    family = detect_family(md)
    cfg = config_from_metadata(family, md, max_tokens)

    if family == Family.QWEN_2_MOE:
        # down_exps numpy shape (E, dim, moe_hidden)
        down_shape = reader.tensor_infos["blk.0.ffn_down_exps.weight"].shape
        object.__setattr__(cfg, "moe_hidden_dim", int(down_shape[-1]))

    def matw(name):
        return _load_matmul(reader, name, param_dtype, pack4)

    def norm(name):
        return _load_dense(reader, name, torch.float32)

    layers = []
    for i in range(cfg.n_layers):
        b = f"blk.{i}."
        lw: dict[str, Any] = {
            "attn_norm": norm(b + "attn_norm.weight"),
            "ffn_norm": norm(b + "ffn_norm.weight"),
            "wo": matw(b + "attn_output.weight"),
        }
        if family == Family.PHI_3:
            wqkv = matw(b + "attn_qkv.weight")
            q_d, kv_d = cfg.q_dim, cfg.kv_dim
            lw["wq"] = _row_slice(wqkv, 0, q_d)
            lw["wk"] = _row_slice(wqkv, q_d, q_d + kv_d)
            lw["wv"] = _row_slice(wqkv, q_d + kv_d, q_d + 2 * kv_d)
            gate_up = matw(b + "ffn_up.weight")  # [2*hidden, dim]: gate rows then up rows
            lw["w1"] = _row_slice(gate_up, 0, cfg.hidden_dim)
            lw["w3"] = _row_slice(gate_up, cfg.hidden_dim, 2 * cfg.hidden_dim)
            lw["w2"] = matw(b + "ffn_down.weight")
        else:
            lw["wq"] = matw(b + "attn_q.weight")
            lw["wk"] = matw(b + "attn_k.weight")
            lw["wv"] = matw(b + "attn_v.weight")
            if cfg.is_moe:
                lw["router"] = matw(b + "ffn_gate_inp.weight")
                lw["gate_exps"] = matw(b + "ffn_gate_exps.weight")
                lw["up_exps"] = matw(b + "ffn_up_exps.weight")
                lw["down_exps"] = matw(b + "ffn_down_exps.weight")
                lw["shared_gate"] = matw(b + "ffn_gate_shexp.weight")
                lw["shared_up"] = matw(b + "ffn_up_shexp.weight")
                lw["shared_down"] = matw(b + "ffn_down_shexp.weight")
                lw["shared_gate_inp"] = norm(b + "ffn_gate_inp_shexp.weight").reshape(-1)
            else:
                lw["w1"] = matw(b + "ffn_gate.weight")
                lw["w2"] = matw(b + "ffn_down.weight")
                lw["w3"] = matw(b + "ffn_up.weight")
        if cfg.qkv_bias:
            lw["q_bias"] = norm(b + "attn_q.bias")
            lw["k_bias"] = norm(b + "attn_k.bias")
            lw["v_bias"] = norm(b + "attn_v.bias")
        if cfg.qk_norm:
            lw["q_norm"] = norm(b + "attn_q_norm.weight")
            lw["k_norm"] = norm(b + "attn_k_norm.weight")
        layers.append(lw)

    stacked = {k: _stack([l[k] for l in layers]) for k in layers[0]}
    cos, sin = precompute_rope_tables(cfg)
    tok_name = "token_embd.weight"
    out_name = "output.weight" if "output.weight" in reader.tensor_infos else tok_name
    weights = {
        "tok_emb": _load_dense(reader, tok_name, param_dtype),
        "final_norm": norm("output_norm.weight"),
        "wcls": matw(out_name),
        "rope_cos": cos,
        "rope_sin": sin,
        "layers": stacked,
    }
    quant_label = reader.tensor_infos[out_name].ggml_type.name.lower()
    if device is not None:
        from llamatpu_torch.models.weights import tree_to

        weights = tree_to(weights, torch.device(device))

    model = LoadedModel(cfg=cfg, weights=weights, metadata=md, family=family,
                        quant_label=quant_label)
    if load_tokenizer and family == Family.LLAMA_3:
        from llamatpu_torch.format import build_chat_format
        from llamatpu_torch.tokenizer import build_tokenizer

        model.tokenizer = build_tokenizer(family, md)
        model.chat_format = build_chat_format(family, model.tokenizer, md)
    reader.close()
    return model
