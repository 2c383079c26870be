"""The transformer forward of the port: dense Llama family, packed KV cache,
q8_row or block-quant (Q8_0 / Q4_0 / packed4) or dense weights.

The port of llamatpu/models/transformer.py's main path. Prefill and decode
are one function over a [B, T] token window that writes the KV cache at
`pos`. Layers run as a Python loop over the stacked weights; a layer's
weights are the views w.qs[li], and the cache is updated IN PLACE (the JAX
package carried it through its layer scan and donated it).

Per layer:
- decode with q8_row weights (B = 1, T = 1): K2 (rmsnorm + wqkv,
  ops/layer_fused.py), RoPE, then K3 (KV append + attention + wo + FFN);
- decode with any other weights (T = 1): rmsnorm, wqkv through ops/matmul.py
  (K5 / K7 for block quants), RoPE, then K6 (KV append + attention,
  ops/attention.py), then the unfused tail (wo, residual, rmsnorm, w13,
  silu * up, w2, residual). The JAX package's fused q8_row kernels decline
  block quants and take this path (`transformer.py:438-440, 602-609, 699`);
- otherwise (prefill): the unfused chain with the dtype of every step as the
  JAX package's (`transformer.py:699-712`, `_dense_ffn`): bf16 residual stream
  between ops, f32 masked softmax, projections through ops/matmul.py (K5 / K7
  for block quants; for q8_row K1 below 128 rows, K4 at 128 and above).
The JAX package's fused decode kernels serve caches shorter than its
split-attention threshold; K3 and K6 serve every length (on the TPU that
limit is VMEM, which this card does not have).

Qkv bias, q/k norm, MoE, int8 KV, paged caches and sharding raise until their
slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from llamatpu_torch.models.config import ModelConfig
from llamatpu_torch.models.weights import QTensor
from llamatpu_torch.ops.attention import decode_attention_fused_write
from llamatpu_torch.ops.layer_fused import layer_attn_tail_fused_rowq, qkv_norm_fused_rowq
from llamatpu_torch.ops.matmul import matmul
from llamatpu_torch.ops.rmsnorm import rmsnorm
from llamatpu_torch.ops.rope import apply_rope


@dataclass
class KVCache:
    """Preallocated packed KV cache [L, B, n_kv, S, hd + vhd]: K in the first
    hd entries of a row, V in the rest. Updated in place by forward_tokens."""

    kv: torch.Tensor


PAD_GRANULE = 128  # final prefill chunks pad to a multiple of this


def physical_cache_len(logical: int, prefill_chunk: int) -> int:
    """Cache positions to ALLOCATE for `logical` usable positions: one
    granule of slack for the padded final prefill chunk's writes, rounded to
    32 (the fused append's tile), and to 1024 past 8192 — the JAX package's
    length, so caches compare directly."""
    granule = min(prefill_chunk, PAD_GRANULE)
    phys = -(-(logical + granule) // 32) * 32
    if phys > 8192:
        phys = -(-phys // 1024) * 1024
    return phys


def pad_chunk_len(real: int, prefill_chunk: int) -> int:
    """Length of a final partial prefill chunk: the next PAD_GRANULE multiple."""
    granule = min(prefill_chunk, PAD_GRANULE)
    return min(prefill_chunk, -(-real // granule) * granule)


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, length: int | None = None,
               device: str | torch.device = "cuda") -> KVCache:
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{dtype} KV cache: int8-KV slice of the port")
    s = length or cfg.context_length
    width = cfg.head_dim + cfg.v_head_dim
    return KVCache(torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, s, width),
                               dtype=dtype, device=device))


def _attention(cfg: ModelConfig, q, kc, vc, pos: int, t_len: int):
    """Masked GQA attention over the cache, f32 scores and softmax.
    q [B, T, KV, G, hd]; kc [B, KV, S, hd]; vc [B, KV, S, vhd]. Key s is
    valid for query t iff s <= pos + t. Returns [B, T, KV, G, vhd] f32."""
    scores = torch.einsum("btkgh,bksh->bkgts", q.float(), kc.float()) * cfg.attn_score_scale
    s_idx = torch.arange(kc.shape[2], device=q.device)
    t_idx = torch.arange(t_len, device=q.device)
    mask = s_idx[None, :] <= (pos + t_idx)[:, None]   # [T, S]
    scores = scores.masked_fill(~mask, float("-inf"))
    att = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgts,bksv->btkgv", att, vc.float())


def embed_tokens(cfg: ModelConfig, weights, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (+ the µP embedding scale)."""
    x = weights["tok_emb"][tokens.long()]
    if cfg.embedding_scale != 1.0:
        x = (x.float() * cfg.embedding_scale).to(x.dtype)
    return x


def rope_slices(weights, pos: int, t: int):
    """RoPE table rows for positions pos..pos+t-1: [1, T, 1, half] cos/sin.
    Positions past the table (the padded tail of a final chunk) clamp to its
    last row, as the JAX package's gather does."""
    table = weights["rope_cos"]
    positions = torch.clamp(pos + torch.arange(t, device=table.device), max=table.shape[0] - 1)
    return (table[positions][None, :, None, :],
            weights["rope_sin"][positions][None, :, None, :])


def finish_logits(cfg: ModelConfig, weights, x, last_logit_only=False, logit_index=None):
    """Final norm + vocab projection (+ logit scale); x [B, T, D] -> f32
    logits [B, T, V], or [B, V] with last_logit_only / logit_index."""
    if logit_index is not None:
        x = x[:, logit_index]
    elif last_logit_only:
        x = x[:, -1]
    x = rmsnorm(x, weights["final_norm"], cfg.rms_norm_eps)
    logits = matmul(weights["wcls"], x).float()
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return logits


def _write_rows(kv: torch.Tensor, new: torch.Tensor, li: int, pos: int) -> None:
    """Write new [B, KV, T, hd + vhd] rows into the stacked cache at layer li,
    positions pos.. (in place)."""
    kv[li, :, :, pos:pos + new.shape[2]] = new.to(kv.dtype)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError("qkv bias / q-k norm: family-deltas slice of the port")
    if cfg.is_moe:
        raise NotImplementedError("MoE: MoE slice of the port")


def _layer(cfg: ModelConfig, lw: dict, x, kv: torch.Tensor, li: int, pos: int, cos, sin,
           s_limit: int | None, pos_vec: torch.Tensor | None):
    b, t = x.shape[:2]
    nkv, g, hd = cfg.n_kv_heads, cfg.gqa_groups, cfg.head_dim
    eps, rs = cfg.rms_norm_eps, cfg.residual_scale
    if "wqkv" not in lw or "w13" not in lw:
        raise NotImplementedError("unfused projections: the port serves fused wqkv/w13")
    wqkv = lw["wqkv"]
    decode = b == 1 and t == 1 and isinstance(wqkv, QTensor) and wqkv.kind == "q8_row"
    if decode:
        qkv = qkv_norm_fused_rowq(lw["wqkv"], lw["attn_norm"], x, li, eps)
    else:
        qkv = matmul(lw["wqkv"], rmsnorm(x, lw["attn_norm"][li], eps), li)
    qd, kd = cfg.q_dim, cfg.kv_dim
    # q and k heads rotate in one call (elementwise: the same values as two)
    qk = apply_rope(qkv[..., :qd + kd].reshape(b, t, cfg.n_heads + nkv, hd), cos, sin,
                    cfg.rope_style)
    q, k = qk[:, :, :cfg.n_heads], qk[:, :, cfg.n_heads:]
    v = qkv[..., qd + kd:].reshape(b, t, nkv, cfg.v_head_dim)
    kvnew = torch.cat([k, v], dim=-1)                 # [B, T, KV, hd + vhd]
    if decode:
        x, _ = layer_attn_tail_fused_rowq(
            lw["wo"], lw["w13"], lw["w2"], lw["ffn_norm"], q.reshape(b, nkv, g, hd),
            kvnew[:, 0], kv, x, pos, li, eps, cfg.attn_score_scale, hd, rs)
        return x
    if t == 1:
        attn, _ = decode_attention_fused_write(q.reshape(b, nkv, g, hd), kvnew[:, 0], kv,
                                               pos_vec, cfg.attn_score_scale, li, hd)
    else:
        _write_rows(kv, kvnew.transpose(1, 2), li, pos)
        kd_all, vd_all = kv[li, ..., :hd], kv[li, ..., hd:]
        if s_limit and s_limit < kd_all.shape[2]:
            # rows past the logical length are write slack, never attended
            lim = -(-s_limit // 8) * 8
            kd_all, vd_all = kd_all[:, :, :lim], vd_all[:, :, :lim]
        attn = _attention(cfg, q.reshape(b, t, nkv, g, hd), kd_all, vd_all, pos, t)
    attn = attn.reshape(b, t, -1).to(x.dtype)
    attn_out = matmul(lw["wo"], attn, li)
    if rs != 1.0:
        attn_out = (attn_out.float() * rs).to(x.dtype)
    x = x + attn_out
    h2 = rmsnorm(x, lw["ffn_norm"][li], eps)
    g13 = matmul(lw["w13"], h2, li)
    ff = g13.shape[-1] // 2
    act = F.silu(g13[..., :ff].float()).to(h2.dtype) * g13[..., ff:]
    ffn = matmul(lw["w2"], act, li)
    if rs != 1.0:
        ffn = (ffn.float() * rs).to(x.dtype)
    return x + ffn


def forward_tokens(cfg: ModelConfig, weights, tokens: torch.Tensor, cache: KVCache, pos: int,
                   last_logit_only=False, logit_index=None, s_limit: int | None = None):
    """Run T tokens at absolute positions pos..pos+T-1 through the model.

    tokens: int [B, T] on the weights' device; pos: the host-side start
    position. The cache is written in place at those positions. Returns
    (f32 logits, cache): [B, T, V], or [B, V] with last_logit_only or
    logit_index (the last REAL token of a padded final prefill chunk)."""
    _check_supported(cfg)
    b, t = tokens.shape
    x = embed_tokens(cfg, weights, tokens)
    cos, sin = rope_slices(weights, pos, t)
    # decode attention (K6) reads the position on the device: no host sync
    pos_vec = torch.full((b,), pos, dtype=torch.int32, device=x.device) if t == 1 else None
    for li in range(cfg.n_layers):
        x = _layer(cfg, weights["layers"], x, cache.kv, li, pos, cos, sin, s_limit, pos_vec)
    return finish_logits(cfg, weights, x, last_logit_only, logit_index), cache
