"""The transformer forward of the port, for all nine families: Llama 3,
Mistral, Devstral (YaRN RoPE), Granite (µP scales), Phi-3, Qwen2 and the
DeepSeek-R1 distills (qkv bias, NeoX RoPE), Qwen3 (per-head q/k RMSNorm)
and Qwen2-MoE (routed experts; the others a dense FFN). Packed KV cache
(dense per lane, or a shared paged block pool) in bf16, f32 or int8 with
per-row scales; q8_row, block-quant (Q8_0 / Q4_0 / packed4, native Q4_K /
Q5_K with their per-32 offsets) or dense weights.

The port of llamatpu/models/transformer.py's main path. Prefill and decode
are one function over a [B, T] token window at per-lane start positions
`pos` (a host int, or a device [B] vector: the batched decode reads lane
positions on the card, with no host sync). Layers run as a Python loop over
the stacked weights; a layer's weights are the views w.qs[li], and the cache
is updated IN PLACE (the JAX package carried it through its layer scan and
donated it).

Per layer, with R = B * T rows (the JAX package's rule, `transformer.py:
429-437, 485-633, 684-695`):
- q8_row weights: rmsnorm + wqkv is K2 for R <= 32 where the JAX
  package's fit accepts (`layer_fused.qkv_fits`; every fused kernel below
  follows its JAX fit the same way), else the plain rmsnorm and the matmul
  dispatch (K1 below 128 rows, K4 at 128 and above);
- the qkv bias (Qwen2) is added to the projection's output, rounded to its
  dtype (`transformer.py:451-454`);
- q/k norm (Qwen3, `transformer.py:458-460`): every q head through
  RMSNorm with q_norm and every k head with k_norm, in the projection's
  dtype, before RoPE, as one plain op over the q and k heads together
  (the weights stacked per head at load, `weights.fuse_layer_weights`):
  the same values as two;
- an int8 cache stores K and V quantized per (token, KV head)
  (ops/kv_quant.py) with their scales in `KVCache.scale`;
- decode (T = 1, no batch_offset) on a dense cache follows the JAX
  package's dispatch. The cache is long when S_phys * itemsize >=
  SPLIT_THRESHOLD_BYTES (bf16 from 8192 rows, f32 from 4096, int8 from
  16384); the KV append fuses into the attention kernel when S_phys % 32 ==
  0, LLAMATPU_NO_FUSED_ATTN is unset (read at call time) and, for a long
  cache, its tile `pick_tile(S_phys)` is at least 128 rows. Then: q8_row
  weights at B = 1 (a dense FFN, a short bf16/f32 cache,
  LLAMATPU_NO_ATTN_TAIL unset, read at call time, a power-of-two value
  head and `layer_fused.attn_tail_fits`) take K3, append + attention + the
  whole tail in one call, reading pos on the device as the JAX kernel
  does; a long cache takes K14 fused (K14-int8 for int8), a short one K6
  (K6-int8). Unfused, the rows are written by index and
  `decode_attention_auto` takes K14 unfused (long) or K15 over the logical
  rows;
- decode on the paged pool: the KV write (`runtime/paged_cache`) then K8
  (its int8 variant with the scale pool) through the tables;
- otherwise (prefill, lane prefill into a wider cache through
  `batch_offset`): the KV rows written, then, at T = 1,
  `decode_attention_auto` over the lane's rows, else the plain f32 masked
  attention over them (int8 rows dequantized; a gathered dense view for the
  paged pool);
- after attention, q8_row weights with R <= 32 and a dense FFN take K9 (wo
  + residual + rmsnorm + w13 + silu * up + w2 + residual) where it fits
  (`layer_fused.tail_fits`), else the unfused tail with the JAX package's
  dtypes (`transformer.py:699-712`): bf16 residual stream between ops,
  projections through ops/matmul.py (K5 / K7 for block quants), and the
  FFN as `_dense_ffn` (`transformer.py:186-200`): K20
  (ops/ffn_fused.py) for q8_row weights where its fit accepts, else w13,
  silu * up and w2 as two projections;
- an MoE layer's FFN (`_moe_ffn`, `transformer.py:222-316`): the router as
  an f32 matmul, softmax over all experts, top-k without renormalization,
  the routed experts through the grouped matmuls (ops/moe_grouped.py,
  K10-K13) at the JAX package's tile rule, and the shared expert either
  folded into them (every token routed to its S chunks with the sigmoid
  shared-gate weight) or as explicit matmuls (`_moe_shared`).
The JAX package takes its fused q8_row kernels only where its TPU tiling
accepts the widths (multiples of 128); the port takes K2, K3 and K9 at every
width, and at multiples of 128 exactly where the JAX package's VMEM fits
accept (a Phi-3-medium layer at 17-24 rows declines K9 and takes K20).

Sharding (tensor, pipeline, sequence parallelism) is a later slice of the
port.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from llamatpu_torch.models.config import ModelConfig
from llamatpu_torch.models.weights import QTensor
from llamatpu_torch.ops import attention as att
from llamatpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from llamatpu_torch.ops.ffn_fused import ffn_fused_rowq
from llamatpu_torch.ops.layer_fused import (attn_tail_fits, layer_attn_tail_fused_rowq,
                                            layer_tail_fused_rowq, qkv_fits,
                                            qkv_norm_fused_rowq)
from llamatpu_torch.ops.matmul import matmul
from llamatpu_torch.ops.moe_grouped import moe_ffn_grouped, tile_rows
from llamatpu_torch.ops.rmsnorm import rmsnorm
from llamatpu_torch.ops.rope import apply_rope
from llamatpu_torch.runtime.paged_cache import (PagedKVCache, paged_gather, paged_gather_scale,
                                                paged_write_scale_stacked, paged_write_stacked)


@dataclass
class KVCache:
    """Preallocated packed KV cache [L, B, n_kv, S, hd + vhd]: K in the first
    hd entries of a row, V in the rest. With int8 entries, `scale` holds one
    f32 per (token, KV head) for K and V, [L, B, n_kv, 2, S] (row 0 = K).
    Updated in place by forward_tokens."""

    kv: torch.Tensor
    scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.scale is not None


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
    if dtype not in (torch.bfloat16, torch.float32, torch.int8):
        raise NotImplementedError(f"{dtype} KV cache: the port keeps bf16, f32 or int8")
    s = length or cfg.context_length
    width = cfg.head_dim + cfg.v_head_dim
    kv = torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, s, width), dtype=dtype, device=device)
    if dtype == torch.int8:
        return KVCache(kv, torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, 2, s),
                                       dtype=torch.float32, device=device))
    return KVCache(kv)


def _attention(cfg: ModelConfig, q, kc, vc, pos_vec: torch.Tensor, t_len: int):
    """Masked GQA attention over the cache, f32 scores and softmax.
    q [B, T, KV, G, hd]; kc [B, KV, S, hd]; vc [B, KV, S, vhd]; pos_vec [B].
    Key s is valid for query t of lane b iff s <= pos_vec[b] + t. Returns
    [B, T, KV, G, vhd] f32."""
    scores = torch.einsum("btkgh,bksh->bkgts", q.float(), kc.float()) * cfg.attn_score_scale
    s_idx = torch.arange(kc.shape[2], device=q.device)
    t_idx = torch.arange(t_len, device=q.device)
    mask = s_idx[None, None, :] <= (pos_vec.long()[:, None] + t_idx[None, :])[:, :, None]
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    att = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgts,bksv->btkgv", att, vc.float())


def embed_tokens(cfg: ModelConfig, weights, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (+ the µP embedding scale)."""
    x = weights["tok_emb"][tokens.long()]
    if cfg.embedding_scale != 1.0:
        x = (x.float() * cfg.embedding_scale).to(x.dtype)
    return x


def rope_slices(weights, pos_vec: torch.Tensor, t: int):
    """Per-lane RoPE table rows for positions pos_vec[b]..pos_vec[b]+t-1:
    [B, T, 1, half] cos/sin. Positions past the table (the padded tail of a
    final chunk, a parked lane) clamp to its last row, as the JAX package's
    gather does."""
    table = weights["rope_cos"]
    positions = pos_vec.long()[:, None] + torch.arange(t, device=table.device)[None, :]
    positions = torch.clamp(positions, max=table.shape[0] - 1)
    return table[positions][:, :, None, :], weights["rope_sin"][positions][:, :, None, :]


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


def _window_rows(pos: torch.Tensor, t: int, s: int, device) -> torch.Tensor:
    """Rows [B, T] of a T-row write at device positions pos [B] into s
    rows, the start clamped to [0, s - T] as XLA's dynamic_update_slice
    clamps it (a speculative verify window within T of the physical end)."""
    start = torch.clamp(pos.to(device=device, dtype=torch.long), 0, s - t)
    return start[:, None] + torch.arange(t, device=device)[None, :]


def _write_rows(kv: torch.Tensor, new: torch.Tensor, li: int, pos, row0: int) -> None:
    """Write new [B, T, KV, hd + vhd] rows into the stacked cache
    [L, Ball, KV, S, hd + vhd] at layer li, batch rows row0.., positions
    pos.. of each lane (a host int, or a [B] vector), in place."""
    b, t = new.shape[:2]
    if isinstance(pos, int):
        kv[li, row0:row0 + b, :, pos:pos + t] = new.transpose(1, 2).to(kv.dtype)
        return
    rows = torch.arange(row0, row0 + b, device=kv.device)[:, None]
    positions = _window_rows(pos, t, kv.shape[3], kv.device)
    kv[li][rows, :, positions] = new.to(kv.dtype)           # [B, T, KV, W]


def _write_scale_rows(sc: torch.Tensor, s_new: torch.Tensor, li: int, pos, row0: int) -> None:
    """Write s_new [B, T, KV, 2] (K and V scale per token and head) into the
    stacked scale rows [L, Ball, KV, 2, S] at layer li, batch rows row0..,
    positions pos.. of each lane (a host int, or a [B] vector), in place."""
    b, t = s_new.shape[:2]
    if isinstance(pos, int):
        sc[li, row0:row0 + b, :, :, pos:pos + t] = s_new.permute(0, 2, 3, 1)
        return
    rows = torch.arange(row0, row0 + b, device=sc.device)[:, None]
    positions = _window_rows(pos, t, sc.shape[4], sc.device)
    sc[li][rows, :, :, positions] = s_new                   # [B, T, KV, 2]


def _write_kv(cache: KVCache, kvnew, kvq, s_new, li: int, pos, row0: int) -> None:
    """The unfused cache write of a window's rows: the packed rows, or under
    int8 the quantized rows and their scales."""
    if cache.quantized:
        _write_rows(cache.kv, kvq, li, pos, row0)
        _write_scale_rows(cache.scale, s_new, li, pos, row0)
    else:
        _write_rows(cache.kv, kvnew, li, pos, row0)


def _prefill_attention(cfg: ModelConfig, q, kvd, scd, pos_vec: torch.Tensor, t: int,
                       s_limit: int | None):
    """The plain masked attention of a window's T query rows over a lane view
    kvd [B, KV, S, hd + vhd] (int8: dequantized with its scale rows scd
    [B, KV, 2, S]); rows past the logical length s_limit are write slack,
    never attended. Returns [B, T, KV, G, vhd] f32."""
    hd = cfg.head_dim
    if s_limit and s_limit < kvd.shape[2]:
        lim = -(-s_limit // 8) * 8
        kvd = kvd[:, :, :lim]
        scd = None if scd is None else scd[..., :lim]
    kd, vd = kvd[..., :hd], kvd[..., hd:]
    if scd is not None:
        kd, vd = dequantize_kv(kd, scd[:, :, 0:1]), dequantize_kv(vd, scd[:, :, 1:2])
    return _attention(cfg, q.reshape(q.shape[0], t, cfg.n_kv_heads, cfg.gqa_groups, hd), kd, vd,
                      pos_vec, t)


def _expert_count(w) -> int:
    """Experts in a stacked [L, E, O, I] expert weight."""
    return w.qs.shape[1] if isinstance(w, QTensor) else w.shape[1]


def _shared_weight(lw: dict, hf: torch.Tensor, li: int) -> torch.Tensor:
    """sigmoid(shared_gate_inp . h) in f32, [N]."""
    return torch.sigmoid(hf.float() @ lw["shared_gate_inp"][li].float())


def _moe_ffn(cfg: ModelConfig, h: torch.Tensor, lw: dict, li: int) -> torch.Tensor:
    """Qwen2-MoE FFN of layer li: softmax-over-all-experts router, top-k
    WITHOUT renormalization, the routed experts through the grouped
    matmuls, plus the always-on shared expert gated by sigmoid(shared_gate_inp
    . h): folded (the stacks hold S more experts, routed to by every token)
    or explicit. h [B, T, D] -> [B, T, D] in h's dtype."""
    b, t, d = h.shape
    hf = h.reshape(b * t, d)
    probs = torch.softmax(matmul(lw["router"], hf, li).float(), dim=-1)
    top_w, top_i = torch.topk(probs, cfg.n_experts_used, dim=-1)
    e_have = _expert_count(lw["gu_exps"] if "gu_exps" in lw else lw["gate_exps"])
    folded = e_have > cfg.n_experts and "shared_gate_inp" in lw
    if folded:
        s = e_have - cfg.n_experts
        vir = torch.arange(cfg.n_experts, e_have, device=hf.device, dtype=top_i.dtype)
        top_i = torch.cat([top_i, vir[None].expand(b * t, s)], dim=1)
        top_w = torch.cat([top_w, _shared_weight(lw, hf, li)[:, None].expand(b * t, s)], dim=1)
    tm = tile_rows(b * t, top_i.shape[1])
    routed = moe_ffn_grouped(cfg, hf, top_w, top_i, lw, tm=tm, li=li,
                             n_experts=e_have).to(h.dtype)
    if folded:  # the shared expert is inside the routed combine
        return routed.reshape(b, t, d)
    return _moe_shared(h, hf, routed, lw, li)


def _moe_shared(h, hf, routed, lw: dict, li: int) -> torch.Tensor:
    """routed + sigmoid gate * shared expert (unfolded stacks), summed in f32."""
    b, t, d = h.shape
    if "shared_g13" in lw:  # fused shared gate+up
        g13 = matmul(lw["shared_g13"], hf, li)
        ff = g13.shape[-1] // 2
        sg, su = g13[..., :ff], g13[..., ff:]
    else:
        sg, su = matmul(lw["shared_gate"], hf, li), matmul(lw["shared_up"], hf, li)
    sact = F.silu(sg.float()).to(h.dtype) * su
    sdown = matmul(lw["shared_down"], sact, li)
    out = routed.float() + _shared_weight(lw, hf, li)[:, None] * sdown.float()
    return out.to(h.dtype).reshape(b, t, d)


def _dense_ffn(h: torch.Tensor, lw: dict, li: int) -> torch.Tensor:
    """The dense FFN of layer li (`transformer.py:186-200`): K20 in one call
    where `ffn_fused_rowq` takes it, else w13 (or w1 and w3 where they did
    not fuse), silu * up in h's dtype, w2."""
    if "w13" not in lw:
        gate, up = matmul(lw["w1"], h, li), matmul(lw["w3"], h, li)
        return matmul(lw["w2"], F.silu(gate.float()).to(h.dtype) * up, li)
    y = ffn_fused_rowq(lw["w13"], lw["w2"], h, li)
    if y is not None:
        return y
    g13 = matmul(lw["w13"], h, li)
    ff = g13.shape[-1] // 2
    act = F.silu(g13[..., :ff].float()).to(h.dtype) * g13[..., ff:]
    return matmul(lw["w2"], act, li)


def _is_rowq(w) -> bool:
    return isinstance(w, QTensor) and w.kind == "q8_row"


def _layer(cfg: ModelConfig, lw: dict, x, cache, li: int, pos, pos_vec: torch.Tensor, cos, sin,
           s_limit: int | None, tables, batch_offset: int | None):
    b, t = x.shape[:2]
    nkv, g, hd = cfg.n_kv_heads, cfg.gqa_groups, cfg.head_dim
    eps, rs = cfg.rms_norm_eps, cfg.residual_scale
    paged = isinstance(cache, PagedKVCache)
    rows = b * t
    rowq = _is_rowq(lw.get("wqkv"))
    xbytes = x.element_size()
    if rowq and qkv_fits(rows, lw["wqkv"].qs.shape[-2], cfg.dim, xbytes):
        qkv = qkv_norm_fused_rowq(lw["wqkv"], lw["attn_norm"], x, li, eps)
    else:
        h = rmsnorm(x, lw["attn_norm"][li], eps)
        # wq, wk and wv stay apart where their kinds differ (a Q4_K_M file's
        # Q6_K attn_v): the same values as the fused projection
        qkv = (matmul(lw["wqkv"], h, li) if "wqkv" in lw
               else torch.cat([matmul(lw[k], h, li) for k in ("wq", "wk", "wv")], dim=-1))
    if cfg.qkv_bias:
        qkv = qkv + torch.cat([lw["q_bias"][li], lw["k_bias"][li],
                               lw["v_bias"][li]]).to(qkv.dtype)
    qd, kd = cfg.q_dim, cfg.kv_dim
    qk = qkv[..., :qd + kd].reshape(b, t, cfg.n_heads + nkv, hd)
    if cfg.qk_norm:  # per head: row h of the stacked weights norms head h
        qk = rmsnorm(qk, lw["qk_norm"][li], eps)
    # q and k heads rotate in one call (elementwise: the same values as two)
    qk = apply_rope(qk, cos, sin, cfg.rope_style)
    q, k = qk[:, :, :cfg.n_heads], qk[:, :, cfg.n_heads:]
    v = qkv[..., qd + kd:].reshape(b, t, nkv, cfg.v_head_dim)
    kvnew = torch.cat([k, v], dim=-1)                 # [B, T, KV, hd + vhd]
    kvq = s_new = None
    if cache.quantized:  # per (token, KV head), outside the kernels as in the JAX package
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        kvq, s_new = torch.cat([kq, vq], dim=-1), torch.stack([ks, vs], dim=-1)  # [B, T, KV, 2]
    stacked = t == 1 and batch_offset is None
    scale = cfg.attn_score_scale
    q4 = q.reshape(b, nkv, g, hd) if t == 1 else None
    if paged:
        pool = paged_write_stacked(cache.kv_pool, li, kvnew if kvq is None else kvq, tables,
                                   pos_vec, cache.block_size)
        if cache.quantized:
            paged_write_scale_stacked(cache.scale, li, s_new, tables, pos_vec, cache.block_size)
        if stacked:
            attn = att.decode_attention_paged(q4, pool, tables, pos_vec, scale, hd, li,
                                              scale_pool=cache.scale)
        else:
            scd = paged_gather_scale(cache.scale[li], tables) if cache.quantized else None
            attn = _prefill_attention(cfg, q, paged_gather(pool[li], tables), scd, pos_vec, t,
                                      None)
    elif stacked:
        s_phys = cache.kv.shape[3]
        long_cache = s_phys * cache.kv.element_size() >= att.SPLIT_THRESHOLD_BYTES
        fused = s_phys % 32 == 0 and not os.environ.get("LLAMATPU_NO_FUSED_ATTN")
        if long_cache:
            fused = fused and att.pick_tile(s_phys) >= 128
        if (fused and not long_cache and not cache.quantized and b == 1 and rowq
                and not cfg.is_moe and _is_rowq(lw["wo"]) and _is_rowq(lw.get("w13"))
                and _is_rowq(lw["w2"]) and not os.environ.get("LLAMATPU_NO_ATTN_TAIL")
                and attn_tail_fits(cfg.dim, lw["wo"].qs.shape[-1], lw["w2"].qs.shape[-1], nkv, g,
                                   cfg.v_head_dim, s_phys, cache.kv.element_size(), xbytes)):
            x, _ = layer_attn_tail_fused_rowq(
                lw["wo"], lw["w13"], lw["w2"], lw["ffn_norm"], q4, kvnew[:, 0], cache.kv, x,
                pos_vec, li, eps, scale, hd, rs)
            return x
        tile = att.pick_tile(s_phys)
        if fused and cache.quantized and long_cache:
            attn, _, _ = att.decode_attention_split_fused_write_q(
                q4, kvq[:, 0], s_new[:, 0], cache.kv, cache.scale, pos_vec, scale, li, hd, tile)
        elif fused and cache.quantized:
            attn, _, _ = att.decode_attention_fused_write_q(
                q4, kvq[:, 0], s_new[:, 0], cache.kv, cache.scale, pos_vec, scale, li, hd)
        elif fused and long_cache:
            attn, _ = att.decode_attention_split_fused_write(q4, kvnew[:, 0], cache.kv, pos_vec,
                                                             scale, li, hd, tile)
        elif fused:
            attn, _ = att.decode_attention_fused_write(q4, kvnew[:, 0], cache.kv, pos_vec, scale,
                                                       li, hd)
        else:
            _write_kv(cache, kvnew, kvq, s_new, li, pos, 0)
            attn = att.decode_attention_auto(q4, cache.kv, pos_vec, scale, scale_rows=cache.scale,
                                             s_limit=s_limit, layer_index=li, hd=hd)
    else:
        row0 = batch_offset or 0
        _write_kv(cache, kvnew, kvq, s_new, li, pos, row0)
        kvd = cache.kv[li, row0:row0 + b]
        scd = cache.scale[li, row0:row0 + b] if cache.quantized else None
        if t == 1:
            attn = att.decode_attention_auto(q4, kvd, pos_vec, scale, scale_rows=scd,
                                             s_limit=s_limit, hd=hd)
        else:
            attn = _prefill_attention(cfg, q, kvd, scd, pos_vec, t, s_limit)
    attn = attn.reshape(b, t, -1).to(x.dtype)
    if not cfg.is_moe and "w13" in lw:
        new_x = layer_tail_fused_rowq(lw["wo"], lw["w13"], lw["w2"], lw["ffn_norm"], attn, x, li,
                                      eps, rs)
        if new_x is not None:
            return new_x
    attn_out = matmul(lw["wo"], attn, li)
    if rs != 1.0:
        attn_out = (attn_out.float() * rs).to(x.dtype)
    x = x + attn_out
    h2 = rmsnorm(x, lw["ffn_norm"][li], eps)
    ffn = _moe_ffn(cfg, h2, lw, li) if cfg.is_moe else _dense_ffn(h2, lw, li)
    if rs != 1.0:
        ffn = (ffn.float() * rs).to(x.dtype)
    return x + ffn


def forward_tokens(cfg: ModelConfig, weights, tokens: torch.Tensor, cache, pos,
                   last_logit_only=False, logit_index=None, s_limit: int | None = None,
                   tables: torch.Tensor | None = None, batch_offset: int | None = None):
    """Run T tokens at absolute positions pos..pos+T-1 through the model.

    tokens: int [B, T] on the weights' device. pos: a host int (every lane
    at the same start: prefill) or an int [B] vector on the device
    (per-lane starts, read on the card: every decode step, whose CUDA graph
    would bake a host int into its kernels' arguments and the cache
    writes' slices). cache: KVCache, or PagedKVCache with `tables`
    [B, MAXBLK] int32 block tables on the device. batch_offset (dense cache
    only): the window's B rows are cache rows [batch_offset, batch_offset +
    B), e.g. one lane's prefill into the batched cache. The cache is written
    in place. Returns (f32 logits, cache): [B, T, V], or [B, V] with
    last_logit_only or logit_index (the last REAL token of a padded final
    prefill chunk)."""
    paged = isinstance(cache, PagedKVCache)
    if paged and (tables is None or batch_offset is not None):
        raise ValueError("a paged cache takes block tables and no batch_offset")
    b, t = tokens.shape
    x = embed_tokens(cfg, weights, tokens)
    if isinstance(pos, torch.Tensor):
        pos_vec = pos.to(device=x.device, dtype=torch.int32)
    else:
        pos = int(pos)
        pos_vec = torch.full((b,), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_slices(weights, pos_vec, t)
    for li in range(cfg.n_layers):
        x = _layer(cfg, weights["layers"], x, cache, li, pos, pos_vec, cos, sin, s_limit,
                   tables, batch_offset)
    return finish_logits(cfg, weights, x, last_logit_only, logit_index), cache
