"""K6: the fused KV-append + decode attention of a layer (T = 1), the
counterpart of llamatpu/ops/pallas_attention.py `_fused_write_kernel`
(through `decode_attention_fused_write`).

q [B, KV, G, hd] and kv_new [B, KV, hd + vhd] are this token's post-RoPE
queries and packed K|V row; kvc is the packed stacked cache
[L, B, KV, S, hd + vhd]. Row pos_vec[b] of layer `layer_index` is written
with kv_new cast to the cache dtype (IN PLACE: the JAX package aliased the
buffer), and nothing else of the cache changes. The new row is cast BEFORE
it is attended, so the result equals write-then-attend. Scores are
(q . k) * scale in f32 over rows s <= pos, masked with NEG_INF = -1e30, and
softmax is e / sum(e); the output is [B, KV, G, vhd] f32.

The TPU version serves caches below 8192 bf16 rows (its VMEM) and hands
longer ones to `_split_kernel`; this card has no such limit, so K6 serves
every length. CUDA source: csrc/attention.cu (design and bound in its
header note). A CPU tensor takes the plain version; a CUDA tensor launches
K6 or raises. Int8 caches (the TPU kernel's `quant=True` variant) belong to
the int8-KV slice of the port.
"""
from __future__ import annotations

import torch

from llamatpu_torch import _build

NEG_INF = -1e30
CHUNK = 64  # cache rows per block of K6's first pass (csrc/attention.cu kChunk)


def _check(q, kv_new, kvc, hd):
    if kvc.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{kvc.dtype} KV cache: int8-KV slice of the port")
    b, kvh, g, hdq = q.shape
    width = kvc.shape[-1]
    if hdq != hd or tuple(kv_new.shape) != (b, kvh, width) or kvc.shape[1:3] != (b, kvh):
        raise ValueError(f"decode_attention_fused_write: shapes q {tuple(q.shape)}, kv_new "
                         f"{tuple(kv_new.shape)}, cache {tuple(kvc.shape)}, hd {hd}")


def decode_attention_fused_write_plain(q, kv_new, kvc, pos_vec, scale: float,
                                       layer_index: int, hd: int | None = None):
    """Plain version of K6 (same arguments and results)."""
    hd = hd or q.shape[-1]
    _check(q, kv_new, kvc, hd)
    b = q.shape[0]
    kv = kvc[layer_index]                                   # [B, KV, S, W] view
    rows = torch.arange(b, device=kv.device)
    pos = pos_vec.to(device=kv.device, dtype=torch.long)
    kv[rows, :, pos] = kv_new.to(kv.dtype)                  # [B, KV, W] at each row's pos
    kf = kv.float()
    scores = torch.einsum("bkgh,bksh->bkgs", q.float(), kf[..., :hd]) * scale
    s_idx = torch.arange(kv.shape[2], device=kv.device)
    mask = (s_idx[None, :] <= pos[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    att = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bkgs,bksv->bkgv", att, kf[..., hd:]), kvc


def decode_attention_fused_write(q: torch.Tensor, kv_new: torch.Tensor, kvc: torch.Tensor,
                                 pos_vec: torch.Tensor, scale: float, layer_index: int,
                                 hd: int | None = None):
    """K6. Returns (attn [B, KV, G, vhd] f32, kvc) with kvc written in place
    at (layer_index, b, :, pos_vec[b]) only. pos_vec: int [B] on the cache's
    device (read by the kernel, so no host sync)."""
    if kvc.device.type == "cpu":
        return decode_attention_fused_write_plain(q, kv_new, kvc, pos_vec, scale,
                                                  layer_index, hd)
    hd = hd or q.shape[-1]
    _check(q, kv_new, kvc, hd)
    b, kvh, g, _ = q.shape
    s_len, width = kvc.shape[-2], kvc.shape[-1]
    vhd = width - hd
    if g > 8 or hd % 8 or vhd % 8 or width > 256:
        raise NotImplementedError("K6 takes G <= 8, hd and vhd multiples of 8, hd + vhd <= 256")
    qc, kvn = q.contiguous(), kv_new.contiguous()
    pv = pos_vec.to(dtype=torch.int32).contiguous()
    _build.require(kvc.is_contiguous() and qc.device == kvn.device == kvc.device == pv.device
                   and qc.dtype == kvn.dtype and tuple(pv.shape) == (b,),
                   "decode_attention_fused_write: contiguous cache, inputs on its device, "
                   "q and kv_new of one dtype, pos_vec [B]")
    nsplit = -(-s_len // CHUNK)
    part_o = torch.empty((b, kvh, nsplit, g, vhd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, kvh, nsplit, g, 2), dtype=torch.float32, device=q.device)
    out = torch.empty((b, kvh, g, vhd), dtype=torch.float32, device=q.device)
    lib = _build.load("attention")
    err = lib.lt_decode_attention(qc.data_ptr(), kvn.data_ptr(), _build.dtype_code(qc),
                                  kvc[layer_index].data_ptr(), _build.dtype_code(kvc),
                                  pv.data_ptr(), b, kvh, g, s_len, hd, vhd, float(scale),
                                  part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                                  nsplit, _build.stream())
    _build.check(lib, err, "decode_attention_fused_write")
    decode_attention_fused_write.launches += 1
    return out, kvc


decode_attention_fused_write.launches = 0
