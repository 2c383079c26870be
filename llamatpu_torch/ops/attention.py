"""Decode attention kernels (T = 1):

- K6 `decode_attention_fused_write`: the fused KV-append + decode attention
  of a layer over the dense packed cache, the counterpart of
  llamatpu/ops/pallas_attention.py `_fused_write_kernel` (through
  `decode_attention_fused_write`);
- K8 `decode_attention_paged`: decode attention over the shared paged block
  pool through per-lane block tables, the counterpart of `_paged_kernel`
  (body `_split_kernel`, through `decode_attention_paged`).

K6:

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
every length.

K8: q [B, KV, G, hd] post-RoPE queries; the packed pool
[L, NBLK, KV, BS, hd + vhd] (with layer_index) or [NBLK, KV, BS, hd + vhd];
tables [B, MAXBLK] int32; pos_vec [B]. Row s of lane b's logical sequence
lives in pool block tables[b, s // BS] at offset s % BS; scores are
(q . k) * scale in f32 over rows s <= pos_vec[b], masked with NEG_INF, and
the output is acc / l, [B, KV, G, vhd] f32. The KV row of this step is
written before the call by `runtime/paged_cache.paged_write_stacked` (a
plain index write, as the JAX package leaves it to XLA); unallocated table
entries point at the trash block and lie past pos, so they are masked.

CUDA source: csrc/attention.cu (designs and bounds in its header note). A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Int8 caches (the TPU kernels' `quant=True` variants) belong to the
int8-KV slice of the port.
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


# ----------------------------------------------------------------- K8
def _check_paged(q, kv_pool, tables, hd, layer_index):
    if kv_pool.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{kv_pool.dtype} KV pool: int8-KV slice of the port")
    b, kvh, _, hdq = q.shape
    pool_dims = 4 if layer_index is None else 5
    bs = kv_pool.shape[-2]
    if (hdq != hd or kv_pool.dim() != pool_dims or kv_pool.shape[-3] != kvh
            or tables.dim() != 2 or tables.shape[0] != b or bs & (bs - 1)):
        raise ValueError(f"decode_attention_paged: shapes q {tuple(q.shape)}, pool "
                         f"{tuple(kv_pool.shape)}, tables {tuple(tables.shape)}, hd {hd}, "
                         f"layer_index {layer_index} (block size a power of two)")


def decode_attention_paged_plain(q, kv_pool, tables, pos_vec, scale: float,
                                 hd: int | None = None, layer_index: int | None = None):
    """Plain version of K8 (same arguments and result): the lane's blocks
    gathered into a dense view, masked f32 scores, acc / l."""
    hd = hd or q.shape[-1]
    _check_paged(q, kv_pool, tables, hd, layer_index)
    pool = kv_pool if layer_index is None else kv_pool[layer_index]
    b, kvh = q.shape[:2]
    nb, bs = tables.shape[1], pool.shape[-2]
    g = pool[tables.long()]                                  # [B, MAXBLK, KV, BS, W]
    kf = g.permute(0, 2, 1, 3, 4).reshape(b, kvh, nb * bs, pool.shape[-1]).float()
    scores = torch.einsum("bkgh,bksh->bkgs", q.float(), kf[..., :hd]) * scale
    pos = pos_vec.to(device=kf.device, dtype=torch.long)
    s_idx = torch.arange(nb * bs, device=kf.device)
    mask = (s_idx[None, :] <= pos[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bkgs,bksv->bkgv", e, kf[..., hd:])
    return acc / e.sum(dim=-1, keepdim=True)


def decode_attention_paged(q: torch.Tensor, kv_pool: torch.Tensor, tables: torch.Tensor,
                           pos_vec: torch.Tensor, scale: float, hd: int | None = None,
                           layer_index: int | None = None) -> torch.Tensor:
    """K8. Returns attn [B, KV, G, vhd] f32. tables (int32 [B, MAXBLK]) and
    pos_vec (int [B]) live on the pool's device and are read by the kernel,
    so the call does not wait for the host. The pool is only read."""
    if kv_pool.device.type == "cpu":
        return decode_attention_paged_plain(q, kv_pool, tables, pos_vec, scale, hd,
                                            layer_index)
    hd = hd or q.shape[-1]
    _check_paged(q, kv_pool, tables, hd, layer_index)
    b, kvh, g, _ = q.shape
    bs, width = kv_pool.shape[-2], kv_pool.shape[-1]
    vhd = width - hd
    if g > 8 or hd % 8 or vhd % 8 or width > 256:
        raise NotImplementedError("K8 takes G <= 8, hd and vhd multiples of 8, hd + vhd <= 256")
    pool = kv_pool if layer_index is None else kv_pool[layer_index]
    qc = q.contiguous()
    tb = tables.to(dtype=torch.int32).contiguous()
    pv = pos_vec.to(dtype=torch.int32).contiguous()
    _build.require(pool.is_contiguous() and qc.device == pool.device == tb.device == pv.device
                   and tuple(pv.shape) == (b,),
                   "decode_attention_paged: contiguous pool, inputs on its device, pos_vec [B]")
    maxblk = tb.shape[1]
    s_len = maxblk * bs
    nsplit = -(-s_len // CHUNK)
    part_o = torch.empty((b, kvh, nsplit, g, vhd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, kvh, nsplit, g, 2), dtype=torch.float32, device=q.device)
    out = torch.empty((b, kvh, g, vhd), dtype=torch.float32, device=q.device)
    lib = _build.load("attention")
    err = lib.lt_paged_attention(qc.data_ptr(), _build.dtype_code(qc), pool.data_ptr(),
                                 _build.dtype_code(pool), tb.data_ptr(), pv.data_ptr(), b, kvh,
                                 g, pool.shape[0], bs.bit_length() - 1, maxblk, hd, vhd,
                                 float(scale), part_o.data_ptr(), part_ml.data_ptr(),
                                 out.data_ptr(), nsplit, _build.stream())
    _build.check(lib, err, "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0
