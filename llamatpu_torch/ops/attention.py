"""Decode attention kernels (T = 1), the counterparts of
llamatpu/ops/pallas_attention.py:

- K6 `decode_attention_fused_write`: the fused KV-append + decode attention
  of a layer over the dense packed cache (`_fused_write_kernel`), and its
  int8 variant `decode_attention_fused_write_q` (quant=True);
- K8 `decode_attention_paged`: decode attention over the shared paged block
  pool through per-lane block tables (`_paged_kernel`, body `_split_kernel`),
  and its int8 variant `decode_attention_paged_q` (the JAX function's
  `scale_pool=`);
- K14, `_split_kernel`'s dense callers: `decode_attention_split[_q]`,
  `decode_attention_split_stats` and `decode_attention_split_fused_write[_q]`,
  S-tiled online-softmax attention over a long cache;
- K15 `decode_attention[_q]`, `_full_kernel`: masked attention over the
  first `s_use` rows;
- `decode_attention_auto`, which picks between K14 and K15 exactly as the
  JAX function does.

Shapes: q [B, KV, G, hd] post-RoPE queries; the packed cache [L, B, KV, S,
hd + vhd] with `layer_index` (or one layer, [B, KV, S, hd + vhd], where the
JAX function takes layer_index=None); int8 caches carry scale rows
[L, B, KV, 2, S] f32 (row 0 = K, row 1 = V; ops/kv_quant.py); pos_vec [B]
int on the cache's device. Every function returns [B, KV, G, vhd] f32.
Scores are (q . k) * scale in f32 (* k_scale[s] under int8) over rows
s <= pos_vec[b], masked with NEG_INF = -1e30; the output is
sum_s exp(score_s - m) (* v_scale[s]) v_s / l with l = sum_s exp(score_s - m)
(the V scale never enters l). The fused functions write row pos_vec[b] of
layer `layer_index` (and under int8 its two scales) IN PLACE, cast to the
cache dtype before it is attended (the JAX package aliased the buffers), and
change nothing else of the cache. `s_tile` is kept for the JAX signature and
checked as the JAX functions assert it (S a multiple of it, a power of two);
the kernels pick their own split.

K8: tables [B, MAXBLK] int32; row s of lane b lives in pool block
tables[b, s // BS] at offset s % BS; the KV row of this step is written
before the call by `runtime/paged_cache.paged_write_stacked` (a plain index
write, as the JAX package leaves it to XLA); unallocated table entries point
at the trash block and lie past pos, so they are masked.

CUDA source: csrc/attention.cu (designs and bounds in its header note). A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import torch

from llamatpu_torch import _build

NEG_INF = -1e30
CHUNK = 64  # cache rows per block of K6's first pass (csrc/attention.cu kChunk)
# a cache of S_phys rows is long when S_phys * itemsize reaches this: the JAX
# package's full-stripe kernel stops fitting its VMEM there and it takes the
# split kernel instead (pallas_attention.py:888); the port keeps its rule
SPLIT_THRESHOLD_BYTES = 16384
SPLIT_TILE = 1024
SMS = 132  # streaming multiprocessors of an H100 SXM: the walk's split target
CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # common.cuh LT_*


def pick_tile(s: int) -> int:
    """The JAX package's S tile: the largest power of two <= 1024 dividing S
    (below 128 the JAX package takes the full-stripe kernel instead)."""
    tile = SPLIT_TILE
    while tile >= 128 and s % tile != 0:
        tile //= 2
    return tile


def split_rows(s_use: int, kvh: int, b: int) -> int:
    """Cache rows per pass-1 block of the walk kernel (K14, K15): a power of
    two from 64 to 1024, the smallest at which the whole stripe needs at most
    about two blocks per SM."""
    rows = CHUNK
    while rows < 1024 and -(-s_use // rows) * kvh * b > 2 * SMS:
        rows *= 2
    return rows


def _layer(t: torch.Tensor | None, layer_index):
    return t if t is None or layer_index is None else t[layer_index]


def _check_dense(q, kvc, hd, layer_index, scale_rows=None, what="decode attention") -> int:
    """Validate q against a dense packed cache (+ scale rows); returns hd."""
    hd = hd or q.shape[-1]
    if scale_rows is None and kvc.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{what}: {kvc.dtype} KV cache (int8-KV caches take the _q "
                                  "variant with their scale rows)")
    if scale_rows is not None and kvc.dtype != torch.int8:
        raise ValueError(f"{what}: scale rows with a {kvc.dtype} cache")
    b, kvh, _, hdq = q.shape
    dims = 4 if layer_index is None else 5
    if (hdq != hd or kvc.dim() != dims or tuple(kvc.shape[-4:-2]) != (b, kvh)
            or (scale_rows is not None
                and tuple(scale_rows.shape) != tuple(kvc.shape[:-2]) + (2, kvc.shape[-2]))):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, cache {tuple(kvc.shape)}, scale "
                         f"rows {None if scale_rows is None else tuple(scale_rows.shape)}, "
                         f"hd {hd}, layer_index {layer_index}")
    return hd


def _check_tile(kvc, s_tile: int) -> None:
    s = kvc.shape[-2]
    if s_tile & (s_tile - 1) or s % s_tile:
        raise ValueError(f"split attention: S {s} is not a multiple of the power-of-two "
                         f"tile {s_tile}")


def _attend_plain(q, kv, pos_vec, scale: float, hd: int, sc=None, s_use: int | None = None):
    """Masked attention of q over one layer's packed rows kv [B, KV, S, W]
    (+ int8 scale rows sc [B, KV, 2, S]), the first s_use rows. Returns
    (acc / l, m, l): [B, KV, G, vhd], [B, KV, G, 1], [B, KV, G, 1] f32."""
    s = s_use or kv.shape[2]
    kf = kv[:, :, :s].float()
    scores = torch.einsum("bkgh,bksh->bkgs", q.float(), kf[..., :hd]) * scale
    if sc is not None:
        scores = scores * sc[:, :, 0, :s][:, :, None]
    pos = pos_vec.to(device=kf.device, dtype=torch.long)
    mask = (torch.arange(s, device=kf.device)[None, :] <= pos[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    l = e.sum(dim=-1, keepdim=True)
    if sc is not None:
        e = e * sc[:, :, 1, :s][:, :, None]
    return torch.einsum("bkgs,bksv->bkgv", e, kf[..., hd:]) / l, m, l


def _write_plain(kvc, scale_rows, kv_new, s_new, pos_vec, layer_index) -> None:
    """Row pos_vec[b] of layer layer_index := kv_new[b] cast to the cache
    dtype (and its scales s_new [B, KV, 2]), in place."""
    kv = kvc[layer_index]
    rows = torch.arange(kv.shape[0], device=kv.device)
    pos = pos_vec.to(device=kv.device, dtype=torch.long)
    kv[rows, :, pos] = kv_new.to(kv.dtype)                  # [B, KV, W] at each row's pos
    if scale_rows is not None:
        scale_rows[layer_index][rows, :, :, pos] = s_new.to(torch.float32)


def _check_new(q, kv_new, kvc, s_new, scale_rows) -> None:
    b, kvh = q.shape[:2]
    if (tuple(kv_new.shape) != (b, kvh, kvc.shape[-1])
            or (scale_rows is not None and (kv_new.dtype != torch.int8 or s_new is None
                                            or tuple(s_new.shape) != (b, kvh, 2)))):
        raise ValueError(f"fused write: kv_new {tuple(kv_new.shape)} {kv_new.dtype}, s_new "
                         f"{None if s_new is None else tuple(s_new.shape)} for cache "
                         f"{tuple(kvc.shape)} {kvc.dtype}")


def _walk(q, kvc, pos_vec, scale: float, hd: int, layer_index, scale_rows=None, kv_new=None,
          s_new=None, s_use: int | None = None, stats: bool = False, rows: int | None = None):
    """Launch the walk kernel (K14, K15, K6's int8 variant) on one layer:
    (out [B, KV, G, vhd], m, l [B, KV, G, 1] or None) f32."""
    kv, sc = _layer(kvc, layer_index), _layer(scale_rows, layer_index)
    b, kvh, g, _ = q.shape
    s_len, width = kv.shape[-2], kv.shape[-1]
    vhd = width - hd
    vec = 16 if kv.dtype == torch.int8 else 8
    if g > 8 or hd % vec or vhd % vec or width > 256:
        raise NotImplementedError(f"decode attention takes G <= 8, hd and vhd multiples of {vec} "
                                  "(the 16-byte loads), hd + vhd <= 256")
    s_use = s_use or s_len
    rows = rows or split_rows(s_use, kvh, b)
    nsplit = -(-s_use // rows)
    qc = q.contiguous()
    pv = pos_vec.to(dtype=torch.int32).contiguous()
    kvn = None if kv_new is None else kv_new.contiguous()
    sn = None if s_new is None else s_new.to(torch.float32).contiguous()
    _build.require(kv.is_contiguous() and (sc is None or sc.is_contiguous())
                   and qc.device == kv.device == pv.device and tuple(pv.shape) == (b,)
                   and (kvn is None or kvn.device == kv.device)
                   and (sn is None or sn.device == kv.device)
                   and (sc is None or sc.device == kv.device),
                   "decode attention: contiguous cache and scale rows, inputs on the cache's "
                   "device, pos_vec [B]")
    dev = q.device
    part_o = torch.empty((b, kvh, nsplit, g, vhd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, kvh, nsplit, g, 2), dtype=torch.float32, device=dev)
    out = torch.empty((b, kvh, g, vhd), dtype=torch.float32, device=dev)
    m = l = None
    if stats:
        m = torch.empty((b, kvh, g, 1), dtype=torch.float32, device=dev)
        l = torch.empty((b, kvh, g, 1), dtype=torch.float32, device=dev)
    kvn_code = 0 if kvn is None else (2 if kvn.dtype == torch.int8 else _build.dtype_code(kvn))
    lib = _build.load("attention")
    err = lib.lt_attention_walk(
        qc.data_ptr(), _build.dtype_code(qc), None if kvn is None else kvn.data_ptr(), kvn_code,
        None if sn is None else sn.data_ptr(), kv.data_ptr(), CACHE_CODES[kv.dtype],
        None if sc is None else sc.data_ptr(), pv.data_ptr(), b, kvh, g, s_len, s_use, hd, vhd,
        float(scale), rows, int(kvn is not None), part_o.data_ptr(), part_ml.data_ptr(),
        out.data_ptr(), None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
        nsplit, _build.stream())
    _build.check(lib, err, "decode attention (walk kernel)")
    return out, m, l


# ----------------------------------------------------------------- K6
def _check(q, kv_new, kvc, hd):
    if kvc.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{kvc.dtype} KV cache: int8-KV caches take "
                                  "decode_attention_fused_write_q")
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


def decode_attention_fused_write_q_plain(q, kv_new, s_new, kvc, scale_rows, pos_vec,
                                         scale: float, layer_index: int, hd: int | None = None):
    """Plain version of K6's int8 variant (same arguments and results)."""
    hd = _check_dense(q, kvc, hd, layer_index, scale_rows, "decode_attention_fused_write_q")
    _check_new(q, kv_new, kvc, s_new, scale_rows)
    _write_plain(kvc, scale_rows, kv_new, s_new, pos_vec, layer_index)
    out = _attend_plain(q, kvc[layer_index], pos_vec, scale, hd, scale_rows[layer_index])[0]
    return out, kvc, scale_rows


def decode_attention_fused_write_q(q, kv_new, s_new, kvc, scale_rows, pos_vec, scale: float,
                                   layer_index: int, hd: int | None = None):
    """K6's int8 variant (`_fused_write_kernel`, quant=True). kv_new int8
    [B, KV, hd + vhd] and s_new f32 [B, KV, 2] come from
    ops/kv_quant.quantize_kv of K and V (quantized outside the kernel, as the
    JAX package does); kvc int8 [L, B, KV, S, hd + vhd]; scale_rows f32
    [L, B, KV, 2, S]. Returns (attn, kvc, scale_rows), both written in place
    at row pos_vec[b] of layer layer_index only. K6's split: 64 rows a block."""
    if kvc.device.type == "cpu":
        return decode_attention_fused_write_q_plain(q, kv_new, s_new, kvc, scale_rows, pos_vec,
                                                    scale, layer_index, hd)
    hd = _check_dense(q, kvc, hd, layer_index, scale_rows, "decode_attention_fused_write_q")
    _check_new(q, kv_new, kvc, s_new, scale_rows)
    out, _, _ = _walk(q, kvc, pos_vec, scale, hd, layer_index, scale_rows, kv_new, s_new,
                      rows=CHUNK)
    decode_attention_fused_write_q.launches += 1
    return out, kvc, scale_rows


decode_attention_fused_write_q.launches = 0


# ----------------------------------------------------------------- K14
def decode_attention_split_plain(q, kvc, pos_vec, scale: float, hd: int | None = None,
                                 s_tile: int = SPLIT_TILE, layer_index=None):
    """Plain version of K14, unfused (same arguments and result)."""
    hd = _check_dense(q, kvc, hd, layer_index, what="decode_attention_split")
    _check_tile(kvc, s_tile)
    return _attend_plain(q, _layer(kvc, layer_index), pos_vec, scale, hd)[0]


def decode_attention_split(q, kvc, pos_vec, scale: float, hd: int | None = None,
                           s_tile: int = SPLIT_TILE, layer_index=None) -> torch.Tensor:
    """K14, unfused (`_split_call`): attention over the whole stripe, bf16/f32
    cache. Returns [B, KV, G, vhd] f32; the cache is only read."""
    if kvc.device.type == "cpu":
        return decode_attention_split_plain(q, kvc, pos_vec, scale, hd, s_tile, layer_index)
    hd = _check_dense(q, kvc, hd, layer_index, what="decode_attention_split")
    _check_tile(kvc, s_tile)
    out, _, _ = _walk(q, kvc, pos_vec, scale, hd, layer_index)
    decode_attention_split.launches += 1
    return out


decode_attention_split.launches = 0


def decode_attention_split_q_plain(q, kvc, scale_rows, pos_vec, scale: float,
                                   hd: int | None = None, s_tile: int = SPLIT_TILE,
                                   layer_index=None):
    """Plain version of K14, unfused int8 (same arguments and result)."""
    hd = _check_dense(q, kvc, hd, layer_index, scale_rows, "decode_attention_split_q")
    _check_tile(kvc, s_tile)
    return _attend_plain(q, _layer(kvc, layer_index), pos_vec, scale, hd,
                         _layer(scale_rows, layer_index))[0]


def decode_attention_split_q(q, kvc, scale_rows, pos_vec, scale: float, hd: int | None = None,
                             s_tile: int = SPLIT_TILE, layer_index=None) -> torch.Tensor:
    """K14, unfused, over an int8 cache and its scale rows [(L,) B, KV, 2, S]."""
    if kvc.device.type == "cpu":
        return decode_attention_split_q_plain(q, kvc, scale_rows, pos_vec, scale, hd, s_tile,
                                              layer_index)
    hd = _check_dense(q, kvc, hd, layer_index, scale_rows, "decode_attention_split_q")
    _check_tile(kvc, s_tile)
    out, _, _ = _walk(q, kvc, pos_vec, scale, hd, layer_index, scale_rows)
    decode_attention_split_q.launches += 1
    return out


decode_attention_split_q.launches = 0


def decode_attention_split_stats_plain(q, kvc, pos_vec, scale: float, hd: int | None = None,
                                       s_tile: int = SPLIT_TILE, layer_index=None):
    """Plain version of K14's stats mode (same arguments and results)."""
    hd = _check_dense(q, kvc, hd, layer_index, what="decode_attention_split_stats")
    _check_tile(kvc, s_tile)
    return _attend_plain(q, _layer(kvc, layer_index), pos_vec, scale, hd)


def decode_attention_split_stats(q, kvc, pos_vec, scale: float, hd: int | None = None,
                                 s_tile: int = SPLIT_TILE, layer_index=None):
    """K14 with the stripe's softmax statistics (`_split_call`, stats=True),
    for a cross-shard combine: (o normalized by this stripe's l, m, l), m and
    l [B, KV, G, 1] f32; combine as w = exp(m - max m) * l, o = sum w o / sum w."""
    if kvc.device.type == "cpu":
        return decode_attention_split_stats_plain(q, kvc, pos_vec, scale, hd, s_tile,
                                                  layer_index)
    hd = _check_dense(q, kvc, hd, layer_index, what="decode_attention_split_stats")
    _check_tile(kvc, s_tile)
    out = _walk(q, kvc, pos_vec, scale, hd, layer_index, stats=True)
    decode_attention_split_stats.launches += 1
    return out


decode_attention_split_stats.launches = 0


def decode_attention_split_fused_write_plain(q, kv_new, kvc, pos_vec, scale: float, layer_index,
                                             hd: int | None = None, s_tile: int = SPLIT_TILE):
    """Plain version of K14, fused (same arguments and results)."""
    hd = _check_dense(q, kvc, hd, layer_index, what="decode_attention_split_fused_write")
    _check_tile(kvc, s_tile)
    _check_new(q, kv_new, kvc, None, None)
    _write_plain(kvc, None, kv_new, None, pos_vec, layer_index)
    return _attend_plain(q, kvc[layer_index], pos_vec, scale, hd)[0], kvc


def decode_attention_split_fused_write(q, kv_new, kvc, pos_vec, scale: float, layer_index,
                                       hd: int | None = None, s_tile: int = SPLIT_TILE):
    """K14, fused (`_split_fused_call`): append kv_new [B, KV, hd + vhd] at
    row pos_vec[b] of the stacked bf16/f32 cache (in place), then attend.
    Returns (attn [B, KV, G, vhd] f32, kvc)."""
    if kvc.device.type == "cpu":
        return decode_attention_split_fused_write_plain(q, kv_new, kvc, pos_vec, scale,
                                                        layer_index, hd, s_tile)
    hd = _check_dense(q, kvc, hd, layer_index, what="decode_attention_split_fused_write")
    _check_tile(kvc, s_tile)
    _check_new(q, kv_new, kvc, None, None)
    out, _, _ = _walk(q, kvc, pos_vec, scale, hd, layer_index, kv_new=kv_new)
    decode_attention_split_fused_write.launches += 1
    return out, kvc


decode_attention_split_fused_write.launches = 0


def decode_attention_split_fused_write_q_plain(q, kv_new, s_new, kvc, scale_rows, pos_vec,
                                               scale: float, layer_index, hd: int | None = None,
                                               s_tile: int = SPLIT_TILE):
    """Plain version of K14, fused int8 (same arguments and results)."""
    hd = _check_dense(q, kvc, hd, layer_index, scale_rows, "decode_attention_split_fused_write_q")
    _check_tile(kvc, s_tile)
    _check_new(q, kv_new, kvc, s_new, scale_rows)
    _write_plain(kvc, scale_rows, kv_new, s_new, pos_vec, layer_index)
    out = _attend_plain(q, kvc[layer_index], pos_vec, scale, hd, scale_rows[layer_index])[0]
    return out, kvc, scale_rows


def decode_attention_split_fused_write_q(q, kv_new, s_new, kvc, scale_rows, pos_vec,
                                         scale: float, layer_index, hd: int | None = None,
                                         s_tile: int = SPLIT_TILE):
    """K14, fused int8: kv_new int8 [B, KV, hd + vhd] and s_new f32 [B, KV, 2]
    (quantized outside) appended at row pos_vec[b] of the stacked int8 cache
    and its scale rows [L, B, KV, 2, S], then attended. Returns (attn, kvc,
    scale_rows), written in place."""
    if kvc.device.type == "cpu":
        return decode_attention_split_fused_write_q_plain(q, kv_new, s_new, kvc, scale_rows,
                                                          pos_vec, scale, layer_index, hd, s_tile)
    hd = _check_dense(q, kvc, hd, layer_index, scale_rows, "decode_attention_split_fused_write_q")
    _check_tile(kvc, s_tile)
    _check_new(q, kv_new, kvc, s_new, scale_rows)
    out, _, _ = _walk(q, kvc, pos_vec, scale, hd, layer_index, scale_rows, kv_new, s_new)
    decode_attention_split_fused_write_q.launches += 1
    return out, kvc, scale_rows


decode_attention_split_fused_write_q.launches = 0


# ----------------------------------------------------------------- K15
def _s_use(kvc, s_use):
    s = kvc.shape[-2]
    if s_use is not None and not 0 < s_use <= s:
        raise ValueError(f"s_use {s_use} outside the cache's {s} rows")
    return s_use or s


def decode_attention_plain(q, kvc, pos_vec, scale: float, hd: int | None = None,
                           s_use: int | None = None, layer_index=None) -> torch.Tensor:
    """Plain version of K15 (same arguments and result)."""
    hd = _check_dense(q, kvc, hd, layer_index, what="decode_attention")
    return _attend_plain(q, _layer(kvc, layer_index), pos_vec, scale, hd,
                         s_use=_s_use(kvc, s_use))[0]


def decode_attention(q, kvc, pos_vec, scale: float, hd: int | None = None,
                     s_use: int | None = None, layer_index=None) -> torch.Tensor:
    """K15 (`_full_kernel`): attention over the first s_use rows of a bf16/f32
    cache (the physical cache's write-slack rows are never read). Returns
    [B, KV, G, vhd] f32; the cache is only read."""
    if kvc.device.type == "cpu":
        return decode_attention_plain(q, kvc, pos_vec, scale, hd, s_use, layer_index)
    hd = _check_dense(q, kvc, hd, layer_index, what="decode_attention")
    out, _, _ = _walk(q, kvc, pos_vec, scale, hd, layer_index, s_use=_s_use(kvc, s_use))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_q_plain(q, kvc, scale_rows, pos_vec, scale: float, hd: int | None = None,
                             s_use: int | None = None, layer_index=None) -> torch.Tensor:
    """Plain version of K15 int8 (same arguments and result)."""
    hd = _check_dense(q, kvc, hd, layer_index, scale_rows, "decode_attention_q")
    return _attend_plain(q, _layer(kvc, layer_index), pos_vec, scale, hd,
                         _layer(scale_rows, layer_index), _s_use(kvc, s_use))[0]


def decode_attention_q(q, kvc, scale_rows, pos_vec, scale: float, hd: int | None = None,
                       s_use: int | None = None, layer_index=None) -> torch.Tensor:
    """K15 over an int8 cache and its scale rows [(L,) B, KV, 2, S]."""
    if kvc.device.type == "cpu":
        return decode_attention_q_plain(q, kvc, scale_rows, pos_vec, scale, hd, s_use,
                                        layer_index)
    hd = _check_dense(q, kvc, hd, layer_index, scale_rows, "decode_attention_q")
    out, _, _ = _walk(q, kvc, pos_vec, scale, hd, layer_index, scale_rows,
                      s_use=_s_use(kvc, s_use))
    decode_attention_q.launches += 1
    return out


decode_attention_q.launches = 0


def decode_attention_auto(q, kvc, pos_vec, scale: float, scale_rows=None,
                          s_limit: int | None = None, layer_index=None,
                          hd: int | None = None) -> torch.Tensor:
    """The JAX package's choice (`pallas_attention.py:902-930`): a long cache
    (S * itemsize >= SPLIT_THRESHOLD_BYTES) with a tile of at least 128 rows
    takes K14 unfused; otherwise K15 over the first round8(s_limit) rows (the
    logical length; write-slack rows are never attended)."""
    s = kvc.shape[-2]
    if s * kvc.element_size() >= SPLIT_THRESHOLD_BYTES:
        tile = pick_tile(s)
        if tile >= 128:
            if scale_rows is not None:
                return decode_attention_split_q(q, kvc, scale_rows, pos_vec, scale, hd=hd,
                                                s_tile=tile, layer_index=layer_index)
            return decode_attention_split(q, kvc, pos_vec, scale, hd=hd, s_tile=tile,
                                          layer_index=layer_index)
    s_use = min(s, -(-s_limit // 8) * 8) if s_limit else None
    if scale_rows is not None:
        return decode_attention_q(q, kvc, scale_rows, pos_vec, scale, hd=hd, s_use=s_use,
                                  layer_index=layer_index)
    return decode_attention(q, kvc, pos_vec, scale, hd=hd, s_use=s_use, layer_index=layer_index)


# ----------------------------------------------------------------- K8
def _check_paged(q, kv_pool, tables, hd, layer_index, scale_pool=None):
    if scale_pool is None and kv_pool.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{kv_pool.dtype} KV pool: int8-KV pools take "
                                  "decode_attention_paged_q (scale_pool=)")
    b, kvh, _, hdq = q.shape
    pool_dims = 4 if layer_index is None else 5
    bs = kv_pool.shape[-2]
    if (hdq != hd or kv_pool.dim() != pool_dims or kv_pool.shape[-3] != kvh
            or tables.dim() != 2 or tables.shape[0] != b or bs & (bs - 1)
            or (scale_pool is not None
                and (kv_pool.dtype != torch.int8 or tuple(scale_pool.shape)
                     != tuple(kv_pool.shape[:-2]) + (2, bs)))):
        raise ValueError(f"decode_attention_paged: shapes q {tuple(q.shape)}, pool "
                         f"{tuple(kv_pool.shape)} {kv_pool.dtype}, scale pool "
                         f"{None if scale_pool is None else tuple(scale_pool.shape)}, tables "
                         f"{tuple(tables.shape)}, hd {hd}, layer_index {layer_index} (block "
                         "size a power of two)")


def _paged_plain(q, kv_pool, tables, pos_vec, scale, hd, layer_index, scale_pool=None):
    hd = hd or q.shape[-1]
    _check_paged(q, kv_pool, tables, hd, layer_index, scale_pool)
    pool = _layer(kv_pool, layer_index)
    b, kvh = q.shape[:2]
    nb, bs = tables.shape[1], pool.shape[-2]
    tl = tables.to(device=pool.device, dtype=torch.long)
    g = pool[tl]                                             # [B, MAXBLK, KV, BS, W]
    kv = g.permute(0, 2, 1, 3, 4).reshape(b, kvh, nb * bs, pool.shape[-1])
    sc = None
    if scale_pool is not None:
        sg = _layer(scale_pool, layer_index)[tl]             # [B, MAXBLK, KV, 2, BS]
        sc = sg.permute(0, 2, 3, 1, 4).reshape(b, kvh, 2, nb * bs)
    return _attend_plain(q, kv, pos_vec, scale, hd, sc)[0]


def decode_attention_paged_plain(q, kv_pool, tables, pos_vec, scale: float,
                                 hd: int | None = None, layer_index: int | None = None,
                                 scale_pool=None):
    """Plain version of K8 (same arguments and result): the lane's blocks
    gathered into a dense view, masked f32 scores, acc / l."""
    if scale_pool is not None:
        return decode_attention_paged_q_plain(q, kv_pool, scale_pool, tables, pos_vec, scale, hd,
                                              layer_index)
    return _paged_plain(q, kv_pool, tables, pos_vec, scale, hd, layer_index)


def _paged_launch(q, kv_pool, tables, pos_vec, scale, hd, layer_index, scale_pool=None):
    hd = hd or q.shape[-1]
    _check_paged(q, kv_pool, tables, hd, layer_index, scale_pool)
    b, kvh, g, _ = q.shape
    bs, width = kv_pool.shape[-2], kv_pool.shape[-1]
    vhd = width - hd
    vec = 16 if kv_pool.dtype == torch.int8 else 8
    if g > 8 or hd % vec or vhd % vec or width > 256:
        raise NotImplementedError(f"K8 takes G <= 8, hd and vhd multiples of {vec}, "
                                  "hd + vhd <= 256")
    pool, spool = _layer(kv_pool, layer_index), _layer(scale_pool, layer_index)
    qc = q.contiguous()
    tb = tables.to(dtype=torch.int32).contiguous()
    pv = pos_vec.to(dtype=torch.int32).contiguous()
    _build.require(pool.is_contiguous() and (spool is None or spool.is_contiguous())
                   and qc.device == pool.device == tb.device == pv.device
                   and (spool is None or spool.device == pool.device)
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
                                 CACHE_CODES[pool.dtype],
                                 None if spool is None else spool.data_ptr(), tb.data_ptr(),
                                 pv.data_ptr(), b, kvh, g, pool.shape[0], bs.bit_length() - 1,
                                 maxblk, hd, vhd, float(scale), part_o.data_ptr(),
                                 part_ml.data_ptr(), out.data_ptr(), nsplit, _build.stream())
    _build.check(lib, err, "decode_attention_paged")
    return out


def decode_attention_paged(q: torch.Tensor, kv_pool: torch.Tensor, tables: torch.Tensor,
                           pos_vec: torch.Tensor, scale: float, hd: int | None = None,
                           layer_index: int | None = None, scale_pool=None) -> torch.Tensor:
    """K8. Returns attn [B, KV, G, vhd] f32. tables (int32 [B, MAXBLK]) and
    pos_vec (int [B]) live on the pool's device and are read by the kernel,
    so the call does not wait for the host. The pool is only read. An int8
    pool passes its scale pool [(L,) NBLK, KV, 2, BS] as scale_pool (the JAX
    signature) and takes the int8 variant, `decode_attention_paged_q`."""
    if scale_pool is not None:
        return decode_attention_paged_q(q, kv_pool, scale_pool, tables, pos_vec, scale, hd,
                                        layer_index)
    if kv_pool.device.type == "cpu":
        return decode_attention_paged_plain(q, kv_pool, tables, pos_vec, scale, hd, layer_index)
    out = _paged_launch(q, kv_pool, tables, pos_vec, scale, hd, layer_index)
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0


def decode_attention_paged_q_plain(q, kv_pool, scale_pool, tables, pos_vec, scale: float,
                                   hd: int | None = None, layer_index: int | None = None):
    """Plain version of K8's int8 variant (same arguments and result)."""
    return _paged_plain(q, kv_pool, tables, pos_vec, scale, hd, layer_index, scale_pool)


def decode_attention_paged_q(q, kv_pool, scale_pool, tables, pos_vec, scale: float,
                             hd: int | None = None, layer_index: int | None = None):
    """K8's int8 variant (`_paged_kernel`, quant=True): an int8 pool
    [(L,) NBLK, KV, BS, hd + vhd] and its scale pool [(L,) NBLK, KV, 2, BS]
    read through the same block tables. Returns [B, KV, G, vhd] f32."""
    if kv_pool.device.type == "cpu":
        return decode_attention_paged_q_plain(q, kv_pool, scale_pool, tables, pos_vec, scale,
                                              hd, layer_index)
    out = _paged_launch(q, kv_pool, tables, pos_vec, scale, hd, layer_index, scale_pool)
    decode_attention_paged_q.launches += 1
    return out


decode_attention_paged_q.launches = 0
