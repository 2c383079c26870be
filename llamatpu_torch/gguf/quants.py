"""Vectorized (numpy) GGML block-quant codecs: the part of
llamatpu/gguf/quants.py this slice needs, bit-exact with it
(tests/test_torch_gguf.py).

- Q8_0 / Q4_0: zero-copy views of the raw blocks as (int8 values, f16
  scales), dequantization for the dense embedding, ggml-order quantization
  for the writer, and the inverse of the views (`q8_0_blocks`,
  `q4_0_blocks`) for writing values that are already quantized.
- Q4_K / Q5_K: the native compute views (`q4_k_views`, `q5_k_views`: int8
  values, f32 per-32 scales and per-32 additive offsets, w = q * scale +
  off), the ggml-layout encoders (`quantize_q4_k`, `quantize_q5_k`: a
  single-pass scale search, for tests and synthetic checkpoints) and the
  decoders.
- Q6_K: decode only, for `requantize_to_q8_0` (llama.cpp Q4_0 and Q4_K_M
  files keep a Q6_K vocab head, attn_v and ffn_down).

`dequantize` and `requantize_to_q8_0` take the native C++ codecs
(gguf/native.py, the same values bit for bit) unless LLAMATPU_NO_NATIVE=1,
as llamatpu/gguf/quants.py:373-390 does.
"""
from __future__ import annotations

import numpy as np

from llamatpu_torch.gguf.ggml_type import QK_K, GGMLType


def _f16(u16: np.ndarray) -> np.ndarray:
    return u16.view(np.float16).astype(np.float32)


# ---------------------------------------------------------------------------
# Q8_0: 32-element blocks, f16 scale + 32 int8
# ---------------------------------------------------------------------------

def q8_0_views(raw: np.ndarray, n_elements: int) -> tuple[np.ndarray, np.ndarray]:
    """Zero-copy split of raw Q8_0 block bytes into (qs int8 [nb, 32], scales f16 [nb])."""
    nb = n_elements // 32
    blocks = raw[: nb * 34].reshape(nb, 34)
    scales = np.ascontiguousarray(blocks[:, :2]).view(np.float16).reshape(nb)
    qs = blocks[:, 2:].view(np.int8)
    return qs, scales


def dequantize_q8_0(raw: np.ndarray, n_elements: int) -> np.ndarray:
    qs, scales = q8_0_views(raw, n_elements)
    return (qs.astype(np.float32) * scales.astype(np.float32)[:, None]).reshape(-1)


def quantize_q8_0(values: np.ndarray) -> np.ndarray:
    """ggml-order Q8_0 quantization: int8 from the full-precision scale, f16
    stored scale, round half away from zero."""
    values = np.asarray(values, dtype=np.float32)
    assert values.size % 32 == 0
    v = values.reshape(-1, 32)
    amax = np.max(np.abs(v), axis=1)
    d = amax / 127.0
    inv = np.where(d != 0.0, np.divide(1.0, d, out=np.zeros_like(d), where=d != 0), 0.0)
    s = v * inv[:, None]
    q = np.trunc(s + np.copysign(0.5, s)).astype(np.int8)  # round half away from zero
    return q8_0_blocks(q, d.astype(np.float16))


def q8_0_blocks(qs: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of q8_0_views: int8 values [..., n] and f16 (or f32, rounded
    to f16) per-32 scales [..., n / 32] -> raw Q8_0 block bytes."""
    q = np.ascontiguousarray(qs, dtype=np.int8).reshape(-1, 32)
    out = np.empty((q.shape[0], 34), dtype=np.uint8)
    out[:, :2] = np.asarray(scales).astype(np.float16).reshape(-1, 1).view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Q4_0: 32-element blocks, f16 scale + 16 bytes; elem j in low nibble, j+16 high
# ---------------------------------------------------------------------------

def q4_0_views(raw: np.ndarray, n_elements: int) -> tuple[np.ndarray, np.ndarray]:
    """Depack raw Q4_0 into (qs int8 [nb, 32] with values in [-8, 7], scales f16 [nb])."""
    nb = n_elements // 32
    blocks = raw[: nb * 18].reshape(nb, 18)
    scales = np.ascontiguousarray(blocks[:, :2]).view(np.float16).reshape(nb)
    packed = blocks[:, 2:]
    qs = np.empty((nb, 32), dtype=np.int8)
    qs[:, :16] = (packed & 0x0F).astype(np.int8) - 8
    qs[:, 16:] = (packed >> 4).astype(np.int8) - 8
    return qs, scales


def dequantize_q4_0(raw: np.ndarray, n_elements: int) -> np.ndarray:
    qs, scales = q4_0_views(raw, n_elements)
    return (qs.astype(np.float32) * scales.astype(np.float32)[:, None]).reshape(-1)


def quantize_q4_0(values: np.ndarray) -> np.ndarray:
    """ggml-order Q4_0: d = (the element of largest magnitude, with its sign) / -8."""
    values = np.asarray(values, dtype=np.float32)
    assert values.size % 32 == 0
    v = values.reshape(-1, 32)
    idx = np.argmax(np.abs(v), axis=1)
    maxv = v[np.arange(v.shape[0]), idx]
    d = maxv / -8.0
    inv = np.where(d != 0.0, 1.0 / d, 0.0)
    q = np.clip((v * inv[:, None]) + 8.5, 0.0, 15.0).astype(np.uint8)
    nb = v.shape[0]
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)
    return out.reshape(-1)


def q4_0_blocks(qs: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of q4_0_views: values in [-8, 7] [..., n] and per-32 scales
    [..., n / 32] (rounded to f16) -> raw Q4_0 block bytes."""
    q = (np.asarray(qs, dtype=np.int8).reshape(-1, 32).astype(np.int16) + 8).astype(np.uint8)
    assert int(q.max(initial=0)) <= 15, "q4_0_blocks: values outside [-8, 7]"
    out = np.empty((q.shape[0], 18), dtype=np.uint8)
    out[:, :2] = np.asarray(scales).astype(np.float16).reshape(-1, 1).view(np.uint8)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Q4_K / Q5_K (256-element super-blocks of eight 32-element sub-blocks)
# ---------------------------------------------------------------------------

def _kquant_scales_mins(scale_bytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min encoding of Q4_K/Q5_K into ([nb,8], [nb,8])."""
    b = scale_bytes.astype(np.uint16)  # [nb, 12]
    sc = np.empty(b.shape[:1] + (8,), dtype=np.int32)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[:, j] = b[:, j] & 63
        mn[:, j] = b[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (b[:, j + 4] & 0x0F) | ((b[:, j - 4] >> 6) << 4)
        mn[:, j] = (b[:, j + 4] >> 4) | ((b[:, j] >> 6) << 4)
    return sc, mn


def _kquant_head(blocks: np.ndarray):
    """(d, dmin, sub-block scales, sub-block mins) of [nb, bytes] superblocks."""
    nb = blocks.shape[0]
    d = _f16(np.ascontiguousarray(blocks[:, 0:2]).view(np.uint16).reshape(nb))
    dmin = _f16(np.ascontiguousarray(blocks[:, 2:4]).view(np.uint16).reshape(nb))
    sc, mn = _kquant_scales_mins(blocks[:, 4:16])
    return d, dmin, sc, mn


def _q4_k_nibbles(blocks: np.ndarray) -> np.ndarray:
    """The 4-bit values q in [0, 15] of Q4_K superblocks, [nb, 256] int16:
    pair p's 32 bytes hold sub-block 2p in the low nibbles, 2p + 1 in the high."""
    qsrc = blocks[:, 16:]
    q = np.empty((blocks.shape[0], QK_K), dtype=np.int16)
    for pair in range(4):
        chunk = qsrc[:, pair * 32:(pair + 1) * 32]
        q[:, pair * 64:pair * 64 + 32] = chunk & 0x0F
        q[:, pair * 64 + 32:pair * 64 + 64] = chunk >> 4
    return q


def _q5_k_values(blocks: np.ndarray) -> np.ndarray:
    """The 5-bit values q in [0, 31] of Q5_K superblocks, [nb, 256] int16: the
    Q4_K nibble layout at bytes 48.., the fifth bits in qh (bytes 16..48),
    bit 2p for sub-block 2p and bit 2p + 1 for 2p + 1."""
    qh = blocks[:, 16:48].astype(np.int16)
    qsrc = blocks[:, 48:176]
    q = np.empty((blocks.shape[0], QK_K), dtype=np.int16)
    for pair in range(4):
        chunk = qsrc[:, pair * 32:(pair + 1) * 32]
        q[:, pair * 64:pair * 64 + 32] = (chunk & 0x0F) | (((qh >> (pair * 2)) & 1) << 4)
        q[:, pair * 64 + 32:pair * 64 + 64] = (chunk >> 4) | (((qh >> (pair * 2 + 1)) & 1) << 4)
    return q


def _kquant_views(blocks: np.ndarray, q: np.ndarray, centre: int):
    """(qs int8 [nb * 8, 32] = q - centre, scales f32 [nb * 8], offs f32
    [nb * 8]) with w = qs * scale + off equal to d * sc * q - dmin * m:
    scale = d * sc, off = centre * scale - dmin * m (f32 holds both exactly:
    an f16 times a 6-bit integer needs 17 significand bits)."""
    d, dmin, sc, mn = _kquant_head(blocks)
    scales = d[:, None] * sc.astype(np.float32)                     # [nb, 8]
    offs = float(centre) * scales - dmin[:, None] * mn.astype(np.float32)
    return ((q - centre).astype(np.int8).reshape(-1, 32),
            np.ascontiguousarray(scales, dtype=np.float32).reshape(-1),
            np.ascontiguousarray(offs, dtype=np.float32).reshape(-1))


def q4_k_views(raw: np.ndarray, n_elements: int):
    """Raw Q4_K -> the native compute layout (qs int8 [n/32, 32] in [-8, 7],
    scales f32 [n/32], offs f32 [n/32]), w = qs * scale + off exactly: the
    Q4_0 kernels take the values, and the offset term is xbsum @ offs^T over
    the activation's per-32 sums (ops/matmul.py)."""
    nb = n_elements // QK_K
    blocks = raw[: nb * 144].reshape(nb, 144)
    return _kquant_views(blocks, _q4_k_nibbles(blocks), 8)


def q5_k_views(raw: np.ndarray, n_elements: int):
    """Raw Q5_K -> (qs int8 [n/32, 32] in [-16, 15], scales f32, offs f32),
    w = qs * scale + off exactly: small int8 values for the Q8_0 kernels."""
    nb = n_elements // QK_K
    blocks = raw[: nb * 176].reshape(nb, 176)
    return _kquant_views(blocks, _q5_k_values(blocks), 16)


def _kquant_encode(values: np.ndarray, qmax: int):
    """The single-pass scale search of both encoders: per sub-block the ideal
    scale (max + min) / qmax and min, their 6-bit codes against the f16
    superblock d / dmin, and the values q in [0, qmax]. Returns (d16,
    dmin16, sc, mn, q [nb, 256] uint8)."""
    v = np.asarray(values, dtype=np.float32)
    assert v.size % QK_K == 0
    v = v.reshape(-1, 8, 32)                          # [nb, sub, 32]
    vmax = v.max(axis=-1)
    mins_f = np.maximum(-v.min(axis=-1), 0.0)         # ggml mins are >= 0
    scales_f = np.maximum(vmax + mins_f, 0.0) / float(qmax)
    d16 = (scales_f.max(axis=-1) / 63.0).astype(np.float16)
    dmin16 = (mins_f.max(axis=-1) / 63.0).astype(np.float16)
    df, dminf = d16.astype(np.float32), dmin16.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = np.where(df[:, None] > 0,
                      np.clip(np.round(scales_f / df[:, None]), 0, 63), 0).astype(np.int32)
        mn = np.where(dminf[:, None] > 0,
                      np.clip(np.round(mins_f / dminf[:, None]), 0, 63), 0).astype(np.int32)
        eff_s = df[:, None] * sc                      # [nb, 8]
        q = np.where(eff_s[..., None] > 0,
                     np.clip(np.round((v + (dminf[:, None] * mn)[..., None])
                                      / np.where(eff_s[..., None] > 0, eff_s[..., None], 1.0)),
                             0, qmax), 0).astype(np.uint8)
    return d16, dmin16, sc, mn, q.reshape(v.shape[0], QK_K)


def _kquant_pack_head(out: np.ndarray, d16, dmin16, sc, mn) -> None:
    """d, dmin and the 12-byte 6-bit pack (the inverse of _kquant_scales_mins)."""
    out[:, 0:2] = d16[:, None].view(np.uint8)
    out[:, 2:4] = dmin16[:, None].view(np.uint8)
    for j in range(4):
        out[:, 4 + j] = (sc[:, j] & 63) | ((sc[:, j + 4] >> 4) << 6)
        out[:, 8 + j] = (mn[:, j] & 63) | ((mn[:, j + 4] >> 4) << 6)
        out[:, 12 + j] = (sc[:, j + 4] & 0x0F) | ((mn[:, j + 4] & 0x0F) << 4)


def quantize_q4_k(values: np.ndarray) -> np.ndarray:
    """f32 values -> Q4_K superblocks (ggml layout; a single-pass scale
    search, coarser than llama.cpp's iterative one: for tests and synthetic
    checkpoints)."""
    d16, dmin16, sc, mn, q = _kquant_encode(values, 15)
    out = np.zeros((q.shape[0], 144), dtype=np.uint8)
    _kquant_pack_head(out, d16, dmin16, sc, mn)
    for pair in range(4):
        lo = q[:, pair * 64:pair * 64 + 32]
        hi = q[:, pair * 64 + 32:pair * 64 + 64]
        out[:, 16 + pair * 32:16 + (pair + 1) * 32] = lo | (hi << 4)
    return out.reshape(-1)


def quantize_q5_k(values: np.ndarray) -> np.ndarray:
    """f32 values -> Q5_K superblocks (ggml layout; the search of quantize_q4_k)."""
    d16, dmin16, sc, mn, q = _kquant_encode(values, 31)
    nb = q.shape[0]
    out = np.zeros((nb, 176), dtype=np.uint8)
    _kquant_pack_head(out, d16, dmin16, sc, mn)
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for pair in range(4):
        lo = q[:, pair * 64:pair * 64 + 32]
        hi = q[:, pair * 64 + 32:pair * 64 + 64]
        out[:, 48 + pair * 32:48 + (pair + 1) * 32] = (lo & 0x0F) | ((hi & 0x0F) << 4)
        qh |= ((lo >> 4) & 1).astype(np.uint8) << (pair * 2)
        qh |= ((hi >> 4) & 1).astype(np.uint8) << (pair * 2 + 1)
    out[:, 16:48] = qh
    return out.reshape(-1)


def _kquant_decode(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """d * sc * q - dmin * m per sub-block, f32 [nb * 256]. Every product is
    exact in f32 (an f16 times a 6-bit and a 5-bit integer), so the one
    rounding is the f32 difference, as in ggml's (and native/quantops.cpp's)
    f32 loop."""
    d, dmin, sc, mn = _kquant_head(blocks)
    nb = blocks.shape[0]
    qf = q.astype(np.float32).reshape(nb, 8, 32)
    a = (d[:, None] * sc.astype(np.float32))[..., None]     # f32 [nb, 8, 1]
    b = (dmin[:, None] * mn.astype(np.float32))[..., None]
    return (a * qf - b).reshape(-1)


def dequantize_q4_k(raw: np.ndarray, n_elements: int) -> np.ndarray:
    nb = n_elements // QK_K
    blocks = raw[: nb * 144].reshape(nb, 144)
    return _kquant_decode(blocks, _q4_k_nibbles(blocks))


def dequantize_q5_k(raw: np.ndarray, n_elements: int) -> np.ndarray:
    nb = n_elements // QK_K
    blocks = raw[: nb * 176].reshape(nb, 176)
    return _kquant_decode(blocks, _q5_k_values(blocks))


# ---------------------------------------------------------------------------
# Q6_K (256-element super-blocks): decode only
# ---------------------------------------------------------------------------

def dequantize_q6_k(raw: np.ndarray, n_elements: int) -> np.ndarray:
    nb = n_elements // QK_K
    blocks = raw[: nb * 210].reshape(nb, 210)
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    scales = blocks[:, 192:208].view(np.int8).astype(np.float32)  # [nb, 16]
    d = _f16(np.ascontiguousarray(blocks[:, 208:210]).view(np.uint16).reshape(nb))
    out = np.empty((nb, QK_K), dtype=np.float32)
    for half in range(2):  # 128-element halves
        qlh = ql[:, half * 64 : half * 64 + 64]
        qhh = qh[:, half * 32 : half * 32 + 32]
        scb = scales[:, half * 8 : half * 8 + 8]  # [nb, 8]
        base = half * 128
        # group k of a half reads the low (k < 2) or high nibbles of ql, the
        # 2-bit field k of qh, and the scale pair 2k, 2k + 1
        for group in range(4):
            src = qlh[:, 0:32] if group in (0, 2) else qlh[:, 32:64]
            nib = (src & 0x0F) if group < 2 else (src >> 4)
            q = nib.astype(np.int32) | (((qhh >> (2 * group)) & 3).astype(np.int32) << 4)
            q = q - 32
            s = np.repeat(scb[:, 2 * group : 2 * group + 2], 16, axis=1)  # [nb, 32]
            out[:, base + group * 32 : base + (group + 1) * 32] = d[:, None] * s * q
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Dispatch + requant
# ---------------------------------------------------------------------------

_DEQUANT = {
    GGMLType.Q8_0: dequantize_q8_0,
    GGMLType.Q4_0: dequantize_q4_0,
    GGMLType.Q4_K: dequantize_q4_k,
    GGMLType.Q5_K: dequantize_q5_k,
    GGMLType.Q6_K: dequantize_q6_k,
}


_NATIVE_KIND = {
    GGMLType.Q8_0: ("q8_0", 32),
    GGMLType.Q4_0: ("q4_0", 32),
    GGMLType.Q4_K: ("q4_k", QK_K),
    GGMLType.Q5_K: ("q5_k", QK_K),
    GGMLType.Q6_K: ("q6_k", QK_K),
}


def dequantize(ggml_type: GGMLType, raw: np.ndarray, n_elements: int) -> np.ndarray:
    """Decode a supported GGML format to float32 (the native codec unless
    LLAMATPU_NO_NATIVE=1, else numpy)."""
    if ggml_type == GGMLType.F32:
        return np.ascontiguousarray(raw[: n_elements * 4]).view(np.float32).copy()
    if ggml_type == GGMLType.F16:
        return np.ascontiguousarray(raw[: n_elements * 2]).view(np.float16).astype(np.float32)
    if ggml_type == GGMLType.BF16:
        u = np.ascontiguousarray(raw[: n_elements * 2]).view(np.uint16).astype(np.uint32) << 16
        return u.view(np.float32)
    if ggml_type in _NATIVE_KIND:
        from llamatpu_torch.gguf import native

        kind, bs = _NATIVE_KIND[ggml_type]
        out = native.dequant(kind, raw, n_elements // bs, bs)
        if out is not None:
            return out
    fn = _DEQUANT.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"dequantize: {ggml_type!r} not supported")
    return fn(np.asarray(raw, dtype=np.uint8), n_elements)


def requantize_to_q8_0(ggml_type: GGMLType, raw: np.ndarray, n_elements: int) -> np.ndarray:
    """K-quant -> Q8_0: full dequant, then the ggml Q8_0 encode (both native
    unless LLAMATPU_NO_NATIVE=1)."""
    from llamatpu_torch.gguf import native

    values = dequantize(ggml_type, raw, n_elements)
    out = native.quantize_q8_0(values)
    return quantize_q8_0(values) if out is None else out
