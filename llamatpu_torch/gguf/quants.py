"""Vectorized (numpy) GGML block-quant codecs: the part of
llamatpu/gguf/quants.py this slice needs, bit-exact with it
(tests/test_torch_gguf.py).

- Q8_0 / Q4_0: zero-copy views of the raw blocks as (int8 values, f16
  scales), dequantization for the dense embedding, ggml-order quantization
  for the writer, and the inverse of the views (`q8_0_blocks`,
  `q4_0_blocks`) for writing values that are already quantized.
- Q6_K: decode only, for `requantize_to_q8_0` (llama.cpp Q4_0 files often
  keep a Q6_K vocab head).

Native Q4_K/Q5_K (values plus per-32 additive offsets) belong to the
quant-breadth slice of the port: decoding them raises here.
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
    GGMLType.Q6_K: dequantize_q6_k,
}


def dequantize(ggml_type: GGMLType, raw: np.ndarray, n_elements: int) -> np.ndarray:
    """Decode a supported GGML format to float32."""
    if ggml_type == GGMLType.F32:
        return np.ascontiguousarray(raw[: n_elements * 4]).view(np.float32).copy()
    if ggml_type == GGMLType.F16:
        return np.ascontiguousarray(raw[: n_elements * 2]).view(np.float16).astype(np.float32)
    if ggml_type == GGMLType.BF16:
        u = np.ascontiguousarray(raw[: n_elements * 2]).view(np.uint16).astype(np.uint32) << 16
        return u.view(np.float32)
    if ggml_type in (GGMLType.Q4_K, GGMLType.Q5_K):
        raise NotImplementedError(
            f"{ggml_type.name} (native K-quant with offsets): quant-breadth slice of the port")
    fn = _DEQUANT.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"dequantize: {ggml_type!r} not supported")
    return fn(np.asarray(raw, dtype=np.uint8), n_elements)


def requantize_to_q8_0(ggml_type: GGMLType, raw: np.ndarray, n_elements: int) -> np.ndarray:
    """K-quant -> Q8_0: full dequant, then the ggml Q8_0 encode."""
    return quantize_q8_0(dequantize(ggml_type, raw, n_elements))
