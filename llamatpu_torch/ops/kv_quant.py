"""Int8 KV-cache quantization, one f32 scale per (token, KV head): the port of
llamatpu/ops/kv_quant.py.

Scales live beside the packed int8 cache as rows [..., 2, S] (row 0 = K,
row 1 = V) and fold into the attention dots instead of a dequantized copy:

    scores[g, s] = (q . k_int[s]) * scale * k_scale[s]
    out[g]      = sum_s exp(scores[g, s] - m) * v_scale[s] * v_int[s] / l

(the V scale never enters the softmax denominator l).
"""
from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., hd] float -> (int8 [..., hd], f32 scales [...]): symmetric per
    row, scale = max|x| / 127, values rounded half to even and clamped to
    +-127. A zero row gets scale 0 (it dequantizes to exact zeros, as the
    zeroed cache holds).

    The divisor 127 is a tensor: CUDA computes a tensor divided by a Python
    scalar as a product with the rounded reciprocal, 1 ulp off the CPU's
    quotient, which flips int8 roundings between the card and the CPU."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale_row: torch.Tensor) -> torch.Tensor:
    """q [..., S, hd] int8; scale_row [..., 1, S] f32 -> f32 [..., S, hd]."""
    return q.float() * scale_row.transpose(-1, -2)
