"""Projection matmuls over q8_row weights: y[..., O] = x[..., I] @ W[O, I]^T.

The dispatch of llamatpu/ops/pallas_matmul.py `quant_matmul_pallas` for
q8_row, plus the logical-row slice of llamatpu/ops/matmul.py:
- T < INT8_MXU_MIN_T: K1 (ops/quant_matmul.py), the row scale multiplying the
  f32 output outside the kernel (pallas_matmul.py:155);
- T >= INT8_MXU_MIN_T: per-token int8 activations, then K4 (ops/gemm.py).
The result is cast to x's dtype (pallas_matmul.py:411): with bf16
activations the logits are bf16 before the caller takes them to f32. Other
weight kinds raise until the quant-breadth slice.
"""
from __future__ import annotations

import torch

from llamatpu_torch.models.weights import QTensor
from llamatpu_torch.ops.gemm import rowq_gemm
from llamatpu_torch.ops.int8_prefill import INT8_MXU_MIN_T, quantize_activation_rows
from llamatpu_torch.ops.quant_matmul import rowq_gemv


def matmul(w: QTensor, x: torch.Tensor, li: int | None = None) -> torch.Tensor:
    """y[..., out] = x[..., in] @ W^T. With `li`, `w` is a stacked [L, O, I]
    tensor and layer li is the view w.qs[li] (no copy)."""
    if not isinstance(w, QTensor) or w.kind != "q8_row":
        kind = w.kind if isinstance(w, QTensor) else "dense"
        raise NotImplementedError(f"{kind} weights: quant-breadth slice of the port")
    qs, scales = (w.qs, w.scales) if li is None else (w.qs[li], w.scales[li])
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.shape[0] >= INT8_MXU_MIN_T:
        xi8, ax = quantize_activation_rows(x2)
        y = rowq_gemm(qs, scales, xi8, ax)
    else:
        y = rowq_gemv(x2, qs) * scales[:, 0][None, :]
    y = y.reshape(*lead, qs.shape[0]).to(x.dtype)
    return y[..., : w.logical_out] if w.logical_out else y
