"""Projection matmuls: y[..., O] = x[..., I] @ W[O, I]^T.

The dispatch of llamatpu/ops/pallas_matmul.py `quant_matmul_pallas`, plus
the logical-row slice of llamatpu/ops/matmul.py:
- q8_0 / q4_0 block quants (canonical): K5 (ops/quant_matmul.py), in decode
  and in prefill alike;
- packed4 Q4_0: K7;
- q8_row: T < INT8_MXU_MIN_T K1, the row scale multiplying the f32 output
  outside the kernel (pallas_matmul.py:155); T >= INT8_MXU_MIN_T per-token
  int8 activations, then K4 (ops/gemm.py);
- dense arrays (F32/F16/BF16 checkpoints): torch.matmul with f32
  accumulation, where the JAX package leaves them to XLA.
The result is cast to x's dtype (pallas_matmul.py:411, 442): with bf16
activations the logits are bf16 before the caller takes them to f32. There is
no fallback path: K5/K7 take any O.
"""
from __future__ import annotations

import torch

from llamatpu_torch.models.weights import QTensor
from llamatpu_torch.ops.gemm import rowq_gemm
from llamatpu_torch.ops.int8_prefill import INT8_MXU_MIN_T, quantize_activation_rows
from llamatpu_torch.ops.quant_matmul import block_matmul, packed4_matmul, rowq_gemv


def matmul(w, x: torch.Tensor, li: int | None = None) -> torch.Tensor:
    """y[..., out] = x[..., in] @ W^T. With `li`, `w` is stacked [L, O, I] and
    layer li is the view w.qs[li] (no copy)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if not isinstance(w, QTensor):
        wd = w if li is None else w[li]
        y = x2.float() @ wd.float().T
        return y.reshape(*lead, wd.shape[0]).to(x.dtype)
    if w.offs is not None:
        raise NotImplementedError(f"{w.kind} with offsets: quant-breadth slice of the port")
    qs, scales = (w.qs, w.scales) if li is None else (w.qs[li], w.scales[li])
    if w.kind == "q8_row":
        if x2.shape[0] >= INT8_MXU_MIN_T:
            xi8, ax = quantize_activation_rows(x2)
            y = rowq_gemm(qs, scales, xi8, ax)
        else:
            y = rowq_gemv(x2, qs) * scales[:, 0][None, :]
    elif w.layout == "packed4":
        y = packed4_matmul(x2, qs, scales)
    elif w.kind in ("q8_0", "q4_0") and w.layout == "canonical":
        y = block_matmul(x2, qs, scales)
    else:
        raise NotImplementedError(f"{w.kind}/{w.layout} weights: not served by the port")
    y = y.reshape(*lead, qs.shape[0]).to(x.dtype)
    return y[..., : w.logical_out] if w.logical_out else y
