"""K4: the w8a8 int8 tensor-core GEMM of the q8_row prefill projections.

Counterpart of llamatpu/ops/pallas_gemm.py `_gemm_kernel` / `_gemm_kernel_li`
(`rowq_gemm_pallas`), which the JAX package keeps bit-identical to its XLA
int8 dot: y[T, O] = (xi8 . qs^T)_int32 * ax[t] * s[o], the epilogue in f32 in
that order. The result is bit-identical to the plain version. CUDA source:
csrc/gemm.cu (design and bound in its header note).
"""
from __future__ import annotations

import torch

from llamatpu_torch import _build
from llamatpu_torch.ops.int8_prefill import _INT8_ACC_MAX_I, int_dot


def rowq_gemm_plain(qs, scales, xi8, ax) -> torch.Tensor:
    """Plain version: the exact integer product, then (p * ax) * s."""
    return int_dot(xi8, qs) * ax * scales[:, 0][None, :]


def rowq_gemm(qs: torch.Tensor, scales: torch.Tensor, xi8: torch.Tensor,
              ax: torch.Tensor) -> torch.Tensor:
    """y[T, O] f32 = (xi8 [T, I] . qs[O, I]^T)_int32 * ax[T, 1] * scales[O, 1].
    `qs`/`scales` may be layer views of stacked tensors. A CPU tensor takes the
    plain version; a CUDA tensor launches K4 (or raises)."""
    t, i = xi8.shape
    o = qs.shape[0]
    if i > _INT8_ACC_MAX_I:
        raise ValueError(f"rowq_gemm: I={i} > {_INT8_ACC_MAX_I} overflows the int32 sum")
    if xi8.device.type == "cpu":
        return rowq_gemm_plain(qs, scales, xi8, ax)
    _build.require(all(a.is_contiguous() for a in (qs, scales, xi8, ax)),
                   "rowq_gemm: contiguous inputs")
    _build.require(qs.dtype == torch.int8 and xi8.dtype == torch.int8 and qs.shape[1] == i,
                   "rowq_gemm: int8 qs [O, I] and xi8 [T, I]")
    _build.require(scales.dtype == torch.float32 and ax.dtype == torch.float32
                   and scales.numel() == o and ax.numel() == t, "rowq_gemm: f32 scales")
    _build.require(i % 16 == 0 and qs.data_ptr() % 16 == 0 and xi8.data_ptr() % 16 == 0,
                   "rowq_gemm: I % 16 == 0 and 16-byte aligned rows")
    y = torch.empty((t, o), dtype=torch.float32, device=xi8.device)
    lib = _build.load("gemm")
    err = lib.lt_rowq_gemm(xi8.data_ptr(), ax.data_ptr(), qs.data_ptr(), scales.data_ptr(),
                           y.data_ptr(), t, o, i, _build.stream())
    _build.check(lib, err, "rowq_gemm")
    rowq_gemm.launches += 1
    return y


rowq_gemm.launches = 0
