"""K4 and K17: the w8a8 GEMMs of the q8_row prefill projections.

- K4 `rowq_gemm`, counterpart of llamatpu/ops/pallas_gemm.py `_gemm_kernel`
  / `_gemm_kernel_li` (`rowq_gemm_pallas`), which the JAX package keeps
  bit-identical to its XLA int8 dot: y[T, O] = (xi8 . qs^T)_int32 * ax[t] *
  s[o], the epilogue in f32 in that order. The result is bit-identical to the
  plain version.
- K17 `rowq_gemm_bf16` (`rowq_gemm(..., variant="bf16")`), counterpart of
  `_gemm_kernel_bf16`: the int8 operands cast to bf16 (exact) and multiplied
  with f32 accumulation, the same epilogue; it differs from K4 only in the f32
  summation's rounding. scripts/bench_gemm.py's diagnostic; the port's
  counterpart is bench/bench_gemm.py.

CUDA source: csrc/gemm.cu (design and bound in its header note).
"""
from __future__ import annotations

import torch

from llamatpu_torch import _build
from llamatpu_torch.ops.int8_prefill import _INT8_ACC_MAX_I, int_dot


def rowq_gemm_plain(qs, scales, xi8, ax) -> torch.Tensor:
    """Plain version: the exact integer product, then (p * ax) * s."""
    return int_dot(xi8, qs) * ax * scales[:, 0][None, :]


def rowq_gemm_bf16_plain(qs, scales, xi8, ax) -> torch.Tensor:
    """Plain version of K17: exact products summed in f32, then (p * ax) * s."""
    return (xi8.float() @ qs.float().T) * ax * scales[:, 0][None, :]


def rowq_gemm(qs: torch.Tensor, scales: torch.Tensor, xi8: torch.Tensor,
              ax: torch.Tensor, variant: str = "int8") -> torch.Tensor:
    """y[T, O] f32 = (xi8 [T, I] . qs[O, I]^T)_int32 * ax[T, 1] * scales[O, 1].
    `qs`/`scales` may be layer views of stacked tensors. A CPU tensor takes the
    plain version; a CUDA tensor launches K4 (or raises). variant="bf16" is
    `rowq_gemm_bf16` (K17, its own launch count)."""
    if variant == "bf16":
        return rowq_gemm_bf16(qs, scales, xi8, ax)
    if variant != "int8":
        raise ValueError(f"rowq_gemm: variant {variant!r} (int8 or bf16)")
    _check_width(xi8)
    if xi8.device.type == "cpu":
        return rowq_gemm_plain(qs, scales, xi8, ax)
    y = _launch(qs, scales, xi8, ax, 0, "rowq_gemm")
    rowq_gemm.launches += 1
    return y


def rowq_gemm_bf16(qs: torch.Tensor, scales: torch.Tensor, xi8: torch.Tensor,
                   ax: torch.Tensor) -> torch.Tensor:
    """K17: y[T, O] f32 = (bf16(xi8) . bf16(qs)^T)_f32 * ax[T, 1] * scales[O, 1],
    under K4's shape rules. A CPU tensor takes the plain version; a CUDA
    tensor launches K17 (or raises)."""
    _check_width(xi8)
    if xi8.device.type == "cpu":
        return rowq_gemm_bf16_plain(qs, scales, xi8, ax)
    y = _launch(qs, scales, xi8, ax, 1, "rowq_gemm_bf16")
    rowq_gemm_bf16.launches += 1
    return y


def _check_width(xi8) -> None:
    i = xi8.shape[1]
    if i > _INT8_ACC_MAX_I:
        raise ValueError(f"rowq_gemm: I={i} > {_INT8_ACC_MAX_I} overflows the int32 sum")


def _launch(qs, scales, xi8, ax, bf16: int, what: str) -> torch.Tensor:
    t, i = xi8.shape
    o = qs.shape[0]
    _build.require(all(a.is_contiguous() for a in (qs, scales, xi8, ax)),
                   f"{what}: contiguous inputs")
    _build.require(qs.dtype == torch.int8 and xi8.dtype == torch.int8 and qs.shape[1] == i,
                   f"{what}: int8 qs [O, I] and xi8 [T, I]")
    _build.require(scales.dtype == torch.float32 and ax.dtype == torch.float32
                   and scales.numel() == o and ax.numel() == t, f"{what}: f32 scales")
    _build.require(i % 16 == 0 and qs.data_ptr() % 16 == 0 and xi8.data_ptr() % 16 == 0,
                   f"{what}: I % 16 == 0 and 16-byte aligned rows")
    y = torch.empty((t, o), dtype=torch.float32, device=xi8.device)
    lib = _build.load("gemm")
    err = lib.lt_rowq_gemm(xi8.data_ptr(), ax.data_ptr(), qs.data_ptr(), scales.data_ptr(),
                           y.data_ptr(), t, o, i, bf16, _build.stream())
    _build.check(lib, err, what)
    return y


rowq_gemm.launches = 0
rowq_gemm_bf16.launches = 0
