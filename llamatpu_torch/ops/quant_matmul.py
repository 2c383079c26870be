"""K1: the q8_row projection at T < 128 — on the main path, the vocab head of
every decode token and every prefill chunk.

Counterpart of llamatpu/ops/pallas_matmul.py `_kernel_rowq` / `_kernel_rowq_li`
(through `_rowq_matmul_2d[_li]`): y[T, O] f32 = x[T, I] . qs[O, I]^T with the
int8 weights converted exactly and an f32 sum. The per-row scale multiplies
the output outside the kernel (ops/matmul.py), as on the TPU. CUDA source:
csrc/quant_matmul.cu (design and bound in its header note).
"""
from __future__ import annotations

import torch

from llamatpu_torch import _build


def rowq_gemv_plain(x2: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Plain version: the dot in f32 (bf16 x bf16-exact-int8 products are
    exact in f32, so this is the TPU's bf16 dot with f32 accumulation)."""
    return x2.float() @ qs.float().T


def _maxt(t: int, i: int) -> int:
    """Activation rows per block pass: as many as fit 192 KB of shared memory."""
    for m in (8, 4, 2, 1):
        if m <= max(t, 1) and m * i * 4 <= 192 * 1024:
            return m
    raise ValueError(f"rowq_gemv: in-features {i} do not fit shared memory")


def rowq_gemv(x2: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """y[T, O] f32 = x2[T, I] . qs[O, I]^T. `qs` may be a layer view of a
    stacked [L, O, I] tensor. A CPU tensor takes the plain version; a CUDA
    tensor launches K1 (or raises)."""
    if x2.device.type == "cpu":
        return rowq_gemv_plain(x2, qs)
    t, i = x2.shape
    o = qs.shape[0]
    _build.require(x2.is_contiguous() and qs.is_contiguous(), "rowq_gemv: contiguous inputs")
    _build.require(qs.dtype == torch.int8 and qs.shape[1] == i and qs.device == x2.device,
                   "rowq_gemv: qs int8 [O, I] on x's device")
    _build.require(i % 4 == 0 and qs.data_ptr() % 4 == 0, "rowq_gemv: I % 4 == 0, aligned rows")
    y = torch.empty((t, o), dtype=torch.float32, device=x2.device)
    lib = _build.load("quant_matmul")
    err = lib.lt_rowq_gemv(x2.data_ptr(), _build.dtype_code(x2), qs.data_ptr(), y.data_ptr(),
                           t, o, i, _maxt(t, i), _build.stream())
    _build.check(lib, err, "rowq_gemv")
    rowq_gemv.launches += 1
    return y


rowq_gemv.launches = 0
