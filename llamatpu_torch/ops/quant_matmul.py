"""The quantized-weight projections of the port (counterparts of
llamatpu/ops/pallas_matmul.py). Each takes one [O, I] weight, which may be a
layer view qs[li] of a stacked [L, O, I] tensor, and returns y[T, O] in f32.

- K1 `rowq_gemv`, the q8_row projection at T < 128 (`_kernel_rowq` /
  `_kernel_rowq_li`): y = x . qs^T with the int8 weights converted exactly
  and an f32 sum; the per-row scale multiplies the output outside the
  kernel (ops/matmul.py), as on the TPU. CUDA: csrc/quant_matmul.cu.
- K5 `block_matmul`, Q8_0 / Q4_0 block quants (`_kernel` / `_kernel_li`):
  y = dot(x.to(dt), (qs.f32 * s[o, i / 32]).to(dt)) with f32 accumulation,
  dt the dot dtype (f32 for f32 activations, else bf16). The dequantized
  weight is rounded to dt BEFORE the dot, as the TPU kernel does
  (pallas_matmul.py:93). CUDA: csrc/block_matmul.cu.
- K7 `packed4_matmul`, the same over packed4 Q4_0 values, two per byte
  (`_kernel_packed4` / `_kernel_packed4_li`). CUDA: csrc/block_matmul.cu.

Each has its plain PyTorch version here; a CPU tensor takes it, a CUDA
tensor launches the kernel or raises. K5 and K7 take any O and T: the
kernels mask the ragged edges themselves.
"""
from __future__ import annotations

import torch

from llamatpu_torch import _build
from llamatpu_torch.models.weights import unpack4_pairs

BLOCK = 32
GEMM_MIN_T = 16  # K5/K7 switch from the GEMV to the tiled tensor-core path here


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


# ------------------------------------------------------------------ K5 / K7
def _dot_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


def dequant_blocks(qs: torch.Tensor, scales: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(qs.f32 * scale of its 32-block) rounded to dt: the TPU kernel's
    in-VMEM dequant."""
    return (qs.float() * scales.float().repeat_interleave(BLOCK, dim=-1)).to(dt)


def block_matmul_plain(x2: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: y[T, O] f32."""
    dt = _dot_dtype(x2)
    w = dequant_blocks(qs, scales, dt)
    return x2.to(dt).float() @ w.float().T


def packed4_matmul_plain(x2: torch.Tensor, qp: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: unpack the sign-extended nibble pairs, then K5's
    arithmetic."""
    return block_matmul_plain(x2, unpack4_pairs(qp), scales)


def _gemv_rows(t: int, i: int) -> int:
    """Activation rows per GEMV block pass: as many as fit 192 KB of shared memory."""
    for m in (8, 4, 2, 1):
        if m <= max(t, 1) and m * i * 4 <= 192 * 1024:
            return m
    raise ValueError(f"block_matmul: in-features {i} do not fit shared memory")


def _launch_block(x2: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor, packed: bool,
                  what: str) -> torch.Tensor:
    t, i = x2.shape
    o = qs.shape[0]
    wbytes = i // 2 if packed else i
    _build.require(x2.is_contiguous() and qs.is_contiguous() and scales.is_contiguous(),
                   f"{what}: contiguous inputs")
    _build.require(qs.dtype == torch.int8 and tuple(qs.shape) == (o, wbytes)
                   and scales.dtype == torch.float32 and tuple(scales.shape) == (o, i // BLOCK)
                   and qs.device == x2.device == scales.device,
                   f"{what}: qs int8 [O, {'I/2' if packed else 'I'}], scales f32 [O, I/32] "
                   "on x's device")
    _build.require(i % BLOCK == 0 and qs.data_ptr() % 16 == 0 and x2.data_ptr() % 16 == 0,
                   f"{what}: I % 32 == 0, 16-byte aligned rows")
    y = torch.empty((t, o), dtype=torch.float32, device=x2.device)
    lib = _build.load("block_matmul")
    maxt = _gemv_rows(t, i) if t < GEMM_MIN_T else 0
    err = lib.lt_block_matmul(x2.data_ptr(), _build.dtype_code(x2), qs.data_ptr(),
                              scales.data_ptr(), y.data_ptr(), t, o, i, int(packed), maxt,
                              _build.stream())
    _build.check(lib, err, what)
    return y


def block_matmul(x2: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K5: y[T, O] f32 = x2[T, I] @ dequant(qs [O, I] int8, scales [O, I/32])^T.
    `qs`/`scales` may be layer views of stacked tensors. A CPU tensor takes
    the plain version; a CUDA tensor launches K5 (or raises)."""
    if x2.device.type == "cpu":
        return block_matmul_plain(x2, qs, scales)
    y = _launch_block(x2, qs, scales, False, "block_matmul")
    block_matmul.launches += 1
    return y


block_matmul.launches = 0


def packed4_matmul(x2: torch.Tensor, qp: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K7: K5 over packed4 values qp [O, I/2] (byte c = canonical columns 2c
    | 2c + 1 << 4, two's complement nibbles)."""
    if x2.device.type == "cpu":
        return packed4_matmul_plain(x2, qp, scales)
    y = _launch_block(x2, qp, scales, True, "packed4_matmul")
    packed4_matmul.launches += 1
    return y


packed4_matmul.launches = 0
