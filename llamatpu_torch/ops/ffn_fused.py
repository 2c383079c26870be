"""K20 `ffn_fused_rowq`: the q8_row FFN of one layer, w13 -> silu * up -> w2
in one call, counterpart of llamatpu/ops/ffn_fused.py `_kernel` (through
`ffn_fused_rowq`). For T <= 32 rows x [T, D] and stacked q8_row w13 [L, 2F,
D] (gate rows, then up rows), w2 [L, D, F], with dt the working dtype (f32
for f32 x, else bf16):

    g13 = (x.to(dt) . w13[li]^T) * s13     f32, never rounded
    act = (gate * sigmoid(gate) * up).to(dt)
    out = (act . w2[li]^T) * s2            f32, returned in x's dtype

The forward takes it where the JAX package's `_dense_ffn` does: a q8_row
decode step whose layer tail (K9) declines its VMEM fit while this one fits
(models/transformer.py).

This module also keeps the JAX package's VMEM-fit arithmetic (`_pick_to`,
`_vmem_need`, `_BLOCK_BYTES`, `_VMEM_BUDGET`, `_MAX_T`, ffn_fused.py:39-61):
the shape rules by which the JAX kernels decline a shape that would not fit
a TPU core's VMEM. The port has no VMEM; it keeps the rules so that it
takes the same kernel as the JAX package at every shape (ops/layer_fused.py
reads `_VMEM_BUDGET` from here at each call, so a test can lower it).

CUDA source: csrc/ffn_fused.cu (design and bound in its header note). A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from llamatpu_torch import _build
from llamatpu_torch.models.weights import QTensor
from llamatpu_torch.ops.quant_matmul import _dot_dtype

_MAX_T = 32          # decode / small-batch rows; prefill takes the int8 GEMM
_BLOCK_BYTES = 2.4 * 1024 * 1024
_VMEM_BUDGET = 12 * 1024 * 1024
W2_SPLITS = (4, 2, 1)  # K20's w2 phase: contraction splits tried, widest first


def _pick_to(o: int, i: int) -> int:
    """The JAX kernels' output tile: the widest of 1024, 512, 256, 128
    dividing o whose int8 [to, i] block stays within _BLOCK_BYTES (0: none)."""
    for to in (1024, 512, 256, 128):
        if o % to == 0 and to * i <= _BLOCK_BYTES:
            return to
    return 0


def _vmem_need(tp: int, d: int, f: int, o13: int, to13: int, to2: int,
               xbytes: int, act_bytes: int) -> int:
    """The JAX kernel's VMEM estimate: the f32 g13 and the act scratch beside
    both phases' double-buffered weight blocks."""
    return (tp * d * xbytes
            + tp * o13 * 4
            + tp * f * act_bytes
            + 2 * tp * to2 * 4
            + 2 * (to13 * d + to13 * 4)
            + 2 * (to2 * f + to2 * 4))


def ffn_fits(t: int, d: int, f: int, xbytes: int) -> bool:
    """Whether the JAX package's `ffn_fused_rowq` takes t rows at width d and
    hidden width f (ffn_fused.py:152-166): t <= 32, both tiles exist, and the
    VMEM estimate is within `_VMEM_BUDGET`."""
    o13 = 2 * f
    to13, to2 = _pick_to(o13, d), _pick_to(d, f)
    if t > _MAX_T or not to13 or not to2:
        return False
    tp = -(-t // 8) * 8
    return _vmem_need(tp, d, f, o13, to13, to2, xbytes, xbytes) <= _VMEM_BUDGET


def _rows(w13, w2, x) -> int | None:
    """T when the call is eligible (stacked q8_row weights of matching
    shapes and `ffn_fits`), else None: the JAX function's checks."""
    for w in (w13, w2):
        if not (isinstance(w, QTensor) and w.kind == "q8_row" and w.qs.dim() == 3
                and not w.logical_out):
            return None
    o13, d = w13.qs.shape[-2:]
    d2, f = w2.qs.shape[-2:]
    t = x.numel() // x.shape[-1]
    if o13 != 2 * f or d2 != d or x.shape[-1] != d:
        return None
    return t if ffn_fits(t, d, f, 4 if x.dtype == torch.float32 else 2) else None


def ffn_fused_plain(w13: QTensor, w2: QTensor, x: torch.Tensor, li: int):
    """Plain version of K20 (same arguments and results; None where the call
    is not eligible)."""
    t = _rows(w13, w2, x)
    if t is None:
        return None
    dot = _dot_dtype(x)
    d = x.shape[-1]
    qs13, s13 = w13.qs[li], w13.scales[li][:, 0]
    qs2, s2 = w2.qs[li], w2.scales[li][:, 0]
    g13 = (x.reshape(t, d).to(dot).float() @ qs13.float().T) * s13
    f = qs2.shape[1]
    gate, up = g13[:, :f], g13[:, f:]
    act = (gate * torch.sigmoid(gate) * up).to(dot)
    y = (act.float() @ qs2.float().T) * s2
    return y.reshape(x.shape).to(x.dtype)


def w2_split(f: int) -> int:
    """K20's bf16 w2 phase splits its contraction F into this many slices of
    a multiple of 64 columns (more blocks on the card at D = 5120)."""
    return next(s for s in W2_SPLITS if f % (64 * s) == 0)


def ffn_fused_rowq(w13: QTensor, w2: QTensor, x: torch.Tensor, li: int):
    """y [..., D] in x's dtype = FFN(x) of layer li with stacked q8_row w13
    [L, 2F, D] and w2 [L, D, F]; None where the JAX function returns None
    (more than 32 rows, other weights, a failed VMEM fit)."""
    if x.device.type == "cpu":
        return ffn_fused_plain(w13, w2, x, li)
    t = _rows(w13, w2, x)
    if t is None:
        return None
    qs13, s13 = w13.qs[li], w13.scales[li][:, 0]
    qs2, s2 = w2.qs[li], w2.scales[li][:, 0]
    d, f = x.shape[-1], qs2.shape[1]
    x2 = x.reshape(t, d).contiguous()
    dot = _dot_dtype(x)
    _build.require(all(a.is_contiguous() for a in (qs13, s13, qs2, s2))
                   and qs13.device == qs2.device == x.device
                   and qs13.data_ptr() % 16 == 0 and qs2.data_ptr() % 16 == 0
                   and x2.data_ptr() % 16 == 0,
                   "ffn_fused_rowq: contiguous, 16-byte aligned weights on x's device")
    tp = -(-t // 8) * 8
    dev = x.device
    split = w2_split(f)
    act = torch.empty((tp, f), dtype=dot, device=dev)
    partial = (torch.empty((split, tp, d), dtype=torch.float32, device=dev)
               if dot == torch.bfloat16 else None)
    out = torch.empty((t, d), dtype=torch.float32, device=dev)
    lib = _build.load("ffn_fused")
    err = lib.lt_ffn_fused(x2.data_ptr(), _build.dtype_code(x2), qs13.data_ptr(),
                           s13.data_ptr(), qs2.data_ptr(), s2.data_ptr(), act.data_ptr(),
                           None if partial is None else partial.data_ptr(), out.data_ptr(),
                           t, d, f, split, _build.stream())
    _build.check(lib, err, "ffn_fused_rowq")
    ffn_fused_rowq.launches += 1
    return out.reshape(x.shape).to(x.dtype)


ffn_fused_rowq.launches = 0
