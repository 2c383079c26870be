"""The exact ggml Q8_0 x Q8_0 matmul of `--impl int8`: activations quantized
per 32-block, int8 x int8 products summed exactly in int32, scaled by
(weight block scale) x (activation block scale rounded through f16).

The port of llamatpu/ops/int8_matmul.py, the ppl-parity mode: bit-for-bit
llama.cpp's Q8_0 CPU dot, where the bf16-dequant kernels trade that
exactness for tensor-core dtypes.

- `quantize_activation_blocks`: ggml's order exactly (amax / 127 in f32;
  inv = 1 / d where d > 0, else 0; s = x * inv, a product; round half away
  from zero as trunc(s + copysign(0.5, s)); d rounded through f16,
  subnormals included). Every division is tensor by tensor: on CUDA a
  division by a Python scalar is a product with its rounded reciprocal.
- `quant_matmul_int8_ref`: the plain block dot, int32 block sums (float64
  on the card, where torch has no int32 matmul: exact, |sum| <= 32 * 127 *
  127), `combined = s_w[o, b] * d[t, b]` before it multiplies the sum, the
  blocks summed in f32, as `int8_matmul.py:64-66`.
- `int8_dot`: the kernel's wrapper (csrc/int8_matmul.cu): the activation
  quantization and the block dot, two launches on the caller's stream, no
  host read (graph-capturable). A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises. With `experts` (an int [R]
  tensor), row r reads expert experts[r] of a stacked [E, O, I] weight: the
  MoE scan's (token, slot) projections in one call, at any R.
- `quant_matmul_int8`: the JAX function. Above `_T_LIMIT` rows (over all
  leading dims) the JAX package takes its dequantised XLA dot of the same
  function; the port takes its own route for the weight, K5.
"""
from __future__ import annotations

import torch

from llamatpu_torch import _build

BLOCK = 32
_T_LIMIT = 16  # above this many rows: the dequantised route (K5)


def quantize_activation_blocks(x2: torch.Tensor):
    """(q int8 [T, NB, 32], d_f16 f32 [T, NB]): x2 [T, I] quantized per
    32-block in ggml's order; q derives from the full-precision scale."""
    t, i = x2.shape
    xb = x2.float().reshape(t, i // BLOCK, BLOCK)
    amax = xb.abs().amax(dim=-1)
    d = amax / torch.full_like(amax, 127.0)
    pos = d > 0
    one = torch.ones_like(d)
    inv = torch.where(pos, one / torch.where(pos, d, one), torch.zeros_like(d))
    s = xb * inv[..., None]
    q = torch.trunc(s + torch.copysign(torch.full_like(s, 0.5), s)).to(torch.int8)
    return q, d.to(torch.float16).float()


def block_sums_int(q: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """p [NB, T, O]: each block's exact int8 dot, q [T, NB, 32] against qs
    [O, I]. int32 on the CPU; float64 on the card (exact below 2^53)."""
    o, i = qs.shape
    dt = torch.int32 if q.device.type == "cpu" else torch.float64
    a = q.to(dt).transpose(0, 1)                               # [NB, T, 32]
    w = qs.reshape(o, i // BLOCK, BLOCK).to(dt).permute(1, 2, 0)  # [NB, 32, O]
    return torch.bmm(a, w)


def quant_matmul_int8_ref(x2: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain version: y [T, O] f32 = the exact block dot of x2 [T, I]
    against Q8_0 values qs [O, I] with block scales [O, I / 32]."""
    q, d = quantize_activation_blocks(x2)
    p = block_sums_int(q, qs).float()                          # [NB, T, O]
    combined = scales.float().T[:, None, :] * d.T[:, :, None]  # [NB, T, O]
    return (p * combined).sum(dim=0)


def int8_dot_plain(x2: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor,
                   experts: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of `int8_dot`: row r of x2 against qs (or, with
    experts, against qs[experts[r]]), y [R, O] f32."""
    if experts is None:
        return quant_matmul_int8_ref(x2, qs, scales)
    y = torch.empty((x2.shape[0], qs.shape[-2]), dtype=torch.float32, device=x2.device)
    for e in torch.unique(experts).tolist():
        rows = (experts == e).nonzero()[:, 0]
        y[rows] = quant_matmul_int8_ref(x2[rows], qs[e], scales[e])
    return y


def _launch(x2: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor,
            experts: torch.Tensor | None, lib=None) -> torch.Tensor:
    """The checks, then one call of csrc/int8_matmul.cu `lt_int8_dot`: one
    group of R <= 16 rows against one weight, or R groups of one row each
    against its expert."""
    r, i = x2.shape
    o = qs.shape[-2]
    nb = i // BLOCK
    _build.require(x2.dtype in (torch.float32, torch.bfloat16) and x2.is_contiguous()
                   and qs.is_contiguous() and scales.is_contiguous(),
                   "int8_dot: contiguous f32 or bf16 x, contiguous weights")
    _build.require(qs.dtype == torch.int8 and qs.shape[-1] == i and i % BLOCK == 0
                   and scales.dtype == torch.float32 and tuple(scales.shape[-2:]) == (o, nb)
                   and qs.device == x2.device == scales.device and r >= 1 and o >= 1,
                   "int8_dot: qs int8 [.., O, I], scales f32 [.., O, I/32] on x's device, "
                   "I % 32 == 0")
    _build.require(qs.data_ptr() % 16 == 0, "int8_dot: 16-byte aligned weights")
    if experts is None:
        _build.require(qs.dim() == 2 and r <= _T_LIMIT, "int8_dot: one [O, I] weight, R <= 16")
        groups, tg, ex, ws, ss = 1, r, None, 0, 0
    else:
        _build.require(qs.dim() == 3 and experts.dtype == torch.int32 and experts.is_contiguous()
                       and tuple(experts.shape) == (r,) and experts.device == x2.device
                       and r <= 65535,
                       "int8_dot: stacked [E, O, I] weights, experts int32 [R], R <= 65535")
        groups, tg, ex, ws, ss = r, 1, experts.data_ptr(), o * i, o * nb
    dev = x2.device
    xq = torch.empty((r, i), dtype=torch.int8, device=dev)
    xd = torch.empty((r, nb), dtype=torch.float32, device=dev)
    y = torch.empty((r, o), dtype=torch.float32, device=dev)
    lib = lib or _build.load("int8_matmul")
    err = lib.lt_int8_dot(x2.data_ptr(), _build.dtype_code(x2), xq.data_ptr(), xd.data_ptr(),
                          qs.data_ptr(), scales.data_ptr(), ex, ws, ss, y.data_ptr(), groups,
                          tg, o, i, _build.stream())
    _build.check(lib, err, "int8_dot")
    return y


def int8_dot(x2: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor,
             experts: torch.Tensor | None = None) -> torch.Tensor:
    """y [R, O] f32: the exact block dot of x2 [R, I] against qs [O, I]
    (R <= 16), or of row r against qs[experts[r]] ([E, O, I], any R). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises)."""
    if x2.device.type == "cpu":
        return int8_dot_plain(x2, qs, scales, experts)
    if experts is not None:
        experts = experts.to(torch.int32).contiguous()
    y = _launch(x2, qs, scales, experts)
    int8_dot.launches += 1
    return y


int8_dot.launches = 0


def quant_matmul_int8(w, x: torch.Tensor, li: int | None = None) -> torch.Tensor:
    """y[..., O] = the exact ggml int8 dot of x against Q8_0 weights w (a
    canonical QTensor; with li, layer li of a stacked one), cast to x's
    dtype. Above _T_LIMIT rows, the port's dequantised route (K5)."""
    assert w.kind == "q8_0" and w.layout == "canonical", "int8 path requires Q8_0 weights"
    from llamatpu_torch.ops.quant_matmul import block_matmul

    qs, scales = (w.qs, w.scales) if li is None else (w.qs[li], w.scales[li])
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.shape[0] > _T_LIMIT:
        y = block_matmul(x2, qs, scales)
    else:
        y = int8_dot(x2, qs, scales)
    y = y.reshape(*lead, qs.shape[-2]).to(x.dtype)
    return y[..., : w.logical_out] if w.logical_out else y
