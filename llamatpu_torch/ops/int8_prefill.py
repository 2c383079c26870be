"""w8a8 prefill matmul for q8_row weights: the plain math.

Prefill projections are compute-bound, and int8 x int8 -> int32 runs at twice
the bf16 tensor-core rate. With per-row weight scales (q8_row) and a per-TOKEN
activation quantization, the whole contraction stays integer:

    y[t, o] = (xi8[t, :] . wi8[o, :])_int32 * ax[t] * s[o]

The port's copy of llamatpu/ops/int8_prefill.py. `quantize_activation_rows`
is bit-exact with the JAX package (multiply by 1/ax, never divide; round half
away from zero by trunc(s + sign(s) * 0.5); a zero row gives (0, 0)).
`rowq_matmul_mxu` is the plain version of the K4 kernel (ops/gemm.py).
"""
from __future__ import annotations

import torch

# Below this many activation rows the K1 cast-and-dot path is taken
# (bandwidth-bound regime; no activation rounding).
INT8_MXU_MIN_T = 128

# int32 accumulator bound: |product| <= 127 * 127 = 16129, so a full int32 sum
# is exact while I <= (2^31 - 1) / 16129 ~= 133,152.
_INT8_ACC_MAX_I = 131_072


def quantize_activation_rows(x2: torch.Tensor):
    """Per-row symmetric int8 quantization: (xi8 [T, I], ax [T, 1] f32) with
    x ~= xi8 * ax. Zero rows quantize to (0, 0)."""
    xf = x2.float()
    ax = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0
    pos = ax > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, ax, torch.ones_like(ax)),
                      torch.zeros_like(ax))
    s = xf * inv
    xi8 = torch.trunc(s + torch.sign(s) * 0.5).to(torch.int8)  # half away from 0
    return xi8, ax


def int_dot(xi8: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Exact integer (xi8 [T, I] . qs[O, I]^T) as f32. int32 matmul on the
    CPU; torch has no int32 matmul on the card, so there the sum is taken in
    float64, exact below 2^53 (|sum| <= 16129 * I)."""
    if xi8.device.type == "cpu":
        return (xi8.to(torch.int32) @ qs.to(torch.int32).T).float()
    return (xi8.double() @ qs.double().T).float()


def rowq_matmul_mxu(qs: torch.Tensor, row_scales: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """y[T, O] f32 = x2[T, I] @ (qs[O, I] * row_scales[O, 1])^T through the
    w8a8 integer product — the plain version, as the JAX package's XLA dot."""
    xi8, ax = quantize_activation_rows(x2)
    i = qs.shape[-1]
    if i <= _INT8_ACC_MAX_I:
        p = int_dot(xi8, qs)
    else:  # int32-safe partials over <= _INT8_ACC_MAX_I columns, f32 sum
        n = -(-i // _INT8_ACC_MAX_I)
        step = -(-i // n)
        p = sum(int_dot(xi8[:, c:c + step], qs[:, c:c + step])
                for c in range(0, i, step))
    return p * ax * row_scales[:, 0][None, :]
