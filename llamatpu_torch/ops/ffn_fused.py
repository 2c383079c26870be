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

It also holds the plan of csrc/rowq_tc.cuh, the tensor-core template that
runs the bf16 GEMV phases of K1, K2, K9 and K20 (`plan_tc`, `TcPlan`:
16-row output blocks times contraction slices, spread over persistent CTAs,
the slices' sums added in order by a second launch), and the rule that
routes a call there or to gemv.cuh (`tc_route`; K20 takes bf16 only at
widths the rule admits).

CUDA source: csrc/ffn_fused.cu (design and bound in its header note). A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from llamatpu_torch import _build
from llamatpu_torch.models.weights import QTensor
from llamatpu_torch.ops.gemm import _sm_count

_MAX_T = 32          # decode / small-batch rows; prefill takes the int8 GEMM
_BLOCK_BYTES = 2.4 * 1024 * 1024
_VMEM_BUDGET = 12 * 1024 * 1024


def _dot_dtype(x: torch.Tensor) -> torch.dtype:
    """The working dtype: f32 for f32 activations, else bf16."""
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


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


# ------------------------------------------- csrc/rowq_tc.cuh's plan and route
TC_ROWS = 16             # rows of a group (w13: 16 gate rows and their 16 up rows)
TC_BOX = 128             # contraction columns of a TMA box
TC_GROUPS = (1, 2, 4)    # 16-row groups a unit: 8, 4 or 2 consumer warps a group split K
TC_DYN_SMEM = 232448 - 1024 - 1024  # a CTA's dynamic shared memory, less the ring's alignment
TC_RING_MIN = 3          # ring stages kept beside the x slice
TC_UNIT_BYTES = 32 * 1024  # a unit's fixed cost (parts, sums, scratch), in weight bytes
TC_REDUCE_BYTES = 48 * 1024  # a split phase's second launch (~2 us), in a CTA's weight bytes
TC_SPLITS_TRIED = 8      # slice counts tried past the fewest that fit
# the weight kinds of rowq_tc.cuh (its `WGeo`): columns of a 128-byte box row,
# bytes streamed a weight, f32 block scales staged a box row. q8_row for K1,
# K2, K9 and K20; Q8_0 (K5) and Q4_0 packed two a byte (K7) with their block
# scales
TC_KINDS = {"rowq": (128, 1.0, 0), "q8_0": (128, 1.125, 4), "q4p": (256, 0.625, 8)}


def tc_route(dtype: torch.dtype, *widths: int) -> bool:
    """Whether a call may run on csrc/rowq_tc.cuh: bf16 activations (the
    tensor cores give no f32 products) and every contraction width a
    multiple of 16 (TMA needs row strides of 16-byte multiples). Otherwise
    K1, K2 and K9 take gemv.cuh's tiled GEMV; K20 takes it for f32 and
    raises for bf16."""
    return dtype == torch.bfloat16 and all(w % 16 == 0 for w in widths)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def tc_x_bytes(tp: int, pair: bool, g: int, split: bool, kind: str = "rowq") -> int:
    """Shared memory for a CTA's bf16 x slice: what csrc/rowq_tc.cuh's
    `launch_nf` leaves beside the consumer warps' parts, a unit's sums of
    16 g-row blocks (`fin`, a phase of one slice only) and TC_RING_MIN ring
    stages (8 weight boxes, or 16 for a pair, and the block kinds' 8 scale
    boxes)."""
    nh = 2 if pair else 1
    fin = 0 if split else nh * g * TC_ROWS * tp * 4
    stage = nh * 8 * TC_ROWS * TC_BOX + 8 * TC_ROWS * TC_KINDS[kind][2] * 4
    return TC_DYN_SMEM - nh * 8 * TC_ROWS * tp * 4 - fin - TC_RING_MIN * stage


@dataclass(frozen=True)
class TcPlan:
    """The walk of one rowq_tc.cuh phase: t activation rows against o output
    rows (pair: o gate rows, each with its up row) over a contraction of i
    columns. Unit u is row block u % nrb (16 g rows: g groups of 16, each
    taken by 8 / g consumer warps splitting the columns) over contraction
    slice u // nrb (ksl columns, the last one shorter); CTA c takes the
    contiguous units [c U / ctas, (c + 1) U / ctas). With more than one slice,
    each unit's sums go to scratch and a second launch adds each output's
    slices in order 0, 1, ..."""
    t: int
    o: int
    i: int
    pair: bool
    g: int
    splits: int
    ksl: int
    ctas: int
    kind: str = "rowq"  # the weight kind (TC_KINDS)

    @property
    def tp(self) -> int:  # activation rows as the mma's B fragments (8 a fragment)
        return _ceil(self.t, 8) * 8

    @property
    def rows(self) -> int:
        return self.g * TC_ROWS

    @property
    def nrb(self) -> int:
        return _ceil(self.o, self.rows)

    @property
    def units(self) -> int:
        return self.nrb * self.splits

    def unit(self, u: int) -> tuple[int, int, int, int]:
        """(first output row, end output row, first column, end column) of unit u."""
        s, rb = divmod(u, self.nrb)
        return (rb * self.rows, min(self.o, (rb + 1) * self.rows), s * self.ksl,
                min(self.i, (s + 1) * self.ksl))

    def units_of(self, c: int) -> range:
        return range(c * self.units // self.ctas, (c + 1) * self.units // self.ctas)

    @property
    def order(self) -> range:
        """The slices, in the order their sums are added."""
        return range(self.splits)

    @property
    def partial_floats(self) -> int:
        """f32 scratch for the slices' sums (none with one slice)."""
        return 0 if self.splits == 1 else self.units * self.rows * self.tp * (2 if self.pair else 1)

    @property
    def args(self) -> tuple[int, int, int, int]:
        """(g, splits, ksl, ctas), as the C entry points take them."""
        return self.g, self.splits, self.ksl, self.ctas


@functools.lru_cache(maxsize=4096)
def plan_tc(t: int, o: int, i: int, pair: bool, sm_count: int = 132,
            kind: str = "rowq", ksl: int = 0) -> TcPlan:
    """The row groups, slices and CTAs of one phase. For each g of TC_GROUPS
    and each slice count from the fewest whose bf16 x slice (tp rows of 2 ksl
    + 32 bytes) fits `tc_x_bytes` to TC_SPLITS_TRIED more, the busiest CTA's
    cost: ceil(units / SMs) units of their weight bytes (the kind's bytes a
    weight, TC_KINDS) plus TC_UNIT_BYTES, and TC_REDUCE_BYTES for the second
    launch of a split contraction. Slices are whole boxes of the kind (128
    columns, 256 packed). The cheapest wins, the fewest units on a tie; one
    CTA an SM, or one a unit. `ksl` (a multiple of the box whose slice fits
    every g) fixes the slices and leaves g to the cost: K16's w2 phase, whose
    slices are its contraction tiles. Cached: a decode step asks for the
    same few plans every layer."""
    tp = _ceil(t, 8) * 8
    box, wbytes, _ = TC_KINDS[kind]

    def ksl_of(s):
        return _ceil(_ceil(i, s), box) * box

    def fits(g, s):
        ksl = ksl_of(s)
        return tp * (2 * ksl + 32) <= tc_x_bytes(tp, pair, g, _ceil(i, ksl) > 1, kind)
    best = None
    fixed = ksl
    for g in TC_GROUPS:
        s0 = _ceil(i, fixed) if fixed else 1
        while not fixed and not fits(g, s0):
            s0 += 1
        nrb = _ceil(o, g * TC_ROWS)
        for s in range(s0, s0 + (0 if fixed else TC_SPLITS_TRIED) + 1):
            ksl = fixed or ksl_of(s)
            splits = _ceil(i, ksl)
            units = nrb * splits
            unit_bytes = g * TC_ROWS * ksl * (2 if pair else 1) * wbytes
            cost = _ceil(units, sm_count) * (unit_bytes + TC_UNIT_BYTES)
            key = (cost + (TC_REDUCE_BYTES if splits > 1 else 0), units)
            if best is None or key < best[0]:
                best = (key, TcPlan(t, o, i, pair, g, splits, ksl, min(units, sm_count), kind))
    return best[1]


def tc_plan(t: int, o: int, i: int, pair: bool, dev: torch.device, sms=None,
            ksl: int = 0) -> TcPlan:
    """`plan_tc` for a call on dev's SMs (or on `sms`, where a test gives them)."""
    return plan_tc(t, o, i, pair, sms or _sm_count(dev.index or 0), ksl=ksl)


def tc_partial(dev: torch.device, *plans: TcPlan) -> torch.Tensor | None:
    """f32 scratch for the slices' sums of the split phases among `plans`
    (None if none is split); the phases run in stream order, so one buffer
    serves them all."""
    n = max(p.partial_floats for p in plans)
    return torch.empty(n, dtype=torch.float32, device=dev) if n else None


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it whose first element is 16-byte aligned (TMA and
    16-byte vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ffn_launch(x2, qs13, s13, qs2, s2, lib=None, sms=None):
    """The checks, then one call of csrc/ffn_fused.cu `lt_ffn_fused` (or of
    `lib`, a library with the same entry point) on x2 [t, d]: bf16 x on
    rowq_tc.cuh with the plan of both phases, f32 x on gemv.cuh. Returns out
    [t, d] f32."""
    t, d = x2.shape
    f = qs2.shape[1]
    _build.require(1 <= t <= _MAX_T and tuple(qs13.shape) == (2 * f, d)
                   and tuple(qs2.shape) == (d, f) and tuple(s13.shape) == (2 * f,)
                   and tuple(s2.shape) == (d,) and d % 4 == 0 and f % 4 == 0,
                   "ffn_fused_rowq: x [T <= 32, D], w13 [2F, D], w2 [D, F], D and F % 4 == 0")
    # every shape `ffn_fits` admits has D and F multiples of 128 (`_pick_to`)
    _build.require(x2.dtype == torch.float32 or tc_route(x2.dtype, d, f),
                   "ffn_fused_rowq: x f32, or bf16 with D and F % 16 == 0")
    _build.require(all(a.is_contiguous() for a in (qs13, s13, qs2, s2))
                   and qs13.device == qs2.device == x2.device
                   and qs13.data_ptr() % 16 == 0 and qs2.data_ptr() % 16 == 0,
                   "ffn_fused_rowq: contiguous, 16-byte aligned weights on x's device")
    x2 = aligned16(x2)
    dev = x2.device
    out = torch.empty((t, d), dtype=torch.float32, device=dev)
    partial = None
    if x2.dtype == torch.bfloat16:
        p13, p2 = tc_plan(t, f, d, True, dev, sms), tc_plan(t, d, f, False, dev, sms)
        act = torch.empty((t, f), dtype=torch.bfloat16, device=dev)
        partial = tc_partial(dev, p13, p2)
        plan = (*p13.args, *p2.args)
    else:
        act = torch.empty((t, f), dtype=torch.float32, device=dev)
        plan = (0,) * 8
    lib = lib or _build.load("ffn_fused")
    err = lib.lt_ffn_fused(x2.data_ptr(), _build.dtype_code(x2), qs13.data_ptr(),
                           s13.data_ptr(), qs2.data_ptr(), s2.data_ptr(), act.data_ptr(),
                           None if partial is None else partial.data_ptr(), out.data_ptr(),
                           t, d, f, *plan, _build.stream())
    _build.check(lib, err, "ffn_fused_rowq")
    return out


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
    out = _ffn_launch(x.reshape(t, x.shape[-1]).contiguous(), qs13, s13, qs2, s2)
    ffn_fused_rowq.launches += 1
    return out.reshape(x.shape).to(x.dtype)


ffn_fused_rowq.launches = 0
