"""The quantized-weight projections of the port (counterparts of
llamatpu/ops/pallas_matmul.py). Each takes one [O, I] weight, which may be a
layer view qs[li] of a stacked [L, O, I] tensor, and returns y[T, O] in f32.

- K1 `rowq_gemv`, the q8_row projection at T < 128 (`_kernel_rowq` /
  `_kernel_rowq_li`): y = x . qs^T with the int8 weights converted exactly
  and an f32 sum; the per-row scale multiplies the output outside the
  kernel (ops/matmul.py), as on the TPU. CUDA: csrc/quant_matmul.cu; bf16
  x runs csrc/rowq_tc.cuh's tensor-core template in passes of up to 32
  rows (`rowq_route`).
- K5 `block_matmul`, Q8_0 / Q4_0 block quants (`_kernel` / `_kernel_li`):
  y = dot(x.to(dt), (qs.f32 * s[o, i / 32]).to(dt)) with f32 accumulation,
  dt the dot dtype (f32 for f32 activations, else bf16). The dequantized
  weight is rounded to dt BEFORE the dot, as the TPU kernel does
  (pallas_matmul.py:93). CUDA: csrc/block_matmul.cu, on the kernel of
  `block_route`: bf16 prefill chunks on its TMA + wgmma GEMM
  (`wgmma_plan`), bf16 decode rows on csrc/rowq_tc.cuh's
  block-scale kinds (`plan_tc`), f32 x on its CUDA-core routes.
- K7 `packed4_matmul`, the same over packed4 Q4_0 values, two per byte
  (`_kernel_packed4` / `_kernel_packed4_li`), on the same routes.

Each has its plain PyTorch version here; a CPU tensor takes it, a CUDA
tensor launches the kernel or raises. K5 and K7 take any O and T: the
kernels mask the ragged edges themselves.
"""
from __future__ import annotations

import functools

import torch

from llamatpu_torch import _build
from llamatpu_torch.models.weights import unpack4_pairs
from llamatpu_torch.ops.ffn_fused import (_dot_dtype, aligned16, plan_tc, tc_partial, tc_plan,
                                          tc_route)
from llamatpu_torch.ops.gemm import BM as GEMM_TILE
from llamatpu_torch.ops.gemm import GemmPlan, _sm_count, plan_gemm

BLOCK = 32
GEMM_MIN_T = 16  # the CUDA-core routes of K5/K7 switch from the GEMV to the tiled kernel here
TC_MAX_T = 32    # K5/K7's bf16 rows on rowq_tc.cuh; more take the wgmma GEMM
SCALE_ROW_I = 128  # block-scale rows [I / 32] f32 are 16-byte multiples (TMA) for I % 128 == 0


def block_sums(x2: torch.Tensor) -> torch.Tensor:
    """xbsum [T, I/32]: the f32 sums of x2 [T, I]'s canonical 32-blocks, the
    activation side of the native K-quants' offset term."""
    t, i = x2.shape
    return x2.float().reshape(t, i // BLOCK, BLOCK).sum(dim=-1)


def rowq_gemv_plain(x2: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Plain version: the dot in f32 (bf16 x bf16-exact-int8 products are
    exact in f32, so this is the TPU's bf16 dot with f32 accumulation)."""
    return x2.float() @ qs.float().T


def _maxt(t: int, i: int) -> int:
    """Activation rows per block pass of gemv.cuh's gemv_kernel: as many as
    fit 192 KB of shared memory."""
    for m in (8, 4, 2, 1):
        if m <= max(t, 1) and m * i * 4 <= 192 * 1024:
            return m
    raise ValueError(f"rowq_gemv: in-features {i} do not fit shared memory")


TC_PASS_ROWS = 32     # rows of one pass of csrc/rowq_tc.cuh (its B fragments)
TILED_MAX_T = 32      # rows gemv.cuh's tiled GEMV takes in one launch


def rowq_route(t: int, i: int, dtype: torch.dtype) -> tuple[str, int]:
    """K1's kernel for t rows of width i: ("tc", passes) on rowq_tc.cuh for
    bf16 x at widths % 16 == 0, ceil(t / 32) passes; ("tiled", 1) on gemv.cuh's
    tiled GEMV for other x up to 32 rows; ("gemv", maxt) on its gemv_kernel
    above that, maxt rows a block pass."""
    if tc_route(dtype, i):
        return "tc", -(-t // TC_PASS_ROWS)
    if t <= TILED_MAX_T:
        return "tiled", 1
    return "gemv", _maxt(t, i)


def _rowq_launch(x2: torch.Tensor, qs: torch.Tensor, lib=None, sms=None,
                 route=None) -> torch.Tensor:
    """The checks, then one call of csrc/quant_matmul.cu `lt_rowq_gemv` (or
    of `lib`, a library with the same entry point) on the route of
    `rowq_route` (or `route`, to time another), with the plan of the
    largest pass and its scratch on the tensor-core route. Returns y [t, O]
    f32."""
    t, i = x2.shape
    o = qs.shape[0]
    _build.require(x2.dtype in (torch.float32, torch.bfloat16) and x2.is_contiguous()
                   and qs.is_contiguous(), "rowq_gemv: contiguous f32 or bf16 x, contiguous qs")
    _build.require(qs.dtype == torch.int8 and qs.dim() == 2 and qs.shape[1] == i
                   and qs.device == x2.device and t >= 1 and o >= 1,
                   "rowq_gemv: qs int8 [O, I] on x's device, T >= 1")
    route, n = route or rowq_route(t, i, x2.dtype)
    align = 4 if route == "gemv" else 16  # TMA and 16-byte weight loads
    _build.require(i % 4 == 0 and qs.data_ptr() % align == 0,
                   f"rowq_gemv: I % 4 == 0, {align}-byte aligned weights")
    dev = x2.device
    x2 = aligned16(x2)
    y = torch.empty((t, o), dtype=torch.float32, device=dev)
    maxt, plan, passes, partial = 0, (0, 0, 0, 0), 0, None
    if route == "tc":
        p = tc_plan(-(-t // n), o, i, False, dev, sms)
        plan, passes, partial = p.args, n, tc_partial(dev, p)
    elif route == "gemv":
        maxt = n
    lib = lib or _build.load("quant_matmul")
    err = lib.lt_rowq_gemv(x2.data_ptr(), _build.dtype_code(x2), qs.data_ptr(), y.data_ptr(),
                           None if partial is None else partial.data_ptr(), t, o, i, maxt,
                           *plan, passes, _build.stream())
    _build.check(lib, err, "rowq_gemv")
    return y


def rowq_gemv(x2: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """y[T, O] f32 = x2[T, I] . qs[O, I]^T. `qs` may be a layer view of a
    stacked [L, O, I] tensor. A CPU tensor takes the plain version; a CUDA
    tensor launches K1 (or raises)."""
    if x2.device.type == "cpu":
        return rowq_gemv_plain(x2, qs)
    y = _rowq_launch(x2, qs)
    rowq_gemv.launches += 1
    return y


rowq_gemv.launches = 0


# ------------------------------------------------------------------ K5 / K7
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


# csrc/block_matmul.cu's routes, by `lt_block_matmul`'s route code
BLOCK_ROUTES = {"gemv": 0, "tiled": 1, "tc": 2, "wgmma": 3}


def block_route(t: int, i: int, dtype: torch.dtype, packed: bool) -> str:
    """K5's (packed: K7's) kernel for t rows of width i in dtype x:
    - "wgmma": bf16, t > 32, i % 128 == 0: block_matmul.cu's TMA + wgmma GEMM;
    - "tc": bf16, t <= 32, i % 128 == 0: rowq_tc.cuh's block-scale kinds;
    - "gemv" (t < 16) and "tiled" (t >= 16) for the rest: f32 x (no f32
      tensor-core products) and widths whose rows of block scales are not
      16-byte multiples (TMA), on block_matmul.cu's CUDA-core kernels.
    Both weight kinds take the same route at every shape."""
    if dtype == torch.bfloat16 and i % SCALE_ROW_I == 0:
        return "tc" if t <= TC_MAX_T else "wgmma"
    return "gemv" if t < GEMM_MIN_T else "tiled"


# The wgmma GEMM's cost model, in K stages of one 128-row x block (fitted on
# the H100 to the four plans of each Llama-3.2-1B, Qwen1.5-MoE and
# Phi-3-medium prefill shape at T = 128, 256 and 512; PERF.md, slice 17): a
# stage of two x blocks costs 1.85 and its ring 2 more to fill (two stages
# of 82 KB against four of 50), and a shared tile's partial sums and the
# second pass that adds them 10.
WGMMA_TWO_BLOCKS = (1.85, 2.0)
WGMMA_SPLIT_COST = 10.0


@functools.lru_cache(maxsize=512)
def wgmma_plan(t: int, o: int, i: int, sms: int) -> tuple[GemmPlan, int]:
    """The wgmma GEMM's walk and x blocks of 128 rows a tile (nx): of one or
    two blocks (two only above 128 rows: each dequantized weight fragment
    then feeds twice the products), each under plan_gemm's plan (K17's:
    every SM busy, stream-K where the tiles are few) or whole tiles in
    rounds, the cheapest by the cost model: the busiest CTA's stages at
    their cost, the two-block ring's fill, the split's partial sums."""
    best = None
    for nx in (1, 2) if t > GEMM_TILE else (1,):
        per, fill = WGMMA_TWO_BLOCKS if nx == 2 else (1.0, 0.0)
        base = plan_gemm(t, o, i, sms, True, GEMM_TILE * nx)
        whole = GemmPlan(t, o, i, base.tiles_m, base.tiles_n, base.nk, min(sms, base.tiles),
                         base.tiles)
        for plan in (base, whole):
            cost = plan.busiest * per + fill + (WGMMA_SPLIT_COST if plan.split else 0.0)
            if best is None or cost < best[0]:
                best = (cost, plan, nx)
    return best[1], best[2]


def block_plan(t: int, o: int, i: int, route: str, packed: bool, sms: int):
    """The plan of a route: plan_tc's (g, splits, ksl, ctas) for "tc",
    `wgmma_plan`'s (walk, x blocks) for "wgmma", None for the CUDA-core
    routes."""
    if route == "tc":
        return plan_tc(t, o, i, False, sms, "q4p" if packed else "q8_0")
    if route == "wgmma":
        return wgmma_plan(t, o, i, sms)
    return None


def _launch_block(x2: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor, packed: bool,
                  what: str, lib=None) -> torch.Tensor:
    """The checks, then one call of csrc/block_matmul.cu `lt_block_matmul`
    (or of `lib`, a library with the same entry point) on the route of
    `block_route` with its plan and scratch. Returns y [t, O] f32."""
    t, i = x2.shape
    o = qs.shape[0]
    wbytes = i // 2 if packed else i
    _build.require(x2.dtype in (torch.float32, torch.bfloat16) and x2.is_contiguous()
                   and qs.is_contiguous() and scales.is_contiguous(),
                   f"{what}: contiguous f32 or bf16 x, contiguous weights")
    _build.require(qs.dtype == torch.int8 and tuple(qs.shape) == (o, wbytes)
                   and scales.dtype == torch.float32 and tuple(scales.shape) == (o, i // BLOCK)
                   and qs.device == x2.device == scales.device and t >= 1 and o >= 1,
                   f"{what}: qs int8 [O, {'I/2' if packed else 'I'}], scales f32 [O, I/32] "
                   "on x's device, T >= 1")
    route = block_route(t, i, x2.dtype, packed)
    dev = x2.device
    x2 = aligned16(x2)
    _build.require(i % BLOCK == 0 and qs.data_ptr() % 16 == 0 and scales.data_ptr() % 16 == 0,
                   f"{what}: I % 32 == 0, 16-byte aligned rows")
    sms = _sm_count(dev.index or 0)
    plan = block_plan(t, o, i, route, packed, sms)
    y = torch.empty((t, o), dtype=torch.float32, device=dev)
    args, scratch = (0, 0, 0, 0), None
    if route == "gemv":
        args = (_gemv_rows(t, i), 0, 0, 0)
    elif route == "tc":
        args, scratch = plan.args, tc_partial(dev, plan)
    elif route == "wgmma":
        plan, nx = plan
        args = (plan.ctas, plan.tiles_dp, nx, 0)
        if plan.split:
            scratch = torch.empty((plan.ws_slots, GEMM_TILE * GEMM_TILE * nx),
                                  dtype=torch.float32, device=dev)
    lib = lib or _build.load("block_matmul")
    err = lib.lt_block_matmul(x2.data_ptr(), _build.dtype_code(x2), qs.data_ptr(),
                              scales.data_ptr(), y.data_ptr(),
                              None if scratch is None else scratch.data_ptr(), t, o, i,
                              int(packed), BLOCK_ROUTES[route], *args, _build.stream())
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
