"""Grouped (ragged) expert matmuls of the MoE FFN: the port of
llamatpu/ops/moe_grouped.py.

The routed FFN over N tokens with k experts each (the folded shared expert
rides along as S more experts per token, models/weights.py
`fold_shared_expert`):
1. `sort_by_expert` flattens the [N, k] routing and sorts it by expert, each
   expert's rows padded to the tile size tm, so every tm-row tile belongs to
   one expert (`tile_expert`, -1 for the tail tiles past the last group);
2. `grouped_matmul` runs each tile against its expert's weights only, by
   weight kind: K10 `grouped_block_matmul` (Q8_0 / Q4_0 / Q4_K / Q5_K
   values), K11 `grouped_packed4_matmul`, K12 `grouped_rowq_matmul`
   (q8_row), K13 `grouped_dense_matmul` (F32 / F16 / BF16 checkpoints, and
   the native K-quants' offset term: `grouped_offset_term`);
3. `grouped_ffn` gathers the sorted rows, runs gate+up, silu(gate) * up in
   f32 rounded once to the activation dtype, and down, then combines each
   token's rows weighted by its routing weights in f32.

The routing runs on the device with no host sync: argsort (stable),
searchsorted and cumsum, with the row count Mp a static bound computed on the
host from N, k, E and tm. The combine is deterministic: each (token, slot)
finds its sorted row (a stable argsort of row_src) and the slots are summed
by a gather and a reduction, with no atomics (the JAX package's one-hot
matmul sums in another order: f32 rounding apart).

Each kernel has its plain PyTorch version here; a CPU tensor takes it, a CUDA
tensor launches the kernel (csrc/moe_grouped.cu `grouped_tc_kernel`, one
template for the four weight kinds, its walk planned by `plan_grouped`) or
raises. The plain versions take the tiles expert by expert, reading the tile
table on the host.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from llamatpu_torch import _build
from llamatpu_torch.models.weights import QTensor, unpack4_pairs
from llamatpu_torch.ops.quant_matmul import block_sums

BLOCK = 32
# front ends of csrc/moe_grouped.cu
_K_BLOCK, _K_PACKED, _K_ROWQ, _K_DENSE = 0, 1, 2, 3
# csrc/moe_grouped.cu's walk: weight rows of a unit in the GEMV form (bf16 x,
# tm <= GEMV_TM, I <= MAX_SLICE: x held in registers) and in the tiled form
GEMV_ROWS, TILE_ROWS = 16, 128
GEMV_TM, MAX_SLICE = 8, 4096


# ----------------------------------------------------------------- routing
def tile_rows(n_tokens: int, k: int) -> int:
    """The tile size of the JAX package's rule (transformer.py:270-271), over
    nk = tokens x (experts per token)."""
    nk = n_tokens * k
    return 128 if nk >= 1024 else (8 if nk <= 64 else 32)


def sorted_rows(n: int, k: int, n_experts: int, tm: int) -> int:
    """Mp, the static bound on the sorted rows: at most min(N*k, E) experts
    are used and each wastes at most tm - 1 pad rows."""
    nk = n * k
    if n == 1:
        return k * tm
    return -(-(nk + min(nk, n_experts) * (tm - 1)) // tm) * tm


def sort_by_expert(top_i: torch.Tensor, n_experts: int, tm: int):
    """[N, k] expert ids -> (row_token [Mp], row_src [Mp], tile_expert
    [Mp / tm]) int32, bit-equal to the JAX package's: row_src maps a sorted
    row to its assignment index in [0, N*k) (N*k for a pad row), row_token to
    its token (N for a pad row). N = 1 takes the fast path of one tile per
    assignment (the top-k ids are distinct)."""
    n, k = top_i.shape
    nk = n * k
    dev = top_i.device
    i32 = torch.int32
    if n == 1:
        r = torch.arange(k * tm, device=dev)
        first = (r % tm) == 0
        row_token = torch.where(first, 0, n).to(i32)
        row_src = torch.where(first, r // tm, nk).to(i32)
        return row_token, row_src, top_i[0].to(i32)
    mp = sorted_rows(n, k, n_experts, tm)
    eid = top_i.reshape(nk).long()
    sort_idx = torch.argsort(eid, stable=True)
    eid_s = eid[sort_idx]
    # per-expert group starts and counts from the sorted ids (no bincount;
    # the last end made on the device: no host data in a captured step)
    starts = torch.searchsorted(eid_s, torch.arange(n_experts, device=dev))
    counts = torch.cat([starts[1:], starts.new_full((1,), nk)]) - starts
    padded = (counts + tm - 1) // tm * tm
    grp_start = torch.cumsum(padded, 0) - padded
    j = torch.arange(nk, device=dev)
    # strictly increasing: groups in expert order, offsets within each group
    dest_sorted = grp_start[eid_s] + (j - starts[eid_s])
    # invert dest_sorted by binary search instead of a scatter
    r = torch.arange(mp, device=dev)
    jj = torch.clamp(torch.searchsorted(dest_sorted, r), max=nk - 1)
    hit = dest_sorted[jj] == r
    src = sort_idx[jj]
    row_src = torch.where(hit, src, nk).to(i32)
    row_token = torch.where(hit, src // k, n).to(i32)
    ends = torch.cumsum(padded, 0)
    tile_start = torch.arange(mp // tm, device=dev) * tm
    tile_expert = torch.clamp(torch.searchsorted(ends, tile_start, right=True), max=n_experts - 1)
    tile_expert = torch.where(tile_start < ends[-1], tile_expert, -1).to(i32)
    return row_token, row_src, tile_expert


# ----------------------------------------------------------------- kernels
def _dot_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


def _expert_weight(kind: int, w: torch.Tensor, s, e: int, dt: torch.dtype) -> torch.Tensor:
    """Expert e's weight [O, I] as the kernel's dot sees it (rounded to dt)."""
    if kind in (_K_DENSE, _K_ROWQ):
        return w[e].to(dt)
    q = unpack4_pairs(w[e]) if kind == _K_PACKED else w[e]
    return (q.float() * s[e].float().repeat_interleave(BLOCK, dim=-1)).to(dt)


def _grouped_plain(kind: int, x: torch.Tensor, w: torch.Tensor, s, tile_expert: torch.Tensor,
                   tm: int) -> torch.Tensor:
    """Plain version of K10-K13: each used expert's tiles against its
    weight, f32 sums; rows of inactive tiles stay zero."""
    dt = _dot_dtype(x)
    y = torch.zeros((x.shape[0], w.shape[-2]), dtype=torch.float32, device=x.device)
    te = tile_expert.tolist()
    for e in sorted(set(te) - {-1}):
        tiles = torch.tensor([t for t, v in enumerate(te) if v == e], device=x.device)
        rows = (tiles[:, None] * tm + torch.arange(tm, device=x.device)[None, :]).reshape(-1)
        ye = x[rows].to(dt).float() @ _expert_weight(kind, w, s, e, dt).float().T
        if kind == _K_ROWQ:
            ye = ye * s[e][:, 0].float()[None, :]
        y[rows] = ye
    return y


def grouped_block_matmul_plain(x, qs, scales, tile_expert, tm):
    return _grouped_plain(_K_BLOCK, x, qs, scales, tile_expert, tm)


def grouped_packed4_matmul_plain(x, qp, scales, tile_expert, tm):
    return _grouped_plain(_K_PACKED, x, qp, scales, tile_expert, tm)


def grouped_rowq_matmul_plain(x, qs, scales, tile_expert, tm):
    return _grouped_plain(_K_ROWQ, x, qs, scales, tile_expert, tm)


def grouped_dense_matmul_plain(x, w, tile_expert, tm):
    return _grouped_plain(_K_DENSE, x, w, None, tile_expert, tm)


@dataclass(frozen=True)
class GroupedPlan:
    """The walk of csrc/moe_grouped.cu `grouped_tc_kernel`: unit u is tile u //
    nob against weight rows [o0, o0 + rows) (o0 = (u % nob) * rows, cut at O)
    of that tile's expert; CTA c takes units c, c + ctas, ... Tile-major
    order with a stride of the CTA count spreads the -1 tail tiles (a suffix
    of the tiles) over all CTAs. Nothing here depends on the routing."""
    tiles: int
    tm: int
    o: int
    gemv: bool
    ctas: int

    @property
    def rows(self) -> int:
        return GEMV_ROWS if self.gemv else TILE_ROWS

    @property
    def nob(self) -> int:
        return -(-self.o // self.rows)

    @property
    def units(self) -> int:
        return self.tiles * self.nob

    def unit(self, u: int) -> tuple[int, int, int]:
        """(tile, first weight row, end weight row) of unit u."""
        tile, ob = divmod(u, self.nob)
        return tile, ob * self.rows, min(self.o, (ob + 1) * self.rows)

    def units_of(self, c: int) -> range:
        return range(c, self.units, self.ctas)


def plan_grouped(mp: int, tm: int, o: int, i: int, x_f32: bool,
                 sm_count: int = 132) -> GroupedPlan:
    """The GEMV form (16-row units, x in registers) for bf16 x at tm <= 8 and
    I <= MAX_SLICE, else the tiled form (128-row units); one CTA an SM, or
    one a unit where there are fewer."""
    gemv = not x_f32 and tm <= GEMV_TM and i <= MAX_SLICE
    rows = GEMV_ROWS if gemv else TILE_ROWS
    units = (mp // tm) * -(-o // rows)
    return GroupedPlan(mp // tm, tm, o, gemv, min(units, sm_count))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(kind: int, x, w, s, tile_expert, tm: int, row_token, n_tokens: int,
            what: str, lib=None) -> torch.Tensor:
    """The checks, then one launch of csrc/moe_grouped.cu (or of `lib`, a
    library with the same entry point: bench/moe_ablation.py's variants)."""
    mp, i = x.shape
    e, o = w.shape[0], w.shape[1]
    wcols = {_K_PACKED: i // 2}.get(kind, i)
    _build.require(x.is_contiguous() and w.is_contiguous() and tile_expert.is_contiguous()
                   and (s is None or s.is_contiguous()), f"{what}: contiguous inputs")
    if kind == _K_DENSE:
        _build.require(w.dtype in (torch.float32, torch.bfloat16) and tuple(w.shape) == (e, o, i),
                       f"{what}: weights f32 or bf16 [E, O, I]")
    else:
        ns = 1 if kind == _K_ROWQ else i // BLOCK
        _build.require(w.dtype == torch.int8 and tuple(w.shape) == (e, o, wcols)
                       and s.dtype == torch.float32 and tuple(s.shape) == (e, o, ns)
                       and s.device == x.device,
                       f"{what}: qs int8 [E, O, {wcols}], scales f32 [E, O, {ns}]")
    _build.require(w.device == x.device == tile_expert.device and tile_expert.dtype == torch.int32
                   and tuple(tile_expert.shape) == (mp // tm,),
                   f"{what}: tile_expert int32 [Mp / tm] and weights on x's device")
    _build.require(i % BLOCK == 0 and mp % tm == 0 and (tm <= 8 or (tm % 32 == 0 and tm <= 128))
                   and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                   f"{what}: I % 32 == 0, tm <= 8 or 32 or 128, 16-byte aligned rows")
    if row_token is not None:
        _build.require(row_token.dtype == torch.int32 and tuple(row_token.shape) == (mp,)
                       and row_token.is_contiguous() and row_token.device == x.device,
                       f"{what}: row_token int32 [Mp]")
    x_code = _build.dtype_code(x)
    plan = plan_grouped(mp, tm, o, i, x.dtype == torch.float32, _sm_count(x.device.index or 0))
    y = torch.empty((mp, o), dtype=torch.float32, device=x.device)
    lib = lib or _build.load("moe_grouped")
    err = lib.lt_grouped_matmul(
        kind, x.data_ptr(), x_code, w.data_ptr(),
        _build.dtype_code(w) if kind == _K_DENSE else 0, 0 if s is None else s.data_ptr(),
        tile_expert.data_ptr(), 0 if row_token is None else row_token.data_ptr(), n_tokens,
        y.data_ptr(), mp, o, i, tm, e, int(plan.gemv), plan.ctas, _build.stream())
    _build.check(lib, err, what)
    return y


def grouped_block_matmul(x, qs, scales, tile_expert, tm, row_token=None, n_tokens=0):
    """K10: y[Mp, O] f32 over Q8_0 / Q4_0 experts qs [E, O, I] int8 and f32
    block scales [E, O, I/32]. With row_token, rows equal to n_tokens are pad
    rows (zero inputs): the kernel skips them and writes zeros."""
    if x.device.type == "cpu":
        return grouped_block_matmul_plain(x, qs, scales, tile_expert, tm)
    y = _launch(_K_BLOCK, x, qs, scales, tile_expert, tm, row_token, n_tokens,
                "grouped_block_matmul")
    grouped_block_matmul.launches += 1
    return y


def grouped_packed4_matmul(x, qp, scales, tile_expert, tm, row_token=None, n_tokens=0):
    """K11: K10 over packed4 Q4_0 experts qp [E, O, I/2] (byte c = canonical
    columns 2c | 2c + 1 << 4)."""
    if x.device.type == "cpu":
        return grouped_packed4_matmul_plain(x, qp, scales, tile_expert, tm)
    y = _launch(_K_PACKED, x, qp, scales, tile_expert, tm, row_token, n_tokens,
                "grouped_packed4_matmul")
    grouped_packed4_matmul.launches += 1
    return y


def grouped_rowq_matmul(x, qs, scales, tile_expert, tm, row_token=None, n_tokens=0):
    """K12: q8_row experts qs [E, O, I] int8 and row scales [E, O, 1]: the
    int8 values cast to the dot dtype, the row scale on the f32 sum."""
    if x.device.type == "cpu":
        return grouped_rowq_matmul_plain(x, qs, scales, tile_expert, tm)
    y = _launch(_K_ROWQ, x, qs, scales, tile_expert, tm, row_token, n_tokens,
                "grouped_rowq_matmul")
    grouped_rowq_matmul.launches += 1
    return y


def grouped_dense_matmul(x, w, tile_expert, tm, row_token=None, n_tokens=0):
    """K13: dense experts w [E, O, I] f32 or bf16, cast to the dot dtype."""
    if x.device.type == "cpu":
        return grouped_dense_matmul_plain(x, w, tile_expert, tm)
    y = _launch(_K_DENSE, x, w, None, tile_expert, tm, row_token, n_tokens,
                "grouped_dense_matmul")
    grouped_dense_matmul.launches += 1
    return y


for _f in (grouped_block_matmul, grouped_packed4_matmul, grouped_rowq_matmul,
           grouped_dense_matmul):
    _f.launches = 0


def grouped_offset_term(x_sorted: torch.Tensor, offs: torch.Tensor, tile_expert: torch.Tensor,
                        tm: int, row_token=None, n_tokens: int = 0) -> torch.Tensor:
    """The K-quant experts' offset term (moe_grouped.py:413-422), y[Mp, O] f32
    = xbsum[Mp, I/32] @ offs[tile_expert[row // tm]]^T through K13 on the
    same tile maps, xbsum the f32 sums of the canonical 32-blocks of
    x_sorted [Mp, I]. K13 takes contraction widths % 32 == 0: offs [E, O, W]
    come padded to such a width W at load (`weights.pad_offsets`;
    Qwen1.5-MoE's down projection: 1408 / 32 = 44 -> 64), and xbsum is
    zero-padded to W here, which adds nothing to the sums; the plain version
    on the CPU takes the same padded operands."""
    xbsum = block_sums(x_sorted)
    width = offs.shape[-1]
    if width % BLOCK or width < xbsum.shape[1]:
        raise ValueError(f"grouped_offset_term: offs width {width} is not I/32 = "
                         f"{xbsum.shape[1]} padded to a multiple of {BLOCK} (weights.pad_offsets)")
    if width > xbsum.shape[1]:
        xbsum = F.pad(xbsum, (0, width - xbsum.shape[1]))
    return grouped_dense_matmul(xbsum.contiguous(), offs, tile_expert, tm, row_token, n_tokens)


def grouped_matmul(w, x_sorted: torch.Tensor, tile_expert: torch.Tensor, tm: int,
                   li: int | None = None, row_token=None, n_tokens: int = 0) -> torch.Tensor:
    """y[Mp, O] f32 = x_sorted[Mp, I] @ W[tile_expert[row // tm]]^T. W: a
    QTensor or a dense [E, O, I] stack, or the [L, E, O, I] layer stack with
    `li` (the layer view, no copy)."""
    if not isinstance(w, QTensor):
        wd = w if li is None else w[li]
        return grouped_dense_matmul(x_sorted, wd, tile_expert, tm, row_token, n_tokens)
    qs, sc = (w.qs, w.scales) if li is None else (w.qs[li], w.scales[li])
    args = (x_sorted, qs, sc, tile_expert, tm, row_token, n_tokens)
    if w.kind == "q8_row":
        y = grouped_rowq_matmul(*args)
    elif w.layout == "packed4":
        y = grouped_packed4_matmul(*args)
    elif w.kind in ("q8_0", "q4_0", "q4_k", "q5_k") and w.layout == "canonical":
        y = grouped_block_matmul(*args)
    else:
        raise NotImplementedError(f"{w.kind}/{w.layout} experts: not served by the port")
    if w.offs is not None:
        y = y + grouped_offset_term(x_sorted, w.offs if li is None else w.offs[li],
                                    tile_expert, tm, row_token, n_tokens)
    return y[:, : w.logical_out] if w.logical_out else y


# ----------------------------------------------------------------- FFN
def grouped_ffn(lw: dict, hf: torch.Tensor, top_w: torch.Tensor, row_token, row_src,
                tile_expert, tm: int, li: int | None = None) -> torch.Tensor:
    """gate/up, act, down over the expert-sorted rows, then each token's
    rows combined with its routing weights. hf [N, D]; top_w [N, k]. Returns
    [N, D] f32."""
    n, d = hf.shape
    k = top_w.shape[1]
    hf_pad = torch.cat([hf, hf.new_zeros((1, d))])
    x_sorted = hf_pad[row_token.long()]                            # [Mp, D]
    w_pad = torch.cat([top_w.reshape(-1).float(), top_w.new_zeros(1, dtype=torch.float32)])
    row_w = w_pad[row_src.long()]                                  # [Mp]
    mm = dict(li=li, row_token=row_token, n_tokens=n)
    if "gu_exps" in lw:  # fused gate+up stacks (weights.fuse_layer_weights)
        g13 = grouped_matmul(lw["gu_exps"], x_sorted, tile_expert, tm, **mm)
        mh = g13.shape[-1] // 2
        gate, up = g13[:, :mh], g13[:, mh:]
    else:
        gate = grouped_matmul(lw["gate_exps"], x_sorted, tile_expert, tm, **mm)
        up = grouped_matmul(lw["up_exps"], x_sorted, tile_expert, tm, **mm)
    act = (F.silu(gate) * up).to(hf.dtype)                         # from the f32 gate and up
    down = grouped_matmul(lw["down_exps"], act, tile_expert, tm, **mm)  # [Mp, D]
    # deterministic combine: the sorted row of each (token, slot), then a
    # gather and a sum over the slots
    rows = torch.argsort(row_src.long(), stable=True)[: n * k].view(n, k)
    return (down[rows] * row_w[rows][..., None]).sum(dim=1)


def moe_ffn_grouped(cfg, hf: torch.Tensor, top_w: torch.Tensor, top_i: torch.Tensor, lw: dict,
                    tm: int = 128, li: int | None = None,
                    n_experts: int | None = None) -> torch.Tensor:
    """Routed-expert FFN over N tokens: hf [N, D], top_w / top_i [N, k]
    (top-k without renormalization). Returns [N, D] f32; the shared expert is
    the caller's, or rides along as virtual experts when the stacks are folded
    (n_experts > cfg.n_experts)."""
    row_token, row_src, tile_expert = sort_by_expert(top_i, n_experts or cfg.n_experts, tm)
    return grouped_ffn(lw, hf, top_w, row_token, row_src, tile_expert, tm, li=li)
