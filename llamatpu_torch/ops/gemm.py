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

CUDA source: csrc/gemm.cu (design and bound in its header note): one TMA +
wgmma kernel for both, whose persistent CTAs walk the output tiles whole or
share their K stages (stream-K). `plan_gemm` is that walk's plan;
`GemmPlan.segments` and `GemmPlan.pieces` say which CTA computes which K
stages of which tile and where its partial sums go, as the kernel and its
second pass read them.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from llamatpu_torch import _build
from llamatpu_torch.ops.int8_prefill import _INT8_ACC_MAX_I, int_dot

BM = BN = 128  # output tile: rows of T x columns of O (csrc/gemm.cu)
BK = 128       # K stage: 128 int8 columns, the 128-byte swizzle


@dataclass(frozen=True)
class GemmPlan:
    """The kernel's walk. `ctas` persistent CTAs first take whole tiles in
    rounds (tile c, c + ctas, ... < tiles_dp); the remaining tiles' (tile, K
    stage) iterations are then cut into `ctas` contiguous ranges, CTA c taking
    [begin(c), begin(c + 1)). Tile t covers rows (t % tiles_m) * BM and
    columns (t // tiles_m) * BN."""
    t: int
    o: int
    i: int
    tiles_m: int
    tiles_n: int
    nk: int        # K stages of BK (the last zero-filled past I)
    ctas: int
    tiles_dp: int  # tiles done whole in rounds before the stream-K ranges

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    @property
    def total_sk(self) -> int:
        return (self.tiles - self.tiles_dp) * self.nk

    def begin(self, c: int) -> int:
        return c * self.total_sk // self.ctas

    def owner(self, it: int) -> int:
        """The CTA whose stream-K range holds iteration `it`."""
        return ((it + 1) * self.ctas - 1) // self.total_sk

    def segments(self, c: int) -> list[tuple[int, int, int, int]]:
        """CTA c's work in order: (tile, k0, k1, slot) for K stages [k0, k1);
        slot -1 is a whole tile (the epilogue at once), 0 or 1 the CTA's
        workspace slot for the partial sums of the tile its range starts in
        or ends in."""
        out = [(t, 0, self.nk, -1) for t in range(c, self.tiles_dp, self.ctas)]
        i, e, slot = self.begin(c), self.begin(c + 1), 0
        while i < e:
            t, k0 = self.tiles_dp + i // self.nk, i % self.nk
            k1 = min(self.nk, k0 + e - i)
            out.append((t, k0, k1, -1 if (k0, k1) == (0, self.nk) else slot))
            i += k1 - k0
            slot = 1
        return out

    def pieces(self, tile: int) -> list[tuple[int, int]]:
        """(cta, slot) of a shared tile's partial sums in K order, summed in
        that order by the second pass; [] when one CTA does the whole tile."""
        if tile < self.tiles_dp:
            return []
        i0 = (tile - self.tiles_dp) * self.nk
        c0, c1 = self.owner(i0), self.owner(i0 + self.nk - 1)
        if c0 == c1:
            return []
        return [(c, 0 if self.begin(c) >= i0 else 1) for c in range(c0, c1 + 1)]

    @functools.cached_property
    def split(self) -> bool:
        """Some tile is shared by CTAs: the workspace and the second pass."""
        return any(self.pieces(t) for t in range(self.tiles_dp, self.tiles))

    @functools.cached_property
    def busiest(self) -> int:
        """The most (tile, K stage) iterations one CTA walks."""
        return max(sum(k1 - k0 for _, k0, k1, _ in self.segments(c)) for c in range(self.ctas))

    @property
    def ws_slots(self) -> int:
        """Workspace slots of BM * BN 4-byte partial sums (two a CTA)."""
        return 2 * self.ctas if self.split else 0


# K4 with whole tiles on at least this share of the SMs is bound by the
# card's L2-to-SM traffic (each stage streams a 16 KB tile of each operand),
# so sharing tiles among more CTAs only adds partial sums to that traffic:
# measured on the H100, whole tiles win at every path shape with 60 or more
# tiles and stream-K at every one with 40 or fewer (chip_smoke.py times each
# shape under both plans; PERF.md). K17's stage costs twice the products and
# the widening, so it fills the card.
K4_WHOLE_TILES_MIN_SHARE = 0.4


@functools.lru_cache(maxsize=256)
def plan_gemm(t: int, o: int, i: int, sm_count: int = 132, bf16: bool = False,
              rows: int = BM) -> GemmPlan:
    """K4 takes whole tiles, one a CTA in rounds, wherever there are enough
    of them to load the card's L2 (K4_WHOLE_TILES_MIN_SHARE). Otherwise, and
    for K17, one CTA per SM (fewer only when there are fewer iterations in
    all): whole tiles in rounds where rounds alone keep the SMs >= 90 % busy,
    else the last one to two rounds' tiles (all of them below one round) cut
    into equal K ranges, so that every SM works for the whole call. `rows`:
    the rows of T a tile (K5 / K7's wgmma GEMM takes 256 above 128 rows)."""
    tiles_m, tiles_n, nk = -(-t // rows), -(-o // BN), -(-i // BK)
    tiles = tiles_m * tiles_n
    if not bf16 and tiles >= K4_WHOLE_TILES_MIN_SHARE * sm_count:
        return GemmPlan(t, o, i, tiles_m, tiles_n, nk, min(sm_count, tiles), tiles)
    ctas = max(1, min(sm_count, tiles * nk))
    rounds = -(-tiles // ctas)
    if tiles >= ctas and tiles >= 0.9 * rounds * ctas:
        tiles_dp = tiles
    else:
        tiles_dp = max(0, (tiles // ctas - 1) * ctas)
    return GemmPlan(t, o, i, tiles_m, tiles_n, nk, ctas, tiles_dp)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    _build.require(t > 0 and o > 0 and i > 0, f"{what}: empty operand")
    plan = plan_gemm(t, o, i, _sm_count(xi8.device.index or 0), bool(bf16))
    y = torch.empty((t, o), dtype=torch.float32, device=xi8.device)
    ws = (torch.empty((plan.ws_slots, BM * BN), dtype=torch.int32, device=xi8.device)
          if plan.split else None)
    lib = _build.load("gemm")
    err = lib.lt_rowq_gemm(xi8.data_ptr(), ax.data_ptr(), qs.data_ptr(), scales.data_ptr(),
                           y.data_ptr(), None if ws is None else ws.data_ptr(), t, o, i, bf16,
                           plan.ctas, plan.tiles_dp, _build.stream())
    _build.check(lib, err, what)
    return y


rowq_gemm.launches = 0
rowq_gemm_bf16.launches = 0
