"""Launchers of the probe kernels in csrc/probes.cu (design and bounds in
its header note). bench/roofline.py (K18) and bench/dma_sweep.py (K19)
build the TPU scripts' probe functions on them; those functions hold the
plain versions and the launch counts, and take the plain version for a CPU
tensor. These launchers take CUDA tensors only.

The GEMV (K18a, K18i: `gemv_bf16`; K18b, K18c, K18g: `gemv`, int8 weights
with tiled f32 scales; K18d, K18h: `int8dot`, int8 weights times int8 xq,
and K18e, the same with block scales) is one TMA-fed tensor-core kernel:
persistent CTAs, one per SM, walk units of (layer, stripe of STRIPE weight
rows, K slice); a CTA's x slice arrives first through its ring and stays in
registers, then each stripe streams through the mbarrier ring of [STRIPE,
STAGE_K] stages (6 of bf16 weights, 12 of int8) into `mma.sync` products:
bf16 m16n8k16, the q8 weights dequantized in the B fragments, or int8
m16n8k32 (kind W_S8) on the raw bytes with int32 sums. PARTS consumer warps
share each stage's steps and add their parts in order at the unit's end
(W_S8's block-scale corrections formed there, one warp a stripe row).
`plan_gemv` lays the walk out (`GemvPlan.units`, mirrored by the kernel):
the whole K as one slice unless stripes alone leave the SMs under 90 %
busy, then K slices whose partial sums (f32; W_S8: int32, exact) a second
pass adds in K order.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from llamatpu_torch import _build
from llamatpu_torch.ops.gemm import _sm_count

# weight kinds of the GEMV (csrc/tc_gemv.cuh WKind): bf16; int8 dequantized in
# f32 or by a bf16 multiply; int8 times int8 xq with int32 sums
W_BF16, W_Q8_F32, W_Q8_BF16, W_S8 = 0, 1, 2, 3
# stream modes (csrc/probes.cu SMode): the last chunk's first rows, the sum
# over chunks of their first rows, the int8 dot of every row summed per chunk
S_LAST, S_SUM, S_DOT = 0, 1, 2
MAX_T = 8
# the GEMV's walk (csrc/probes.cu): weight rows of a unit, columns of a ring
# stage, consumer warps (each the 16-column steps j = warp mod PARTS of a
# stage), the most x columns a CTA stages; the planner cuts no K slice
# narrower than MIN_SLICE columns
STRIPE, STAGE_K, PARTS, MAX_SLICE, MIN_SLICE = 8, 2048, 8, 4096, 256
BUSY_SHARE = 0.9


@dataclass(frozen=True)
class GemvPlan:
    """The GEMV's walk over L layers of [O, I] weights: unit u is stripe
    u // nks (layer s // stripes, rows (s % stripes) * STRIPE ..) over K
    slice u % nks; CTA c takes units c, c + ctas, ...; ctas % nks == 0, so a
    CTA keeps one slice (and stages x's columns of it once)."""
    o: int
    i: int
    layers: int
    nks: int   # K slices of whole 16-column steps (`slice`)
    ctas: int

    @property
    def stripes(self) -> int:
        return -(-self.o // STRIPE)

    @property
    def n_units(self) -> int:
        return self.layers * self.stripes * self.nks

    def slice(self, ks: int) -> tuple[int, int]:
        """Columns [k0, k1) of K slice ks."""
        n16 = self.i // 16
        return ks * n16 // self.nks * 16, (ks + 1) * n16 // self.nks * 16

    def units(self, c: int) -> list[tuple[int, int, int, int, int]]:
        """CTA c's units in order: (layer, row0, row1, k0, k1)."""
        out = []
        for u in range(c, self.n_units, self.ctas):
            s, ks = divmod(u, self.nks)
            layer, j = divmod(s, self.stripes)
            out.append((layer, j * STRIPE, min(self.o, (j + 1) * STRIPE), *self.slice(ks)))
        return out


def _busy(stripes: int, nks: int, sm_count: int) -> tuple[float, int]:
    """(share of the SMs busy over the call, CTAs) with nks K slices: each
    slice's stripes go to sm_count // nks CTAs in rounds."""
    per = max(1, min(stripes, sm_count // nks))
    rounds = -(-stripes // per)
    return stripes * nks / (max(sm_count, nks * per) * rounds), nks * per


@functools.lru_cache(maxsize=256)
def plan_gemv(o: int, i: int, layers: int, sm_count: int = 132) -> GemvPlan:
    """Whole-K stripes in rounds over min(stripes, SMs) CTAs where that keeps
    the SMs >= 90 % busy; else the fewest K slices (no narrower than
    MIN_SLICE columns) that do, or the busiest. Slices also keep x's staged
    columns within MAX_SLICE."""
    n16 = i // 16
    stripes = layers * -(-o // STRIPE)
    lo = -(-n16 // (MAX_SLICE // 16))
    hi = max(lo, min(n16 // (MIN_SLICE // 16), sm_count))
    best = None
    for nks in range(lo, hi + 1):
        busy, ctas = _busy(stripes, nks, sm_count)
        if busy >= BUSY_SHARE:
            return GemvPlan(o, i, layers, nks, ctas)
        if best is None or busy > best[0]:
            best = (busy, nks, ctas)
    return GemvPlan(o, i, layers, best[1], best[2])


def scales_fixed(nb: int) -> bool:
    """Whether an int8 GEMV lane's four scales stay fixed for a unit (the
    kernel's TILED form): warp w's columns of step j = w + PARTS * i are
    kbeg + 16 j + 4q + e, so modulo NB they do not depend on i (or the
    stage) when NB divides 16 * PARTS. Other NB load the scales a step."""
    return (16 * PARTS) % nb == 0


def _stacked(w: torch.Tensor) -> torch.Tensor:
    return w if w.dim() == 3 else w[None]


def _check(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    _build.require(x.device.type == "cuda" and w.device == x.device,
                   f"{what}: CUDA tensors on one device (the plain versions take the CPU)")
    _build.require(x.is_contiguous() and w.is_contiguous() and x.dim() == 2
                   and 1 <= x.shape[0] <= MAX_T and x.shape[1] == w.shape[-1]
                   and w.shape[-1] % 16 == 0, f"{what}: contiguous x [T <= 8, I], I % 16 == 0")


def _gemv(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor | None, wkind: int, what: str,
          xsc: torch.Tensor | None = None) -> torch.Tensor:
    """The checks, then one launch (and the K-slice sum where the plan splits
    K). Shapes, dtypes, contiguity, alignment and devices raise (ValueError)
    before the device is asked for anything."""
    w3 = _stacked(w)
    s8 = wkind == W_S8
    _build.require(x.dim() == 2 and 1 <= x.shape[0] <= MAX_T and x.shape[1] == w3.shape[-1],
                   f"{what}: x [T <= 8, I] against w [L, O, I]")
    lay, o, i = w3.shape
    _build.require(i > 0 and i % 16 == 0 and o > 0 and lay > 0,
                   f"{what}: I % 16 == 0, nothing empty")
    xdt, wdt = ((torch.int8, torch.int8) if s8 else
                (torch.bfloat16, torch.bfloat16 if wkind == W_BF16 else torch.int8))
    _build.require(x.dtype == xdt and w3.dtype == wdt, f"{what}: int8 xq and w" if s8 else
                   f"{what}: bf16 x and w ({'bf16' if wkind == W_BF16 else 'int8'} w)")
    ts = [x, w3]
    nb = 0
    if s is not None:
        s3 = _stacked(s)
        nb = s3.shape[-1]
        _build.require(s3.dim() == 3 and tuple(s3.shape[:2]) == (lay, o) and nb > 0,
                       f"{what}: scales [L, O, NB]")
        if s8:
            _build.require(xsc.dim() == 2 and tuple(xsc.shape) == (x.shape[0], nb),
                           f"{what}: xsc [T, NB] beside scales [L, O, NB]")
        else:
            _build.require(nb % 16 == 0 and i % nb == 0, f"{what}: NB % 16 == 0 and I % NB == 0")
        _build.require(s3.dtype == torch.float32 and (xsc is None or xsc.dtype == torch.float32),
                       f"{what}: f32 scales")
        ts += [s3] + ([xsc] if s8 else [])
    _build.require(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts),
                   f"{what}: contiguous, 16-byte aligned operands")
    _build.require(all(t.device.type == "cuda" and t.device == x.device for t in ts),
                   f"{what}: CUDA tensors on one device (the plain versions take the CPU)")
    plan = plan_gemv(o, i, lay, _sm_count(x.device.index or 0))
    t = x.shape[0]
    y = torch.empty((lay, t, o), dtype=torch.float32, device=x.device)
    part = (torch.empty((plan.nks, lay, t, o), dtype=torch.int32 if s8 else torch.float32,
                        device=x.device) if plan.nks > 1 else None)
    sp = 0 if s is None else ts[2].data_ptr()
    pp = 0 if part is None else part.data_ptr()
    lib = _build.load("probes")
    if s8:
        err = lib.lt_probe_int8dot(x.data_ptr(), w3.data_ptr(), sp,
                                   0 if xsc is None else xsc.data_ptr(), y.data_ptr(), pp, t, o,
                                   i, lay, nb, plan.nks, plan.ctas, _build.stream())
    else:
        err = lib.lt_probe_gemv(x.data_ptr(), w3.data_ptr(), sp, y.data_ptr(), pp, t, o, i, lay,
                                nb, wkind, plan.nks, plan.ctas, _build.stream())
    _build.check(lib, err, what)
    return y


def gemv_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y [L, T, O] f32 = x [T, I] bf16 . w[l]^T for bf16 w [L, O, I] (or [O,
    I]), f32 sums, on the tensor-core GEMV."""
    return _gemv(x, w, None, W_BF16, "probe gemv bf16")


def gemv(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, wkind: int) -> torch.Tensor:
    """y [L, T, O] f32 = x [T, I] bf16 . wd[l]^T for int8 w [L, O, I] (or
    [O, I]) with f32 scales s [L, O, NB] (or [O, NB]), column k scaled by
    s[l, o, k % NB] (the TPU scripts' tiled scales), dequantized in f32
    (W_Q8_F32) or by a bf16 multiply (W_Q8_BF16), on the tensor-core GEMV."""
    _build.require(wkind in (W_Q8_F32, W_Q8_BF16), "probe gemv: a q8 weight kind")
    return _gemv(x, w, s, wkind, "probe gemv")


def int8dot(xq: torch.Tensor, w: torch.Tensor, s: torch.Tensor | None = None,
            xsc: torch.Tensor | None = None) -> torch.Tensor:
    """y [L, T, O] f32 = f32((xq [T, I] . w[l]^T)_int32) for int8 xq and w [L,
    O, I] (or [O, I]), times (s[l] . xsc^T)^T where the block scales s [L, O,
    NB] (or [O, NB]) and xsc [T, NB] are given (both or neither), f32; on the
    tensor-core GEMV's int8 kind (W_S8): int32 sums, exact."""
    _build.require((s is None) == (xsc is None), "probe int8dot: block scales s and xsc, "
                   "both or neither")
    return _gemv(xq, w, s, W_S8, "probe int8dot", xsc)


def stream(w: torch.Tensor, x: torch.Tensor, ch: int, depth: int, mode: int, nr: int, nc: int,
           out_cols: int) -> torch.Tensor:
    """out [T, out_cols] f32 of the stream probe over the rows of w (the
    stack flattened to [rows, I], bf16 or int8), chunks of `ch` rows through a
    `depth`-deep ring: S_LAST / S_SUM the first `nr` rows of the last / every
    chunk at `nc` columns plus x[t, 0] (x bf16 [T, I]); S_DOT the int8 dot of
    xq (x int8 [T, I]) with every row, summed per chunk."""
    w2 = w.reshape(-1, w.shape[-1])
    _check(x, w2, "probe stream")
    rows, i = w2.shape
    _build.require(w2.dtype in (torch.bfloat16, torch.int8) and rows % ch == 0,
                   "probe stream: bf16 or int8 rows, a whole number of chunks")
    _build.require(x.dtype == (torch.int8 if mode == S_DOT else torch.bfloat16),
                   "probe stream: x bf16 (xq int8 for the dot)")
    dev = x.device
    n_chunks = rows // ch
    rec = part = None
    if mode == S_LAST:
        rec = torch.empty((nr, nc), dtype=torch.float32, device=dev)
    elif mode == S_SUM:
        rec = torch.empty((n_chunks, nr, nc), dtype=torch.float32, device=dev)
    else:
        part = torch.empty((n_chunks, x.shape[0]), dtype=torch.int32, device=dev)
    out = torch.empty((x.shape[0], out_cols), dtype=torch.float32, device=dev)
    lib = _build.load("probes")
    err = lib.lt_probe_stream(w2.data_ptr(), rows, i, w2.element_size(), ch, depth, mode, nr, nc,
                              x.data_ptr(), x.shape[0], 0 if rec is None else rec.data_ptr(),
                              0 if part is None else part.data_ptr(), out.data_ptr(), out_cols,
                              _build.stream())
    _build.check(lib, err, "probe stream")
    return out
