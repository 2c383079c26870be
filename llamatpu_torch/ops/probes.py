"""Launchers of the three probe kernels in csrc/probes.cu (design and bounds
in its header note). bench/roofline.py (K18) and bench/dma_sweep.py (K19)
build the TPU scripts' probe functions on them; those functions hold the
plain versions and the launch counts, and take the plain version for a CPU
tensor. These launchers take CUDA tensors only.
"""
from __future__ import annotations

import torch

from llamatpu_torch import _build

# weight kinds of the GEMV probe (csrc/probes.cu WKind)
W_BF16, W_Q8_F32, W_Q8_BF16 = 0, 1, 2
# stream modes (csrc/probes.cu SMode): the last chunk's first rows, the sum
# over chunks of their first rows, the int8 dot of every row summed per chunk
S_LAST, S_SUM, S_DOT = 0, 1, 2
MAX_T = 8


def _stacked(w: torch.Tensor) -> torch.Tensor:
    return w if w.dim() == 3 else w[None]


def _check(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    _build.require(x.device.type == "cuda" and w.device == x.device,
                   f"{what}: CUDA tensors on one device (the plain versions take the CPU)")
    _build.require(x.is_contiguous() and w.is_contiguous() and x.dim() == 2
                   and 1 <= x.shape[0] <= MAX_T and x.shape[1] == w.shape[-1]
                   and w.shape[-1] % 16 == 0, f"{what}: contiguous x [T <= 8, I], I % 16 == 0")


def gemv(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor | None, wkind: int) -> torch.Tensor:
    """y [L, T, O] f32 = x [T, I] bf16 . wd[l]^T for w [L, O, I] (or [O, I]):
    bf16 weights (W_BF16) or int8 with f32 scales s [L, O, NB], column k
    scaled by s[l, o, k % NB] (the TPU scripts' tiled scales), dequantized in
    f32 (W_Q8_F32) or by a bf16 multiply (W_Q8_BF16)."""
    w3 = _stacked(w)
    _check(x, w3, "probe gemv")
    lay, o, i = w3.shape
    want = torch.bfloat16 if wkind == W_BF16 else torch.int8
    _build.require(x.dtype == torch.bfloat16 and w3.dtype == want, "probe gemv: dtypes")
    nb = 0
    if wkind != W_BF16:
        s3 = _stacked(s)
        nb = s3.shape[-1]
        _build.require(s3.dtype == torch.float32 and s3.is_contiguous() and nb % 16 == 0
                       and tuple(s3.shape[:2]) == (lay, o), "probe gemv: scales [L, O, NB]")
    y = torch.empty((lay, x.shape[0], o), dtype=torch.float32, device=x.device)
    lib = _build.load("probes")
    err = lib.lt_probe_gemv(x.data_ptr(), w3.data_ptr(), 0 if wkind == W_BF16 else s.data_ptr(),
                            y.data_ptr(), x.shape[0], o, i, lay, nb, wkind, _build.stream())
    _build.check(lib, err, "probe gemv")
    return y


def int8dot(xq: torch.Tensor, w: torch.Tensor, s: torch.Tensor | None = None,
            xsc: torch.Tensor | None = None) -> torch.Tensor:
    """y [L, T, O] f32 = f32((xq [T, I] . w[l]^T)_int32), times (s[l] . xsc^T)^T
    where the block scales s [L, O, NB] and xsc [T, NB] are given."""
    w3 = _stacked(w)
    _check(xq, w3, "probe int8dot")
    lay, o, i = w3.shape
    _build.require(xq.dtype == torch.int8 and w3.dtype == torch.int8, "probe int8dot: int8")
    nb, sp, xp = 0, 0, 0
    if s is not None:
        s3 = _stacked(s)
        nb = s3.shape[-1]
        _build.require(s3.dtype == xsc.dtype == torch.float32 and s3.is_contiguous()
                       and xsc.is_contiguous() and tuple(s3.shape[:2]) == (lay, o)
                       and tuple(xsc.shape) == (xq.shape[0], nb), "probe int8dot: scales")
        sp, xp = s3.data_ptr(), xsc.data_ptr()
    y = torch.empty((lay, xq.shape[0], o), dtype=torch.float32, device=xq.device)
    lib = _build.load("probes")
    err = lib.lt_probe_int8dot(xq.data_ptr(), w3.data_ptr(), sp, xp, y.data_ptr(), xq.shape[0],
                               o, i, lay, nb, int(s is not None), _build.stream())
    _build.check(lib, err, "probe int8dot")
    return y


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
