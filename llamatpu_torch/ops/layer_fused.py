"""K2, K3, K9 and K16: the fused calls of a q8_row decode layer.

- K2 `qkv_norm_fused_rowq`, counterpart of llamatpu/ops/layer_fused.py
  `_qkv_kernel`: h = rmsnorm(x) * attn_norm[li] rounded to the working dtype,
  then y = (h . wqkv[li]^T) * s.
- K3 `layer_attn_tail_fused_rowq`, counterpart of `_attn_tail_kernel`
  (megakernel v3): append the post-RoPE K|V row at `pos` (the cache is
  updated IN PLACE, where the JAX package aliased it), masked f32 GQA
  attention over s <= pos, wo + residual (x2 in f32), rmsnorm, w13,
  silu * up, w2 + residual. B = 1, T = 1 on a dense cache; the position is
  read on the device (the forward's pos_vec), as the JAX kernel reads it.
- K9 `layer_tail_fused_rowq`, counterpart of `_tail_kernel`: everything after
  attention (wo + residual with x2 in f32, rmsnorm, w13, silu * up, w2 +
  residual) for T <= 32 rows (`ffn_fused._MAX_T`), e.g. the B lanes of a
  batched decode step; above that, or where the JAX function's VMEM fit
  declines (`tail_fits`), it returns None, as the JAX function does.
- K16 `layer_tail_kt_fused_rowq`, counterpart of `_tail_kernel_kt`: K9's
  function with w2 streamed as contraction tiles [D, tf] summed in f32 in
  tile order. `layer_tail_fused_rowq` takes it instead of K9 while the module
  flag `_W2_KTILE` is set (read at each call), as the JAX function does;
  bench/sweep_tail.py times the two.
K2 takes up to 32 rows on the card (any number on the CPU); the forward
calls it for B * T <= 32 rows where `qkv_fits` accepts, and K3 where
`attn_tail_fits` does: the JAX package's rules, its VMEM fits included (the
fits section below).

The working ("dot") dtype is f32 for f32 activations, else bf16. CUDA source:
csrc/layer_fused.cu (design and bound in its header note); K2's, K3's, K9's
and K16's bf16 GEMV phases run csrc/rowq_tc.cuh's tensor-core template on
ops/ffn_fused.py `plan_tc`'s plans where `ffn_fused.tc_route` takes the
call, and K3's attention phase runs K6's cluster body (csrc/attention.cu) on
ops/attention.py `plan_dense`'s plan. Each entry point has its plain torch
version here; a CPU tensor takes it, a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import dataclasses

import torch

from llamatpu_torch import _build
from llamatpu_torch.models.weights import QTensor
from llamatpu_torch.ops import attention, ffn_fused
from llamatpu_torch.ops.ffn_fused import _MAX_T, _pick_to
from llamatpu_torch.ops.rmsnorm import rmsnorm


def _dot_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


def _rowq_layer(w: QTensor, li: int) -> tuple[torch.Tensor, torch.Tensor]:
    if not (isinstance(w, QTensor) and w.kind == "q8_row" and w.qs.dim() == 3
            and not w.logical_out):
        raise NotImplementedError("fused decode kernels take stacked q8_row weights")
    return w.qs[li], w.scales[li][:, 0]


# ------------------------------------------------ the JAX package's fits
# The JAX kernels decline a shape whose blocks and scratch would not fit a
# TPU core's VMEM (llamatpu/ops/layer_fused.py:300-364, 681-764, 834-860).
# The port keeps that arithmetic so that its forward takes the kernel the
# JAX package takes at every shape. One known difference stays: at a width
# that is not a multiple of 128 the JAX package finds no tile (`_pick_to`)
# and takes none of these kernels, where the port still takes K2, K3 and K9
# (ROADMAP.md, Queue 3). `ffn_fused._VMEM_BUDGET` is read at each call.
_V3_LIMIT = 16 * 1024 * 1024        # K3's scoped-VMEM limit on the TPU
_V3_STACK = int(3.5 * 1024 * 1024)  # and its measured kernel-stack margin


def _lane_pad(n: int) -> int:
    return -(-n // 128) * 128


def _aligned(*widths: int) -> bool:
    return all(w % 128 == 0 for w in widths)


def _shrink(need, cur: dict, limit: int) -> bool:
    """Halve the tiles (wo first, then w2, then w13, each while it stays a
    multiple of 128) until need(cur) <= limit; False if they cannot."""
    while need(cur) > limit:
        for name in ("wo", "w2", "w13"):
            if cur[name] > 128 and (cur[name] // 2) % 128 == 0:
                cur[name] //= 2
                break
        else:
            return False
    return True


def _tail_vmem(tp, d, hdim, o13, f, towo, to13, to2, xbytes, act_bytes):
    return (tp * hdim * xbytes + tp * d * xbytes
            + tp * d * 4 + tp * d * act_bytes
            + tp * o13 * 4 + tp * f * act_bytes
            + 2 * tp * to2 * 4
            + 2 * (towo * hdim + towo * 4)
            + 2 * (to13 * d + to13 * 4)
            + 2 * (to2 * f + to2 * 4))


def _fit_tail_tiles(t, d, hdim, o13, f, xbytes):
    """(towo, to13, to2) of the JAX `_tail_kernel` within the budget, or None."""
    cur = {"wo": _pick_to(d, hdim), "w13": _pick_to(o13, d), "w2": _pick_to(d, f)}
    if not all(cur.values()):
        return None
    tp = -(-t // 8) * 8
    if not _shrink(lambda c: _tail_vmem(tp, d, hdim, o13, f, c["wo"], c["w13"], c["w2"],
                                        xbytes, xbytes), cur, ffn_fused._VMEM_BUDGET):
        return None
    return cur["wo"], cur["w13"], cur["w2"]


def _fit_tail_tiles_kt(t, d, hdim, o13, f, xbytes):
    """(towo, to13, tf) of the JAX `_tail_kernel_kt` within the budget, or None."""
    tf = next((c for c in (1024, 512, 256, 128)
               if f % c == 0 and d * c <= ffn_fused._BLOCK_BYTES), 0)
    cur = {"wo": _pick_to(d, hdim), "w13": _pick_to(o13, d), "w2": tf}
    if not all(cur.values()):
        return None
    tp = -(-t // 8) * 8

    def need(c):
        return (_tail_vmem(tp, d, hdim, o13, f, c["wo"], c["w13"], 128, xbytes, xbytes)
                - 2 * (128 * f + 128 * 4) + 2 * (d * c["w2"] + d * 4) + tp * d * 4)
    if not _shrink(need, cur, ffn_fused._VMEM_BUDGET):
        return None
    return cur["wo"], cur["w13"], cur["w2"]


def _fit_attn_tail(t, d, hdim, o13, f, kvh, g, width, S, kv_itemsize, xbytes):
    """(towo, to13, to2, s_tile) of the JAX `_attn_tail_kernel` within its
    16 MiB limit, lane padding and stack margin included, or None."""
    tiles = {"wo": _pick_to(d, hdim), "w13": _pick_to(o13, d), "w2": _pick_to(d, f)}
    if not all(tiles.values()):
        return None
    tp = -(-t // 8) * 8
    vhd = width // 2
    kv_padw = _lane_pad(width)

    def need(c, s_tile):
        est = _tail_vmem(tp, d, hdim, o13, f, c["wo"], c["w13"], c["w2"], xbytes, xbytes)
        est += 2 * kvh * s_tile * kv_padw * kv_itemsize
        est += 2 * kvh * 32 * kv_padw * kv_itemsize
        est += 3 * kvh * g * 128 * 4 + kvh * g * kv_padw * 4 + tp * hdim * xbytes
        est += 2 * kvh * (kv_padw + _lane_pad(vhd)) * xbytes
        est += (kv_padw * hdim + 2 * kvh * g * hdim) * 4
        return est + _V3_STACK

    for s_tile in (512, 256, 128, 64, 32):
        if S % s_tile:
            continue
        cur = dict(tiles)
        if _shrink(lambda c: need(c, s_tile), cur, _V3_LIMIT):
            return cur["wo"], cur["w13"], cur["w2"], s_tile
    return None


def _qkv_need(t, o, d, xbytes) -> int | None:
    """VMEM estimate of the JAX `_qkv_kernel`, or None where it has no tile."""
    to = _pick_to(o, d)
    if not to:
        return None
    tp = -(-t // 8) * 8
    return tp * d * xbytes + tp * d * xbytes + 2 * tp * to * 4 + 2 * (to * d + to * 4)


def qkv_fits(t: int, o: int, d: int, xbytes: int) -> bool:
    """K2 for t rows of x [t, d] and wqkv [o, d], as the JAX package's
    `qkv_norm_fused_rowq` takes its kernel."""
    if t > _MAX_T:
        return False
    if not _aligned(o):
        return True
    need = _qkv_need(t, o, d, xbytes)
    return need is not None and need <= ffn_fused._VMEM_BUDGET


def tail_fits(t: int, d: int, hdim: int, f: int, xbytes: int) -> bool:
    """K9 for t rows, as the JAX package's `layer_tail_fused_rowq` fits."""
    return t <= _MAX_T and (not _aligned(d, 2 * f)
                           or _fit_tail_tiles(t, d, hdim, 2 * f, f, xbytes) is not None)


def attn_tail_fits(d: int, hdim: int, f: int, kvh: int, g: int, vhd: int, s_len: int,
                   kv_itemsize: int, xbytes: int) -> bool:
    """K3 at one token, as the JAX package's `layer_attn_tail_fused_rowq`
    accepts: a power-of-two value head (its flatten shifts and masks) and
    the fit of its tiles, KV stream and scratch."""
    if vhd & (vhd - 1):
        return False
    return not _aligned(d, 2 * f) or _fit_attn_tail(
        1, d, hdim, 2 * f, f, kvh, g, 2 * vhd, s_len, kv_itemsize, xbytes) is not None


# ----------------------------------------------------------------- K2
def qkv_norm_plain(wqkv: QTensor, attn_norm, x, li: int, eps: float) -> torch.Tensor:
    qs, s = _rowq_layer(wqkv, li)
    h = rmsnorm(x, attn_norm[li], eps).to(_dot_dtype(x))
    return ((h.float() @ qs.float().T) * s).to(x.dtype)


def _qkv_launch(qs, s, nw, x2, eps: float, lib=None, sms=None) -> torch.Tensor:
    """The checks, then one call of csrc/layer_fused.cu `lt_qkv_norm` (or of
    `lib`, a library with the same entry point) for x2 [t <= 32, D]:
    the norm phase and rowq_tc.cuh's GEMV on the plan of
    `ffn_fused.plan_tc` where `ffn_fused.tc_route` takes the call, gemv.cuh's
    tiled GEMV otherwise. Returns y [t, O] f32."""
    t, d = x2.shape
    o = qs.shape[0]
    _build.require(1 <= t <= _MAX_T and x2.dtype in (torch.float32, torch.bfloat16)
                   and qs.dtype == torch.int8 and tuple(qs.shape) == (o, d)
                   and tuple(s.shape) == (o,) and tuple(nw.shape) == (d,),
                   "qkv_norm_fused_rowq: x [T <= 32, D] f32 or bf16, wqkv [O, D], norm [D]")
    _build.require(d % 4 == 0 and qs.is_contiguous() and s.is_contiguous()
                   and qs.device == s.device == x2.device and qs.data_ptr() % 16 == 0,
                   "qkv_norm_fused_rowq: contiguous, 16-byte aligned weights on x's device, "
                   "D % 4 == 0")
    dev = x2.device
    x2 = ffn_fused.aligned16(x2)
    nw = ffn_fused.aligned16(nw.float().contiguous())
    y = torch.empty((t, o), dtype=torch.float32, device=dev)
    h = partial = None
    plan = (0, 0, 0, 0)
    if ffn_fused.tc_route(x2.dtype, d):
        p = ffn_fused.tc_plan(t, o, d, False, dev, sms)
        h = torch.empty((t, d), dtype=torch.bfloat16, device=dev)
        partial, plan = ffn_fused.tc_partial(dev, p), p.args
    lib = lib or _build.load("layer_fused")
    ptr = [None if a is None else a.data_ptr() for a in (h, partial)]
    err = lib.lt_qkv_norm(x2.data_ptr(), _build.dtype_code(x2), nw.data_ptr(), float(eps),
                          qs.data_ptr(), s.data_ptr(), y.data_ptr(), *ptr, t, o, d,
                          _build.DTYPE_CODES[_dot_dtype(x2)], *plan, _build.stream())
    _build.check(lib, err, "qkv_norm_fused_rowq")
    return y


def qkv_norm_fused_rowq(wqkv: QTensor, attn_norm: torch.Tensor, x: torch.Tensor,
                        li: int, eps: float) -> torch.Tensor:
    """y[..., O] = rmsnorm(x, attn_norm[li]) @ wqkv[li]^T, in x's dtype.
    wqkv stacked q8_row [L, O, D], attn_norm [L, D]. On the card x has at
    most 32 rows (`ffn_fused._MAX_T`), as the JAX function takes."""
    if x.device.type == "cpu":
        return qkv_norm_plain(wqkv, attn_norm, x, li, eps)
    qs, s = _rowq_layer(wqkv, li)
    o, d = qs.shape
    lead = x.shape[:-1]
    y = _qkv_launch(qs, s, attn_norm[li], x.reshape(-1, d).contiguous(), eps)
    qkv_norm_fused_rowq.launches += 1
    return y.reshape(*lead, o).to(x.dtype)


qkv_norm_fused_rowq.launches = 0


# ----------------------------------------------------------------- K3
def _check_attn_tail(q4, kvc, x, hd):
    if q4.shape[0] != 1 or x.shape[0] != 1 or x.numel() != x.shape[-1]:
        raise NotImplementedError("fused decode layer: B = 1, T = 1 only")
    if kvc.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{kvc.dtype} KV cache: K3 takes bf16/f32 caches, as the "
                                  "JAX megakernel does")
    if kvc.shape[-1] != 2 * hd:
        raise NotImplementedError("head_dim != v_head_dim: K3 takes equal key and value "
                                  "head widths, as the JAX megakernel does")


def _host_pos(pos) -> int:
    """pos as a host int: an int, or the one element of a CPU tensor."""
    return int(pos.reshape(-1)[0]) if isinstance(pos, torch.Tensor) else int(pos)


def layer_attn_tail_plain(wo: QTensor, w13: QTensor, w2: QTensor, ffn_norm, q4, kv_new,
                          kvc, x, pos, li: int, eps: float, scale: float, hd: int,
                          residual_scale: float = 1.0):
    """Plain version of K3 (same arguments and results; pos an int or a CPU
    tensor of one element)."""
    _check_attn_tail(q4, kvc, x, hd)
    pos = _host_pos(pos)
    dot = _dot_dtype(x)
    wo_q, so = _rowq_layer(wo, li)
    w13_q, s13 = _rowq_layer(w13, li)
    w2_q, s2 = _rowq_layer(w2, li)
    kv = kvc[li, 0]                                   # [KV, S, hd + vhd] view
    kv[:, pos] = kv_new[0].to(kv.dtype)
    kf = kv[:, : pos + 1].float()
    q = q4[0].float()                                 # [KV, G, hd]
    scores = torch.einsum("kgh,ksh->kgs", q, kf[..., :hd]) * scale
    att = torch.softmax(scores, dim=-1)
    aflat = torch.einsum("kgs,ksv->kgv", att, kf[..., hd:]).reshape(1, -1).to(dot)
    y = (aflat.float() @ wo_q.float().T) * so
    if residual_scale != 1.0:
        y = y * residual_scale
    x2 = x.reshape(1, -1).float() + y
    h = rmsnorm(x2, ffn_norm[li], eps).to(dot)
    g13 = (h.float() @ w13_q.float().T) * s13
    f = g13.shape[-1] // 2
    gate, up = g13[:, :f], g13[:, f:]
    act = (gate * torch.sigmoid(gate) * up).to(dot)
    y2 = (act.float() @ w2_q.float().T) * s2
    if residual_scale != 1.0:
        y2 = y2 * residual_scale
    return (x2 + y2).to(x.dtype).reshape(x.shape), kvc


def _align4(n: int) -> int:
    """n f32 rounded up to 16 bytes."""
    return -(-n // 4) * 4


@dataclasses.dataclass(frozen=True)
class AttnTailSetup:
    """What K3's launch takes from its inputs' shapes alone, worked out once
    a geometry (`_attn_tail_setup`): the layer strides in bytes, the
    attention phase's plan, the three rowq_tc.cuh plans (zeros: gemv.cuh's
    route) and the scratch pieces' f32 offsets in one buffer (aflat, x2,
    act, the sums of squares, the slices' sums; -1: none)."""
    layers: int
    strides: tuple      # bytes a layer: wo, so, w13, s13, w2, s2, ffn_norm, cache
    args: tuple         # lt_attn_tail's shape arguments after pos, before x
    dims: tuple         # (D, F, dot dtype code)
    plan: tuple         # 12 ints
    offsets: tuple      # 5 f32 offsets into the scratch, -1 for none
    floats: int         # scratch size in f32


def _attn_tail_setup(wo, w13, w2, ffn_norm, q4, kv_new, kvc, x, pos, hd: int,
                     scale: float, dev, sms) -> AttnTailSetup:
    """The checks and plans of K3 for one geometry; raises on what the
    kernel does not take."""
    for w in (wo, w13, w2):
        if not (isinstance(w, QTensor) and w.kind == "q8_row" and w.qs.dim() == 3
                and not w.logical_out):
            raise NotImplementedError("fused decode kernels take stacked q8_row weights")
    _check_attn_tail(q4, kvc, x, hd)
    n_l, d, hdim = wo.qs.shape
    f = w2.qs.shape[-1]
    _, kvh, g, _ = q4.shape
    s_len, width = kvc.shape[-2], kvc.shape[-1]
    vhd = width - hd
    if g > 8 or hd % 8 or vhd % 8 or vhd > 128 or width > 256:
        raise NotImplementedError(f"K3 takes G <= 8, hd and vhd multiples of 8, vhd <= 128, "
                                  f"hd + vhd <= 256 (got G {g}, hd {hd}, vhd {vhd})")
    _build.require(hdim == kvh * g * vhd and tuple(w13.qs.shape) == (n_l, 2 * f, d)
                   and tuple(w2.qs.shape) == (n_l, d, f)
                   and all(tuple(w.scales.shape) == (n_l, w.qs.shape[1], 1)
                           and w.scales.dtype == torch.float32 for w in (wo, w13, w2))
                   and tuple(ffn_norm.shape) == (n_l, d) and ffn_norm.dtype == torch.float32
                   and tuple(x.shape) == (1, 1, d)
                   and tuple(kv_new.shape) == (1, kvh, width) and kvc.dim() == 5
                   and kvc.shape[0] == n_l and tuple(pos.shape) == (1,)
                   and pos.dtype == torch.int32, "layer_attn_tail_fused_rowq: shapes")
    _build.require(x.dtype in (torch.float32, torch.bfloat16)
                   and q4.dtype == kv_new.dtype == x.dtype,
                   "layer_attn_tail_fused_rowq: f32 or bf16 x, q and kv_new in x's dtype")
    _build.require(min(d, hdim, f) % 4 == 0 and (d * hdim) % 16 == 0 and (d * f) % 16 == 0
                   and (s_len * width * kvc.element_size()) % 16 == 0,
                   "layer_attn_tail_fused_rowq: widths % 4 == 0, 16-byte aligned layers")
    n_sm = sms or ffn_fused._sm_count(dev.index or 0)
    ap = attention.plan_dense(1, kvh, s_len, width, kvc.element_size(), n_sm)
    if s_len % ap.rows:
        raise ValueError(f"layer_attn_tail_fused_rowq: S {s_len} is not a multiple of the "
                         f"stage's {ap.rows} rows")
    tc = ffn_fused.tc_route(x.dtype, d, hdim, f)
    plan, split = (0,) * 12, 0
    if tc:
        plans = (ffn_fused.tc_plan(1, d, hdim, False, dev, n_sm),
                 ffn_fused.tc_plan(1, f, d, True, dev, n_sm),
                 ffn_fused.tc_plan(1, d, f, False, dev, n_sm))
        plan = tuple(v for p in plans for v in p.args)
        split = max(p.partial_floats for p in plans)
    # aflat, x2, act (bf16 on the tensor cores: half the floats), the sums of
    # squares, the slices' sums; each 16-byte aligned
    sizes = (hdim, d, -(-f // 2) if tc else f, -(-d // ffn_fused.TC_ROWS) if tc else 0, split)
    offsets, at = [], 0
    for n in sizes:
        offsets.append(at if n else -1)
        at += _align4(n)
    kvb = kvc.shape[1] * kvh * s_len * width * kvc.element_size()
    return AttnTailSetup(
        layers=n_l, strides=(d * hdim, d * 4, 2 * f * d, 2 * f * 4, d * f, d * 4, d * 4, kvb),
        args=(s_len, kvh, g, hd, vhd, float(scale), ap.cluster, ap.rows),
        dims=(d, f, _build.DTYPE_CODES[_dot_dtype(x)]), plan=plan, offsets=tuple(offsets),
        floats=at)


_ATTN_TAIL_SETUPS: dict = {}


def _attn_tail_launch(wo, w13, w2, ffn_norm, q4, kv_new, kvc, x, pos, li: int, eps: float,
                      scale: float, hd: int, residual_scale: float, lib=None, sms=None):
    """One call of csrc/layer_fused.cu `lt_attn_tail` (or of `lib`, a
    library with the same entry point) on layer li of the stacked weights
    and cache: q [1, KV, G, hd] and kv_new [1, KV, hd + vhd] in x's dtype, x
    [1, 1, D], pos int32 [1] on the device. The attention phase on
    `attention.plan_dense`'s plan, then rowq_tc.cuh's three phases on
    `ffn_fused.tc_plan`'s plans where `ffn_fused.tc_route` takes the call,
    gemv.cuh's otherwise. The shape checks and plans are worked out once a
    geometry (`_attn_tail_setup`); a call checks layout and alignment and
    passes the layer's addresses (the host cost of a decode step's 16
    calls). The scratch is one f32 buffer. Returns the new x [1, 1, D]."""
    tensors = (wo.qs, wo.scales, w13.qs, w13.scales, w2.qs, w2.scales, ffn_norm, kvc)
    _build.require(all(t.is_contiguous() for t in tensors) and q4.is_contiguous()
                   and kv_new.is_contiguous() and x.is_contiguous(),
                   "layer_attn_tail_fused_rowq: contiguous stacked weights, cache and inputs")
    base = [t.data_ptr() for t in tensors]
    dev = x.device
    _build.require(all(b % 16 == 0 for b in base) and all(
        t.device == dev for t in (wo.qs, w13.qs, w2.qs, kvc, q4, kv_new, pos)),
        "layer_attn_tail_fused_rowq: 16-byte aligned weights and cache on x's device")
    key = (wo.qs.shape, w13.qs.shape, w2.qs.shape, ffn_norm.shape, ffn_norm.dtype, q4.shape,
           q4.dtype, kv_new.shape, kv_new.dtype, kvc.shape, kvc.dtype, x.shape, x.dtype,
           pos.shape, pos.dtype, hd, float(scale), dev, sms)
    su = _ATTN_TAIL_SETUPS.get(key)
    if su is None:
        su = _attn_tail_setup(wo, w13, w2, ffn_norm, q4, kv_new, kvc, x, pos, hd, scale, dev,
                              sms)
        _ATTN_TAIL_SETUPS[key] = su
    _build.require(0 <= li < su.layers, f"layer_attn_tail_fused_rowq: layer {li} of {su.layers}")
    ptr = [b + li * st for b, st in zip(base, su.strides)]
    ws = torch.empty(su.floats, dtype=torch.float32, device=dev)
    w0 = ws.data_ptr()
    scratch = [None if o < 0 else w0 + 4 * o for o in su.offsets]
    out = torch.empty_like(x)
    lib = lib or _build.load("layer_fused")
    err = lib.lt_attn_tail(
        q4.data_ptr(), kv_new.data_ptr(), _build.DTYPE_CODES[x.dtype], ptr[7],
        _build.DTYPE_CODES[kvc.dtype], pos.data_ptr(), *su.args, x.data_ptr(), ptr[6],
        float(eps), float(residual_scale), *ptr[:6], *scratch, out.data_ptr(), *su.dims,
        *su.plan, _build.stream())
    _build.check(lib, err, "layer_attn_tail_fused_rowq")
    return out


def layer_attn_tail_fused_rowq(wo: QTensor, w13: QTensor, w2: QTensor,
                               ffn_norm: torch.Tensor, q4: torch.Tensor,
                               kv_new: torch.Tensor, kvc: torch.Tensor, x: torch.Tensor,
                               pos, li: int, eps: float, scale: float, hd: int,
                               residual_scale: float = 1.0):
    """One decode layer after the qkv projection. q4 [1, KV, G, hd] and
    kv_new [1, KV, hd + vhd] post-RoPE; kvc the packed stacked cache
    [L, 1, KV, S, hd + vhd], written IN PLACE at (li, pos) only; x [1, 1, D];
    pos the position: an int32 tensor [1] on x's device (the forward's
    pos_vec: the kernel reads it there, as the JAX kernel does), or a host
    int. Returns (new x in x's dtype, kvc)."""
    if x.device.type == "cpu":
        return layer_attn_tail_plain(wo, w13, w2, ffn_norm, q4, kv_new, kvc, x, pos, li,
                                     eps, scale, hd, residual_scale)
    if not isinstance(pos, torch.Tensor):
        s_len = kvc.shape[-2]
        _build.require(0 <= pos < s_len,
                       f"layer_attn_tail_fused_rowq: pos {pos} outside [0, {s_len})")
        pos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    out = _attn_tail_launch(wo, w13, w2, ffn_norm, q4, kv_new, kvc, x, pos, li, eps, scale, hd,
                            residual_scale)
    layer_attn_tail_fused_rowq.launches += 1
    return out, kvc


layer_attn_tail_fused_rowq.launches = 0


# ----------------------------------------------------------------- K9

def _tail_weights(wo, w13, w2, li):
    for w in (wo, w13, w2):
        if not (isinstance(w, QTensor) and w.kind == "q8_row" and w.qs.dim() == 3
                and not w.logical_out):
            return None
    return _rowq_layer(wo, li), _rowq_layer(w13, li), _rowq_layer(w2, li)


def _tail_rows(attn, x, parts, fit=tail_fits) -> int | None:
    """T when the weights' and inputs' shapes match and `fit` accepts them."""
    (wo_q, _), (w13_q, _), (w2_q, _) = parts
    d, hdim = wo_q.shape
    f = w2_q.shape[1]
    t = x.numel() // x.shape[-1]
    if (t > _MAX_T or w13_q.shape != (2 * f, d) or w2_q.shape[0] != d
            or x.shape[-1] != d or attn.shape[-1] != hdim or attn.numel() != t * hdim):
        return None
    return t if fit(t, d, hdim, f, 4 if x.dtype == torch.float32 else 2) else None


def _tail_front(parts, ffn_norm, attn, x, li: int, t: int, eps: float, residual_scale: float):
    """The plain versions' phases before w2: (x2 f32 [T, D], act [T, F] rounded
    to the working dtype)."""
    (wo_q, so), (w13_q, s13), _ = parts
    dot = _dot_dtype(x)
    d = x.shape[-1]
    y = (attn.reshape(t, -1).to(dot).float() @ wo_q.float().T) * so
    if residual_scale != 1.0:
        y = y * residual_scale
    x2 = x.reshape(t, d).float() + y
    ss = torch.mean(x2 * x2, dim=-1, keepdim=True) + eps
    h = (x2 * torch.rsqrt(ss) * ffn_norm[li].float()).to(dot)
    g13 = (h.float() @ w13_q.float().T) * s13
    f = g13.shape[-1] // 2
    gate, up = g13[:, :f], g13[:, f:]
    return x2, (gate * torch.sigmoid(gate) * up).to(dot)


def _tail_out(x2, acc, s2, x, residual_scale: float):
    y2 = acc * s2
    if residual_scale != 1.0:
        y2 = y2 * residual_scale
    return (x2 + y2).to(x.dtype).reshape(x.shape)


def layer_tail_plain(wo: QTensor, w13: QTensor, w2: QTensor, ffn_norm, attn, x, li: int,
                     eps: float, residual_scale: float = 1.0):
    """Plain version of K9 (same arguments and results)."""
    parts = _tail_weights(wo, w13, w2, li)
    t = None if parts is None else _tail_rows(attn, x, parts)
    if t is None:
        return None
    x2, act = _tail_front(parts, ffn_norm, attn, x, li, t, eps, residual_scale)
    w2_q, s2 = parts[2]
    return _tail_out(x2, act.float() @ w2_q.float().T, s2, x, residual_scale)


def layer_tail_fused_rowq(wo: QTensor, w13: QTensor, w2: QTensor, ffn_norm: torch.Tensor,
                          attn: torch.Tensor, x: torch.Tensor, li: int, eps: float,
                          residual_scale: float = 1.0):
    """new x [..., D] (x's dtype) = x + rs * wo(attn), then + rs * FFN(rmsnorm(.)),
    with stacked q8_row wo [L, D, H], w13 [L, 2F, D], w2 [L, D, F] and
    ffn_norm [L, D]; attn [..., H]. None for more than 32 rows, weights
    other than stacked q8_row, or where the JAX function's VMEM fit declines
    (the caller takes the unfused chain). While `_W2_KTILE` is set, K16
    (`layer_tail_kt_fused_rowq`) where it fits, as in the JAX package."""
    if _W2_KTILE:
        y = layer_tail_kt_fused_rowq(wo, w13, w2, ffn_norm, attn, x, li, eps, residual_scale)
        if y is not None:
            return y
    if x.device.type == "cpu":
        return layer_tail_plain(wo, w13, w2, ffn_norm, attn, x, li, eps, residual_scale)
    parts = _tail_weights(wo, w13, w2, li)
    t = None if parts is None else _tail_rows(attn, x, parts)
    if t is None:
        return None
    d = x.shape[-1]
    out = _tail_launch(parts, ffn_norm[li], attn.reshape(t, -1).to(x.dtype).contiguous(),
                       x.reshape(t, d).contiguous(), eps, residual_scale)
    layer_tail_fused_rowq.launches += 1
    return out.reshape(x.shape)


def _tail_scratch(t: int, d: int, f: int, plans, dev):
    """rowq_tc.cuh's scratch for K9's three phases: act [t, F] bf16, the sums
    of squares of x2 a 16-row block [t, D / 16], and the split phases'
    slice sums (None if no phase is split)."""
    act = torch.empty((t, f), dtype=torch.bfloat16, device=dev)
    ssp = torch.empty((t, -(-d // ffn_fused.TC_ROWS)), dtype=torch.float32, device=dev)
    return act, ssp, ffn_fused.tc_partial(dev, *plans)


def tail_plans(t: int, d: int, hdim: int, f: int, dev, sms=None, ksl: int = 0):
    """rowq_tc.cuh's plans of the tail's three phases (`ffn_fused.tc_plan`):
    wo [D, H], w13 [2F, D] as gate / up pairs, w2 [D, F]; `ksl` fixes the
    w2 phase's contraction slices (K16's tiles)."""
    return (ffn_fused.tc_plan(t, d, hdim, False, dev, sms),
            ffn_fused.tc_plan(t, f, d, True, dev, sms),
            ffn_fused.tc_plan(t, d, f, False, dev, sms, ksl=ksl))


def _tail_launch(parts, nw, a2, x2in, eps: float, residual_scale: float, lib=None, sms=None,
                 kt: bool = False):
    """The checks, then one call of csrc/layer_fused.cu `lt_tail` (K9), or
    with kt `lt_tail_kt` (K16), or of `lib`, a library with the same entry
    points, for a2 [t, H] and x2in [t, D] in x's dtype: rowq_tc.cuh's three
    phases on `tail_plans` (K16: `kt_plans`) where `ffn_fused.tc_route`
    takes the call, gemv.cuh's otherwise (K16 there: its tile kernels on
    partials [F / tf, t, D]). Returns the new x [t, D]."""
    (wo_q, so), (w13_q, s13), (w2_q, s2) = parts
    d, hdim = wo_q.shape
    f = w2_q.shape[1]
    t = x2in.shape[0]
    tf = ktile_width(f) if kt else 0
    name = "layer_tail_kt_fused_rowq" if kt else "layer_tail_fused_rowq"
    _build.require(1 <= t <= _MAX_T and tuple(x2in.shape) == (t, d)
                   and tuple(a2.shape) == (t, hdim) and tuple(w13_q.shape) == (2 * f, d)
                   and tuple(w2_q.shape) == (d, f) and so.numel() == d
                   and s13.numel() == 2 * f and s2.numel() == d and (tf > 0 or not kt),
                   f"{name}: attn [T <= 32, H], x [T, D], wo [D, H], w13 [2F, D], w2 [D, F] "
                   "(K16: F a multiple of 128)")
    _build.require(all(w.is_contiguous() for w in (wo_q, w13_q, w2_q, so, s13, s2))
                   and min(d, hdim, f) % 4 == 0 and a2.device == x2in.device == wo_q.device
                   and all(w.data_ptr() % 16 == 0 for w in (wo_q, w13_q, w2_q)),
                   f"{name}: contiguous, 16-byte aligned weights on x's device, widths % 4 == 0")
    dev = x2in.device
    a2, x2in = ffn_fused.aligned16(a2), ffn_fused.aligned16(x2in)
    nw = ffn_fused.aligned16(nw.float().contiguous())
    x2 = torch.empty((t, d), dtype=torch.float32, device=dev)
    out = torch.empty_like(x2in)
    if ffn_fused.tc_route(x2in.dtype, d, hdim, f):
        plans = tail_plans(t, d, hdim, f, dev, sms, tf)
        act, ssp, partial = _tail_scratch(t, d, f, plans, dev)
        plan = tuple(v for p in plans for v in p.args)
    else:
        act = torch.empty((t, f), dtype=torch.float32, device=dev)
        ssp, plan = None, (0,) * 12
        partial = torch.empty((f // tf, t, d), dtype=torch.float32, device=dev) if kt else None
    lib = lib or _build.load("layer_fused")
    args = (a2.data_ptr(), _build.dtype_code(x2in), x2in.data_ptr(), nw.data_ptr(), float(eps),
            float(residual_scale), wo_q.data_ptr(), so.data_ptr(), w13_q.data_ptr(),
            s13.data_ptr(), w2_q.data_ptr(), s2.data_ptr(), x2.data_ptr(), act.data_ptr(),
            *[None if a is None else a.data_ptr() for a in (ssp, partial)], out.data_ptr(), t, d,
            hdim, f)
    dot = _build.DTYPE_CODES[_dot_dtype(x2in)]
    if kt:
        err = lib.lt_tail_kt(*args, tf, dot, *plan, _build.stream())
    else:
        err = lib.lt_tail(*args, dot, *plan, _build.stream())
    _build.check(lib, err, name)
    return out


layer_tail_fused_rowq.launches = 0


# ----------------------------------------------------------------- K16
# w2 phase layout, as llamatpu/ops/layer_fused.py `_W2_KTILE`: False = K9's
# out-tiled rows; True = K16's contraction tiles [D, tf]
_W2_KTILE = False


def ktile_width(f: int) -> int:
    """K16's contraction tile tf: the widest of 1024, 512, 256, 128 dividing F
    (0: none, and the tail stays K9)."""
    return next((c for c in (1024, 512, 256, 128) if f % c == 0), 0)


def tail_kt_fits(t: int, d: int, hdim: int, f: int, xbytes: int) -> bool:
    """K16 for t rows, as the JAX package's `_fit_tail_tiles_kt` fits."""
    return bool(ktile_width(f)) and (
        not _aligned(d, 2 * f) or _fit_tail_tiles_kt(t, d, hdim, 2 * f, f, xbytes) is not None)


def layer_tail_kt_plain(wo: QTensor, w13: QTensor, w2: QTensor, ffn_norm, attn, x, li: int,
                        eps: float, residual_scale: float = 1.0):
    """Plain version of K16: K9's, with the w2 products summed tile by tile."""
    parts = _tail_weights(wo, w13, w2, li)
    t = None if parts is None else _tail_rows(attn, x, parts, tail_kt_fits)
    if t is None:
        return None
    x2, act = _tail_front(parts, ffn_norm, attn, x, li, t, eps, residual_scale)
    w2_q, s2 = parts[2]
    tf = ktile_width(w2_q.shape[1])
    acc = torch.zeros_like(x2)
    for k0 in range(0, w2_q.shape[1], tf):
        acc += act[:, k0:k0 + tf].float() @ w2_q[:, k0:k0 + tf].float().T
    return _tail_out(x2, acc, s2, x, residual_scale)


def kt_plans(t: int, d: int, hdim: int, f: int, dev, sms=None):
    """K16's three rowq_tc.cuh plans: K9's wo and w13 plans, and a w2 plan
    whose contraction slices are the tiles (ksl = ktile_width(F), splits =
    F / ksl), its row groups and CTAs by `plan_tc`'s cost."""
    return tail_plans(t, d, hdim, f, dev, sms, ktile_width(f))


def layer_tail_kt_fused_rowq(wo: QTensor, w13: QTensor, w2: QTensor, ffn_norm: torch.Tensor,
                             attn: torch.Tensor, x: torch.Tensor, li: int, eps: float,
                             residual_scale: float = 1.0):
    """K16: `layer_tail_fused_rowq`'s function and arguments, w2 in contraction
    tiles. None where its shapes or its fit decline (`tail_kt_fits`)."""
    if x.device.type == "cpu":
        return layer_tail_kt_plain(wo, w13, w2, ffn_norm, attn, x, li, eps, residual_scale)
    parts = _tail_weights(wo, w13, w2, li)
    t = None if parts is None else _tail_rows(attn, x, parts, tail_kt_fits)
    if t is None:
        return None
    d = x.shape[-1]
    out = _tail_launch(parts, ffn_norm[li], attn.reshape(t, -1).to(x.dtype).contiguous(),
                       x.reshape(t, d).contiguous(), eps, residual_scale, kt=True)
    layer_tail_kt_fused_rowq.launches += 1
    return out.reshape(x.shape)


layer_tail_kt_fused_rowq.launches = 0
