"""K2, K3 and K9: the fused calls of a q8_row decode layer.

- K2 `qkv_norm_fused_rowq`, counterpart of llamatpu/ops/layer_fused.py
  `_qkv_kernel`: h = rmsnorm(x) * attn_norm[li] rounded to the working dtype,
  then y = (h . wqkv[li]^T) * s.
- K3 `layer_attn_tail_fused_rowq`, counterpart of `_attn_tail_kernel`
  (megakernel v3): append the post-RoPE K|V row at `pos` (the cache is
  updated IN PLACE, where the JAX package aliased it), masked f32 GQA
  attention over s <= pos, wo + residual (x2 in f32), rmsnorm, w13,
  silu * up, w2 + residual. B = 1, T = 1 on a dense cache.
- K9 `layer_tail_fused_rowq`, counterpart of `_tail_kernel`: everything after
  attention (wo + residual with x2 in f32, rmsnorm, w13, silu * up, w2 +
  residual) for T <= 32 rows (`ffn_fused._MAX_T`), e.g. the B lanes of a
  batched decode step; above that it returns None, as the JAX function does.
- K16 `layer_tail_kt_fused_rowq`, counterpart of `_tail_kernel_kt`: K9's
  function with w2 streamed as contraction tiles [D, tf] summed in f32 in
  tile order. `layer_tail_fused_rowq` takes it instead of K9 while the module
  flag `_W2_KTILE` is set (read at each call), as the JAX function does;
  bench/sweep_tail.py times the two.
K2 takes any number of rows; the forward calls it for B * T <= 32 rows, the
JAX package's rule.

The working ("dot") dtype is f32 for f32 activations, else bf16. CUDA source:
csrc/layer_fused.cu (design and bound in its header note). Each entry point
has its plain torch version here; a CPU tensor takes it, a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from llamatpu_torch import _build
from llamatpu_torch.models.weights import QTensor
from llamatpu_torch.ops.rmsnorm import rmsnorm


def _dot_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


def _rowq_layer(w: QTensor, li: int) -> tuple[torch.Tensor, torch.Tensor]:
    if not (isinstance(w, QTensor) and w.kind == "q8_row" and w.qs.dim() == 3
            and not w.logical_out):
        raise NotImplementedError("fused decode kernels take stacked q8_row weights")
    return w.qs[li], w.scales[li][:, 0]


# ----------------------------------------------------------------- K2
def qkv_norm_plain(wqkv: QTensor, attn_norm, x, li: int, eps: float) -> torch.Tensor:
    qs, s = _rowq_layer(wqkv, li)
    h = rmsnorm(x, attn_norm[li], eps).to(_dot_dtype(x))
    return ((h.float() @ qs.float().T) * s).to(x.dtype)


def qkv_norm_fused_rowq(wqkv: QTensor, attn_norm: torch.Tensor, x: torch.Tensor,
                        li: int, eps: float) -> torch.Tensor:
    """y[..., O] = rmsnorm(x, attn_norm[li]) @ wqkv[li]^T, in x's dtype.
    wqkv stacked q8_row [L, O, D], attn_norm [L, D]."""
    if x.device.type == "cpu":
        return qkv_norm_plain(wqkv, attn_norm, x, li, eps)
    qs, s = _rowq_layer(wqkv, li)
    o, d = qs.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d).contiguous()
    nw = attn_norm[li].float().contiguous()
    _build.require(d % 4 == 0 and qs.is_contiguous() and s.is_contiguous(),
                   "qkv_norm_fused_rowq: contiguous weights, D % 4 == 0")
    y = torch.empty((x2.shape[0], o), dtype=torch.float32, device=x.device)
    lib = _build.load("layer_fused")
    err = lib.lt_qkv_norm(x2.data_ptr(), _build.dtype_code(x2), nw.data_ptr(), float(eps),
                          qs.data_ptr(), s.data_ptr(), y.data_ptr(), x2.shape[0], o, d,
                          _build.DTYPE_CODES[_dot_dtype(x)], _build.stream())
    _build.check(lib, err, "qkv_norm_fused_rowq")
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
        raise NotImplementedError("head_dim != v_head_dim: family-deltas slice of the port")


def layer_attn_tail_plain(wo: QTensor, w13: QTensor, w2: QTensor, ffn_norm, q4, kv_new,
                          kvc, x, pos: int, li: int, eps: float, scale: float, hd: int,
                          residual_scale: float = 1.0):
    """Plain version of K3 (same arguments and results)."""
    _check_attn_tail(q4, kvc, x, hd)
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


def layer_attn_tail_fused_rowq(wo: QTensor, w13: QTensor, w2: QTensor,
                               ffn_norm: torch.Tensor, q4: torch.Tensor,
                               kv_new: torch.Tensor, kvc: torch.Tensor, x: torch.Tensor,
                               pos: int, li: int, eps: float, scale: float, hd: int,
                               residual_scale: float = 1.0):
    """One decode layer after the qkv projection. q4 [1, KV, G, hd] and
    kv_new [1, KV, hd + vhd] post-RoPE; kvc the packed stacked cache
    [L, 1, KV, S, hd + vhd], written IN PLACE at (li, pos) only; x [1, 1, D].
    Returns (new x in x's dtype, kvc)."""
    if x.device.type == "cpu":
        return layer_attn_tail_plain(wo, w13, w2, ffn_norm, q4, kv_new, kvc, x, pos, li,
                                     eps, scale, hd, residual_scale)
    _check_attn_tail(q4, kvc, x, hd)
    wo_q, so = _rowq_layer(wo, li)
    w13_q, s13 = _rowq_layer(w13, li)
    w2_q, s2 = _rowq_layer(w2, li)
    _, kvh, g, _ = q4.shape
    s_len, width = kvc.shape[-2], kvc.shape[-1]
    d, hdim = wo_q.shape
    f = w2_q.shape[1]
    _build.require(hdim == kvh * g * (width - hd) and w13_q.shape == (2 * f, d)
                   and x.shape[-1] == d, "layer_attn_tail_fused_rowq: shapes")
    _build.require(0 <= pos < s_len, f"layer_attn_tail_fused_rowq: pos {pos} outside [0, {s_len})")
    if g > 8 or hd % 32 or hd > 128:
        raise NotImplementedError("K3 attention takes G <= 8 and hd a multiple of 32 up to 128")
    _build.require(all(t.is_contiguous() for t in (wo_q, w13_q, w2_q, so, s13, s2, kvc))
                   and min(d, hdim, f) % 4 == 0, "layer_attn_tail_fused_rowq: layout")
    q4c, kvn, xc = q4.contiguous(), kv_new.to(x.dtype).contiguous(), x.contiguous()
    _build.require(q4c.dtype == x.dtype, "layer_attn_tail_fused_rowq: q in x's dtype")
    nw = ffn_norm[li].float().contiguous()
    dev = x.device
    aflat = torch.empty(hdim, dtype=torch.float32, device=dev)
    x2 = torch.empty(d, dtype=torch.float32, device=dev)
    act = torch.empty(f, dtype=torch.float32, device=dev)
    out = torch.empty_like(xc)
    lib = _build.load("layer_fused")
    err = lib.lt_attn_tail(
        q4c.data_ptr(), kvn.data_ptr(), _build.dtype_code(xc), kvc[li, 0].data_ptr(),
        _build.dtype_code(kvc), s_len, int(pos), kvh, g, hd, width - hd, float(scale),
        xc.data_ptr(), nw.data_ptr(), float(eps), float(residual_scale),
        wo_q.data_ptr(), so.data_ptr(), w13_q.data_ptr(), s13.data_ptr(),
        w2_q.data_ptr(), s2.data_ptr(), aflat.data_ptr(), x2.data_ptr(), act.data_ptr(),
        out.data_ptr(), d, f, _build.DTYPE_CODES[_dot_dtype(x)], _build.stream())
    _build.check(lib, err, "layer_attn_tail_fused_rowq")
    layer_attn_tail_fused_rowq.launches += 1
    return out, kvc


layer_attn_tail_fused_rowq.launches = 0


# ----------------------------------------------------------------- K9
MAX_T = 32  # rows the fused tail takes (llamatpu/ops/ffn_fused.py _MAX_T)


def _tail_weights(wo, w13, w2, li):
    for w in (wo, w13, w2):
        if not (isinstance(w, QTensor) and w.kind == "q8_row" and w.qs.dim() == 3
                and not w.logical_out):
            return None
    return _rowq_layer(wo, li), _rowq_layer(w13, li), _rowq_layer(w2, li)


def _tail_rows(attn, x, parts) -> int | None:
    (wo_q, _), (w13_q, _), (w2_q, _) = parts
    d, hdim = wo_q.shape
    t = x.numel() // x.shape[-1]
    if (t > MAX_T or w13_q.shape != (2 * w2_q.shape[1], d) or w2_q.shape[0] != d
            or x.shape[-1] != d or attn.shape[-1] != hdim or attn.numel() != t * hdim):
        return None
    return t


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
    ffn_norm [L, D]; attn [..., H]. None for more than 32 rows or weights
    other than stacked q8_row (the caller takes the unfused chain). While
    `_W2_KTILE` is set, K16 (`layer_tail_kt_fused_rowq`) where F has a tile."""
    if _W2_KTILE and isinstance(w2, QTensor) and ktile_width(w2.qs.shape[-1]):
        return layer_tail_kt_fused_rowq(wo, w13, w2, ffn_norm, attn, x, li, eps, residual_scale)
    if x.device.type == "cpu":
        return layer_tail_plain(wo, w13, w2, ffn_norm, attn, x, li, eps, residual_scale)
    parts = _tail_weights(wo, w13, w2, li)
    t = None if parts is None else _tail_rows(attn, x, parts)
    if t is None:
        return None
    (wo_q, so), (w13_q, s13), (w2_q, s2) = parts
    d, hdim = wo_q.shape
    f = w2_q.shape[1]
    a2 = attn.reshape(t, hdim).to(x.dtype).contiguous()
    x2in = x.reshape(t, d).contiguous()
    _build.require(all(w.is_contiguous() for w in (wo_q, w13_q, w2_q, so, s13, s2))
                   and min(d, hdim, f) % 4 == 0 and a2.device == x.device == wo_q.device,
                   "layer_tail_fused_rowq: contiguous weights on x's device, widths % 4 == 0")
    nw = ffn_norm[li].float().contiguous()
    x2 = torch.empty((t, d), dtype=torch.float32, device=x.device)
    act = torch.empty((t, f), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x2in)
    lib = _build.load("layer_fused")
    err = lib.lt_tail(a2.data_ptr(), _build.dtype_code(x2in), x2in.data_ptr(), nw.data_ptr(),
                      float(eps), float(residual_scale), wo_q.data_ptr(), so.data_ptr(),
                      w13_q.data_ptr(), s13.data_ptr(), w2_q.data_ptr(), s2.data_ptr(),
                      x2.data_ptr(), act.data_ptr(), out.data_ptr(), t, d, hdim, f,
                      _build.DTYPE_CODES[_dot_dtype(x)], _build.stream())
    _build.check(lib, err, "layer_tail_fused_rowq")
    layer_tail_fused_rowq.launches += 1
    return out.reshape(x.shape)


layer_tail_fused_rowq.launches = 0


# ----------------------------------------------------------------- K16
# w2 phase layout, as llamatpu/ops/layer_fused.py `_W2_KTILE`: False = K9's
# out-tiled rows; True = K16's contraction tiles [D, tf]
_W2_KTILE = False


def ktile_width(f: int) -> int:
    """K16's contraction tile tf: the widest of 1024, 512, 256, 128 dividing F
    (0: none, and the tail stays K9)."""
    return next((c for c in (1024, 512, 256, 128) if f % c == 0), 0)


def layer_tail_kt_plain(wo: QTensor, w13: QTensor, w2: QTensor, ffn_norm, attn, x, li: int,
                        eps: float, residual_scale: float = 1.0):
    """Plain version of K16: K9's, with the w2 products summed tile by tile."""
    parts = _tail_weights(wo, w13, w2, li)
    t = None if parts is None else _tail_rows(attn, x, parts)
    if t is None:
        return None
    x2, act = _tail_front(parts, ffn_norm, attn, x, li, t, eps, residual_scale)
    w2_q, s2 = parts[2]
    tf = ktile_width(w2_q.shape[1])
    acc = torch.zeros_like(x2)
    for k0 in range(0, w2_q.shape[1], tf):
        acc += act[:, k0:k0 + tf].float() @ w2_q[:, k0:k0 + tf].float().T
    return _tail_out(x2, acc, s2, x, residual_scale)


def layer_tail_kt_fused_rowq(wo: QTensor, w13: QTensor, w2: QTensor, ffn_norm: torch.Tensor,
                             attn: torch.Tensor, x: torch.Tensor, li: int, eps: float,
                             residual_scale: float = 1.0):
    """K16: `layer_tail_fused_rowq`'s function and arguments, w2 in contraction
    tiles. None where K9 declines or F has no tile."""
    if x.device.type == "cpu":
        return layer_tail_kt_plain(wo, w13, w2, ffn_norm, attn, x, li, eps, residual_scale)
    parts = _tail_weights(wo, w13, w2, li)
    t = None if parts is None else _tail_rows(attn, x, parts)
    if t is None:
        return None
    (wo_q, so), (w13_q, s13), (w2_q, s2) = parts
    d, hdim = wo_q.shape
    f = w2_q.shape[1]
    tf = ktile_width(f)
    if not tf:
        return None
    a2 = attn.reshape(t, hdim).to(x.dtype).contiguous()
    x2in = x.reshape(t, d).contiguous()
    _build.require(all(w.is_contiguous() for w in (wo_q, w13_q, w2_q, so, s13, s2))
                   and min(d, hdim) % 4 == 0 and a2.device == x.device == wo_q.device
                   and w2_q.data_ptr() % 16 == 0,
                   "layer_tail_kt_fused_rowq: contiguous weights on x's device, widths % 4 == 0")
    nw = ffn_norm[li].float().contiguous()
    dev = x.device
    x2 = torch.empty((t, d), dtype=torch.float32, device=dev)
    act = torch.empty((t, f), dtype=torch.float32, device=dev)
    partial = torch.empty((f // tf, t, d), dtype=torch.float32, device=dev)
    out = torch.empty_like(x2in)
    lib = _build.load("layer_fused")
    err = lib.lt_tail_kt(a2.data_ptr(), _build.dtype_code(x2in), x2in.data_ptr(), nw.data_ptr(),
                         float(eps), float(residual_scale), wo_q.data_ptr(), so.data_ptr(),
                         w13_q.data_ptr(), s13.data_ptr(), w2_q.data_ptr(), s2.data_ptr(),
                         x2.data_ptr(), act.data_ptr(), partial.data_ptr(), out.data_ptr(), t, d,
                         hdim, f, tf, _build.DTYPE_CODES[_dot_dtype(x)], _build.stream())
    _build.check(lib, err, "layer_tail_kt_fused_rowq")
    layer_tail_kt_fused_rowq.launches += 1
    return out.reshape(x.shape)


layer_tail_kt_fused_rowq.launches = 0
