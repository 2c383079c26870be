"""Weight containers, the load-time transforms of the serving paths, and the
bridge from the JAX package's parameters.

A QTensor of logical shape [out, in] stores

    qs:     int8 [..., out, in]        values: Q8_0 in [-127, 127], Q4_0 and
                                       Q4_K in [-8, 7], Q5_K in [-16, 15]
                                       (canonical column order)
            int8 [..., out, in // 2]   layout "packed4" (Q4_0, Q4_K): byte c holds
                                       canonical columns 2c (low nibble) and
                                       2c + 1 (high nibble), two's complement
    scales: f32  [..., out, in // 32]  for "q8_0" / "q4_0" / "q4_k" / "q5_k"
                                       (per-32 block scales)
            f32  [..., out, 1]         for "q8_row" (one scale per out row)
    offs:   f32  [..., out, in // 32]  native K-quants only ("q4_k" values in
                                       [-8, 7], "q5_k" in [-16, 15]): the
                                       per-32 additive offsets, w = q *
                                       scale + off, in canonical block order
                                       under every layout; an expert stack's
                                       last dim is zero-padded to a multiple
                                       of 32 once fused (`pad_offsets`)

Leading dims stack layers ([L, ...]). At load time the fields are numpy
arrays and every transform here is numpy, or torch where a step is an
elementwise IEEE f32 operation or a max (the q8_row requant and
equalization, on the CPU or the serving device), so the port's served
weights equal the JAX package's bit for bit (tests/test_torch_weights.py,
tests/test_torch_gguf.py). `serving_weights` then moves the tree to the
device as torch tensors; a layer's weights are the view `qs[li]`, so no
kernel needs a stacked variant.

The interleaved column layout, the column-halves nibble packing and the row
padding of the JAX package's `prepare_qtensor` are Mosaic layouts, not
semantics: the port keeps values canonical (packed4 pairs adjacent columns,
so a 32-block stays inside 16 bytes) and rows unpadded, and
`from_numpy_weights` converts what it is given (padded rows keep their
`logical_out`, and the matmul dispatch slices them off).
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

BLOCK = 32  # ggml Q8_0 block size


@dataclass
class QTensor:
    """Quantized tensor: int8 values plus f32 scales (see module docstring).

    kind: "q8_0" / "q4_0" / "q4_k" / "q5_k" (per-32 block scales) |
    "q8_row" (per-out-row scales). logical_out: real out-features when rows
    are zero-padded (0 = all rows are real). layout: "canonical", "packed4"
    (Q4_0 and Q4_K) or, for tensors taken from the JAX package before
    `from_numpy_weights`, "interleaved". offs: the per-32 additive offsets
    of "q4_k" / "q5_k" (None for the other kinds)."""

    qs: Any
    scales: Any
    kind: str = "q8_0"
    logical_out: int = 0
    layout: str = "canonical"
    offs: Any = None

    @property
    def shape(self):
        return tuple(self.qs.shape)


def _np(a) -> np.ndarray:
    """numpy view of a load-time array (numpy, or a CPU torch tensor)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def deinterleave_columns(qs: np.ndarray) -> np.ndarray:
    """Interleaved -> canonical: the JAX package stores column j as original
    column (j % NB)*32 + j//NB; this is the inverse transpose."""
    *lead, o, i = qs.shape
    nb = i // BLOCK
    return np.swapaxes(qs.reshape(*lead, o, BLOCK, nb), -1, -2).reshape(*lead, o, i)


def pack4_pairs(qs: np.ndarray) -> np.ndarray:
    """Canonical int8 values in [-8, 7] [..., in] -> packed4 [..., in // 2]:
    byte c = (col 2c & 0xF) | (col 2c + 1) << 4. Load-time, numpy."""
    q = np.asarray(qs)
    lo = q[..., 0::2].astype(np.uint8) & 0x0F
    hi = q[..., 1::2].astype(np.uint8) & 0x0F
    return np.ascontiguousarray(lo | (hi << 4)).view(np.int8)


def unpack4_pairs(qp):
    """packed4 [..., in // 2] -> canonical int8 [..., in], sign-extended:
    lo = (p << 28) >> 28, hi = p >> 4 on the signed byte widened to int32.
    numpy or torch."""
    if isinstance(qp, torch.Tensor):
        p = qp.to(torch.int32)
        lo, hi = (p << 28) >> 28, p >> 4
        return torch.stack([lo, hi], dim=-1).flatten(-2).to(torch.int8)
    p = np.asarray(qp).astype(np.int32)
    lo, hi = (p << 28) >> 28, p >> 4
    return np.stack([lo, hi], axis=-1).reshape(*p.shape[:-1], -1).astype(np.int8)


def _unpack4_halves(qp: np.ndarray) -> np.ndarray:
    """The JAX package's packed4 (byte c = interleaved columns c | c + in/2
    << 4) -> its interleaved int8 values."""
    p = np.asarray(qp).astype(np.int32)
    return np.concatenate([(p << 28) >> 28, p >> 4], axis=-1).astype(np.int8)


def rowq_requant(w: QTensor, device: str | torch.device | None = None) -> QTensor:
    """Requantize a Q8_0 tensor to per-OUT-ROW int8 (`q8_row`): one f32 scale
    per output row instead of one per 32 inputs. Decode then streams 1.0
    byte/weight and the row scale multiplies the [T, O] output; prefill feeds
    the int8 values straight to an int8 GEMM (ops/gemm.py). Rounding: half
    away from zero against the row max / 127. Output is canonical.

    Computed in torch one leading index at a time (a layer of a [L, O, I] or
    [L, E, O, I] stack) to bound the f32 working set; every step is an IEEE
    f32 operation, so the values are bit-equal to the JAX package's numpy on
    any device. device None: on the CPU, returning numpy arrays; a device:
    computed there, returning tensors on it (an MoE model's expert stacks are
    ~12 G weights: the card converts them in seconds)."""
    assert w.kind == "q8_0", f"rowq_requant: want q8_0, got {w.kind}"
    assert w.offs is None
    qs = w.qs
    if w.layout == "interleaved":
        qs = deinterleave_columns(_np(qs))
    else:
        assert w.layout == "canonical", "rowq_requant: packed4 is Q4_0-only"
    dev = torch.device("cpu" if device is None else device)
    qs = torch.as_tensor(qs)
    scales = torch.as_tensor(_np(w.scales)) if not isinstance(w.scales, torch.Tensor) else w.scales
    out_q = torch.empty(qs.shape, dtype=torch.int8, device=dev)
    out_s = torch.empty((*qs.shape[:-1], 1), dtype=torch.float32, device=dev)
    chunks = range(qs.shape[0]) if qs.ndim > 2 else [slice(None)]
    for l in chunks:
        q, sc = qs[l].to(dev), scales[l].to(dev)
        v = q.float() * sc.float().repeat_interleave(BLOCK, dim=-1)
        out_q[l], out_s[l] = _rowq_from_f32(v)
    if device is None:
        return QTensor(out_q.numpy(), out_s.numpy(), kind="q8_row", logical_out=w.logical_out,
                       layout="canonical")
    return QTensor(out_q, out_s, kind="q8_row", logical_out=w.logical_out, layout="canonical")


def _rowq_from_f32(v):
    """[..., O, I] f32 -> (int8 [..., O, I], f32 [..., O, 1]) per-out-row
    symmetric quant: r = max|v| / 127, q = trunc(v / r + copysign(0.5)) with
    v / r taken as v * (1 / r). torch tensors, or numpy arrays (converted).
    r and 1 / r are taken on the CPU from the (exact) row max: CUDA divides
    by a scalar as a product with its rounded reciprocal, 1 ulp off."""
    if isinstance(v, np.ndarray):
        q, r = _rowq_from_f32(torch.from_numpy(v))
        return q.numpy(), r.numpy()
    r = v.abs().amax(dim=-1, keepdim=True).cpu() / 127.0
    one = torch.ones_like(r)
    inv = torch.where(r > 0, one / torch.where(r > 0, r, one), torch.zeros_like(r))
    s = v * inv.to(v.device)
    q = torch.trunc(s + torch.copysign(torch.full_like(s, 0.5), s)).to(torch.int8)
    return q, r.to(v.device)


def _col_eq_scale(v: torch.Tensor, clip: float = 4.0) -> torch.Tensor:
    """Per-input-column equalization scale: s_j = sqrt(colamax_j / gmean),
    clipped. Dividing W's columns by s flattens outlier input channels so the
    per-ROW amax no longer coarsens every other weight in the row. v: f32
    [rows, cols] on any device (the column amax is exact everywhere); the
    rest is numpy on the [cols] vector, returned on v's device."""
    a = v.abs().amax(dim=0).cpu().numpy()
    pos = a[a > 0]
    if pos.size == 0:
        return np.ones_like(a)
    g = np.exp(np.mean(np.log(pos)))
    s = np.sqrt(np.where(a > 0, a, g) / g)
    return torch.from_numpy(np.clip(s, 1.0 / clip, clip).astype(np.float32)).to(v.device)


def equalize_rowq_layers(layers: dict, device: str | torch.device | None = None) -> dict:
    """Equalized q8_row (exact algebra, no runtime cost): before the per-row
    requant, divide each matmul's input columns by an equalization scale and
    fold the inverse into the op that produces its input —

      wqkv columns -> attn_norm rows   (x enters wqkv straight from rmsnorm)
      w13 columns  -> ffn_norm rows
      w2 columns   -> w13's UP rows    (act = silu(gate) * up is linear in up)

    wo and the vocab head keep plain `rowq_requant`. Input: a stacked layers
    dict, fused (wqkv/w13/w2) or unfused (wq/wk/wv/w1/w3/w2), with
    attn_norm/ffn_norm [L, D]. Returns a new dict with those matmuls as
    q8_row QTensors and the norms scaled; a dict that does not qualify, or
    any dict while LLAMATPU_NO_ROWQ_EQ is set (plain per-row requant, as in
    the JAX package), comes back unchanged.

    The matrices are computed one layer at a time in torch on `device`
    (None: the CPU, returning numpy arrays; a device: tensors on it): every
    step is an elementwise IEEE f32 product or quotient of tensors, or a
    max, so the values equal the JAX package's numpy on any device; the
    scale vectors' log/exp arithmetic stays in numpy (`_col_eq_scale`)."""
    fused = all(k in layers for k in ("wqkv", "w13"))
    qkv_keys = ("wqkv",) if fused else ("wq", "wk", "wv")
    ffn_keys = ("w13",) if fused else ("w1", "w3")
    mm_keys = qkv_keys + ffn_keys + ("w2",)
    need = mm_keys + ("attn_norm", "ffn_norm")
    if os.environ.get("LLAMATPU_NO_ROWQ_EQ") or not all(k in layers for k in need):
        return layers
    for k in mm_keys:
        t = layers[k]
        if not (isinstance(t, QTensor) and t.kind == "q8_0" and t.offs is None
                and t.layout in ("canonical", "interleaved")):
            return layers
    L = layers["w2"].qs.shape[0]
    f = layers["w2"].qs.shape[-1]
    if fused and layers["w13"].qs.shape[-2] != 2 * f:
        return layers  # padded fused stack: fold mapping ambiguous
    dev = torch.device("cpu" if device is None else device)
    out = dict(layers)

    def deq(t: QTensor, l: int) -> torch.Tensor:
        qs = _np(t.qs)[l]
        if t.layout == "interleaved":
            qs = deinterleave_columns(qs)
        o, i = qs.shape
        scales = torch.from_numpy(np.ascontiguousarray(_np(t.scales)[l])).to(dev)
        q = torch.from_numpy(np.ascontiguousarray(qs)).to(dev).float().view(o, i // BLOCK, BLOCK)
        return (q * scales[..., None]).view(o, i)

    an = np.array(_np(layers["attn_norm"]), np.float32, copy=True)
    fn = np.array(_np(layers["ffn_norm"]), np.float32, copy=True)
    res = {k: (torch.empty(tuple(layers[k].shape), dtype=torch.int8, device=dev),
               torch.empty((*layers[k].shape[:-1], 1), dtype=torch.float32, device=dev))
           for k in mm_keys}

    def push(k, l, v):
        res[k][0][l], res[k][1][l] = _rowq_from_f32(v)

    for l in range(L):
        v2 = deq(layers["w2"], l)            # [D, F]
        s_f = _col_eq_scale(v2)
        push("w2", l, v2 / s_f[None, :])
        ffn = {k: deq(layers[k], l) for k in ffn_keys}
        # up rows absorb w2's fold; only the logical rows (padded rows are 0)
        if fused:
            ffn["w13"][f:] *= s_f[:, None]
        else:
            ffn["w3"][:f] *= s_f[:, None]
        s_d2 = _col_eq_scale(torch.cat(list(ffn.values())))
        fn[l] *= s_d2.cpu().numpy()
        for k in ffn_keys:
            push(k, l, ffn[k] / s_d2[None, :])
        qkv = {k: deq(layers[k], l) for k in qkv_keys}
        s_d = _col_eq_scale(torch.cat(list(qkv.values())))
        an[l] *= s_d.cpu().numpy()
        for k in qkv_keys:
            push(k, l, qkv[k] / s_d[None, :])
    for k, (q, r) in res.items():
        if device is None:
            q, r = q.numpy(), r.numpy()
        out[k] = QTensor(q, r, kind="q8_row", logical_out=layers[k].logical_out,
                         layout="canonical")
    out["attn_norm"] = an.astype(_np(layers["attn_norm"]).dtype)
    out["ffn_norm"] = fn.astype(_np(layers["ffn_norm"]).dtype)
    return out


_EXPERT_KEYS = ("gate_exps", "up_exps", "gu_exps", "down_exps")


def rowq_convert_weights(weights: dict, experts: bool = True,
                         device: str | torch.device | None = None) -> dict:
    """Convert every Q8_0 QTensor of a (fused) weights tree to q8_row:
    equalized for wqkv/w13/w2, plain `rowq_requant` for the rest (wo, the
    vocab head, an MoE model's shared expert and, with experts=True, its
    routed expert stacks: K12 serves them). device: where the conversion is
    computed and its results live (see `rowq_requant`)."""
    skip = () if experts else _EXPERT_KEYS
    eq_layers = equalize_rowq_layers(weights["layers"], device)
    converted = sum(1 for k in ("wqkv", "w13", "w2")
                    if isinstance(eq_layers.get(k), QTensor)
                    and eq_layers[k].kind == "q8_row")
    layers = {}
    for k, v in eq_layers.items():
        if k not in skip and isinstance(v, QTensor) and v.kind == "q8_0":
            v = rowq_requant(v, device)
            converted += 1
        layers[k] = v
    out = dict(weights)
    out["layers"] = layers
    if isinstance(out.get("wcls"), QTensor) and out["wcls"].kind == "q8_0":
        out["wcls"] = rowq_requant(out["wcls"], device)
        converted += 1
    if not converted:
        warnings.warn(
            "rowq had no effect: no Q8_0 tensors in the checkpoint (q8_row is "
            "a Q8_0 requant format)", stacklevel=2)
    return out


def _concat_rows(ts: list[QTensor]) -> QTensor:
    if isinstance(ts[0].qs, torch.Tensor):  # a tree already on a device
        def cat(parts):
            return torch.cat(parts, dim=-2)
    else:
        def cat(parts):
            return np.concatenate([_np(a) for a in parts], axis=-2)
    offs = None if ts[0].offs is None else cat([t.offs for t in ts])
    return QTensor(cat([t.qs for t in ts]), cat([t.scales for t in ts]), ts[0].kind,
                   logical_out=0, layout=ts[0].layout, offs=offs)


def _fusable(ts: list[QTensor]) -> bool:
    return (all(isinstance(t, QTensor) for t in ts)
            and len({t.kind for t in ts}) == 1
            and len({t.offs is None for t in ts}) == 1
            and len({t.layout for t in ts}) == 1
            and all(not t.logical_out for t in ts)
            and len({t.qs.shape[-1] for t in ts}) == 1)


def _dense_fusable(ts) -> bool:
    """Dense stacks (F32/F16/BF16 checkpoints) of one type and in-width."""
    return (len({type(t) for t in ts}) == 1 and isinstance(ts[0], (np.ndarray, torch.Tensor))
            and len({t.dtype for t in ts}) == 1 and len({t.shape[-1] for t in ts}) == 1)


def _qt_parts(t: QTensor):
    """(qs, scales, offs or None) as numpy."""
    return _np(t.qs), _np(t.scales), None if t.offs is None else _np(t.offs)


def _filled(shape, dtype, pieces) -> np.ndarray:
    """One array of `shape` filled from (index, part) pieces: a stack built
    with a single copy of its parts."""
    out = np.empty(shape, dtype)
    for idx, part in pieces:
        out[idx] = part
    return out


def _shared_chunks(layers: dict, s: int, mh: int) -> dict:
    """The shared expert as S virtual experts of routed geometry: gate/up
    rows [L, S*MH, D] -> [L, S, MH, D] and down columns [L, D, S*MH] ->
    [L, S, D, MH], cut in canonical column space (a packed4 byte holds two
    adjacent columns, so chunks of MH columns are MH/2 bytes), as
    (qs, scales, offs) views (offs None for kinds without offsets)."""
    out = {}
    for k in ("shared_gate", "shared_up"):
        out[k] = tuple(None if a is None else a.reshape(a.shape[0], s, mh, a.shape[-1])
                       for a in _qt_parts(layers[k]))
    out["shared_down"] = tuple(
        None if a is None else a.reshape(*a.shape[:2], s, a.shape[-1] // s).transpose(0, 2, 1, 3)
        for a in _qt_parts(layers["shared_down"]))
    return out


def _expert_cat(parts, extras, n: int, e: int, s: int):
    """Each part [L, E, ...] followed by its extra [L, S, ...] along the
    expert axis, one copy each (None where the kind has no offsets)."""
    return [None if a is None else
            _filled((n, e + s, *a.shape[2:]), a.dtype, [(np.s_[:, :e], a), (np.s_[:, e:], c)])
            for a, c in zip(parts, extras)]


def _foldable(cfg, layers: dict) -> int:
    """S, the shared expert's chunks of routed geometry, or 0 where the stacks
    do not fold: the LLAMATPU_NO_SHARED_FOLD escape hatch (read under the JAX
    package's name), missing or dense stacks, mixed kinds or layouts, padded
    rows, or a shared hidden size that is not a multiple of the routed one."""
    need = ("gate_exps", "up_exps", "down_exps", "shared_gate", "shared_up", "shared_down")
    if os.environ.get("LLAMATPU_NO_SHARED_FOLD") or not all(k in layers for k in need):
        return 0
    ts = [layers[k] for k in need]
    if not all(isinstance(t, QTensor) for t in ts):
        return 0
    if len({t.kind for t in ts}) != 1 or len({t.layout for t in ts}) != 1 \
            or any(t.logical_out for t in ts):
        return 0
    mh, sh = ts[0].qs.shape[-2], ts[3].qs.shape[-2]
    if mh == 0 or sh % mh or mh % BLOCK:
        return 0
    return sh // mh


def fold_shared_expert(cfg, layers: dict) -> dict:
    """Fold the always-on shared expert into the routed expert stacks as
    S = hidden_dim / moe_hidden_dim VIRTUAL experts (Qwen1.5-MoE: 5632/1408 =
    4), experts E..E+S-1, each routed to by every token with the sigmoid
    shared-gate weight (models/transformer.py `_moe_ffn`). Exact: silu and
    the product are elementwise, so gate/up rows partition, and the down
    projection's partial sums over column chunks add up. Stacks that do not
    fold come back unchanged (`_foldable`)."""
    s = _foldable(cfg, layers)
    if not s:
        return layers
    mh = layers["gate_exps"].qs.shape[-2]
    chunks = _shared_chunks(layers, s, mh)
    out = dict(layers)
    for k, sk in (("gate_exps", "shared_gate"), ("up_exps", "shared_up"),
                  ("down_exps", "shared_down")):
        t = layers[k]
        n, e = t.qs.shape[:2]
        qs, sc, offs = _expert_cat(_qt_parts(t), chunks[sk], n, e, s)
        out[k] = QTensor(qs, sc, t.kind, layout=t.layout, offs=offs)
        del out[sk]
    return out


def _fold_and_fuse_experts(cfg, layers: dict) -> dict:
    """fold_shared_expert then the gate+up row concat, built as one gu_exps
    stack [L, E+S, 2*MH, D] with a single copy of its parts (at Qwen1.5-MoE
    width the stacks are ~12 G weights: no intermediate folded gate/up)."""
    s = _foldable(cfg, layers)
    if not s:
        return layers
    out = dict(layers)
    g, u = layers["gate_exps"], layers["up_exps"]
    n, e, mh = g.qs.shape[:3]
    chunks = _shared_chunks(layers, s, mh)

    def fused(a, b, ca, cb):
        if a is None:
            return None
        return _filled((n, e + s, 2 * mh, a.shape[-1]), a.dtype,
                       [(np.s_[:, :e, :mh], a), (np.s_[:, e:, :mh], ca),
                        (np.s_[:, :e, mh:], b), (np.s_[:, e:, mh:], cb)])

    gu = [fused(*parts) for parts in zip(_qt_parts(g), _qt_parts(u), chunks["shared_gate"],
                                         chunks["shared_up"])]
    out["gu_exps"] = QTensor(gu[0], gu[1], g.kind, layout=g.layout, offs=gu[2])
    d = layers["down_exps"]
    dq, ds, doffs = _expert_cat(_qt_parts(d), chunks["shared_down"], n, e, s)
    out["down_exps"] = QTensor(dq, ds, d.kind, layout=d.layout, offs=doffs)
    for k in ("gate_exps", "up_exps", "shared_gate", "shared_up", "shared_down"):
        del out[k]
    return out


def fuse_layer_weights(cfg, weights: dict) -> dict:
    """Fuse projections sharing an input into one wider matmul: wq+wk+wv ->
    wqkv, w1+w3 -> w13 and, for MoE, the shared expert's gate+up ->
    shared_g13 and the routed gate+up stacks -> gu_exps (row concats,
    bit-exact; the forward splits the output columns; block-quant and
    packed4 rows are independent too). An MoE model's shared expert is
    folded into the routed stacks first where it folds
    (`fold_shared_expert`), and its shared_* keys are then gone. Dense
    F32/F16/BF16 projections fuse the same way, where the JAX package leaves
    them unfused (the same values either way). Native K-quant expert stacks
    get their offsets padded for K13 (`pad_offsets`), and Qwen3's q_norm /
    k_norm become one per-head stack, qk_norm (`_stack_qk_norm`)."""
    layers = dict(weights["layers"])
    if getattr(cfg, "is_moe", False):
        layers = _fold_and_fuse_experts(cfg, layers)
    for fused, parts in (("wqkv", ("wq", "wk", "wv")), ("w13", ("w1", "w3")),
                         ("shared_g13", ("shared_gate", "shared_up")),
                         ("gu_exps", ("gate_exps", "up_exps"))):
        ts = [layers.get(k) for k in parts]
        if any(t is None for t in ts):
            continue
        if _fusable(ts):
            layers[fused] = _concat_rows(ts)
        elif _dense_fusable(ts):
            layers[fused] = (torch.cat(ts, dim=-2) if isinstance(ts[0], torch.Tensor)
                             else np.concatenate(ts, axis=-2))
        else:
            continue
        for k in parts:
            del layers[k]
    for k in ("gate_exps", "up_exps", "down_exps", "gu_exps"):
        if isinstance(layers.get(k), QTensor):
            layers[k] = pad_offsets(layers[k])
    if getattr(cfg, "qk_norm", False) and "q_norm" in layers:
        layers["qk_norm"] = _stack_qk_norm(cfg, layers.pop("q_norm"), layers.pop("k_norm"))
    out = dict(weights)
    out["layers"] = layers
    return out


def pad_offsets(t: QTensor) -> QTensor:
    """An expert stack whose offsets [..., O, I/32] are zero-padded to a
    width % 32 == 0, the contraction widths K13 takes (the experts' offset
    term, `moe_grouped.grouped_offset_term`; Qwen1.5-MoE's down projection
    1408 / 32 = 44 -> 64). Zero columns add nothing to the term."""
    if t.offs is None or t.offs.shape[-1] % BLOCK == 0:
        return t
    pad = -t.offs.shape[-1] % BLOCK
    if isinstance(t.offs, torch.Tensor):
        return replace(t, offs=torch.nn.functional.pad(t.offs, (0, pad)))
    return replace(t, offs=np.pad(t.offs, [(0, 0)] * (t.offs.ndim - 1) + [(0, pad)]))


def _stack_qk_norm(cfg, q, k):
    """Qwen3's q_norm / k_norm [L, hd] -> qk_norm [L, H + KV, hd]: row h of
    a layer norms head h of the projection's q heads then k heads, so the
    forward norms them in one op with no per-step concat."""
    n, hd = q.shape
    parts = ((q, cfg.n_heads), (k, cfg.n_kv_heads))
    if isinstance(q, torch.Tensor):
        return torch.cat([a[:, None].expand(n, h, hd) for a, h in parts], dim=1)
    return np.concatenate([np.broadcast_to(np.asarray(a)[:, None], (n, h, hd))
                           for a, h in parts], axis=1)


def _to_torch(a, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, read by dtype name so the port
    never imports it) or torch -> torch tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. jax.device_get's buffers
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return replace(tree, qs=_to_torch(tree.qs, device),
                       scales=_to_torch(tree.scales, device),
                       offs=None if tree.offs is None else _to_torch(tree.offs, device))
    return _to_torch(tree, device)


def serving_weights(cfg, weights: dict, rowq: bool = False,
                    device: str | torch.device = "cuda", rowq_experts: bool | None = None) -> dict:
    """Load-time weight prep: fuse per-layer projections (folding an MoE
    model's shared expert), optionally requantize Q8_0 to q8_row (on
    `device`, bit-exact with the JAX package), then move the tree to
    `device` as torch tensors. rowq=False serves the block quants as loaded
    (q8_0 / q4_0 / packed4). rowq_experts: also convert the MoE routed
    expert stacks (default: follow `rowq`)."""
    w = fuse_layer_weights(cfg, weights)
    if rowq:
        w = rowq_convert_weights(w, experts=rowq_experts is not False, device=device)
    return tree_to(w, device)


def from_numpy_weights(tree: dict, device: str | torch.device = "cpu") -> dict:
    """The weights bridge: the JAX package's parameters (its raw synthetic
    dict, its `load_model(..., device_put=False)` tree, or its
    `serving_weights(...)` after `jax.device_get`) -> the port's tree on
    `device`. A QTensor is recognised and read by its field names, never by
    its class; interleaved values are de-interleaved and the JAX package's
    packed4 (column halves) is unpacked and re-packed as the port's adjacent
    pairs, so both packages hold the same values."""
    if isinstance(tree, dict):
        return {k: from_numpy_weights(v, device) for k, v in tree.items()}
    if all(hasattr(tree, f) for f in ("qs", "scales", "kind", "layout")):
        qs = np.asarray(tree.qs)
        layout = "canonical"
        if tree.layout == "packed4":
            qs = pack4_pairs(deinterleave_columns(_unpack4_halves(qs)))
            layout = "packed4"
        elif tree.layout == "interleaved":
            qs = deinterleave_columns(qs)
        offs = getattr(tree, "offs", None)  # canonical block order in both packages
        return QTensor(_to_torch(qs, device), _to_torch(np.asarray(tree.scales), device),
                       tree.kind, int(tree.logical_out), layout,
                       None if offs is None else _to_torch(np.asarray(offs), device))
    return _to_torch(np.asarray(tree), device)
