"""Weight containers, the load-time transforms of the serving paths, and the
bridge from the JAX package's parameters.

A QTensor of logical shape [out, in] stores

    qs:     int8 [..., out, in]        values: Q8_0 in [-127, 127], Q4_0 in
                                       [-8, 7] (canonical column order)
            int8 [..., out, in // 2]   layout "packed4" (Q4_0): byte c holds
                                       canonical columns 2c (low nibble) and
                                       2c + 1 (high nibble), two's complement
    scales: f32  [..., out, in // 32]  for "q8_0" / "q4_0" (ggml block scales)
            f32  [..., out, 1]         for "q8_row" (one scale per out row)

Leading dims stack layers ([L, ...]). At load time the fields are numpy
arrays and every transform here is numpy, so the port's served weights equal
the JAX package's bit for bit (tests/test_torch_weights.py,
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

import warnings
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

BLOCK = 32  # ggml Q8_0 block size


@dataclass
class QTensor:
    """Quantized tensor: int8 values plus f32 scales (see module docstring).

    kind: "q8_0" / "q4_0" (per-32 block scales) | "q8_row" (per-out-row
    scales). logical_out: real out-features when rows are zero-padded (0 =
    all rows are real). layout: "canonical", "packed4" (Q4_0 only) or, for
    tensors taken from the JAX package before `from_numpy_weights`,
    "interleaved". offs: per-32 additive offsets of native K-quants (the
    quant-breadth slice; always None here)."""

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


def rowq_requant(w: QTensor) -> QTensor:
    """Requantize a Q8_0 tensor to per-OUT-ROW int8 (`q8_row`): one f32 scale
    per output row instead of one per 32 inputs. Decode then streams 1.0
    byte/weight and the row scale multiplies the [T, O] output; prefill feeds
    the int8 values straight to an int8 GEMM (ops/gemm.py). Rounding: half
    away from zero against the row max / 127. Layer by layer to bound the f32
    working set. Output is canonical."""
    assert w.kind == "q8_0", f"rowq_requant: want q8_0, got {w.kind}"
    assert w.offs is None
    qs = _np(w.qs)
    scales = _np(w.scales)
    if w.layout == "interleaved":
        qs = deinterleave_columns(qs)
    else:
        assert w.layout == "canonical", "rowq_requant: packed4 is Q4_0-only"
    lead = qs.shape[:-2]
    qs2 = qs.reshape(-1, *qs.shape[-2:])
    sc2 = scales.reshape(-1, *scales.shape[-2:])
    out_q = np.empty_like(qs2)
    out_s = np.empty((qs2.shape[0], qs2.shape[1], 1), np.float32)
    for l in range(qs2.shape[0]):
        v = qs2[l].astype(np.float32) * np.repeat(sc2[l], BLOCK, axis=-1)
        out_q[l], out_s[l] = _rowq_from_f32(v)
    return QTensor(out_q.reshape(*lead, *qs.shape[-2:]),
                   out_s.reshape(*lead, qs.shape[-2], 1),
                   kind="q8_row", logical_out=w.logical_out, layout="canonical")


def _rowq_from_f32(v: np.ndarray):
    """[O, I] f32 -> (int8 [O, I], f32 [O, 1]) per-out-row symmetric quant."""
    r = np.max(np.abs(v), axis=-1, keepdims=True) / 127.0
    inv = np.where(r > 0, 1.0 / np.where(r > 0, r, 1.0), 0.0)
    s = v * inv
    q = np.trunc(s + np.copysign(0.5, s)).astype(np.int8)
    return q, r.astype(np.float32)


def _col_eq_scale(v: np.ndarray, clip: float = 4.0) -> np.ndarray:
    """Per-input-column equalization scale: s_j = sqrt(colamax_j / gmean),
    clipped. Dividing W's columns by s flattens outlier input channels so the
    per-ROW amax no longer coarsens every other weight in the row."""
    a = np.max(np.abs(v), axis=0)
    pos = a[a > 0]
    if pos.size == 0:
        return np.ones_like(a)
    g = np.exp(np.mean(np.log(pos)))
    s = np.sqrt(np.where(a > 0, a, g) / g)
    return np.clip(s, 1.0 / clip, clip).astype(np.float32)


def equalize_rowq_layers(layers: dict) -> dict:
    """Equalized q8_row (exact algebra, no runtime cost): before the per-row
    requant, divide each matmul's input columns by an equalization scale and
    fold the inverse into the op that produces its input —

      wqkv columns -> attn_norm rows   (x enters wqkv straight from rmsnorm)
      w13 columns  -> ffn_norm rows
      w2 columns   -> w13's UP rows    (act = silu(gate) * up is linear in up)

    wo and the vocab head keep plain `rowq_requant`. Input: a stacked layers
    dict, fused (wqkv/w13/w2) or unfused (wq/wk/wv/w1/w3/w2), with
    attn_norm/ffn_norm [L, D]. Returns a new dict with those matmuls as
    q8_row QTensors and the norms scaled; a dict that does not qualify comes
    back unchanged."""
    fused = all(k in layers for k in ("wqkv", "w13"))
    qkv_keys = ("wqkv",) if fused else ("wq", "wk", "wv")
    ffn_keys = ("w13",) if fused else ("w1", "w3")
    mm_keys = qkv_keys + ffn_keys + ("w2",)
    need = mm_keys + ("attn_norm", "ffn_norm")
    if not all(k in layers for k in need):
        return layers
    for k in mm_keys:
        t = layers[k]
        if not (isinstance(t, QTensor) and t.kind == "q8_0" and t.offs is None
                and t.layout in ("canonical", "interleaved")):
            return layers
    out = dict(layers)

    def deq(t: QTensor, l: int) -> np.ndarray:
        qs = _np(t.qs)[l]
        if t.layout == "interleaved":
            qs = deinterleave_columns(qs)
        return qs.astype(np.float32) * np.repeat(_np(t.scales)[l], BLOCK, axis=-1)

    L = layers["w2"].qs.shape[0]
    f = layers["w2"].qs.shape[-1]
    an = np.array(_np(layers["attn_norm"]), np.float32, copy=True)
    fn = np.array(_np(layers["ffn_norm"]), np.float32, copy=True)
    parts = {k: ([], []) for k in mm_keys}

    def push(k, v):
        q, r = _rowq_from_f32(v)
        parts[k][0].append(q)
        parts[k][1].append(r)

    for l in range(L):
        v2 = deq(layers["w2"], l)            # [D, F]
        s_f = _col_eq_scale(v2)
        v2 = v2 / s_f[None, :]
        push("w2", v2)
        ffn = {k: deq(layers[k], l) for k in ffn_keys}
        # up rows absorb w2's fold; only the logical rows (padded rows are 0)
        if fused:
            if ffn["w13"].shape[0] != 2 * f:
                return layers  # padded fused stack: fold mapping ambiguous
            ffn["w13"][f:] *= s_f[:, None]
        else:
            ffn["w3"][:f] *= s_f[:, None]
        s_d2 = _col_eq_scale(np.concatenate(list(ffn.values()), axis=0))
        fn[l] *= s_d2
        for k in ffn_keys:
            push(k, ffn[k] / s_d2[None, :])
        qkv = {k: deq(layers[k], l) for k in qkv_keys}
        s_d = _col_eq_scale(np.concatenate(list(qkv.values()), axis=0))
        an[l] *= s_d
        for k in qkv_keys:
            push(k, qkv[k] / s_d[None, :])
    for k in mm_keys:
        out[k] = QTensor(np.stack(parts[k][0]), np.stack(parts[k][1]),
                         kind="q8_row", logical_out=layers[k].logical_out,
                         layout="canonical")
    out["attn_norm"] = an.astype(_np(layers["attn_norm"]).dtype)
    out["ffn_norm"] = fn.astype(_np(layers["ffn_norm"]).dtype)
    return out


def rowq_convert_weights(weights: dict) -> dict:
    """Convert every Q8_0 QTensor of a (fused) dense weights tree to q8_row:
    equalized for wqkv/w13/w2, plain `rowq_requant` for the rest (wo, the
    vocab head)."""
    eq_layers = equalize_rowq_layers(weights["layers"])
    converted = sum(1 for k in ("wqkv", "w13", "w2")
                    if isinstance(eq_layers.get(k), QTensor)
                    and eq_layers[k].kind == "q8_row")
    layers = {}
    for k, v in eq_layers.items():
        if isinstance(v, QTensor) and v.kind == "q8_0":
            v = rowq_requant(v)
            converted += 1
        layers[k] = v
    out = dict(weights)
    out["layers"] = layers
    if isinstance(out.get("wcls"), QTensor) and out["wcls"].kind == "q8_0":
        out["wcls"] = rowq_requant(out["wcls"])
        converted += 1
    if not converted:
        warnings.warn(
            "rowq had no effect: no Q8_0 tensors in the checkpoint (q8_row is "
            "a Q8_0 requant format)", stacklevel=2)
    return out


def _concat_rows(ts: list[QTensor]) -> QTensor:
    if isinstance(ts[0].qs, torch.Tensor):  # a tree already on a device
        qs = torch.cat([t.qs for t in ts], dim=-2)
        scales = torch.cat([t.scales for t in ts], dim=-2)
    else:
        qs = np.concatenate([_np(t.qs) for t in ts], axis=-2)
        scales = np.concatenate([_np(t.scales) for t in ts], axis=-2)
    return QTensor(qs, scales, ts[0].kind, logical_out=0, layout=ts[0].layout)


def _fusable(ts: list[QTensor]) -> bool:
    return (all(isinstance(t, QTensor) for t in ts)
            and len({t.kind for t in ts}) == 1
            and all(t.offs is None for t in ts)
            and len({t.layout for t in ts}) == 1
            and all(not t.logical_out for t in ts)
            and len({t.qs.shape[-1] for t in ts}) == 1)


def _dense_fusable(ts) -> bool:
    """Dense stacks (F32/F16/BF16 checkpoints) of one type and in-width."""
    return (len({type(t) for t in ts}) == 1 and isinstance(ts[0], (np.ndarray, torch.Tensor))
            and len({t.dtype for t in ts}) == 1 and len({t.shape[-1] for t in ts}) == 1)


def fuse_layer_weights(cfg, weights: dict) -> dict:
    """Fuse projections sharing an input into one wider matmul: wq+wk+wv ->
    wqkv and w1+w3 -> w13 (a row concat, bit-exact; the forward splits the
    output columns; block-quant and packed4 rows are independent too). Dense
    F32/F16/BF16 projections fuse the same way, where the JAX package leaves
    them unfused (the same values either way). Dense (not MoE) models only
    in this slice."""
    if getattr(cfg, "is_moe", False):
        raise NotImplementedError("MoE weights: MoE slice of the port")
    layers = dict(weights["layers"])
    for fused, parts in (("wqkv", ("wq", "wk", "wv")), ("w13", ("w1", "w3"))):
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
    out = dict(weights)
    out["layers"] = layers
    return out


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
                       scales=_to_torch(tree.scales, device))
    return _to_torch(tree, device)


def serving_weights(cfg, weights: dict, rowq: bool = False,
                    device: str | torch.device = "cuda") -> dict:
    """Load-time weight prep: fuse per-layer projections, optionally
    requantize Q8_0 to q8_row (numpy, bit-exact with the JAX package), then
    move the tree to `device` as torch tensors. rowq=False serves the block
    quants as loaded (q8_0 / q4_0 / packed4)."""
    w = fuse_layer_weights(cfg, weights)
    if rowq:
        w = rowq_convert_weights(w)
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
        if getattr(tree, "offs", None) is not None:
            raise NotImplementedError(f"{tree.kind} weights with offsets: quant-breadth slice")
        qs = np.asarray(tree.qs)
        layout = "canonical"
        if tree.layout == "packed4":
            qs = pack4_pairs(deinterleave_columns(_unpack4_halves(qs)))
            layout = "packed4"
        elif tree.layout == "interleaved":
            qs = deinterleave_columns(qs)
        return QTensor(_to_torch(qs, device), _to_torch(np.asarray(tree.scales), device),
                       tree.kind, int(tree.logical_out), layout)
    return _to_torch(np.asarray(tree), device)
