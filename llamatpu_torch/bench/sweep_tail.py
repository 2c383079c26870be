"""The layer tail's w2 layout, K9 against K16: the port of scripts/sweep_tail.py.

K9 (`_tail_kernel`'s port) streams w2 as output rows; K16 (`_tail_kernel_kt`'s)
as contraction tiles [D, tf] summed in f32. Both run through
`ops.layer_fused.layer_tail_fused_rowq`, whose module flag `_W2_KTILE`
selects K16 (restored after the sweep). For each variant the harness runs
`repeat` passes over every layer of the preset's stacked q8_row wo / w13 /
w2 (random, from a seed, made on the device), all captured in one CUDA graph
and replayed between CUDA events, and prints one JSON row as the script
does: ms per layer, ms per token (all layers) and the weight stream's GB/s.
It asserts that the variant's kernel's count grew by the launches issued and
the other's not at all. The script chained each layer's output into the next input
(x + 1e-6 y); here the calls stay independent (the graph runs them in
order) so no elementwise pass is timed with them.

    python -m llamatpu_torch.bench.sweep_tail [--preset llama32-1b] [--rows 1]
    python -m llamatpu_torch.bench.sweep_tail --device cpu --dim 256 --hidden 512 --layers 2 --repeat 2
"""
from __future__ import annotations

import argparse
import json

import torch

from llamatpu_torch.bench.roofline import time_run
from llamatpu_torch.models.synthetic import PRESETS
from llamatpu_torch.models.weights import QTensor
from llamatpu_torch.ops import layer_fused


def rand_rowq(layers: int, o: int, i: int, gen, device) -> QTensor:
    """Stacked q8_row weights whose projection keeps unit variance."""
    qs = torch.randint(-127, 128, (layers, o, i), dtype=torch.int8, generator=gen, device=device)
    s = (torch.rand((layers, o, 1), generator=gen, device=device) + 0.5) / (73.6 * i ** 0.5)
    return QTensor(qs, s, "q8_row")


def make_tail(layers: int, d: int, h: int, f: int, rows: int, device, seed: int = 0) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    return {"wo": rand_rowq(layers, d, h, g, device), "w13": rand_rowq(layers, 2 * f, d, g, device),
            "w2": rand_rowq(layers, d, f, g, device),
            "n": torch.ones((layers, d), device=device),
            "x": torch.zeros((rows, d), device=device).to(torch.bfloat16),
            "attn": (torch.ones((rows, h), device=device) * 0.01).to(torch.bfloat16)}


def sweep(st: dict, repeat: int, device) -> list[dict]:
    """One row per variant (w2_outtile = K9, w2_ktile = K16)."""
    layers, d, h = st["wo"].qs.shape
    nbytes = sum(st[k].qs[0].numel() for k in ("wo", "w13", "w2"))  # one layer's weights
    kernels = {False: layer_fused.layer_tail_fused_rowq, True: layer_fused.layer_tail_kt_fused_rowq}
    saved = layer_fused._W2_KTILE
    rows = []
    try:
        for kt in (False, True):
            layer_fused._W2_KTILE = kt
            before = {kt_: k.launches for kt_, k in kernels.items()}

            def run():
                for _ in range(repeat):
                    for li in range(layers):
                        layer_fused.layer_tail_fused_rowq(st["wo"], st["w13"], st["w2"], st["n"],
                                                          st["attn"], st["x"], li, 1e-5, 1.0)
            secs = time_run(run, device)
            calls = 0 if device.type == "cpu" else 2 * repeat * layers  # warm-up + capture
            got = {kt_: k.launches - before[kt_] for kt_, k in kernels.items()}
            assert got == {kt: calls, not kt: 0}, f"w2_ktile={kt}: launches {got}, issued {calls}"
            per = secs / (layers * repeat)
            rows.append({"bench": "sweep_tail", "variant": "w2_ktile" if kt else "w2_outtile",
                         "device": str(device), "T": st["x"].shape[0], "L": layers,
                         "D": d, "H": h, "F": st["w2"].qs.shape[-1],
                         "ms_per_layer": per * 1e3, "ms_per_tok": per * layers * 1e3,
                         "gbs": nbytes / per / 1e9, "launches": got[kt]})
    finally:
        layer_fused._W2_KTILE = saved
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="layer tail w2 layout sweep: K9 against K16")
    ap.add_argument("--preset", default="llama32-1b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=1, help="activation rows T (<= 32)")
    ap.add_argument("--repeat", type=int, default=32)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dim", type=int, default=None)
    ap.add_argument("--hidden", type=int, default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; --device cpu runs the plain versions")
    g = PRESETS[args.preset]
    layers = args.layers or g["n_layers"]
    d = args.dim or g["dim"]
    f = args.hidden or g["hidden_dim"]
    h = g["n_heads"] * g.get("head_dim", g["dim"] // g["n_heads"]) if args.dim is None else d
    st = make_tail(layers, d, h, f, args.rows, device)
    for row in sweep(st, args.repeat, device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
