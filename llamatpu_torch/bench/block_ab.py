"""K5 (`block_matmul`) and K7 (`packed4_matmul`), the GGUF block-quant
projections, timed per shape and end to end.

Per shape: the tree's chip_smoke.py `block_shapes` at Llama-3.2-1B
(wqkv [3072, 2048], wo [2048, 2048], w13 [16384, 2048], w2 [2048, 8192] and
the vocab head [128256, 2048]) at T = 1, 8 and 512 bf16 rows, Q8_0 (K5) and
Q4_0 packed two a byte (K7), random weights from a seed: `graph_ms`, the
wrapper's calls captured in a CUDA graph and replayed between CUDA events
(tail_ab.py's `graph_ms`); `bound_ms`, chip_smoke.py's `bound` of the weight
and scale bytes, x and the f32 y, and the products at the bf16 peak;
`library_ms`, bf16 `torch.matmul` against the weight dequantized
beforehand. A layer row sums the four projections. One timing method for
both trees, which chip_smoke.py's own table of a parent commit need not
share.

End to end, the GGUF paths of chip_smoke.py: the full-width, full-depth
Llama-3.2-1B Q8_0 GGUF through Engine (cache 1024, prefill chunk 512): a
512-token prefill (tok/s over three untraced runs, then one traced) and a
16-step decode window after it (decode tok/s over 64 untraced steps, then
one traced); the 4-layer Q4_0 GGUF loaded with pack4: a 128-token prefill.
A trace is read by the tree's own chip_smoke.py `device_breakdown`: device
busy ms, host wall, idle share, and the K5 / K7 kernels' ms and share of
busy.

    python -m llamatpu_torch.bench.block_ab [--label L] [--out FILE] [--variants]
    PYTHONPATH=<tree> python llamatpu_torch/bench/block_ab.py --label parent

With --variants (this tree only), the wgmma GEMM is also timed at T = 512
on wqkv, w13 and the head in copies of csrc/block_matmul.cu with one piece
taken out (VARIANTS: no dequantization, no products, no x boxes; each a
wrong result whose time bounds what the piece costs), built by nvcc into
build/block_ablation/.

It times whatever `llamatpu_torch` imports, and reads the `chip_smoke`
module beside it: with another checkout first on PYTHONPATH, that tree's
kernels and script (the first design's, for a parent commit).
The GGUF files are written once into --gguf-dir (default build/block_ab)
by the tree's chip_smoke.py `make_gguf` and read by every tree after it.
Compare trees within one call only, in turns (parent, change, change,
parent). One JSON row a measurement, each with the card's name and power
limit. Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from llamatpu_torch.bench.tail_ab import graph_ms

ROWS = (1, 8, 512)
# K5 / K7's kernels as the profiler names them, in this design and the first
BLOCK_KERNELS = ("bq_wgmma", "rtc::K5>", "rtc::K7>", "bq_gemv_kernel", "bq_gemm_kernel")


def _replace(s: str, old: str, new: str) -> str:
    if old not in s:
        raise ValueError(f"block_ab variant: {old[:60]!r} not in the source")
    return s.replace(old, new)


# name: edit of csrc/block_matmul.cu
VARIANTS = {
    "as built": None,
    # A from the raw bytes and scales: the loads stay, the arithmetic goes
    "no dequantization": lambda s: _replace(
        s, "    dequant_block<PACKED>(raw0, s0[k >> 1], af[k][0], af[k][2]);\n"
           "    dequant_block<PACKED>(raw8, s8[k >> 1], af[k][1], af[k][3]);\n",
        "    af[k][0] = raw0, af[k][2] = raw0 ^ __float_as_uint(s0[k >> 1]);\n"
        "    af[k][1] = raw8, af[k][3] = raw8 ^ __float_as_uint(s8[k >> 1]);\n"),
    # the fragments folded into the sums by one add a step instead of wgmma
    "no products": lambda s: _replace(
        s, "          wgmma_bf16(d[b], af[kk],\n"
           "                     smem_desc(st + G::xoff + (2 * b + (kk >> 2)) * kXBox) + "
           "2 * (kk & 3), 1);\n",
        "          d[b][kk] += __uint_as_float(af[kk][0] ^ af[kk][1] ^ af[kk][2] ^ af[kk][3]);\n"),
    # the x boxes not loaded: the stage's weights and scales alone
    "no x boxes": lambda s: _replace(_replace(
        s, "            tma_load_2d(st + G::xoff + b * kXBox, &mx, k * BK + 64 * (b & 1), "
           "x0 + BN * (b >> 1),\n                        &full[stage]);\n",
        "            ;\n"), "mbar_expect_tx(&full[stage], G::stage);",
        "mbar_expect_tx(&full[stage], G::xoff);"),
}
VARIANT_SHAPES = ("wqkv", "w13", "head")


def build_variants() -> dict:
    """{variant: ctypes library}: csrc/block_matmul.cu edited per VARIANTS
    (its headers from csrc/), built in parallel."""
    from llamatpu_torch import _build

    src = (_build.CSRC / "block_matmul.cu").read_text()
    out = _build.BUILD_DIR.parent / "block_ablation"
    procs = {}
    for n, (name, edit) in enumerate(VARIANTS.items()):
        vdir = out / f"v{n}"
        vdir.mkdir(parents=True, exist_ok=True)
        cu, so = vdir / "block_matmul.cu", vdir / "block_matmul.so"
        cu.write_text(edit(src) if edit else src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"block_ab variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES["block_matmul"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def variant_rows(label: str, card: str, dev, shapes: dict) -> list[dict]:
    """The wgmma GEMM at T = 512 (its route there) in each VARIANTS copy."""
    from llamatpu_torch.ops import quant_matmul as qm

    libs = build_variants()
    gen = torch.Generator(device=dev).manual_seed(23)
    rows = []
    for packed in (False, True):
        for name in VARIANT_SHAPES:
            o, i = shapes[name]
            assert qm.block_route(512, i, torch.bfloat16, packed) == "wgmma"
            w = torch.randint(-127, 128, (o, i // 2 if packed else i), dtype=torch.int8,
                              device=dev, generator=gen)
            s = torch.rand((o, i // 32), device=dev, generator=gen) * 0.001 + 0.0005
            x = torch.randn((512, i), device=dev, generator=gen).to(torch.bfloat16)
            for v, lib in libs.items():
                ms = graph_ms(lambda: qm._launch_block(x, w, s, packed, "block_ab", lib=lib),
                              4 if name == "head" else 16)
                row = dict(bench="block_ab", tree=label, variant=v, packed=packed, shape=name,
                           t=512, graph_ms=ms, card=card)
                rows.append(row)
                print(json.dumps(row), flush=True)
            del w, s, x
            torch.cuda.empty_cache()
    return rows


def kernel_rows(label: str, card: str, dev, smoke) -> list[dict]:
    from llamatpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(17)
    rows = []
    for packed in (False, True):
        kern = qm.packed4_matmul if packed else qm.block_matmul
        layer = {t: dict(graph_ms=0.0, library_ms=0.0, bound_ms=0.0) for t in ROWS}
        for name, (o, i) in smoke.block_shapes(smoke.LLAMA32_1B).items():
            if packed:
                w = torch.randint(-128, 128, (o, i // 2), dtype=torch.int8, device=dev,
                                  generator=gen)
            else:
                w = torch.randint(-127, 128, (o, i), dtype=torch.int8, device=dev, generator=gen)
            s = torch.rand((o, i // 32), device=dev, generator=gen) * 0.001 + 0.0005
            wbf = torch.randn((o, i), device=dev, generator=gen).to(torch.bfloat16)
            for t in ROWS:
                x = torch.randn((t, i), device=dev, generator=gen).to(torch.bfloat16)
                iters = 4 if name == "head" and t > 8 else 16
                wbytes = o * (i // 2 if packed else i) + o * (i // 32) * 4
                b, _ = smoke.bound(wbytes + t * i * 2 + t * o * 4, 2 * t * o * i,
                                   smoke.BF16_OPS_S)
                row = dict(bench="block_ab", tree=label, kernel=kern.__name__, shape=name,
                           o=o, i=i, t=t, graph_ms=graph_ms(lambda: kern(x, w, s), iters),
                           library_ms=graph_ms(lambda: torch.matmul(x, wbf.T), iters),
                           bound_ms=b, card=card)
                if name != "head":
                    for k in layer[t]:
                        layer[t][k] += row[k]
                rows.append(row)
                print(json.dumps(row), flush=True)
            del w, s, wbf
            torch.cuda.empty_cache()
        for t in ROWS:
            row = dict(bench="block_ab", tree=label, kernel=kern.__name__, shape="layer", t=t,
                       **layer[t], card=card)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def breakdown(smoke, fn) -> dict:
    """fn() once under the tree's device_breakdown, with K5 / K7's share."""
    tr = smoke.device_breakdown(fn)
    k = [r for r in tr["kernels"] if any(n in r["name"] for n in BLOCK_KERNELS)]
    k_ms = sum(r["ms"] for r in k)
    return dict(busy_ms=tr["busy_ms"], wall_ms=tr["wall_ms"], idle_share=tr["idle_share"],
                block_ms=k_ms, block_share=k_ms / tr["busy_ms"],
                block_launches=sum(r["count"] for r in k),
                top=[(r["name"][:60], r["ms"]) for r in tr["kernels"][:5]])


def path_rows(label: str, card: str, dev, smoke, gguf_dir: Path) -> list[dict]:
    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.runtime.engine import Engine

    gguf_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for quant, layers, pp, chunk, pack4 in (("q8_0", None, 512, 512, False),
                                            ("q4_0", 4, 128, 128, True)):
        path = gguf_dir / f"block_ab-{quant}-L{layers or 'all'}.gguf"
        if not path.exists():
            made = smoke.make_gguf(gguf_dir, quant, n_layers=layers)
            made.rename(path)
        model = load_model(str(path), max_tokens=1024, pack4=pack4)
        engine = Engine(model, cache_len=1024, prefill_chunk=chunk, decode_window=64,
                        device=dev)
        prompt = np.random.default_rng(42).integers(0, 128000, pp).tolist()
        engine.generate(prompt[:16], 4)  # every kernel built and launched once
        walls = []
        for _ in range(3):
            engine.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, _ = engine.prefill(prompt, 0)
            int(tok[0])
            walls.append(time.perf_counter() - t0)
        engine.reset()
        tr = breakdown(smoke, lambda: engine.prefill(prompt, 0))
        row = dict(bench="block_ab", tree=label, path=f"{quant}{'-pack4' if pack4 else ''}",
                   layers=model.cfg.n_layers, window="prefill", tokens=pp,
                   tok_s=pp / statistics.median(walls), card=card, **tr)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not pack4:
            engine.reset()
            tok, _ = engine.prefill(prompt, 0)
            first = int(tok[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.decode_window_run(first, pp, 64)
            tok_s = len(out) / (time.perf_counter() - t0)
            tr = breakdown(smoke, lambda: engine.decode_window_run(out[-1], pp + len(out), 16))
            row = dict(bench="block_ab", tree=label, path=quant, layers=model.cfg.n_layers,
                       window="decode16", tokens=16, tok_s=tok_s, card=card, **tr)
            rows.append(row)
            print(json.dumps(row), flush=True)
        del engine, model
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="tree", help="the rows' `tree` field")
    ap.add_argument("--out", default=None, help="also append the rows here (JSON lines)")
    ap.add_argument("--gguf-dir", default="build/block_ab", help="where the GGUF files are kept")
    ap.add_argument("--no-paths", action="store_true", help="the per-shape rows only")
    ap.add_argument("--variants", action="store_true", help="also the VARIANTS (this tree)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("block_ab: no CUDA device")
    from llamatpu_torch import _build

    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    import chip_smoke as smoke  # the script beside the imported llamatpu_torch

    rows = kernel_rows(args.label, card, dev, smoke)
    if args.variants:
        rows += variant_rows(args.label, card, dev, smoke.block_shapes(smoke.LLAMA32_1B))
    if not args.no_paths:
        rows += path_rows(args.label, card, dev, smoke, Path(args.gguf_dir))
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
