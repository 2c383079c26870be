"""K2 (`qkv_norm_fused_rowq`) and K1 (`rowq_gemv`) timed at the shapes of
PERF.md's rows: K2 at Llama-3.2-1B (wqkv [3072, 2048]) with T = 1, 8 and 32
rows and at Phi-3-medium (wqkv [7680, 5120]) with T = 1, 8, 24 and 32; K1 on
Llama-3.2-1B's vocab head [128256, 2048] with T = 1, 8 and 32 and on
Phi-3-medium's wo [5120, 5120], w13 [35840, 5120] and w2 [5120, 17920] with T
= 24 and 32; bf16 x, random q8_row weights from a seed, the layers of a stack
in turn (each call's weights cold in L2).

    python -m llamatpu_torch.bench.qkv_ab [--out FILE]      # this tree
    PYTHONPATH=<tree> python llamatpu_torch/bench/qkv_ab.py   # another tree's port

It times whatever `llamatpu_torch` imports: run from another checkout's path
it gives that tree's kernels (the first design's, for a parent commit), with
the same wrapper calls. Per shape: `graph_ms`, the wrapper's calls captured
in a CUDA graph and replayed between CUDA events (a launch's wait under
programmatic dependent launch is counted once); `bound_ms`, the bytes each
call must move (weights, K2's row scales and norm, x, y) at 3.35 TB/s or
its products at the bf16 peak, the larger; `library_ms`, bf16
`torch.matmul` on the weight in bf16 (K2's: the dequantized weight, no
norm). On a tree whose K1 and K2 run csrc/rowq_tc.cuh also their ablation
variants: tail_ab.VARIANTS' edits of a copy of rowq_tc.cuh, and for K2 "no
norm phase" (layer_fused.cu's norm launch skipped and x staged as it is: a
wrong result whose time bounds any way of taking the norm), built by nvcc
into build/qkv_ablation/; and K1 at T = 1 on gemv.cuh's gemv_kernel<1>. One JSON row a measurement, each with the card's name and
power limit. Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from llamatpu_torch.bench.sweep_tail import rand_rowq
from llamatpu_torch.bench.tail_ab import VARIANTS as TC_VARIANTS
from llamatpu_torch.bench.tail_ab import _replace_all, graph_ms

HBM_BYTES_S, BF16_OPS_S = 3.35e12, 989e12
# (kernel, geometry, O, I, layers of the stack, rows)
CASES = (("K2", "llama32-1b wqkv", 3072, 2048, 12, (1, 8, 32)),
         ("K2", "phi3-medium wqkv", 7680, 5120, 3, (1, 8, 24, 32)),
         ("K1", "llama32-1b head", 128256, 2048, 1, (1, 8, 32)),
         ("K1", "phi3-medium wo", 5120, 5120, 4, (24, 32)),
         ("K1", "phi3-medium w13", 35840, 5120, 2, (24, 32)),
         ("K1", "phi3-medium w2", 5120, 17920, 2, (24, 32)))
NORM_LAUNCH = "const cudaError_t ce = cudaLaunchKernelEx(\n        &cfg, qkv_rmsnorm_kernel,"
NORM_CHECK = "    if (ce != cudaSuccess) return static_cast<int>(ce);\n    rtc::Phase p = {};\n" \
             "    p.x = h;\n"
# name: (edit of rowq_tc.cuh, edit of the kernel's .cu, the kernels it applies to)
VARIANTS = {**{k: (v, None, ("K1", "K2")) for k, v in TC_VARIANTS.items()},
            "no norm phase": (None, lambda s: _replace_all(s, [
                (NORM_LAUNCH, "if (false) cudaLaunchKernelEx(\n        &cfg, qkv_rmsnorm_kernel,"),
                (NORM_CHECK, "    rtc::Phase p = {};\n    p.x = x;\n")]), ("K2",))}
SOURCES = {"K1": "quant_matmul", "K2": "layer_fused"}


def build_variants() -> dict:
    """{(kernel, variant): ctypes library}: the kernel's source built against
    the variant's copies of rowq_tc.cuh and of the source (a quoted include
    finds the copy beside the source first, then csrc/ for the other
    headers)."""
    from llamatpu_torch import _build

    hdr = (_build.CSRC / "rowq_tc.cuh").read_text()
    out = _build.BUILD_DIR.parent / "qkv_ablation"
    procs = {}
    for n, (what, (edit_h, edit_cu, kernels)) in enumerate(VARIANTS.items()):
        vdir = out / f"v{n}"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "rowq_tc.cuh").write_text(edit_h(hdr) if edit_h else hdr)
        for k in kernels:
            name = SOURCES[k]
            src = (_build.CSRC / f"{name}.cu").read_text()
            cu, so = vdir / f"{name}.cu", vdir / f"{name}.so"
            cu.write_text(edit_cu(src) if edit_cu else src)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                   str(cu)]
            procs[(k, what)] = (name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (name, proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation build {key} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.lt_error_string.argtypes = [ctypes.c_int]
        lib.lt_error_string.restype = ctypes.c_char_p
        libs[key] = lib
    return libs


def bound_ms(kernel: str, t: int, o: int, i: int) -> float:
    if kernel == "K2":  # weights, row scales, norm, x in, y out in x's dtype
        nbytes = o * i + o * 4 + i * 4 + t * i * 2 + t * o * 2
    else:  # weights, x in, y out in f32
        nbytes = o * i + t * i * 2 + t * o * 4
    return max(nbytes / HBM_BYTES_S, 2 * t * o * i / BF16_OPS_S) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here (JSON lines)")
    ap.add_argument("--label", default="tree", help="the rows' `tree` field")
    ap.add_argument("--no-variants", action="store_true", help="time the kernels as built only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("qkv_ab: no CUDA device")
    from llamatpu_torch import _build
    from llamatpu_torch.ops import layer_fused, quant_matmul

    _build.build(["layer_fused", "quant_matmul"])  # both at once
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    tc = hasattr(quant_matmul, "rowq_route") and not args.no_variants
    libs = build_variants() if tc else {}
    rows = []

    def emit(**r):
        r.update(tree=args.label, card=card)
        rows.append(r)
        print(json.dumps(r), flush=True)
    gen = torch.Generator(device=dev).manual_seed(15)
    for kernel, geo, o, i, n, ts in CASES:
        w = rand_rowq(n, o, i, gen, dev)
        nw = torch.rand((n, i), device=dev, generator=gen) + 0.5
        w_bf = (w.qs[0].float() * w.scales[0]).to(torch.bfloat16) if kernel == "K2" \
            else w.qs[0].to(torch.bfloat16)
        for t in ts:
            li = iter(range(10**9))
            x = torch.randn((t, i), device=dev, generator=gen).to(torch.bfloat16)
            if kernel == "K2":
                def call(lib=None):
                    k = next(li) % n
                    if lib is None:
                        return layer_fused.qkv_norm_fused_rowq(w, nw, x, k, 1e-5)
                    return layer_fused._qkv_launch(w.qs[k], w.scales[k][:, 0], nw[k], x, 1e-5,
                                                   lib=lib)
            else:
                def call(lib=None):
                    k = next(li) % n
                    if lib is None:
                        return quant_matmul.rowq_gemv(x, w.qs[k])
                    return quant_matmul._rowq_launch(x, w.qs[k], lib=lib)
            base = dict(kernel=kernel, geometry=geo, O=o, I=i, T=t,
                        bound_ms=bound_ms(kernel, t, o, i),
                        library_ms=graph_ms(lambda: torch.matmul(x, w_bf.T)))
            emit(**base, variant="as built", graph_ms=graph_ms(call))
            if not tc:
                continue
            for what in VARIANTS:
                if (kernel, what) in libs:
                    emit(**base, variant=what, graph_ms=graph_ms(lambda: call(libs[(kernel, what)])))
            if kernel == "K1" and t == 1:
                emit(**base, variant="gemv_kernel<1>", graph_ms=graph_ms(
                    lambda: quant_matmul._rowq_launch(x, w.qs[next(li) % n], route=("gemv", 1))))
        del w, w_bf
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
