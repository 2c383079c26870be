"""K9 (`layer_tail_fused_rowq`) and K20 (`ffn_fused_rowq`) timed at the
shapes of PERF.md's rows: K9 at Llama-3.2-1B width with T = 1, 8 and 32
rows and at Phi-3-medium width with T = 1, 8 and 16, K20 at Phi-3-medium
width with T = 17 and 24, bf16, random q8_row weights from a seed, the
layers of a stack in turn (each call's weights cold in L2).

    python -m llamatpu_torch.bench.tail_ab [--out FILE]      # this tree
    PYTHONPATH=<tree> python llamatpu_torch/bench/tail_ab.py   # another tree's port

It times whatever `llamatpu_torch` imports: run from another checkout's path
it gives that tree's kernels (the first design's, for a parent commit), with
the same wrapper calls. Per shape: `graph_ms`, the wrapper's calls captured
in a CUDA graph and replayed between CUDA events; `device_ms`, the device
time of every kernel of the calls (torch.profiler) a call. On a tree with
csrc/rowq_tc.cuh also the kernel's ablation variants (VARIANTS: copies of
rowq_tc.cuh with a few statements replaced: no products, the mma replaced by
an add; the weight stream alone, no x staging and no products, the units'
ends kept; no unit ends: no parts, sums, epilogues or slice sums; no
reduce launch, the slices of a split phase left unsummed; no programmatic
dependent launch between the phases), built by nvcc into
build/tail_ablation/ beside copies of csrc/layer_fused.cu and ffn_fused.cu
and called through the same launchers. One JSON row a measurement, each
with the card's name and power limit. Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from llamatpu_torch.bench.sweep_tail import rand_rowq

LLAMA = dict(D=2048, H=2048, F=8192, L=4)
PHI3 = dict(D=5120, H=5120, F=17920, L=2)
CASES = (("K9", "llama32-1b", LLAMA, 1), ("K9", "llama32-1b", LLAMA, 8),
         ("K9", "llama32-1b", LLAMA, 32), ("K9", "phi3-medium", PHI3, 1),
         ("K9", "phi3-medium", PHI3, 8), ("K9", "phi3-medium", PHI3, 16),
         ("K20", "phi3-medium", PHI3, 17), ("K20", "phi3-medium", PHI3, 24))
PRODUCTS = ("      mma16(acc[n], a, bx[n]);", "        mma16(accu[n], a, bx[n]);")
STAGE_X = "      stage_x<NF>(p, xs, rstd, k0, k1, ct, xbar, xphase);\n"
PRODUCTS_CALL = "      if (wb >= nb) {\n"
UNIT_END = "    // the warp's part to the finishers:"
FINISH = "    finish<NF, PAIR>(p, hd,"
REDUCE = "if (e || p.splits == 1) return e;"
PDL = "cfg.numAttrs = 1;"


def _replace_all(s: str, pairs) -> str:
    for old, new in pairs:
        assert s.count(old) == 1, old
        s = s.replace(old, new)
    return s


# name: the edit of csrc/rowq_tc.cuh's text
VARIANTS = {
    "no products": lambda s: _replace_all(s, [
        (PRODUCTS[0], "      acc[n][0] += __uint_as_float(a[0] ^ bx[n][0]);"),
        (PRODUCTS[1], "        accu[n][0] += __uint_as_float(a[1] ^ bx[n][1]);")]),
    "stream only": lambda s: _replace_all(s, [
        (STAGE_X, ""), (PRODUCTS_CALL, PRODUCTS_CALL.replace("wb >= nb", "true"))]),
    "no unit ends": lambda s: _replace_all(s, [
        (UNIT_END, "    continue;\n" + UNIT_END), (FINISH, "    if (false)" + FINISH[3:])]),
    "no reduce launch": lambda s: _replace_all(s, [(REDUCE, "return e;")]),
    "no PDL": lambda s: _replace_all(s, [(PDL, "cfg.numAttrs = 0;")]),
}


def graph_ms(fn, iters: int = 16, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = None
    for _ in range(3):
        a.record()
        for _ in range(reps):
            g.replay()
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / (reps * iters)
        best = ms if best is None else min(best, ms)
    del g
    return best


def device_ms(fn, iters: int = 16) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / iters


def build_ablations(names=("layer_fused", "ffn_fused")) -> dict:
    """{(name, variant): ctypes library} of each source built against the
    variant's copy of rowq_tc.cuh (a quoted include finds the copy beside
    the source first, then csrc/ for the other headers)."""
    from llamatpu_torch import _build

    src = (_build.CSRC / "rowq_tc.cuh").read_text()
    out = _build.BUILD_DIR.parent / "tail_ablation"
    procs = {}
    for n, (what, edit) in enumerate(VARIANTS.items()):
        vdir = out / f"v{n}"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "rowq_tc.cuh").write_text(edit(src))
        for name in names:
            cu, so = vdir / f"{name}.cu", vdir / f"{name}.so"
            cu.write_text((_build.CSRC / f"{name}.cu").read_text())
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                   str(cu)]
            procs[(name, what)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation build {key} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES[key[0]].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.lt_error_string.argtypes = [ctypes.c_int]
        lib.lt_error_string.restype = ctypes.c_char_p
        libs[key] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here (JSON lines)")
    ap.add_argument("--label", default="tree", help="the rows' `tree` field")
    ap.add_argument("--no-variants", action="store_true", help="time the kernels as built only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tail_ab: no CUDA device")
    from llamatpu_torch import _build
    from llamatpu_torch.ops import ffn_fused, layer_fused

    _build.build(["layer_fused", "ffn_fused"])  # both at once
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    tc = hasattr(ffn_fused, "plan_tc") and not args.no_variants
    libs = build_ablations() if tc else {}
    rows = []

    def emit(**r):
        r.update(tree=args.label, card=card)
        rows.append(r)
        print(json.dumps(r), flush=True)
    for geo, dims in (("llama32-1b", LLAMA), ("phi3-medium", PHI3)):
        gen = torch.Generator(device=dev).manual_seed(14)
        L, D, H, F = dims["L"], dims["D"], dims["H"], dims["F"]
        wo, w13, w2 = rand_rowq(L, D, H, gen, dev), rand_rowq(L, 2 * F, D, gen, dev), \
            rand_rowq(L, D, F, gen, dev)
        nw = torch.rand((L, D), device=dev, generator=gen) + 0.5
        for kernel, g, _, t in CASES:
            if g != geo:
                continue
            li = iter(range(10**9))
            attn = torch.randn((t, H), device=dev, generator=gen).to(torch.bfloat16)
            x = torch.randn((t, D), device=dev, generator=gen).to(torch.bfloat16)
            if kernel == "K9":
                def call(lib=None):
                    k = next(li) % L
                    if lib is None:
                        return layer_fused.layer_tail_fused_rowq(wo, w13, w2, nw, attn, x, k,
                                                                 1e-5)
                    parts = layer_fused._tail_weights(wo, w13, w2, k)
                    return layer_fused._tail_launch(parts, nw[k], attn, x, 1e-5, 1.0, lib=lib)
                name = "layer_fused"
            else:
                def call(lib=None):
                    k = next(li) % L
                    if lib is None:
                        return ffn_fused.ffn_fused_rowq(w13, w2, x, k)
                    return ffn_fused._ffn_launch(x, w13.qs[k], w13.scales[k][:, 0], w2.qs[k],
                                                 w2.scales[k][:, 0], lib=lib)
                name = "ffn_fused"
            assert call() is not None, (kernel, geo, t)
            base = dict(kernel=kernel, geometry=geo, T=t)
            emit(**base, variant="as built", graph_ms=graph_ms(call), device_ms=device_ms(call))
            if not tc:
                continue
            for what in VARIANTS:
                lib = libs[(name, what)]
                emit(**base, variant=what, graph_ms=graph_ms(lambda: call(lib)),
                     device_ms=device_ms(lambda: call(lib)))
        del wo, w13, w2
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
