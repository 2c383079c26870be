"""K9 (`layer_tail_fused_rowq`), K20 (`ffn_fused_rowq`), K3
(`layer_attn_tail_fused_rowq`) and K16 (`layer_tail_kt_fused_rowq`) timed at
the shapes of PERF.md's rows: K9 at Llama-3.2-1B width with T = 1, 8 and 32
rows and at Phi-3-medium width with T = 1, 8 and 16, K20 at Phi-3-medium
width with T = 17 and 24, K3 at Llama-3.2-1B width at pos 512 of a 1152-row
bf16 cache, K16 at Llama-3.2-1B width with T = 1, 8 and 32; bf16, random
q8_row weights from a seed, the layers of a stack in turn (each call's
weights cold in L2).

    python -m llamatpu_torch.bench.tail_ab [--out FILE] [--kernels K3,K16]  # this tree
    PYTHONPATH=<tree> python llamatpu_torch/bench/tail_ab.py   # another tree's port

It times whatever `llamatpu_torch` imports: run from another checkout's path
it gives that tree's kernels (the first design's, for a parent commit), with
the same wrapper calls. Per shape: `graph_ms`, the wrapper's calls captured
in a CUDA graph and replayed between CUDA events, best of three; `device_ms`,
the device time of every kernel of the calls (torch.profiler) a call. K3's
rows also give `kernels_ms`, each kernel's device ms a call by its profiler
name (the first design's four launches: append + attention, then the wo,
w13 and w2 GEMVs; with programmatic dependent launch the phases overlap
and the sum counts the overlap twice), `host_us`, the wrapper's host time
a call with the card idle before the calls (the enqueue, best of three
runs of 200 calls), and the two-call yardstick, K6
(`decode_attention_fused_write`) then K9 at T = 1 on the same inputs. On a
tree with csrc/rowq_tc.cuh also the kernel's ablation variants (VARIANTS: copies of
rowq_tc.cuh with a few statements replaced: no products, the mma replaced by
an add; the weight stream alone, no x staging and no products, the units'
ends kept; no unit ends: no parts, sums, epilogues or slice sums; no
reduce launch, the slices of a split phase left unsummed; no programmatic
dependent launch between the phases), built by nvcc into
build/tail_ablation/ beside copies of csrc/layer_fused.cu and ffn_fused.cu
and called through the same launchers; and K3's: "no attention trigger" (a
copy of layer_fused.cu whose attention kernel does not let the wo phase
launch early, K3_VARIANTS), "no PDL" (the template's variant) and the wo
phase planned on the SMs the attention's CTAs leave free (`WoOnFreeSms`).
One JSON row a measurement, each with the card's name and power limit.
Needs the card.
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
         ("K9", "llama32-1b", LLAMA, 32), ("K16", "llama32-1b", LLAMA, 1),
         ("K16", "llama32-1b", LLAMA, 8), ("K16", "llama32-1b", LLAMA, 32),
         ("K3", "llama32-1b", LLAMA, 1),
         ("K9", "phi3-medium", PHI3, 1),
         ("K9", "phi3-medium", PHI3, 8), ("K9", "phi3-medium", PHI3, 16),
         ("K20", "phi3-medium", PHI3, 17), ("K20", "phi3-medium", PHI3, 24))
# K3's attention at Llama-3.2-1B: 8 KV heads of 4 queries, head 64, the main
# path's 1152-row cache, pos 512
K3_ATTN = dict(KV=8, G=4, HD=64, S=1152, pos=512)
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


# K3's attention kernel lets the wo phase launch at its start
TRIGGER = ('  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n'
           "  ca::cluster_attention")
# name: the edit of csrc/layer_fused.cu's text, built beside VARIANTS
K3_VARIANTS = {
    "no attention trigger": lambda s: _replace_all(s, [(TRIGGER, "  ca::cluster_attention")])}

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


def kernels_ms(fn, iters: int = 16) -> dict:
    """{kernel name: device ms a call} of fn's kernels (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:90]: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.self_device_time_total > 0}


def device_ms(fn, iters: int = 16) -> float:
    return sum(kernels_ms(fn, iters).values())


def host_us(fn, calls: int = 200) -> float:
    """Host µs a call of fn, the card idle when the calls start: the
    enqueue, best of three runs."""
    import time

    best = None
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        best = us if best is None else min(best, us)
    return best


def build_ablations(names=("layer_fused", "ffn_fused")) -> dict:
    """{(name, variant): ctypes library} of each source built against the
    variant's copy of rowq_tc.cuh (a quoted include finds the copy beside
    the source first, then csrc/ for the other headers), and of
    layer_fused.cu's K3_VARIANTS against the header as built."""
    from llamatpu_torch import _build

    src = (_build.CSRC / "rowq_tc.cuh").read_text()
    out = _build.BUILD_DIR.parent / "tail_ablation"
    builds = [(what, {"rowq_tc.cuh": edit(src)}, names) for what, edit in VARIANTS.items()]
    builds += [(what, {"layer_fused.cu": edit((_build.CSRC / "layer_fused.cu").read_text())},
                ("layer_fused",)) for what, edit in K3_VARIANTS.items() if "layer_fused" in names]
    procs = {}
    for n, (what, files, srcs) in enumerate(builds):
        vdir = out / f"v{n}"
        vdir.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (vdir / fname).write_text(text)
        for name in srcs:
            cu, so = vdir / f"{name}.cu", vdir / f"{name}.so"
            if f"{name}.cu" not in files:
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


def k3_case(layer_fused, wo, w13, w2, nw, L, H, D, gen, dev):
    """(call, yardstick) of K3 at pos 512 (K3_ATTN), the layers in turn:
    call(lib) launches through the wrapper, or through `lib` (an ablation
    variant's library) where given; the yardstick is K6
    (`decode_attention_fused_write`) then K9 at T = 1 on the same inputs. A
    tree whose K3 reads pos on the device takes it as the path passes it,
    an int32 tensor; the first design takes a host int."""
    from llamatpu_torch.ops import attention

    kv, g, hd, s_len, pos = (K3_ATTN[k] for k in ("KV", "G", "HD", "S", "pos"))
    assert kv * g * hd == H
    kvc = torch.randn((L, 1, kv, s_len, 2 * hd), device=dev, generator=gen).to(torch.bfloat16)
    q4 = torch.randn((1, kv, g, hd), device=dev, generator=gen).to(torch.bfloat16)
    kvn = torch.randn((1, kv, 2 * hd), device=dev, generator=gen).to(torch.bfloat16)
    x = torch.randn((1, 1, D), device=dev, generator=gen).to(torch.bfloat16)
    pv = torch.tensor([pos], dtype=torch.int32, device=dev)
    at = pv if hasattr(layer_fused, "_attn_tail_launch") else pos
    li = iter(range(10**9))

    def k3(lib=None):
        k = next(li) % L
        if lib is not None:
            return layer_fused._attn_tail_launch(wo, w13, w2, nw, q4, kvn, kvc, x, pv, k, 1e-5,
                                                 hd ** -0.5, hd, 1.0, lib=lib)
        return layer_fused.layer_attn_tail_fused_rowq(wo, w13, w2, nw, q4, kvn, kvc, x, at, k,
                                                      1e-5, hd ** -0.5, hd)

    def k6_k9():
        k = next(li) % L
        a, _ = attention.decode_attention_fused_write(q4, kvn, kvc, pv, hd ** -0.5, k, hd)
        return layer_fused.layer_tail_fused_rowq(wo, w13, w2, nw, a.reshape(1, 1, H).to(x.dtype),
                                                 x, k, 1e-5)
    return k3, k6_k9


class WoOnFreeSms:
    """K3's wo phase planned on the SMs its attention's CTAs (one an SM)
    leave free, so that under programmatic dependent launch all of its CTAs
    start beside the attention (the setups worked out again on entry and on
    exit)."""

    def __init__(self, layer_fused, ffn_fused, d, h, attn_ctas):
        self.mods, self.d, self.h, self.ctas = (layer_fused, ffn_fused), d, h, attn_ctas
        self.plan = ffn_fused.tc_plan

    def __enter__(self):
        lf, ff = self.mods

        def plan(t, o, i, pair, dev, sms=None, ksl=0):
            if (t, o, i, pair) == (1, self.d, self.h, False):
                sms = (sms or ff._sm_count(dev.index or 0)) - self.ctas
            return self.plan(t, o, i, pair, dev, sms, ksl)
        ff.tc_plan = plan
        lf._ATTN_TAIL_SETUPS.clear()

    def __exit__(self, *_):
        lf, ff = self.mods
        ff.tc_plan = self.plan
        lf._ATTN_TAIL_SETUPS.clear()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here (JSON lines)")
    ap.add_argument("--label", default="tree", help="the rows' `tree` field")
    ap.add_argument("--no-variants", action="store_true", help="time the kernels as built only")
    ap.add_argument("--kernels", default="K9,K16,K3,K20",
                    help="comma-separated kernels of CASES to time (default: all)")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("tail_ab: no CUDA device")
    from llamatpu_torch import _build
    from llamatpu_torch.ops import attention, ffn_fused, layer_fused

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
        if not any(g == geo and k in kernels for k, g, _, _ in CASES):
            continue
        gen = torch.Generator(device=dev).manual_seed(14)
        L, D, H, F = dims["L"], dims["D"], dims["H"], dims["F"]
        wo, w13, w2 = rand_rowq(L, D, H, gen, dev), rand_rowq(L, 2 * F, D, gen, dev), \
            rand_rowq(L, D, F, gen, dev)
        nw = torch.rand((L, D), device=dev, generator=gen) + 0.5
        for kernel, g, _, t in CASES:
            if g != geo or kernel not in kernels:
                continue
            li = iter(range(10**9))
            attn = torch.randn((t, H), device=dev, generator=gen).to(torch.bfloat16)
            x = torch.randn((t, D), device=dev, generator=gen).to(torch.bfloat16)
            if kernel == "K3":
                k3, k6_k9 = k3_case(layer_fused, wo, w13, w2, nw, L, H, D, gen, dev)
                base = dict(kernel="K3", geometry=geo, T=1, pos=K3_ATTN["pos"])
                emit(**base, variant="as built", graph_ms=graph_ms(k3), device_ms=device_ms(k3),
                     kernels_ms=kernels_ms(k3), host_us=host_us(k3),
                     k6_k9_graph_ms=graph_ms(k6_k9), k6_k9_kernels_ms=kernels_ms(k6_k9))
                if not tc:
                    continue
                for what in ("no attention trigger", "no PDL"):
                    emit(**base, variant=what,
                         graph_ms=graph_ms(lambda: k3(libs[("layer_fused", what)])))
                ap = attention.plan_dense(1, K3_ATTN["KV"], K3_ATTN["S"], 2 * K3_ATTN["HD"], 2,
                                          torch.cuda.get_device_properties(0).multi_processor_count)
                with WoOnFreeSms(layer_fused, ffn_fused, D, H, ap.cluster * K3_ATTN["KV"]):
                    emit(**base, variant="wo on the SMs the attention leaves free",
                         graph_ms=graph_ms(k3))
                continue
            if kernel == "K16":
                def call16():
                    return layer_fused.layer_tail_kt_fused_rowq(wo, w13, w2, nw, attn, x,
                                                                next(li) % L, 1e-5)
                assert call16() is not None, (kernel, geo, t)
                emit(kernel=kernel, geometry=geo, T=t, variant="as built",
                     graph_ms=graph_ms(call16), device_ms=device_ms(call16))
                continue
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
