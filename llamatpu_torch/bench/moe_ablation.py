"""What bounds K10-K13's grouped tensor-core kernel (csrc/moe_grouped.cu
`grouped_tc_kernel`) on the card: the kernel as built beside copies of it
with one piece changed, on K10's Q8_0 and K13's bf16 front ends at
Qwen1.5-MoE-A2.7B width (E = 64 experts of gate/up [2816, 2048] and down
[2048, 1408], 8 experts a token) at N = 1, 8 and 512 tokens, with
torch._grouped_mm on the bf16 stacks beside them.

    python -m llamatpu_torch.bench.moe_ablation     # the card; one JSON row a variant and shape

Each variant is csrc/moe_grouped.cu with a constant or a few statements
replaced (VARIANTS), built by nvcc into build/moe_ablation/ and called
through its own `lt_grouped_matmul` by ops/moe_grouped.py `_launch`. The
variants that still compute the product are held to the plain version within
1e-3 of its largest output; those that drop a piece (to time the rest) are
not. Times: the call captured in a CUDA graph and replayed between CUDA
events (best of 3), two rounds in alternating order. Needs the card and
nvcc.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess

import torch

from llamatpu_torch import _build
from llamatpu_torch.bench import roofline
from llamatpu_torch.ops import moe_grouped as mg
from llamatpu_torch.ops.quant_matmul import dequant_blocks

PRODUCTS = ("mma16(acc[f0 + f], af, bx[b][f]);",
            "mma16(acc[(i0 + i) & 1], af[i], xr[st * G::SPW + i0 + i]);")
DEQUANT = r"to_bf16<KIND, WDT>\((r[01])\[(\w)\], [^;]*, (b[01])\);"
XBOXES = "const int nx = GEMV ? 0 : nf * G::XB, ns = G::scaled && a.tma_scales ? 1 : 0;"
SCALES = "if constexpr (G::scaled) {  // without the TMA box: zeros past I / 32 and the last row"
GEMV_PRODUCTS = "      if (steps == G::STEPS)\n        products(Flag<false>());\n      else\n        products(Flag<true>());\n"
TILED_STEPS = "    for (int j = 0; j < G::STEPS; ++j) {\n      const int col = 16 * j + 4 * q, c = j & 1;"
RESTAGE = (("    if (t.tile != xtile) {  // loaded a unit ahead, or now", "    if (xtile < 0) {"),
           ("    if (walk.up.nr > 0 && walk.up.tile != xtile && walk.up.tile != ntile) {",
            "    if (false) {"))


def _replace_all(s: str, pairs) -> str:
    for old, new in pairs:
        assert old in s, old
        s = s.replace(old, new)
    return s


def _no_products(s: str) -> str:
    """Loads and conversions kept, each mma replaced by one f32 add of its fragments."""
    return _replace_all(s, [
        (PRODUCTS[0], "acc[f0 + f][0] += __uint_as_float(af[0] ^ bx[b][f][0]);"),
        (PRODUCTS[1], "acc[(i0 + i) & 1][0] += __uint_as_float(af[i][0] ^ xr[st * G::SPW + i0 + i][0]);")])


def _no_dequant(s: str) -> str:
    """The raw loaded words as the A fragment (no dequantization)."""
    text, n = re.subn(DEQUANT, r"\3[0] = \3[1] = \1[\2][0];", s)
    assert n == 4, n
    return text


def _stream_only(s: str) -> str:
    """The consumers wait for each stage and release it: no fragment, no product."""
    return _replace_all(s, [(GEMV_PRODUCTS, ""),
                            (TILED_STEPS, TILED_STEPS.replace("j < G::STEPS", "j < 0"))])


def _const(name: str, value: int):
    return lambda s: re.sub(rf"constexpr int {name} = \d+(?: \* 1024)?;",
                            f"constexpr int {name} = {value};", s)


# name: (source transform, computes the product)
VARIANTS = {
    "as built": (lambda s: s, True),
    "no products (loads and conversions kept)": (_no_products, False),
    "no dequantization (raw words as A)": (_no_dequant, False),
    "no scales in the ring": (lambda s: _replace_all(s, [
        (SCALES, "if constexpr (false) {"),
        (XBOXES, XBOXES.replace("ns = G::scaled && a.tma_scales ? 1 : 0", "ns = 0"))]), False),
    "stream only (consumers wait and release)": (_stream_only, False),
    "stream only, no x boxes (weights and scales alone)": (
        lambda s: _replace_all(_stream_only(s), [(XBOXES, XBOXES.replace("nf * G::XB", "0"))]), False),
    "GEMV: x of the first tile kept (no reloading)": (lambda s: _replace_all(s, RESTAGE), False),
    "GEMV stages of 2048 int8 columns": (
        lambda s: _replace_all(s, [("GEMV ? (bits == 4 ? 1024 : 8192 / bits)",
                                    "GEMV ? (bits == 4 ? 1024 : 16384 / bits)")]), True),
    "ring depth 6": (_const("kMaxDepth", 6), True),
    "GEMV steps 8 at a time": (
        lambda s: _replace_all(s, [("constexpr int NG = G::SPW < 4 ? G::SPW : 4;",
                                    "constexpr int NG = G::SPW < 8 ? G::SPW : 8;")]), True),
    "GEMV: four accumulator chains (not two)": (
        lambda s: _replace_all(s, [
            ("float acc[2][4] = {};  // even and odd steps", "float acc[4][4] = {};"),
            ("mma16(acc[(i0 + i) & 1], af[i], xr[st * G::SPW + i0 + i]);",
             "mma16(acc[(i0 + i) & 3], af[i], xr[st * G::SPW + i0 + i]);"),
            *[(f"acc[0][{c}] + acc[1][{c}];", f"acc[0][{c}] + acc[1][{c}] + acc[2][{c}] + acc[3][{c}];")
              for c in range(4)]]), True),
    "tiled: 128 columns a stage for bf16 weights": (
        lambda s: _replace_all(s, [(": (XF32 || bits >= 16) ? 64 : 128;", ": (XF32 || bits >= 32) ? 64 : 128;")]),
        True),
    "tiled: x fragments 2 a group": (
        lambda s: _replace_all(s, [("constexpr int FG = NFM < 8 ? NFM : 8;",
                                    "constexpr int FG = NFM < 2 ? NFM : 2;")]), True),
    "tiled: x fragments 4 a group": (
        lambda s: _replace_all(s, [("constexpr int FG = NFM < 8 ? NFM : 8;",
                                    "constexpr int FG = NFM < 4 ? NFM : 4;")]), True),
}


def source() -> str:
    return (_build.CSRC / "moe_grouped.cu").read_text()


def build(out_dir) -> dict:
    """{variant: ctypes library}, compiled in parallel."""
    src = source()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (name, (edit, _)) in enumerate(VARIANTS.items()):
        text = edit(src)
        assert name == "as built" or text != src, f"variant {name!r} changed nothing"
        cu, so = out_dir / f"moe_{n}.cu", out_dir / f"moe_{n}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.lt_grouped_matmul.argtypes = list(_build._SIGNATURES["moe_grouped"]["lt_grouped_matmul"])
        lib.lt_grouped_matmul.restype = ctypes.c_int
        lib.lt_error_string.argtypes = [ctypes.c_int]
        lib.lt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def routing(n: int, k: int, e: int, seed: int, dev):
    """[n, k] distinct expert ids per token over e experts (as top-k gives)."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, e), generator=g).argsort(dim=1)[:, :k].to(dev)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("moe_ablation times the card's kernels: no CUDA device")
    dev = torch.device("cuda")
    e, d, mh, k = 64, 2048, 1408, 8
    gen = torch.Generator(device=dev).manual_seed(13)
    stacks = {}
    for proj, (o, i) in {"gu": (2 * mh, d), "down": (d, mh)}.items():
        q = torch.randint(-127, 128, (e, o, i), dtype=torch.int8, device=dev, generator=gen)
        s = torch.rand((e, o, i // 32), device=dev, generator=gen) * 0.001 + 0.0005
        stacks[proj] = (q, s, dequant_blocks(q, s, torch.bfloat16))
    cases = []
    for n in (1, 8, 512):
        top = routing(n, k, e, seed=n, dev=dev)
        tm = mg.tile_rows(n, k)
        rt, _, te = mg.sort_by_expert(top, e, tm)
        for proj, (q, s, wbf) in stacks.items():
            x = (torch.randn((n, q.shape[-1]), device=dev, generator=gen) * 0.5).to(torch.bfloat16)
            xs = torch.cat([x, x.new_zeros((1, x.shape[1]))])[rt.long()]
            for kind in (mg._K_BLOCK, mg._K_DENSE):
                name = f"{'K10' if kind == mg._K_BLOCK else 'K13'} {proj} N={n} tm={tm}"
                cases.append((name, xs, q, s, te, tm, rt, n, wbf, top, x, kind))
    libs = build(_build.BUILD_DIR.parent / "moe_ablation")
    device = torch.cuda.get_device_name(dev)

    def call(lib, c):
        _, xs, q, s, te, tm, rt, n, wbf = c[:9]
        if c[11] == mg._K_DENSE:
            return mg._launch(mg._K_DENSE, xs, wbf, None, te, tm, rt, n, "moe ablation", lib=lib)
        return mg._launch(mg._K_BLOCK, xs, q, s, te, tm, rt, n, "moe ablation", lib=lib)

    def row(variant, case, run, rnd, **extra):
        ms = roofline.time_run(run, dev) * 1e3
        print(json.dumps({"bench": "moe_ablation", "variant": variant, "shape": case,
                          "device": device, "ms": ms, "round": rnd, **extra}), flush=True)

    for rnd in range(2):
        names = list(VARIANTS) if rnd == 0 else list(reversed(VARIANTS))
        for name in names:
            lib = libs[name]
            for c in cases:
                err = None
                if VARIANTS[name][1]:
                    got = call(lib, c)
                    want = (mg.grouped_dense_matmul_plain(c[1], c[8], c[4], c[5])
                            if c[11] == mg._K_DENSE else
                            mg.grouped_block_matmul_plain(c[1], c[2], c[3], c[4], c[5]))
                    err = ((got - want).abs().max() / want.abs().max()).item()
                    assert err <= 1e-3, f"{name} {c[0]}: rel err {err}"
                row(name, c[0], lambda c=c, lib=lib: call(lib, c), rnd, max_rel_err=err)
        for c in cases[::2]:  # the library call on the bf16 dequantized stack
            top, x, wbf = c[9], c[10], c[8]
            flat = top.reshape(-1)
            order = torch.argsort(flat, stable=True)
            xg = x[order // top.shape[1]].contiguous()
            offs = torch.cumsum(torch.bincount(flat, minlength=wbf.shape[0]), 0).to(torch.int32)
            wt = wbf.transpose(-2, -1)
            row("torch._grouped_mm (bf16)", c[0],
                lambda xg=xg, wt=wt, offs=offs: torch._grouped_mm(xg, wt, offs=offs), rnd)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
