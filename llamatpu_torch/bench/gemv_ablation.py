"""What bounds the bf16 tensor-core GEMV of K18a / K18i (csrc/probes.cu
`probe_gemv_tc_kernel`) on the card: the kernel as built beside copies of
it with one piece changed, bf16 `torch.matmul` and the stream probe K18j;
and the per-row cost of the first GEMV design, which the q8 forms K18b and
K18g keep, at T = 1 and 8.

    python -m llamatpu_torch.bench.gemv_ablation     # the card; one JSON row a variant

Each variant is csrc/probes.cu with a constant or a few statements replaced
(VARIANTS), built by nvcc into build/ablation/ and called through its own
`lt_probe_gemv_bf16` under `ops/probes.py plan_gemv`. Every variant that
still computes the product is held to the plain one within 1e-5 of its
largest output; those that drop x or the products (to time the ring alone)
are not. Times as bench/roofline.py takes them (a CUDA graph replayed
between CUDA events, best of 3): one [4096, 4096] layer of 24 in turn, per
call, and the [24, 4096, 4096] stack, in two rounds of alternating order.
Needs the card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess

import torch

from llamatpu_torch import _build
from llamatpu_torch.bench import roofline
from llamatpu_torch.ops import probes

X_COPY = "const int rows = max(0, min(4, a.T - 4 * h));"
X_FRAG = "lds64(xf[f], x_lane + col * 2);"
PRODUCT = "if (warp + kParts * i < steps)"


def _const(name: str, value: int):
    return lambda s: re.sub(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", s)


def _no_x(s: str) -> str:
    """No x copy; every x fragment a constant."""
    return s.replace(X_COPY, "const int rows = 0;").replace(
        X_FRAG, "xf[f][0] = xf[f][1] = 0x3f803f80u;")


def _x_after(s: str) -> str:
    """The x copy issued after the weight stages that fit the ring beside it."""
    i, j = s.index("    // x's slice first,"), s.index("    int slot = 2;\n")
    body = s[i:j].split("\n", 1)[1]
    s = s[:i] + "    bool sent = false;\n    auto send_x = [&]() {\n" + body + \
        "      sent = true;\n    };\n" + s[j:]
    s = s.replace("        mbar_wait(&empty[slot], phase ^ 1);",
                  "        if (slot == 0 && !sent) send_x();\n"
                  "        mbar_wait(&empty[slot], phase ^ 1);")
    return s.replace("    return;\n  }\n\n  // This warp's x fragments",
                     "    if (!sent) send_x();\n    return;\n  }\n\n  // This warp's x fragments")


# name: (source transform, computes the product)
VARIANTS = {
    "as built": (lambda s: s, True),
    "ring depth 4": (_const("kDepth", 4), True),
    "ring depth 5": (_const("kDepth", 5), True),
    "16 consumer warps": (_const("kParts", 16), True),
    "x copy after the first weight stages": (_x_after, True),
    "no x copy (constant x)": (_no_x, False),
    "no x copy, no products (the ring alone)": (lambda s: _no_x(s).replace(PRODUCT, "if (false)"),
                                                False),
}


def build(out_dir) -> dict:
    """{variant: ctypes library}, the variants compiled in parallel."""
    src = (_build.CSRC / "probes.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (name, (edit, _)) in enumerate(VARIANTS.items()):
        text = edit(src)
        assert name == "as built" or text != src, f"variant {name!r} changed nothing"
        cu, so = out_dir / f"probes_{n}.cu", out_dir / f"probes_{n}.so"
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
        lib.lt_probe_gemv_bf16.argtypes = list(_build._SIGNATURES["probes"]["lt_probe_gemv_bf16"])
        libs[name] = lib
    return libs


def gemv(lib, x, w, sms: int) -> torch.Tensor:
    """ops/probes.py gemv_bf16 on the variant's library."""
    lay, o, i = w.shape
    plan = probes.plan_gemv(o, i, lay, sms)
    y = torch.empty((lay, x.shape[0], o), dtype=torch.float32, device=x.device)
    part = (torch.empty((plan.nks, lay, x.shape[0], o), dtype=torch.float32, device=x.device)
            if plan.nks > 1 else None)
    err = lib.lt_probe_gemv_bf16(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                 0 if part is None else part.data_ptr(), x.shape[0], o, i, lay,
                                 plan.nks, plan.ctas, _build.stream())
    _build.check(lib, err, "gemv ablation")
    return y


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("gemv_ablation times the card's kernels: no CUDA device")
    dev = torch.device("cuda")
    w = roofline.make_weights(24, 4096, 4096, dev)
    stack, x = w["bf16"], w["x"]
    layers = stack.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build(_build.BUILD_DIR.parent / "ablation")
    want = x.float() @ stack.float().transpose(-1, -2)
    device = torch.cuda.get_device_name(dev)

    def row(variant, layer_run, stack_run, **extra):
        layer_ms = roofline.time_run(layer_run, dev) * 1e3 / layers
        stack_ms = None if stack_run is None else roofline.time_run(stack_run, dev) * 1e3
        print(json.dumps({"bench": "gemv_ablation", "variant": variant, "device": device,
                          "layer_ms": layer_ms, "stack_ms": stack_ms, **extra}), flush=True)

    for rnd in range(2):
        names = list(VARIANTS) if rnd == 0 else list(reversed(VARIANTS))
        for name in names:
            lib = libs[name]
            err = None
            if VARIANTS[name][1]:
                got = gemv(lib, x, stack, sms)
                torch.cuda.synchronize()
                err = ((got - want).abs().max() / want.abs().max()).item()
                assert err <= 1e-5, f"{name}: rel err {err}"
            row(name, lambda lib=lib: [gemv(lib, x, stack[li:li + 1], sms) for li in range(layers)],
                lambda lib=lib: gemv(lib, x, stack, sms), round=rnd, max_rel_err=err)
        flat = stack.reshape(-1, stack.shape[-1])
        row("bf16 torch.matmul", lambda: [torch.matmul(x, stack[li].T) for li in range(layers)],
            lambda: torch.matmul(x, flat.T), round=rnd)
        row("stream probe (K18f / K18j)",
            lambda: [roofline.step_dma_probe((stack[li],), x) for li in range(layers)],
            lambda: roofline.call3_dma_probe((stack,), x), round=rnd)
        # per-row cost: the tensor-core GEMV against the first design's q8 form
        for t in (1, 8):
            xt = x[:t].contiguous()
            row(f"as built, T = {t}",
                lambda xt=xt: [gemv(libs["as built"], xt, stack[li:li + 1], sms)
                               for li in range(layers)],
                None, round=rnd)
            row(f"first design (q8 form K18b), T = {t}",
                lambda xt=xt: [probes.gemv(xt, w["qs"][li], w["ss"][li], probes.W_Q8_F32)
                               for li in range(layers)], None, round=rnd)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
