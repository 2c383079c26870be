"""What bounds the tensor-core GEMV of K18a / K18i (bf16 weights) and K18b /
K18c / K18g (int8 weights, the dequantization in the B fragments) on the
card: csrc/probes.cu `probe_gemv_tc_kernel` as built beside copies of it with
one piece changed, bf16 `torch.matmul` and the stream probe K18f / K18j over
the bf16 and the int8 stack; and the per-row cost against the first
CUDA-core design of the q8 forms, rebuilt as a variant, at T = 1 and 8.

    python -m llamatpu_torch.bench.gemv_ablation     # the card; one JSON row a variant

Each variant is csrc/probes.cu with a constant or a few statements replaced
(VARIANTS, timed on the bf16 stack; Q8_VARIANTS, timed on the int8 stack in
the W_Q8_F32 kind), built by nvcc into build/ablation/ and called through its
own `lt_probe_gemv` under `ops/probes.py plan_gemv`. Every variant that still
computes the product is held to the plain one within 1e-5 of its largest
output; those that drop x, the dequantization or the products (to time the
rest alone) are not. Times as bench/roofline.py takes them (a CUDA graph
replayed between CUDA events, best of 3): one [4096, 4096] layer of 24 in
turn, per call, and the [24, 4096, 4096] stack, in two rounds of alternating
order. Needs the card and nvcc.
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

X_COPY = "const int rows = max(0, min(S::xrows, a.T - S::xrows * h));"
X_FRAG = "lds64(v, x_lane + col * 2);"
LOAD = "if (!G || j < steps) {"
PRODUCT = "if (!G || warp + kParts * (i0 + i) < steps)"
MMA = "mma16(acc[(i0 + i) & 1], xq[(st * S::steps + i0 + i) / 2], bf[i]);"
DEQUANT = "dequant4<WK>(ld[i][0], su, bf[i]);"  # and its form with a step's scales sv
PERMUTE = "f[e] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + e)) - 8388736.f;"
CVT = "const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n  return *reinterpret_cast<const uint32_t*>(&v);"

# The first design of the q8 forms (a CUDA-core GEMV, since replaced),
# appended to the source as `lt_probe_gemv_first`: a warp takes kRows weight
# rows, each lane 16 int8 weights a load with their 16 f32 scales, x staged in
# shared memory in f32 kTileK columns at a time.
FIRST_DESIGN = r'''
namespace {
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int WK>
__device__ __forceinline__ void load_weights(const void* wbase, const float* s, long row, int I,
                                             int NB, int k, float (&w)[16]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
      static_cast<const char*>(wbase) + row * I + k));
  const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
  const float4* sp = reinterpret_cast<const float4*>(s + row * NB + k % NB);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 sv = __ldg(sp + j);
    const float sc[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float qv = static_cast<float>(q[4 * j + e]);
      w[4 * j + e] = WK == W_Q8_F32 ? bf16_round(__fmul_rn(qv, sc[e]))
                                    : bf16_round(__fmul_rn(qv, bf16_round(sc[e])));
    }
  }
}

template <int WK>
__global__ void __launch_bounds__(kThreads) probe_gemv_first_kernel(
    const __nv_bfloat16* __restrict__ x, const void* __restrict__ w, const float* __restrict__ s,
    float* __restrict__ y, int T, int O, int I, int NB) {
  constexpr int E = 16;
  __shared__ __align__(16) float xs[kMaxT][kTileK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const long layer = blockIdx.y;
  const int o0 = (blockIdx.x * nwarps + warp) * kRows;
  float acc[kRows][kMaxT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) acc[r][t] = 0.f;
  for (int k0 = 0; k0 < I; k0 += kTileK) {
    const int kt = min(kTileK, I - k0);
    for (int i = threadIdx.x; i < T * kt; i += blockDim.x) {
      const int t = i / kt, k = i - t * kt;
      xs[t][k] = __bfloat162float(x[static_cast<long>(t) * I + k0 + k]);
    }
    __syncthreads();
    for (int c = lane; c < kt / E; c += 32) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int o = o0 + r;
        if (o >= O) break;
        float wv[16];
        load_weights<WK>(w, s, layer * O + o, I, NB, k0 + c * E, wv);
#pragma unroll
        for (int t = 0; t < kMaxT; ++t) {
          if (t < T) {
#pragma unroll
            for (int e = 0; e < E; e += 4) {
              const float4 xv = *reinterpret_cast<const float4*>(&xs[t][c * E + e]);
              acc[r][t] += xv.x * wv[e] + xv.y * wv[e + 1] + xv.z * wv[e + 2] + xv.w * wv[e + 3];
            }
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int o = o0 + r;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const float v = lt_warp_sum(acc[r][t]);
      if (lane == 0 && o < O && t < T) y[(layer * T + t) * O + o] = v;
    }
  }
}
}  // namespace

LT_EXPORT int lt_probe_gemv_first(const void* x, const void* w, const void* s, void* y, int T,
                                  int O, int I, int L, int NB, int wkind, void* stream) {
  const int per_block = (kThreads / 32) * kRows;
  dim3 grid((O + per_block - 1) / per_block, L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sf = static_cast<const float*>(s);
  auto* yf = static_cast<float*>(y);
  if (wkind == W_Q8_F32)
    probe_gemv_first_kernel<W_Q8_F32><<<grid, kThreads, 0, st>>>(xb, w, sf, yf, T, O, I, NB);
  else
    probe_gemv_first_kernel<W_Q8_BF16><<<grid, kThreads, 0, st>>>(xb, w, sf, yf, T, O, I, NB);
  return static_cast<int>(cudaGetLastError());
}
'''
FIRST_SIGNATURE = tuple(ctypes.c_void_p if i in (0, 1, 2, 3, 10) else ctypes.c_int
                        for i in range(11))


def _const(name: str, value: int):
    return lambda s: re.sub(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", s)


def _no_x(s: str) -> str:
    """No x copy; every x fragment a constant."""
    return s.replace(X_COPY, "const int rows = 0;").replace(
        X_FRAG, "v[0] = v[1] = 0x3f803f80u;")


def _x_after(s: str) -> str:
    """The x copy issued after the weight stages that fit the ring beside it."""
    i, j = s.index("    // x's slice first,"), s.index("    int slot = S::xslots;\n")
    body = s[i:j].split("\n", 1)[1]
    s = s[:i] + "    bool sent = false;\n    auto send_x = [&]() {\n" + body + \
        "      sent = true;\n    };\n" + s[j:]
    s = s.replace("        mbar_wait(&empty[slot], phase ^ 1);",
                  "        if (slot == 0 && !sent) send_x();\n"
                  "        mbar_wait(&empty[slot], phase ^ 1);")
    return s.replace("    return;\n  }\n\n  const int g = lane >> 2",
                     "    if (!sent) send_x();\n    return;\n  }\n\n  const int g = lane >> 2")


def _i2f(s: str) -> str:
    """int8 -> f32 by the conversion pipe (I2F) in place of the byte permute."""
    return s.replace(PERMUTE, "f[e] = static_cast<float>(static_cast<int8_t>(raw >> (8 * e)));")


def _int_round(s: str) -> str:
    """f32 -> bf16 by integer rounding (ties to even) in place of cvt.rn.bf16x2.f32."""
    return s.replace(CVT, "const uint32_t a = __float_as_uint(lo), b = __float_as_uint(hi);\n"
                          "  return __byte_perm(a + 0x7fffu + ((a >> 16) & 1u), "
                          "b + 0x7fffu + ((b >> 16) & 1u), 0x7632);")


def _wide_q8_stages(s: str) -> str:
    """int8 stages of 4096 columns (32 KB, as a bf16 stage), 6 in the ring."""
    return s.replace("static constexpr int K = kStageK;", "static constexpr int K = kStageK * 2 / esize;") \
        .replace("static constexpr int depth = kDepth * 2 / esize;", "static constexpr int depth = kDepth;")


def _no_dequant(s: str) -> str:
    """The raw int8 bytes reinterpreted as the B fragment (no dequantization)."""
    return re.sub(r"dequant4<WK>\(ld\[i\]\[0\], s[uv], bf\[i\]\);",
                  "bf[i][0] = bf[i][1] = ld[i][0];", s)


def _no_products(s: str) -> str:
    """Loads and conversions kept, each mma replaced by one f32 add of its B fragment."""
    return s.replace(MMA, "acc[0][0] += __uint_as_float(bf[i][0] ^ bf[i][1]);")


# name: (source transform, computes the product). VARIANTS time the bf16
# kind, Q8_VARIANTS the W_Q8_F32 kind ("as built" also both q8 kinds, and
# "16 consumer warps" the W_Q8_F32 kind).
VARIANTS = {
    "as built": (lambda s: s, True),
    "ring depth 4": (_const("kDepth", 4), True),
    "ring depth 5": (_const("kDepth", 5), True),
    "16 consumer warps": (_const("kParts", 16), True),
    "x copy after the first weight stages": (_x_after, True),
    "no x copy (constant x)": (_no_x, False),
    "no x copy, no products (the ring alone)": (
        lambda s: _no_x(s).replace(PRODUCT, "if (false)").replace(LOAD, "if (false) {"), False),
}
Q8_VARIANTS = {
    "q8: I2F conversions (no byte permute)": (_i2f, True),
    "q8: integer bf16 rounding (no cvt)": (_int_round, True),
    "q8: 4096-column stages, 6 deep": (_wide_q8_stages, True),
    "q8: no dequantization (raw int8 as bf16)": (_no_dequant, False),
    "q8: no products (conversions kept)": (_no_products, False),
    "q8: first design (CUDA-core GEMV)": (lambda s: s + FIRST_DESIGN, True),
}


def build(out_dir) -> dict:
    """{variant: ctypes library}, the variants of both tables compiled in parallel."""
    src = (_build.CSRC / "probes.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (name, (edit, _)) in enumerate({**VARIANTS, **Q8_VARIANTS}.items()):
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
        lib.lt_probe_gemv.argtypes = list(_build._SIGNATURES["probes"]["lt_probe_gemv"])
        if name in Q8_VARIANTS and "first design" in name:
            lib.lt_probe_gemv_first.argtypes = list(FIRST_SIGNATURE)
        libs[name] = lib
    return libs


def gemv(lib, x, w, s, wkind: int, sms: int) -> torch.Tensor:
    """ops/probes.py gemv_bf16 / gemv on the variant's library (the first
    design's own launch where the variant has it)."""
    lay, o, i = w.shape
    nb = 0 if s is None else s.shape[-1]
    y = torch.empty((lay, x.shape[0], o), dtype=torch.float32, device=x.device)
    if hasattr(lib, "lt_probe_gemv_first"):
        err = lib.lt_probe_gemv_first(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
                                      x.shape[0], o, i, lay, nb, wkind, _build.stream())
        _build.check(lib, err, "gemv ablation")
        return y
    plan = probes.plan_gemv(o, i, lay, sms)
    part = (torch.empty((plan.nks, lay, x.shape[0], o), dtype=torch.float32, device=x.device)
            if plan.nks > 1 else None)
    err = lib.lt_probe_gemv(x.data_ptr(), w.data_ptr(), 0 if s is None else s.data_ptr(),
                            y.data_ptr(), 0 if part is None else part.data_ptr(), x.shape[0], o,
                            i, lay, nb, wkind, plan.nks, plan.ctas, _build.stream())
    _build.check(lib, err, "gemv ablation")
    return y


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("gemv_ablation times the card's kernels: no CUDA device")
    dev = torch.device("cuda")
    w = roofline.make_weights(24, 4096, 4096, dev)
    x = w["x"]
    layers = w["bf16"].shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build(_build.BUILD_DIR.parent / "ablation")
    deq = {probes.W_Q8_F32: roofline.deq_q8_current, probes.W_Q8_BF16: roofline.deq_q8_bf16mul}
    # (weights, scales, kind): the bf16 stack, the int8 stack in both kinds
    kinds = {"bf16": (w["bf16"], None, probes.W_BF16),
             "q8_f32": (w["qs"], w["ss"], probes.W_Q8_F32),
             "q8_bf16": (w["qs"], w["ss"], probes.W_Q8_BF16)}
    want = {k: x.float() @ (ws.float() if s is None else torch.stack(
        [deq[kd](ws[li], s[li]) for li in range(layers)]).float()).transpose(-1, -2)
        for k, (ws, s, kd) in kinds.items()}
    device = torch.cuda.get_device_name(dev)

    def row(variant, layer_run, stack_run, **extra):
        layer_ms = roofline.time_run(layer_run, dev) * 1e3 / layers
        stack_ms = None if stack_run is None else roofline.time_run(stack_run, dev) * 1e3
        print(json.dumps({"bench": "gemv_ablation", "variant": variant, "device": device,
                          "layer_ms": layer_ms, "stack_ms": stack_ms, **extra}), flush=True)

    def variant(name, kind, computes, rnd, xt=x, stack=True):
        lib = libs[name]
        ws, s, kd = kinds[kind]
        err = None
        if computes:
            got = gemv(lib, xt, ws, s, kd, sms)
            torch.cuda.synchronize()
            ref = want[kind][:, :xt.shape[0]]
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            assert err <= 1e-5, f"{name} ({kind}): rel err {err}"
        sl = (lambda li: None) if s is None else (lambda li: s[li:li + 1])
        row(f"{name} [{kind}]" + ("" if xt is x else f", T = {xt.shape[0]}"),
            lambda: [gemv(lib, xt, ws[li:li + 1], sl(li), kd, sms) for li in range(layers)],
            (lambda: gemv(lib, xt, ws, s, kd, sms)) if stack else None, round=rnd,
            max_rel_err=err)

    for rnd in range(2):
        order = (lambda d: list(d)) if rnd == 0 else (lambda d: list(reversed(d)))
        for name in order(VARIANTS):
            variant(name, "bf16", VARIANTS[name][1], rnd)
        for kind in order(["q8_f32", "q8_bf16"]):
            variant("as built", kind, True, rnd)
        for name in order(["16 consumer warps", *Q8_VARIANTS]):
            variant(name, "q8_f32", {**VARIANTS, **Q8_VARIANTS}[name][1], rnd)
        bf, qs = w["bf16"], w["qs"]
        row("bf16 torch.matmul", lambda: [torch.matmul(x, bf[li].T) for li in range(layers)],
            lambda: torch.matmul(x, bf.reshape(-1, bf.shape[-1]).T), round=rnd)
        for stack in (bf, qs):
            row(f"stream probe (K18f / K18j) [{'bf16' if stack is bf else 'int8'}]",
                lambda stack=stack: [roofline.step_dma_probe((stack[li],), x)
                                     for li in range(layers)],
                lambda stack=stack: roofline.call3_dma_probe((stack,), x), round=rnd)
        # per-row cost: the tensor-core GEMV against the first design
        for t in (1, 8):
            xt = x[:t].contiguous()
            variant("as built", "q8_f32", True, rnd, xt=xt, stack=False)
            variant("q8: first design (CUDA-core GEMV)", "q8_f32", True, rnd, xt=xt, stack=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
