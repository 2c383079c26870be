"""What bounds the tensor-core GEMV of K18a / K18i (bf16 weights), K18b /
K18c / K18g (int8 weights, the dequantization in the B fragments) and K18d /
K18e / K18h (its W_S8 kind: int8 weights times int8 xq, int32 sums) on the
card: csrc/probes.cu `probe_gemv_tc_kernel` as built beside copies of it with
one piece changed, bf16 `torch.matmul` and the stream probe K18f / K18j over
the bf16 and the int8 stack; and the per-row cost against the first
CUDA-core design of the q8 forms, and the first (dp4a) design of the int8
dots, each rebuilt as a variant.

    python -m llamatpu_torch.bench.gemv_ablation     # the card; one JSON row a variant
    python -m llamatpu_torch.bench.gemv_ablation --tables s8   # the int8 dots only

Each variant is csrc/probes.cu (its shared header tc_gemv.cuh written in)
with a constant or a few statements replaced, or another plan (VARIANTS,
timed on the bf16 stack; Q8_VARIANTS, timed on the int8 stack in the
W_Q8_F32 kind; S8_VARIANTS, timed on the int8 stack as K18d and K18h, and
with block scales as K18e), built by nvcc into build/ablation/ and called
through its own `lt_probe_gemv` / `lt_probe_int8dot` under `ops/probes.py
plan_gemv` (or a forced two-slice plan). Every variant that still computes
the product is held to the plain one: within 1e-5 of its largest output, the
int8 dots without scales exactly; those that drop x, the dequantization or
the products (to time the rest alone) are not. Times as bench/roofline.py
takes them (a CUDA graph replayed between CUDA events, best of 3): one [4096,
4096] layer of 24 in turn, per call, and the [24, 4096, 4096] stack, in two
rounds of alternating order. Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
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
MMA_S8 = "mma_s8(acc[(i0 + i) & 1], xq[(st * S::steps + i0 + i) / 2], bf[i]);"
CORR = "const float corr = block_corr(sv, xv, bs_row(u), a.xsc, a.NB, a.T, lane);"
READ_SCALES = "read_block_scales(sv, bs_slot(n));"
CVT = "const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n  return *reinterpret_cast<const uint32_t*>(&v);"

# The first design of the q8 forms (a CUDA-core GEMV, since replaced),
# appended to the source as `lt_probe_gemv_first`: a warp takes kRows weight
# rows, each lane 16 int8 weights a load with their 16 f32 scales, x staged in
# shared memory in f32 kTileK columns at a time.
FIRST_CONSTS = r'''
namespace {
constexpr int kRows = 2;      // weight rows a warp
constexpr int kTileK = 1024;  // x columns staged a pass
}  // namespace
'''
FIRST_DESIGN = FIRST_CONSTS + r'''
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
# The first design of K18d, e, h (a dp4a GEMV, since replaced), appended as
# `lt_probe_int8dot_first`: a warp takes kRows weight rows, a lane one
# 16-byte load of a row at a time, xq staged in shared memory kTileK columns
# at a time between two block barriers, the block-scale corrections a lane-0
# loop of NB dependent products each.
S8_FIRST_DESIGN = FIRST_CONSTS + r'''
namespace {
__global__ void __launch_bounds__(kThreads) probe_int8dot_first_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ w, const float* __restrict__ s,
    const float* __restrict__ xsc, float* __restrict__ y, int T, int O, int I, int NB,
    int blockscale) {
  __shared__ __align__(16) int8_t xs[kMaxT][kTileK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const long layer = blockIdx.y;
  const int o0 = (blockIdx.x * nwarps + warp) * kRows;
  int acc[kRows][kMaxT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) acc[r][t] = 0;
  for (int k0 = 0; k0 < I; k0 += kTileK) {
    const int kt = min(kTileK, I - k0);
    for (int i = threadIdx.x; i < T * kt; i += blockDim.x) {
      const int t = i / kt, k = i - t * kt;
      xs[t][k] = xq[static_cast<long>(t) * I + k0 + k];
    }
    __syncthreads();
    for (int c = lane; c < kt / 16; c += 32) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int o = o0 + r;
        if (o >= O) break;
        const int4 wv = __ldg(reinterpret_cast<const int4*>(w + (layer * O + o) * I + k0) + c);
#pragma unroll
        for (int t = 0; t < kMaxT; ++t) {
          if (t < T) {
            const int4 xv = *reinterpret_cast<const int4*>(&xs[t][c * 16]);
            int a = acc[r][t];
            a = __dp4a(wv.x, xv.x, a);
            a = __dp4a(wv.y, xv.y, a);
            a = __dp4a(wv.z, xv.z, a);
            acc[r][t] = __dp4a(wv.w, xv.w, a);
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
      const int v = warp_isum(acc[r][t]);
      if (lane == 0 && o < O && t < T) {
        float out = static_cast<float>(v);
        if (blockscale) {  // corr[o, t] = sum_b s[o, b] * xs[t, b], f32 in b order
          const float* so = s + (layer * O + o) * NB;
          float corr = 0.f;
          for (int b = 0; b < NB; ++b) corr = __fadd_rn(corr, __fmul_rn(so[b], xsc[t * NB + b]));
          out = __fmul_rn(out, corr);
        }
        y[(layer * T + t) * O + o] = out;
      }
    }
  }
}
}  // namespace

LT_EXPORT int lt_probe_int8dot_first(const void* xq, const void* w, const void* s,
                                     const void* xsc, void* y, int T, int O, int I, int L, int NB,
                                     int blockscale, void* stream) {
  const int per_block = (kThreads / 32) * kRows;
  dim3 grid((O + per_block - 1) / per_block, L);
  probe_int8dot_first_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w), static_cast<const float*>(s),
      static_cast<const float*>(xsc), static_cast<float*>(y), T, O, I, NB, blockscale);
  return static_cast<int>(cudaGetLastError());
}
'''
S8_FIRST_SIGNATURE = tuple(ctypes.c_void_p if i in (0, 1, 2, 3, 4, 11) else ctypes.c_int
                           for i in range(12))
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
# S8_VARIANTS time the W_S8 kind (K18d a layer, K18h the stack, K18e a layer):
# name: (source transform, computes the product, a forced two-slice plan).
S8_VARIANTS = {
    "s8: as built": (lambda s: s, True, False),
    "s8: forced two-slice plan": (lambda s: s, True, True),
    "s8: no products (the stream)": (
        lambda s: s.replace(MMA_S8, "acc[0][0] += static_cast<int>(bf[i][0] ^ bf[i][1]);"),
        False, False),
    "s8: block scales read at the unit's end (no lookahead)": (
        lambda s: s.replace(READ_SCALES, "load_block_scales(sv, bs_row(u), a.NB, lane);"),
        True, False),
    "s8: block scales one unit ahead": (_const("kScaleAhead", 1), True, False),
    "s8: block scales three units ahead": (_const("kScaleAhead", 3), True, False),
    "s8: no block-scale reads (zero-filled copies)": (
        lambda s: s.replace('"l"(row + min(b, NB - 1)), "r"(b < NB ? 4 : 0)', '"l"(row), "r"(0)'),
        False, False),
    "s8: no corrections (scales copied, corr a scale)": (
        lambda s: s.replace(CORR, "const float corr = sv[0];"), False, False),
    "s8: first design (dp4a GEMV)": (lambda s: s + S8_FIRST_DESIGN, True, False),
}
TABLES = {"bf16": VARIANTS, "q8": Q8_VARIANTS, "s8": S8_VARIANTS}


def source() -> str:
    """csrc/probes.cu with its shared header csrc/tc_gemv.cuh written in place
    of the #include, so that a variant can edit the helpers it shares with
    moe_grouped.cu (dequant4, pack_bf16x2) in its own copy only."""
    header = (_build.CSRC / "tc_gemv.cuh").read_text().replace("#pragma once\n", "")
    return (_build.CSRC / "probes.cu").read_text().replace('#include "tc_gemv.cuh"\n', header, 1)


def build(out_dir, tables=("bf16", "q8", "s8")) -> dict:
    """{variant: ctypes library} for the variants of the named tables,
    compiled in parallel; variants with the same source share a library."""
    src = source()
    out_dir.mkdir(parents=True, exist_ok=True)
    edits = {}
    for table in tables:
        edits.update({n: v[0] for n, v in TABLES[table].items()})
    if "q8" in tables:
        edits.update({n: VARIANTS[n][0] for n in ("as built", "16 consumer warps")})
    procs, by_text = {}, {}
    for n, (name, edit) in enumerate(edits.items()):
        text = edit(src)
        assert text != src or "as built" in name or "plan" in name, \
            f"variant {name!r} changed nothing"
        if text in by_text:
            procs[name] = procs[by_text[text]]
            continue
        by_text[text] = name
        cu, so = out_dir / f"probes_{n}.cu", out_dir / f"probes_{n}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, done = {}, {}
    for name, (proc, so) in procs.items():
        if so not in done:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
            lib = ctypes.CDLL(str(so))
            sig = _build._SIGNATURES["probes"]
            lib.lt_probe_gemv.argtypes = list(sig["lt_probe_gemv"])
            lib.lt_probe_int8dot.argtypes = list(sig["lt_probe_int8dot"])
            if hasattr(lib, "lt_probe_gemv_first"):
                lib.lt_probe_gemv_first.argtypes = list(FIRST_SIGNATURE)
            if hasattr(lib, "lt_probe_int8dot_first"):
                lib.lt_probe_int8dot_first.argtypes = list(S8_FIRST_SIGNATURE)
            done[so] = lib
        libs[name] = done[so]
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


def int8dot(lib, xq, w, s, xsc, sms: int, split: bool = False) -> torch.Tensor:
    """ops/probes.py int8dot on the variant's library, under plan_gemv or a
    forced two-slice plan (the first design's own launch where the variant
    has it)."""
    lay, o, i = w.shape
    t, nb = xq.shape[0], 0 if s is None else s.shape[-1]
    sp, xp = (0, 0) if s is None else (s.data_ptr(), xsc.data_ptr())
    y = torch.empty((lay, t, o), dtype=torch.float32, device=xq.device)
    if hasattr(lib, "lt_probe_int8dot_first"):
        err = lib.lt_probe_int8dot_first(xq.data_ptr(), w.data_ptr(), sp, xp, y.data_ptr(), t, o,
                                         i, lay, nb, int(s is not None), _build.stream())
        _build.check(lib, err, "gemv ablation")
        return y
    plan = (probes.GemvPlan(o, i, lay, 2, sms - sms % 2) if split
            else probes.plan_gemv(o, i, lay, sms))
    part = (torch.empty((plan.nks, lay, t, o), dtype=torch.int32, device=xq.device)
            if plan.nks > 1 else None)
    err = lib.lt_probe_int8dot(xq.data_ptr(), w.data_ptr(), sp, xp, y.data_ptr(),
                               0 if part is None else part.data_ptr(), t, o, i, lay, nb, plan.nks,
                               plan.ctas, _build.stream())
    _build.check(lib, err, "gemv ablation")
    return y


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the tensor-core GEMV's ablation variants")
    ap.add_argument("--tables", default="bf16,q8,s8",
                    help="comma-separated tables to time: bf16, q8 (with the yardsticks), s8")
    tables = ap.parse_args(argv).tables.split(",")
    if not torch.cuda.is_available():
        raise RuntimeError("gemv_ablation times the card's kernels: no CUDA device")
    dev = torch.device("cuda")
    w = roofline.make_weights(24, 4096, 4096, dev)
    x = w["x"]
    layers = w["bf16"].shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build(_build.BUILD_DIR.parent / "ablation", tables)
    deq = {probes.W_Q8_F32: roofline.deq_q8_current, probes.W_Q8_BF16: roofline.deq_q8_bf16mul}
    # (weights, scales, kind): the bf16 stack, the int8 stack in both kinds
    kinds = {"bf16": (w["bf16"], None, probes.W_BF16),
             "q8_f32": (w["qs"], w["ss"], probes.W_Q8_F32),
             "q8_bf16": (w["qs"], w["ss"], probes.W_Q8_BF16)}
    want = {k: x.float() @ (ws.float() if s is None else torch.stack(
        [deq[kd](ws[li], s[li]) for li in range(layers)]).float()).transpose(-1, -2)
        for k, (ws, s, kd) in kinds.items() if ("bf16" if k == "bf16" else "q8") in tables}
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

    # K18d / K18h (no scales) and K18e (block scales, xsc = ones as the script)
    qs, ss = w["qs"], w["ss"]
    xq = roofline.quantize_x(x)
    xsc = torch.ones((xq.shape[0], ss.shape[-1]), dtype=torch.float32, device=dev)
    if "s8" in tables:
        s8_want = roofline._int_dot(xq, qs)
        bs_want = s8_want * (ss @ xsc.T).transpose(-1, -2)

    def variant_s8(name, rnd):
        lib, (_, computes, split) = libs[name], S8_VARIANTS[name]
        for bs in (False, True):
            s, xs = (ss, xsc) if bs else (None, None)
            err = None
            if computes:
                got = int8dot(lib, xq, qs, s, xs, sms, split)
                torch.cuda.synchronize()
                if bs:
                    err = ((got - bs_want).abs().max() / bs_want.abs().max()).item()
                    assert err <= 1e-5, f"{name} (block scales): rel err {err}"
                else:
                    assert torch.equal(got, s8_want), f"{name}: not exact"
                    err = 0.0
            sl = (lambda li: None) if s is None else (lambda li: s[li:li + 1])
            row(f"{name} [{'s8 block scales' if bs else 's8'}]",
                lambda: [int8dot(lib, xq, qs[li:li + 1], sl(li), xs, sms, split)
                         for li in range(layers)],
                None if bs else (lambda: int8dot(lib, xq, qs, None, None, sms, split)),
                round=rnd, max_rel_err=err)

    for rnd in range(2):
        order = (lambda d: list(d)) if rnd == 0 else (lambda d: list(reversed(d)))
        if "s8" in tables:
            for name in order(S8_VARIANTS):
                variant_s8(name, rnd)
        if "bf16" in tables:
            for name in order(VARIANTS):
                variant(name, "bf16", VARIANTS[name][1], rnd)
        if "q8" not in tables:
            continue
        for kind in order(["q8_f32", "q8_bf16"]):
            variant("as built", kind, True, rnd)
        for name in order(["16 consumer warps", *Q8_VARIANTS]):
            variant(name, "q8_f32", {**VARIANTS, **Q8_VARIANTS}[name][1], rnd)
        bf = w["bf16"]
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
