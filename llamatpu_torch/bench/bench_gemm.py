"""Prefill GEMM A/B on the card: the port of scripts/bench_gemm.py.

At llama32-1b's four prefill projections (T = 512 rows by default; 128 is
the serving chunk), three ways to compute y[T, O] = (xi8 . qs^T) * ax * s
from the same int8 operands (qs, row scales and x from a numpy seed, x
quantized per row as the prefill path does): the library (`torch._int_mm`,
then the epilogue as torch ops), K4 (`ops.gemm.rowq_gemm`, int8 tensor
cores, int32 sums) and K17 (`rowq_gemm(variant="bf16")`, bf16 tensor cores,
f32 sums), and beside them K17's own yardstick, bf16 `torch.matmul` of the
operands cast once outside the timing (bf16 out, no epilogue). Each is timed
as `rep` calls captured in one CUDA graph and replayed between CUDA events.
One JSON row per shape: ms per call (`library_ms`, `k4_ms`, `k17_ms`,
`library_bf16_ms`), TFLOP/s of each and its share of the card's dense int8
peak (1979 TOP/s, H100 SXM data sheet), and each result's max difference from
the exact plain version. It asserts that K4's and K17's counts grew by the
launches it issued (the check calls after the timing are not counted in the
row).

    python -m llamatpu_torch.bench.bench_gemm [T]
    python -m llamatpu_torch.bench.bench_gemm 128
    python -m llamatpu_torch.bench.bench_gemm 64 --device cpu
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from llamatpu_torch.bench.roofline import time_run
from llamatpu_torch.ops import gemm
from llamatpu_torch.ops.int8_prefill import quantize_activation_rows

INT8_PEAK = 1979e12  # dense int8 TOP/s of one H100 SXM (700 W)
SHAPES = {  # llama32-1b prefill GEMMs (O, I)
    "wqkv": (2560, 2048),
    "wo": (2048, 2048),
    "w13": (16384, 2048),
    "w2": (2048, 8192),
}


def library_gemm(qs, sc, xi8, ax) -> torch.Tensor:
    """The same function through the library: torch._int_mm, then the epilogue."""
    return torch._int_mm(xi8, qs.t()).float() * ax * sc[:, 0][None, :]


def operands(o: int, i: int, t: int, device, rng) -> tuple:
    qs = torch.from_numpy(rng.integers(-127, 128, (o, i), dtype=np.int8)).to(device)
    sc = torch.from_numpy(rng.random((o, 1), dtype=np.float32) / 127).to(device)
    x = torch.from_numpy(rng.standard_normal((t, i), dtype=np.float32)).to(device)
    xi8, ax = quantize_activation_rows(x.to(torch.bfloat16))
    return qs, sc, xi8.contiguous(), ax.contiguous()


def bench(t: int, rep: int, device, shapes=SHAPES) -> list[dict]:
    rng = np.random.default_rng(0)
    out = []
    for name, (o, i) in shapes.items():
        qs, sc, xi8, ax = operands(o, i, t, device, rng)
        flops = 2.0 * t * o * i * rep
        row = {"bench": "gemm-ab", "shape": name, "device": str(device), "T": t, "O": o, "I": i}
        xb, wb = xi8.to(torch.bfloat16), qs.to(torch.bfloat16)
        fns = {"library": lambda: library_gemm(qs, sc, xi8, ax),
               "k4": lambda: gemm.rowq_gemm(qs, sc, xi8, ax),
               "k17": lambda: gemm.rowq_gemm(qs, sc, xi8, ax, variant="bf16"),
               "library_bf16": lambda: torch.matmul(xb, wb.T)}
        if device.type == "cpu":  # torch._int_mm is a CUDA operator; the CPU times the plain versions
            del fns["library"], fns["library_bf16"]
        before = (gemm.rowq_gemm.launches, gemm.rowq_gemm_bf16.launches)
        for tag, fn in fns.items():
            secs = time_run(lambda fn=fn: [fn() for _ in range(rep)], device)
            row[f"{tag}_ms"] = secs * 1e3 / rep
            row[f"{tag}_tflops"] = flops / secs / 1e12
            row[f"{tag}_pct_int8_peak"] = flops / secs / INT8_PEAK * 100
        calls = 0 if device.type == "cpu" else 2 * rep  # warm-up + capture
        row["launches"] = {"k4": gemm.rowq_gemm.launches - before[0],
                           "k17": gemm.rowq_gemm_bf16.launches - before[1]}
        assert row["launches"] == {"k4": calls, "k17": calls}, row["launches"]
        # correctness: each against the exact plain version
        want = gemm.rowq_gemm_plain(qs, sc, xi8, ax)
        for tag, fn in fns.items():
            if tag != "library_bf16":  # bf16 out: a yardstick of time only
                row[f"{tag}_maxdiff"] = float((fn() - want).abs().max())
        row["max_abs"] = float(want.abs().max())
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="prefill GEMM A/B: library, K4, K17")
    ap.add_argument("t", nargs="?", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rep", type=int, default=32)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; --device cpu runs the plain versions")
    for row in bench(args.t, args.rep, device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
