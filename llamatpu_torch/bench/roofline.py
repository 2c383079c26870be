"""Weight-stream rate probes (K18): the port of scripts/bench_roofline.py.

What byte rate does each way of consuming a weight stream reach on the card?
Each probe function keeps the script's name and its function, with its plain
PyTorch version beside it (`<name>_plain`); a CPU tensor takes the plain
version, a CUDA tensor launches csrc/probes.cu (through ops/probes.py) and
adds one to the function's `launches`. The 2-D steps take one layer (w a
tuple: (wb,) or (qs, ss)), x bf16 [TT, I], and return [TT, O] f32; the
`call3_*` forms take the whole [L, O, I] stack in one call, compute every
layer and return layer 0's [TT, O]. The Q8_0 scales ss are [.., O, NB], NB
= I / 32, and the script's `pltpu.repeat` TILES them along the columns:
column k is scaled by ss[o, k % NB].

`step_xla_bf16`, `call_big_xla_bf16` and the script's other XLA rows reach
no Pallas kernel: here they are library rows (`torch.matmul`), yardsticks,
not kernels; `step_repo_q8` is the already ported K5 (ops/quant_matmul.py).

The harness, as the script's `main` and `main2`: R sweeps over an L-layer
stack, the 2-D steps once per layer, the stacked forms once per sweep, all R
sweeps captured in one CUDA graph and replayed between CUDA events (a host
issuing each launch would measure itself); one JSON row per variant: ms per
run and per call, G values/s, the int8 and bf16 byte rates of the script's
report and the variant's own weight bytes per second. It asserts that each
function's count grew by the launches the harness issued.

    python -m llamatpu_torch.bench.roofline                  # the card, 24 x 4096 x 4096
    python -m llamatpu_torch.bench.roofline --device cpu --layers 2 --o 1024 --i 512 --sweeps 1

On the CPU the plain versions run and the times are host times of PyTorch's
CPU kernels, labelled so (never a device rate).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from llamatpu_torch.ops import probes

BLOCK = 32      # Q8_0 block: NB = I / BLOCK scales per row
TO = 512        # weight rows per TPU program (the stream probes' tile)
TT = 8          # activation rows (the TPU harness pads T = 1 to 8)


def _cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _tile_scales(ss: torch.Tensor, i: int) -> torch.Tensor:
    """pltpu.repeat(ss, BLOCK, axis=-1) = jnp.tile: [.., O, NB] -> [.., O, NB * BLOCK]."""
    reps = [1] * (ss.dim() - 1) + [i // ss.shape[-1]]
    return ss.repeat(*reps)


def deq_q8_current(qs, ss) -> torch.Tensor:
    """bf16(f32(qs) * tiled ss): step_q8_current's weight."""
    return (qs.float() * _tile_scales(ss, qs.shape[-1])).to(torch.bfloat16)


def deq_q8_bf16mul(qs, ss) -> torch.Tensor:
    """bf16(qs) * bf16(tiled ss), the product rounded to bf16: step_q8_bf16mul's."""
    return qs.to(torch.bfloat16) * _tile_scales(ss.to(torch.bfloat16), qs.shape[-1])


def quantize_x(x) -> torch.Tensor:
    """xq = clip(round(16 x), -127, 127) as int8 (round half to even), outside
    the kernel as in the script."""
    return torch.clamp(torch.round(x.float() * 16.0), -127, 127).to(torch.int8)


def _int_dot(xq, w) -> torch.Tensor:
    """Exact (xq . w^T) as f32 over the last axis of w ([.., O, I]): float64
    sums, exact below 2^53."""
    return torch.matmul(xq.double(), w.double().transpose(-1, -2)).float()


# ------------------------------------------------------------------ 2-D steps
def step_xla_bf16(w, x):
    """Library row: one torch.matmul (the script's XLA dot)."""
    (wb,) = w
    return torch.matmul(x.float(), wb.float().T) if _cpu(x) else torch.matmul(x, wb.T).float()


def step_pallas_bf16_plain(w, x):
    (wb,) = w
    return x.float() @ wb.float().T


def step_pallas_bf16(w, x):
    """K18a: y = x . W^T, bf16 weights, f32 sums (the tensor-core GEMV)."""
    if _cpu(x):
        return step_pallas_bf16_plain(w, x)
    y = probes.gemv_bf16(x, w[0])[0]
    step_pallas_bf16.launches += 1
    return y


def step_q8_current_plain(w, x):
    qs, ss = w
    return x.float() @ deq_q8_current(qs, ss).float().T


def step_q8_current(w, x):
    """K18b: W = bf16(f32(qs) * tiled ss), then x . W^T."""
    if _cpu(x):
        return step_q8_current_plain(w, x)
    y = probes.gemv(x, w[0], w[1], probes.W_Q8_F32)[0]
    step_q8_current.launches += 1
    return y


def step_q8_bf16mul_plain(w, x):
    qs, ss = w
    return x.float() @ deq_q8_bf16mul(qs, ss).float().T


def step_q8_bf16mul(w, x):
    """K18c: W = bf16(qs) * bf16(tiled ss) rounded to bf16, then x . W^T."""
    if _cpu(x):
        return step_q8_bf16mul_plain(w, x)
    y = probes.gemv(x, w[0], w[1], probes.W_Q8_BF16)[0]
    step_q8_bf16mul.launches += 1
    return y


def step_q8_int8dot_plain(w, x):
    return _int_dot(quantize_x(x), w[0])


def step_q8_int8dot(w, x):
    """K18d: f32((xq . qs^T)_int32), xq = clip(round(16 x))."""
    if _cpu(x):
        return step_q8_int8dot_plain(w, x)
    y = probes.int8dot(quantize_x(x), w[0])[0]
    step_q8_int8dot.launches += 1
    return y


def _ones_xs(x, nb):
    return torch.ones((x.shape[0], nb), dtype=torch.float32, device=x.device)


def step_q8_int8dot_blockscale_plain(w, x):
    qs, ss = w
    corr = ss @ _ones_xs(x, ss.shape[-1]).T              # [O, TT]
    return _int_dot(quantize_x(x), qs) * corr.T


def step_q8_int8dot_blockscale(w, x):
    """K18e: f32((xq . qs^T)_int32) * (ss . xs^T)^T with xs = ones [TT, NB]."""
    if _cpu(x):
        return step_q8_int8dot_blockscale_plain(w, x)
    qs, ss = w
    y = probes.int8dot(quantize_x(x), qs, ss, _ones_xs(x, ss.shape[-1]))[0]
    step_q8_int8dot_blockscale.launches += 1
    return y


def step_dma_probe_plain(w, x, to: int = TO):
    (wb,) = w
    o = wb.shape[-2]
    y = torch.zeros((x.shape[0], o), dtype=torch.float32, device=x.device)
    y[0, :to] = wb[o - to, :to].float() + x[0, 0].float()
    return y


def step_dma_probe(w, x, to: int = TO):
    """K18f: every [to, I] tile streamed; row 0, columns 0:to of the output =
    the last tile's W[0, 0:to] + x[0, 0]; the rest 0."""
    if _cpu(x):
        return step_dma_probe_plain(w, x, to)
    (wb,) = w
    y = probes.stream(wb, x, to, 2, probes.S_LAST, 1, to, wb.shape[-2])
    step_dma_probe.launches += 1
    return y


# ------------------------------------------------------------- stacked forms
def call3_q8_current_plain(ws, x):
    qs, ss = ws
    return (x.float() @ deq_q8_current(qs, ss).float().transpose(-1, -2))[0]


def call3_q8_current(ws, x):
    """K18g: K18b over every layer of the stack in one call; layer 0's result."""
    if _cpu(x):
        return call3_q8_current_plain(ws, x)
    y = probes.gemv(x, ws[0], ws[1], probes.W_Q8_F32)[0]
    call3_q8_current.launches += 1
    return y


def call3_q8_int8dot_plain(ws, x):
    return _int_dot(quantize_x(x), ws[0])[0]


def call3_q8_int8dot(ws, x):
    """K18h: K18d over every layer of the stack in one call; layer 0's result."""
    if _cpu(x):
        return call3_q8_int8dot_plain(ws, x)
    y = probes.int8dot(quantize_x(x), ws[0])[0]
    call3_q8_int8dot.launches += 1
    return y


def call3_bf16_plain(ws, x):
    (wb,) = ws
    return (x.float() @ wb.float().transpose(-1, -2))[0]


def call3_bf16(ws, x):
    """K18i: K18a over every layer of the stack in one call; layer 0's result."""
    if _cpu(x):
        return call3_bf16_plain(ws, x)
    y = probes.gemv_bf16(x, ws[0])[0]
    call3_bf16.launches += 1
    return y


def call3_dma_probe_plain(ws, x, to: int = TO):
    (wb,) = ws
    o = wb.shape[-2]
    y = torch.zeros((x.shape[0], o), dtype=torch.float32, device=x.device)
    t = x.shape[0]
    y[:, :to] = wb[-1, o - to:o - to + t, :to].float() + x[:, :1].float()
    return y


def call3_dma_probe(ws, x, to: int = TO):
    """K18j: the stack streamed in [to, I] tiles; output = the last tile's
    W[0:TT, 0:to] + x[0:TT, 0:1], padded to [TT, O]."""
    if _cpu(x):
        return call3_dma_probe_plain(ws, x, to)
    (wb,) = ws
    y = probes.stream(wb, x, to, 2, probes.S_LAST, x.shape[0], to, wb.shape[-2])
    call3_dma_probe.launches += 1
    return y


def call_big_xla_bf16(ws, x):
    """Library row: one torch.matmul over the flattened stack; layer 0's columns."""
    (wb,) = ws
    o, i = wb.shape[-2:]
    if _cpu(x):
        return (x.float() @ wb.reshape(-1, i).float().T)[:, :o]
    return torch.matmul(x, wb.reshape(-1, i).T)[:, :o].float()


KERNELS = (step_pallas_bf16, step_q8_current, step_q8_bf16mul, step_q8_int8dot,
           step_q8_int8dot_blockscale, step_dma_probe, call3_q8_current, call3_q8_int8dot,
           call3_bf16, call3_dma_probe)
for _f in KERNELS:
    _f.launches = 0


# ------------------------------------------------------------------ harness
def make_weights(layers: int, o: int, i: int, device, seed: int = 0) -> dict:
    """The script's stacks from a seed, made on the device: bf16 weights,
    int8 Q8_0 values and their f32 scales [L, O, I / 32], x bf16 [TT, I]."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {"bf16": torch.randn((layers, o, i), generator=g, device=device).to(torch.bfloat16),
            "qs": torch.randint(-127, 128, (layers, o, i), dtype=torch.int8, generator=g,
                                device=device),
            "ss": torch.randn((layers, o, i // BLOCK), generator=g, device=device).abs() * 0.01,
            "x": (torch.randn((TT, i), generator=g, device=device) * 0.1).to(torch.bfloat16)}


def variants(w: dict) -> list[tuple]:
    """(name, fn, weights, stacked, weight bytes per value) as the script's
    two tables: 2-D steps per layer, then the stacked forms per sweep."""
    bf, q8, qsonly = (w["bf16"],), (w["qs"], w["ss"]), (w["qs"],)
    q8_bytes = 1 + 4 / BLOCK
    return [("dma_probe_bf16", step_dma_probe, bf, False, 2),
            ("dma_probe_int8", step_dma_probe, qsonly, False, 1),
            ("xla_bf16", step_xla_bf16, bf, False, 2),
            ("pallas_bf16", step_pallas_bf16, bf, False, 2),
            ("q8_current", step_q8_current, q8, False, q8_bytes),
            ("q8_bf16mul", step_q8_bf16mul, q8, False, q8_bytes),
            ("q8_int8dot", step_q8_int8dot, q8, False, 1),
            ("q8_int8dot_blockscale", step_q8_int8dot_blockscale, q8, False, q8_bytes),
            ("3d_dma_probe_bf16", call3_dma_probe, bf, True, 2),
            ("3d_dma_probe_int8", call3_dma_probe, qsonly, True, 1),
            ("3d_bf16", call3_bf16, bf, True, 2),
            ("3d_q8_current", call3_q8_current, q8, True, q8_bytes),
            ("3d_q8_int8dot", call3_q8_int8dot, qsonly, True, 1),
            ("big_xla_bf16", call_big_xla_bf16, bf, True, 2)]


def time_run(run, device, reps: int = 3) -> float:
    """Seconds of the best of `reps` runs. On the card: run() captured once in
    a CUDA graph (after one warm call) and replayed between CUDA events; on
    the CPU: the host clock around run()."""
    if device.type == "cpu":
        run()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    del graph
    return best


def bench(w: dict, sweeps: int, device, names=None) -> list[dict]:
    """One row per variant: R sweeps of the L-layer stack timed as one run."""
    layers, o, i = w["bf16"].shape
    x = w["x"]
    rows = []
    for name, fn, ws, stacked, bpv in variants(w):
        if names is not None and name not in names:
            continue

        def run(fn=fn, ws=ws, stacked=stacked):
            for _ in range(sweeps):
                if stacked:
                    fn(ws, x)
                else:
                    for li in range(layers):
                        fn(tuple(t[li] for t in ws), x)
        counted = fn in KERNELS
        before = fn.launches if counted else 0
        secs = time_run(run, device)
        per_run = sweeps * (1 if stacked else layers)
        launches = fn.launches - before if counted else None
        if counted:  # warm call + captured run on the card; none on the CPU
            want = 0 if device.type == "cpu" else 2 * per_run
            assert launches == want, f"{name}: {launches} launches counted, {want} issued"
        vals = layers * sweeps * o * i
        rows.append({"bench": "roofline", "variant": name, "function": fn.__name__,
                     "device": str(device), "L": layers, "O": o, "I": i, "R": sweeps,
                     "ms": secs * 1e3, "ms_per_call": secs * 1e3 / per_run,
                     "gvals_s": vals / secs / 1e9,
                     "int8_gbs": vals / secs / 1e9, "bf16_gbs": 2 * vals / secs / 1e9,
                     "weight_gbs": vals * bpv / secs / 1e9, "launches": launches})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="weight-stream rate probes (K18)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--o", type=int, default=4096)
    ap.add_argument("--i", type=int, default=4096)
    ap.add_argument("--sweeps", type=int, default=24)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; --device cpu runs the plain versions")
    w = make_weights(args.layers, args.o, args.i, device)
    for row in bench(w, args.sweeps, device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
