"""Weight-streaming strategy sweep (K19): the port of scripts/bench_dma_sweep.py.

How fast does the card stream an int8 (or bf16) weight stack into on-chip
memory, by tile size and by the depth of the copy pipeline? The script's
three probe factories keep their names: each returns call(ws, x) -> [TT, O]
f32 over ws = (stack [L, O, I], ...) and x bf16 [TT, I], with its plain
PyTorch version beside it (`<name>_plain(ws, x, ...)`); a CPU tensor takes
the plain version, a CUDA tensor launches the stream kernel of
csrc/probes.cu and adds one to the FACTORY's `launches`.

- probe_blockspec(to) (K19a): the stack in [to, I] tiles, double-buffered;
  output = the last tile's W[0:TT, 0:128] + x[0:TT, 0:1], padded to O columns.
- probe_manual_dma(depth, ch) (K19b): a depth-deep copy ring over [ch, I]
  chunks of the flattened stack; output = sum over chunks c, in order, of
  Wflat[c*ch : c*ch + TT, 0:128] (f32) + x[0:TT, 0:1], padded. This is the
  script's intended function: its kernel starts the copy of chunk c + depth
  into slot c % depth before reading that slot (bench_dma_sweep.py:107-108),
  so under plain Pallas interpretation it reads chunk c + depth instead. The
  port consumes a stage before refilling its slot.
- int8dot_manual_dma(depth, ch) (K19c): the same ring; out[t, 0] = sum over
  chunks of f32(sum over the chunk's rows r of (xq . Wflat[r])_int32), xq =
  clip(round(16 x)); columns 1.. zero (the same hazard at :157-158).

How (depth, ch) map onto Hopper is in csrc/probes.cu's header note. The
harness, as the script's `main`: R sweeps of each probe in one CUDA-graph
replay between CUDA events; one JSON row per probe with ms (per run and per
call), G values/s and GB/s of weight bytes; it asserts that the factory's
count grew by the launches it issued.

    python -m llamatpu_torch.bench.dma_sweep                 # the card, 24 x 4096 x 4096
    python -m llamatpu_torch.bench.dma_sweep --device cpu --layers 2 --o 1024 --i 512 --sweeps 1
"""
from __future__ import annotations

import argparse
import json

import torch

from llamatpu_torch.bench.roofline import TT, _cpu, make_weights, quantize_x, time_run
from llamatpu_torch.ops import probes

COLS = 128  # columns of the touched rows (the script's 128-lane output)


def _pad(y: torch.Tensor, o: int) -> torch.Tensor:
    out = torch.zeros((y.shape[0], o), dtype=torch.float32, device=y.device)
    out[:, :y.shape[1]] = y
    return out


# ---------------------------------------------------------------- K19a
def probe_blockspec_plain(ws, x, to: int):
    (wb,) = ws
    o = wb.shape[-2]
    t = x.shape[0]
    return _pad(wb[-1, o - to:o - to + t, :COLS].float() + x[:, :1].float(), o)


def probe_blockspec(to: int):
    def call(ws, x):
        if _cpu(x):
            return probe_blockspec_plain(ws, x, to)
        (wb,) = ws
        y = probes.stream(wb, x, to, 2, probes.S_LAST, x.shape[0], COLS, wb.shape[-2])
        probe_blockspec.launches += 1
        return y
    return call


# ---------------------------------------------------------------- K19b
def probe_manual_dma_plain(ws, x, depth: int, ch: int):
    del depth  # the ring's depth changes the rate, not the function
    (wb,) = ws
    o, i = wb.shape[-2:]
    t = x.shape[0]
    chunks = wb.reshape(-1, ch, i)[:, :t, :COLS].float()
    acc = torch.zeros((t, COLS), dtype=torch.float32, device=x.device)
    for c in range(chunks.shape[0]):  # in chunk order, as the TPU loop
        acc = acc + chunks[c]
    return _pad(acc + x[:, :1].float(), o)


def probe_manual_dma(depth: int, ch: int):
    def call(ws, x):
        if _cpu(x):
            return probe_manual_dma_plain(ws, x, depth, ch)
        (wb,) = ws
        y = probes.stream(wb, x, ch, depth, probes.S_SUM, x.shape[0], COLS, wb.shape[-2])
        probe_manual_dma.launches += 1
        return y
    return call


# ---------------------------------------------------------------- K19c
def int8dot_manual_dma_plain(ws, x, depth: int, ch: int):
    del depth
    qs = ws[0]
    o, i = qs.shape[-2:]
    xq = quantize_x(x)
    # exact integer dot of every row (float64, exact below 2^53), summed per
    # chunk and wrapped to int32 as the TPU's int32 sum
    p = (xq.double() @ qs.reshape(-1, i).double().T).reshape(x.shape[0], -1, ch).sum(-1)
    p = torch.remainder(p.to(torch.int64) + 2**31, 2**32) - 2**31
    acc = torch.zeros((x.shape[0], 1), dtype=torch.float32, device=x.device)
    for c in range(p.shape[1]):
        acc = acc + p[:, c:c + 1].float()
    return _pad(acc, o)


def int8dot_manual_dma(depth: int, ch: int):
    def call(ws, x):
        if _cpu(x):
            return int8dot_manual_dma_plain(ws, x, depth, ch)
        qs = ws[0]
        y = probes.stream(qs, quantize_x(x), ch, depth, probes.S_DOT, x.shape[0], 1,
                          qs.shape[-2])
        int8dot_manual_dma.launches += 1
        return y
    return call


FACTORIES = (probe_blockspec, probe_manual_dma, int8dot_manual_dma)
for _f in FACTORIES:
    _f.launches = 0


def probes_of(w: dict) -> list[tuple]:
    """(name, factory, call, weights, bytes per value): the script's rows."""
    o = w["qs"].shape[-2]
    rows = [(f"blockspec_probe_int8 to={to}", probe_blockspec, probe_blockspec(to),
             (w["qs"],), 1) for to in (256, 1024, 2048) if o % to == 0]
    for depth, ch in ((2, 512), (4, 512), (8, 256), (4, 1024), (8, 512), (16, 256)):
        rows.append((f"manual_probe_int8 d={depth} ch={ch}", probe_manual_dma,
                     probe_manual_dma(depth, ch), (w["qs"],), 1))
    rows.append(("manual_probe_bf16 d=4 ch=512", probe_manual_dma, probe_manual_dma(4, 512),
                 (w["bf16"],), 2))
    for depth, ch in ((4, 512), (8, 256), (8, 512)):
        rows.append((f"manual_int8dot d={depth} ch={ch}", int8dot_manual_dma,
                     int8dot_manual_dma(depth, ch), (w["qs"], None), 1))
    return rows


def bench(w: dict, sweeps: int, device, names=None) -> list[dict]:
    layers, o, i = w["bf16"].shape
    x = w["x"]
    out = []
    for name, factory, call, ws, bpv in probes_of(w):
        if names is not None and name not in names:
            continue
        before = factory.launches
        secs = time_run(lambda call=call, ws=ws: [call(ws, x) for _ in range(sweeps)], device)
        launches = factory.launches - before
        want = 0 if device.type == "cpu" else 2 * sweeps
        assert launches == want, f"{name}: {launches} launches counted, {want} issued"
        vals = layers * sweeps * o * i
        out.append({"bench": "dma_sweep", "probe": name, "function": factory.__name__,
                    "device": str(device), "L": layers, "O": o, "I": i, "R": sweeps,
                    "ms": secs * 1e3, "ms_per_call": secs * 1e3 / sweeps,
                    "gvals_s": vals / secs / 1e9, "gbs": vals * bpv / secs / 1e9,
                    "launches": launches})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="weight-streaming strategy sweep (K19)")
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
