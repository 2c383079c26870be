"""K14, K15 and K3 end to end: the decode windows of chip_smoke.py's
long-context paths and of its main path on Llama-3.2-1B (full width and
depth, synthetic q8_0 served as q8_row, seed 0, built with context 32768):
cache 32768, prefill chunk 512, a 32000-token seeded prompt, then 128 greedy
decode tokens, in bf16 KV (K14 fused) and int8 KV (K14 fused int8); the K15
path, f32 KV at cache 4000 with a 3000-token prompt and 32 tokens; the main
path, bf16 KV at cache 1024 with a 512-token prompt and 128 tokens (K3 every
layer and step). Per path: decode tok/s over the untraced steps (`--repeat`
runs of them), then a traced 16-step window read by the tree's own chip_smoke.py
`device_breakdown` (the device busy ms, the union of the trace's intervals;
the idle share of the window's host wall; each kernel's ms): the path's
kernel's ms and share of busy, and its ms a call (`attn_*`: the attention
kernel of K14 / K15, the whole layer for K3).

    python -m llamatpu_torch.bench.long_ab [--label L] [--out FILE] [--paths main,k15]
    PYTHONPATH=<tree> python llamatpu_torch/bench/long_ab.py --label parent

It times whatever `llamatpu_torch` imports, and reads the trace with the
chip_smoke.py beside that package: with another checkout first on
PYTHONPATH, that tree's kernels (the walk kernel, for a parent commit).
Compare trees within one call only, in turns (parent, change, change,
parent): host walls move up to 2x between runs. One JSON row a path, with
the card's name and power limit. Needs the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

# K14's and K15's kernels as the profiler names them: this design's and the
# walk kernel's (its two passes) before it
ATTN_KERNELS = ("stripe_cluster_kernel", "attn_walk")
# K3's: this design's attention and GEMV phases, the first design's append +
# attention and its three gemv_kernel<1, ...> phases
K3_KERNELS = ("attn_tail_cluster_kernel", "rtc::K3>", "attn_append_kernel", "gemv_kernel<1,")
# (path, KV dtype, cache rows, prompt tokens, decode tokens, the kernels read)
PATHS = (("longctx", torch.bfloat16, 32768, 32000, 128, ATTN_KERNELS),
         ("longctx_int8", torch.int8, 32768, 32000, 128, ATTN_KERNELS),
         ("k15", torch.float32, 4000, 3000, 32, ATTN_KERNELS),
         ("main", torch.bfloat16, 1024, 512, 128, K3_KERNELS))


def breakdown(fn, names=ATTN_KERNELS) -> dict:
    """fn() once under the tree's chip_smoke.device_breakdown: its busy ms,
    host wall and idle share, and the named kernels' ms, share of busy and
    launches from its per-kernel rows."""
    import importlib.util
    from pathlib import Path

    import llamatpu_torch

    path = Path(llamatpu_torch.__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tr = smoke.device_breakdown(fn)
    attn = [k for k in tr["kernels"] if any(n in k["name"] for n in names)]
    attn_ms = sum(k["ms"] for k in attn)
    return dict(busy_ms=tr["busy_ms"], wall_ms=tr["wall_ms"], idle_share=tr["idle_share"],
                attn_ms=attn_ms, attn_share=attn_ms / tr["busy_ms"],
                attn_launches=sum(k["count"] for k in attn))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="tree", help="the rows' `tree` field")
    ap.add_argument("--out", default=None, help="also append the rows here (JSON lines)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="timed decode runs a path (decode_tok_s_runs; decode_tok_s the first)")
    ap.add_argument("--paths", default=",".join(p[0] for p in PATHS),
                    help="comma-separated paths to run, of " + ", ".join(p[0] for p in PATHS))
    args = ap.parse_args()
    run = args.paths.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("long_ab: no CUDA device")
    from llamatpu_torch import _build
    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.runtime.engine import Engine

    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    model = build_synthetic_model("llama32-1b", quant="q8_0", context_length=32768)
    engine = Engine(model, cache_len=1024, prefill_chunk=512, decode_window=128, rowq=True,
                    device=dev)
    rng = np.random.default_rng(32)
    prompts = {32000: rng.integers(0, model.cfg.vocab_size, 32000).tolist(),
               3000: rng.integers(0, model.cfg.vocab_size, 3000).tolist(),
               512: np.random.default_rng(42).integers(0, model.cfg.vocab_size, 512).tolist()}
    for name, cdt, cache_len, pp, tg, names in PATHS:
        if name not in run:
            continue
        # the engine pointed at another cache, its weights staying on the card
        engine.cache_len, engine.cache_dtype = cache_len, cdt
        engine.prefill_chunk, engine.decode_window = 512, 128 if tg > 32 else 32
        engine.reset()
        prompt = prompts[pp]
        tok, _ = engine.prefill(prompt, 0)
        torch.cuda.synchronize()
        runs = []
        for _ in range(args.repeat):  # the same tokens each time, the cache rewritten
            out, pos = [int(tok[0])], pp
            t0 = time.perf_counter()
            while len(out) <= tg:
                window = engine.decode_window_run(out[-1], pos, tg + 1 - len(out))
                if not window:
                    break
                out += window
                pos += len(window)
            runs.append((len(out) - 1) / (time.perf_counter() - t0))
        tok_s = runs[0]
        tr = breakdown(lambda: engine.decode_window_run(out[-1], pos, 16), names)
        row = dict(bench="long_ab", tree=args.label, path=name, kv=str(cdt)[6:],
                   cache=cache_len, prompt=pp, decode_tok_s=tok_s, decode_tok_s_runs=runs,
                   window_pos=pos, steps=16,
                   attn_ms_per_call=tr["attn_ms"] / max(1, 16 * model.cfg.n_layers),
                   card=card, **tr)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
