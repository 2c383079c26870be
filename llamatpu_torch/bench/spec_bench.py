"""Speculative-decode bench rows (the port of scripts/bench_spec.py): the
verify forward's step cost and the acceptance telemetry.

A synthetic Q8_0 model at a preset's width (block-quant weights: K5 for
every projection and the head), cache 1024, prefill chunk 512, decode
window 32; a 512-token prompt of 32 seeded ids tiled, so the bigram lookup
has repeats to draft from; then tg128 greedy, once plain (K = 0) and once
with K drafts a verify forward. On random weights the generated text is not
the prompt's, so acceptance measures what the model repeats of its own
output; the row's point is the verify forward's cost beside a plain step's.

    python -m llamatpu_torch.bench.spec_bench [preset] [K] [--device cpu]

One JSON row a run: decode tok/s (host clock, after a warm-up window, the
engine's decode steps replayed as CUDA graphs on the card), tokens, and
for K > 0 spec_accept_rate and spec_forwards; the launches of every kernel
wrapper over the timed run (prefill and decode; none on the CPU, where the
plain versions run), the prefill chunks, the forwards run (each window
ends at its stop or budget, so these are the forwards the tokens needed),
the decode windows and the host reads of the decode state (one a window);
the card's name and power limit (or "cpu"). Without --device it needs the
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


# scripts/bench_spec.py's settings
CACHE_LEN, PREFILL_CHUNK, DECODE_WINDOW, PROMPT_LEN, TG = 1024, 512, 32, 512, 128


def tiled_prompt(vocab: int) -> list[int]:
    """PROMPT_LEN ids: 32 ids seeded with 42, tiled (scripts/bench_spec.py's
    prompt)."""
    base = np.random.default_rng(42).integers(0, vocab, 32)
    return [int(base[i % 32]) for i in range(PROMPT_LEN)]


def timed_run(engine, prompt: list[int], tg: int) -> dict:
    """A warm-up window, a reset, then prefill and greedy decode windows up
    to tg tokens; the kernel wrappers' launches and the engine's spec
    telemetry count the timed part only: (tokens, seconds, launches, decode
    steps, prefill chunks, decode windows, host reads of the verify state)."""
    from llamatpu_torch.runtime.decode_graph import launch_counters

    tok, _ = engine.prefill(prompt, 0)
    engine.decode_window_run(int(tok[0]), len(prompt), 8)  # the first run of every kernel
    engine.reset()
    fns = launch_counters()
    for f in fns:
        f.launches = 0
    for key in ("spec_emitted", "spec_forwards", "spec_accept_rate"):
        engine.metrics.extra.pop(key, None)
    engine.spec_reads = 0
    steps0 = engine.decode_steps
    windows = 0
    t0 = time.perf_counter()
    tok, _ = engine.prefill(prompt, 0)
    cur, pos, out = int(tok[0]), len(prompt), []
    while len(out) < tg:
        w = engine.decode_window_run(cur, pos, tg - len(out))
        windows += 1
        if not w:
            break
        out += w
        cur, pos = w[-1], pos + len(w)
    seconds = time.perf_counter() - t0
    return dict(tokens=out, seconds=seconds,
                launches={f.__name__: f.launches for f in fns if f.launches},
                steps=engine.decode_steps - steps0,
                chunks=-(-len(prompt) // engine.prefill_chunk), windows=windows,
                reads=engine.spec_reads if engine.spec_k else windows)


def bench_rows(model, k: int = 8, device=None, label: str = "") -> list[dict]:
    """The plain and the K-draft rows on one model (the engines built in
    turn)."""
    from llamatpu_torch.runtime.engine import Engine

    prompt = tiled_prompt(min(model.cfg.vocab_size, 128000))
    rows = []
    for spec in (0, k):
        eng = Engine(model, cache_len=CACHE_LEN, prefill_chunk=PREFILL_CHUNK, temperature=0.0,
                     decode_window=DECODE_WINDOW, spec_decode=spec, device=device)
        r = timed_run(eng, prompt, TG)
        row = {"bench": "spec-decode", "model": label, "K": spec,
               "decode_tok_s": len(r["tokens"]) / r["seconds"], "tg": len(r["tokens"]),
               "seconds": r["seconds"], "launches": r["launches"], "forwards_run": r["steps"],
               "prefill_chunks": r["chunks"], "windows": r["windows"],
               "host_reads": r["reads"], "tokens": r["tokens"]}
        if spec:
            ex = eng.metrics.extra
            row.update(spec_accept_rate=ex.get("spec_accept_rate"),
                       spec_forwards=ex.get("spec_forwards"))
        rows.append(row)
        del eng
    return rows


def card_name(device) -> str:
    import torch

    if torch.device(device or "cuda").type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.runtime.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("preset", nargs="?", default="llama32-1b")
    ap.add_argument("k", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = build_synthetic_model(args.preset, quant="q8_0", context_length=CACHE_LEN)
    card = card_name(device)
    for row in bench_rows(model, args.k, device, args.preset):
        row.pop("tokens")
        print(json.dumps(dict(row, device=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
