"""The hermetic quantization-parity harness of the port (the port of
llamatpu/bench/parity.py with the runners scripts/run_parity.py and
scripts/run_parity_moe.py as `main`).

    python -m llamatpu_torch.bench.parity [--preset llama32-1b ...] [--out table.md]
    python -m llamatpu_torch.bench.parity --moe

Method: ONE dense f32 master at a preset's geometry (seeded synthetic
weights), a corpus SAMPLED FROM THE MASTER ITSELF (temperature 0.8, so the
scored tokens sit where the model puts probability mass), then every
variant derives from the same master by the exact ggml encodes of the
port's own codecs (gguf/quants.py) and scores the same corpus through
bench/perplexity.py at chunk 16 with identical sliding windows:

  f32           dense float32 weights (the reference numerics)
  bf16          dense bfloat16
  q8_0          Q8_0 through K5
  q8_0-int8dot  Q8_0 through the exact ggml int8 x int8 block dot
                (impl "int8", ops/int8_matmul.py)
  q8_0-kvint8   q8_0 weights and an int8 KV cache
  q4_0          Q4_0 through K5;  q4_0-pack4  packed nibbles through K7
  q4_k          native Q4_K (Q4_0 values + per-32 offsets); q4_k-pack4
  q5_k          native Q5_K
  q8_row        Q8_0 requantized per out row (equalized fold)
  q8_row-noeq   the same with LLAMATPU_NO_ROWQ_EQ set (plain per-row)
  q8_row-a8     q8_row with the w8a8 route (per-token int8 activations, K4)
                at every width: INT8_MXU_MIN_T = 1, read at call time

Every variant scores the UNFUSED layer weights, as the JAX package's
perplexity does (it places model.weights as they are): the fused layer
kernels (K2, K3, K9, K20) take no part, and q8_row-a8 quantizes each
projection's activations. The JAX package's `force_impl` (its TPU compile
service's escape to the XLA dot) has no counterpart here and is gone.

Caveat: the master is random, so absolute ppl values mean nothing; the
deltas between variants measure each quantized compute path against f32 on
identical weights. `main` writes its markdown table to --out or stdout
(never PARITY.md) and exits 1 when a delta passes its gate.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

import numpy as np
import torch

VARIANTS = ("f32", "bf16", "q8_0", "q8_0-int8dot", "q8_0-kvint8",
            "q4_0", "q4_0-pack4", "q4_k", "q4_k-pack4", "q5_k", "q8_row",
            "q8_row-noeq", "q8_row-a8")

# keys quantized in a real GGUF checkpoint: the dense llama graph, plus the
# MoE routed-expert stacks and the always-on shared expert (router and
# shared_gate_inp stay f32)
_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3",
                "gate_exps", "up_exps", "down_exps",
                "shared_gate", "shared_up", "shared_down")
_EXPERT_KEYS = ("gate_exps", "up_exps", "down_exps")

# scripts/run_parity.py's presets: (variants or None for all, geometry
# overrides, note), its corpus and cache; scripts/run_parity_moe.py's MoE run
PRESETS = {
    "llama32-1b": (None, {}, "full depth; every compute-path variant"),
    "qwen15-moe-a2.7b": (
        ("f32", "q8_0", "q4_0", "q4_0-pack4", "q4_k", "q8_row"),
        {"n_layers": 2},
        "reduced depth (2 layers) with production per-layer expert geometry; "
        "grouped-kernel variants incl. q8_row expert stacks and native q4_k experts"),
}
CORPUS, CACHE = 512, 512
MOE_VARIANTS = ("f32", "q8_0", "q4_0-pack4", "q4_k", "q8_row")
MOE_CORPUS, MOE_CACHE = 256, 256

# Gates (scripts/run_parity.py:20-48): the corpus comes from a RANDOM-weight
# master, which inflates every quantization delta far beyond real-checkpoint
# levels; the thresholds catch regressions of each path against its own
# class on this corpus
Q8_REL_MAX, Q4_REL_MAX = 0.02, 0.60   # block-scale compute paths
ROWQ_REL_MAX = 0.04                   # q8_row: a second int8 rounding
A8_REL_MAX = 0.05                     # q8_row-a8: plus per-token activation int8

CHUNK = 16  # every variant: the int8 dot covers T <= 16, and windows must match


def _kind(variant: str) -> str | None:
    for k in ("q8_row", "q8_0", "q5_k", "q4_k", "q4_0"):
        if variant.startswith(k):
            return k
    return None


def build_master(preset: str, seed: int = 0, **overrides):
    """Dense f32 model at `preset` geometry: the single source checkpoint."""
    from llamatpu_torch.models.synthetic import build_synthetic_model

    return build_synthetic_model(preset, quant="none", dtype="f32", seed=seed,
                                 overrides=overrides or None)


def _np32(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def quantize_array(arr: np.ndarray, kind: str):
    """A float array [..., O, I] as a canonical QTensor of `kind` by the
    ggml encode (q8_0 through the native codec where it serves: the same
    bytes)."""
    from llamatpu_torch.gguf import native, quants
    from llamatpu_torch.models.weights import QTensor

    v = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    shape = tuple(arr.shape)
    blocks = (*shape[:-1], shape[-1] // 32)
    offs = None
    if kind == "q8_0":
        raw = native.quantize_q8_0(v)
        qs, scales = quants.q8_0_views(quants.quantize_q8_0(v) if raw is None else raw, v.size)
    elif kind == "q4_0":
        qs, scales = quants.q4_0_views(quants.quantize_q4_0(v), v.size)
    elif kind in ("q4_k", "q5_k"):
        enc, views = ((quants.quantize_q4_k, quants.q4_k_views) if kind == "q4_k"
                      else (quants.quantize_q5_k, quants.q5_k_views))
        qs, scales, offs = views(enc(v), v.size)
        offs = np.ascontiguousarray(offs, np.float32).reshape(blocks)
    else:
        raise ValueError(f"quantize_array: {kind!r}")
    qs = np.ascontiguousarray(qs).reshape(shape)
    scales = np.ascontiguousarray(scales).astype(np.float32).reshape(blocks)
    return QTensor(qs, scales, kind, offs=offs)


def dequant_array(w) -> np.ndarray:
    """A block QTensor's f32 values in canonical order (the embedding
    lookup's table): q * scale (+ offset), as the JAX QTensor.dequant."""
    from llamatpu_torch.models.weights import unpack4_pairs

    qs = unpack4_pairs(w.qs) if w.layout == "packed4" else np.asarray(w.qs)
    out = qs.astype(np.float32) * np.repeat(np.asarray(w.scales, np.float32), 32, axis=-1)
    if w.offs is not None:
        out = out + np.repeat(np.asarray(w.offs, np.float32), 32, axis=-1)
    return out


def make_variant(master, variant: str, memo: dict | None = None):
    """Derive a variant model from the master by the exact ggml encodes.
    Returns (model, ppl_kwargs): ppl_kwargs feed bench.perplexity (impl and
    the KV cache dtype). `memo` (a dict kept across calls on one master)
    reuses the quantized tensors of variants of one kind (pack4 packs
    them)."""
    from llamatpu_torch.models.loader import LoadedModel
    from llamatpu_torch.models.weights import (QTensor, equalize_rowq_layers, pack4_pairs,
                                               rowq_requant)

    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    kind = _kind(variant)
    # q8_row converts at the LAYERS level below (the equalized fold needs the
    # whole layer); conv() emits q8_0 for it
    pack4 = variant.endswith("-pack4")
    impl = "int8" if variant == "q8_0-int8dot" else "auto"
    cache_dtype = torch.int8 if variant == "q8_0-kvint8" else torch.float32
    memo = {} if memo is None else memo

    def conv(name, arr):
        if kind is None:
            t = torch.from_numpy(_np32(arr))
            return t if variant == "f32" else t.to(torch.bfloat16)
        qk = "q8_0" if kind == "q8_row" else kind
        if (name, qk) not in memo:
            memo[name, qk] = quantize_array(_np32(arr), qk)
        q = memo[name, qk]
        if pack4 and qk in ("q4_0", "q4_k"):
            return replace(q, qs=pack4_pairs(q.qs), layout="packed4")
        return q

    w = dict(master.weights)
    lw = dict(w["layers"])
    for k in _MATMUL_KEYS:
        if k in lw:
            lw[k] = conv(k, lw[k])
    if kind == "q8_row":
        # the --rowq load-time conversion at the layers level: the equalized
        # fold (the serving default) or the plain per-row requant
        if variant == "q8_row-noeq":
            os.environ["LLAMATPU_NO_ROWQ_EQ"] = "1"
        try:
            lw = equalize_rowq_layers(lw)
        finally:
            if variant == "q8_row-noeq":
                os.environ.pop("LLAMATPU_NO_ROWQ_EQ", None)
        for k in _MATMUL_KEYS:
            if k in lw and isinstance(lw[k], QTensor) and lw[k].kind == "q8_0":
                lw[k] = rowq_requant(lw[k])
    w["layers"] = lw
    w["wcls"] = (rowq_requant(conv("wcls", w["wcls"])) if kind == "q8_row"
                 else conv("wcls", w["wcls"]))
    # token embedding: real checkpoints quantize it too; the lookup reads the
    # dequantized values, so the table is quantize -> dequant of the master's
    if kind is not None:
        w["tok_emb"] = torch.from_numpy(dequant_array(conv("tok_emb", w["tok_emb"])))
    elif variant == "bf16":
        w["tok_emb"] = torch.from_numpy(_np32(w["tok_emb"])).to(torch.bfloat16)
    model = LoadedModel(cfg=master.cfg, weights=w, metadata=dict(master.metadata),
                        family=master.family, quant_label=variant)
    return model, dict(impl=impl, dtype=cache_dtype)


def apply_spectrum(master, spectrum: str | None, seed: int = 123):
    """Re-draw the master's matmul weights from a REALISTIC spectrum: "heavy"
    is a student-t(4) body matched to the builder's std plus 1% of input
    channels scaled 8x (per matrix, seeded), the outlier-channel structure
    that stresses one-scale-per-row quantization. None / "random" returns
    the master unchanged. The same numpy stream as the JAX package."""
    if spectrum in (None, "random"):
        return master
    assert spectrum == "heavy", spectrum
    from llamatpu_torch.models.loader import LoadedModel

    rng = np.random.default_rng(seed)
    w = dict(master.weights)
    lw = dict(w["layers"])

    def heavy(arr):
        arr = _np32(arr)
        out = rng.standard_t(df=4, size=arr.shape).astype(np.float32)
        out *= float(arr.std()) / max(float(out.std()), 1e-9)
        ncol = max(1, arr.shape[-1] // 128)
        cols = rng.choice(arr.shape[-1], ncol, replace=False)
        out[..., cols] *= 8.0
        # keep the layer's effective gain close to the builder's stable
        # scaling so the master still generates a usable corpus
        out *= float(np.abs(arr).mean()) / max(float(np.abs(out).mean()), 1e-9)
        return out

    for k in _MATMUL_KEYS:
        if k in lw:
            lw[k] = heavy(lw[k])
    w["layers"] = lw
    w["wcls"] = heavy(w["wcls"])
    return LoadedModel(cfg=master.cfg, weights=w, metadata=dict(master.metadata),
                       family=master.family, quant_label=master.quant_label)


def sample_corpus(master, n: int, seed: int = 42, prompt_len: int = 8, device=None) -> list[int]:
    """Corpus = the master's own temperature-0.8 sample (seeded, on the
    port's generator), after a numpy-seeded prompt of `prompt_len` ids."""
    from llamatpu_torch.runtime.engine import Engine

    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, master.cfg.vocab_size, prompt_len).tolist()
    eng = Engine(master, cache_len=min(n + prompt_len + 8, master.cfg.context_length),
                 temperature=0.8, seed=seed, cache_dtype=torch.float32, device=device)
    res = eng.generate(prompt, n - prompt_len)
    del eng
    return prompt + list(res.tokens)


def scoring_weights(model, device) -> dict:
    """The variant's weights on `device` as they are (unfused, as the JAX
    package's perplexity places them), expert offsets zero-padded for K13."""
    from llamatpu_torch.models.weights import QTensor, pad_offsets, tree_to

    w = dict(model.weights)
    w["layers"] = {k: pad_offsets(v) if k in _EXPERT_KEYS and isinstance(v, QTensor) else v
                   for k, v in w["layers"].items()}
    return tree_to(w, device)


def score_variant(model, variant: str, corpus: list[int], cache_len: int, kw: dict,
                  device=None) -> dict:
    """ppl of `corpus` under a variant model at chunk 16, stride cache_len //
    2; q8_row-a8 with INT8_MXU_MIN_T = 1 for the call."""
    from llamatpu_torch.bench.perplexity import perplexity
    from llamatpu_torch.ops import int8_prefill
    from llamatpu_torch.runtime.engine import resolve_device

    dev = resolve_device(device)
    weights = scoring_weights(model, dev)
    saved = int8_prefill.INT8_MXU_MIN_T
    if variant.endswith("-a8"):
        int8_prefill.INT8_MXU_MIN_T = 1
    try:
        return perplexity(model, corpus, chunk=CHUNK, cache_len=cache_len,
                          stride=cache_len // 2, device=dev, weights=weights, **kw)
    finally:
        int8_prefill.INT8_MXU_MIN_T = saved


def parity_table(preset: str = "llama32-1b", corpus_len: int = 1024, cache_len: int = 512,
                 seed: int = 0, variants=VARIANTS, spectrum: str | None = None, device=None,
                 corpus: list[int] | None = None, **overrides) -> list[dict]:
    """One row per variant: ppl, tokens scored, delta and relative delta
    against the first variant (f32). `corpus`: score these ids instead of
    the master's own sample."""
    assert variants[0] == "f32", "the first variant anchors the deltas"
    master = apply_spectrum(build_master(preset, seed=seed, **overrides), spectrum)
    if corpus is None:
        corpus = sample_corpus(master, corpus_len, device=device)
    rows, base_ppl, memo = [], None, {}
    for v in variants:
        print(f"# parity {preset}: variant {v}...", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        model, kw = make_variant(master, v, memo)
        r = score_variant(model, v, corpus, cache_len, kw, device)
        if v == "f32":
            base_ppl = r["ppl"]
        rows.append({"variant": v, "ppl": r["ppl"], "tokens": r["tokens"],
                     "delta": r["ppl"] - base_ppl, "rel": (r["ppl"] - base_ppl) / base_ppl,
                     "seconds": time.perf_counter() - t0})
        print(f"#   {v}: ppl {r['ppl']:.4f} ({rows[-1]['seconds']:.1f} s)", file=sys.stderr,
              flush=True)
        del model
    return rows


def gate(rows: list[dict]) -> tuple[bool, list[str]]:
    """The runners' verdict on one preset's rows: (ok, markdown lines)."""
    by = {r["variant"]: r for r in rows}
    q8 = [v for v in ("q8_0", "q8_0-int8dot", "q8_0-kvint8") if v in by]
    q4 = [v for v in ("q4_0", "q4_0-pack4", "q4_k", "q4_k-pack4") if v in by]
    q8_worst = max((abs(by[v]["rel"]) for v in q8), default=0.0)
    q4_worst = max((abs(by[v]["rel"]) for v in q4), default=0.0)
    rowq = abs(by["q8_row"]["rel"]) if "q8_row" in by else 0.0
    a8 = abs(by["q8_row-a8"]["rel"]) if "q8_row-a8" in by else 0.0
    q8_ok, q4_ok = q8_worst <= Q8_REL_MAX, q4_worst <= Q4_REL_MAX
    rowq_ok = rowq <= ROWQ_REL_MAX and a8 <= A8_REL_MAX
    lines = [f"Verdict: worst Q8_0-path |rel ppl delta| = {q8_worst:.3%} "
             f"({'within' if q8_ok else 'EXCEEDS'} the {Q8_REL_MAX:.0%} gate); worst "
             f"Q4-path = {q4_worst:.3%} ({'within' if q4_ok else 'EXCEEDS'} the "
             f"{Q4_REL_MAX:.0%} gate)."]
    if "q8_row" in by:
        a8_text = f", q8_row-a8 {a8:.3%} (gate {A8_REL_MAX:.0%})" if "q8_row-a8" in by else ""
        lines.append(f"q8_row: {rowq:.3%} (gate {ROWQ_REL_MAX:.0%}){a8_text}: "
                     f"{'within' if rowq_ok else 'EXCEEDS'}.")
    return q8_ok and q4_ok and rowq_ok, lines


def table(preset: str, rows: list[dict], note: str) -> list[str]:
    out = [f"## {preset}", "", f"_{note}_", "",
           "| variant | ppl | delta vs f32 | relative | tokens | s |",
           "|---|---:|---:|---:|---:|---:|"]
    out += [f"| {r['variant']} | {r['ppl']:.4f} | {r['delta']:+.4f} | {r['rel']:+.3%} "
            f"| {r['tokens']} | {r['seconds']:.1f} |" for r in rows]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="quantization-parity table of the port")
    ap.add_argument("--preset", nargs="*", default=None, choices=list(PRESETS),
                    help="scripts/run_parity.py's presets (default: both)")
    ap.add_argument("--moe", action="store_true",
                    help="scripts/run_parity_moe.py's run instead: qwen15-moe-a2.7b at 2 "
                         f"layers, {', '.join(MOE_VARIANTS)}, corpus and cache {MOE_CORPUS}")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--out", default=None, help="write the markdown table here")
    args = ap.parse_args(argv)
    from llamatpu_torch.runtime.engine import resolve_device

    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = ["# Quantization parity (llamatpu_torch/bench/parity.py)", "",
           f"Device: {kind}. Corpus sampled from the seeded f32 master (temperature "
           "0.8); chunk 16, stride cache / 2 for every variant.", ""]
    ok, result = True, {}
    moe = "qwen15-moe-a2.7b"
    for preset in [moe] if args.moe else args.preset or list(PRESETS):
        variants, overrides, note = PRESETS[preset]
        if args.moe:
            variants = MOE_VARIANTS
        corpus, cache = (MOE_CORPUS, MOE_CACHE) if args.moe else (CORPUS, CACHE)
        t0 = time.perf_counter()
        rows = parity_table(preset, corpus_len=corpus, cache_len=cache, seed=0,
                            variants=variants or VARIANTS, device=dev, **overrides)
        good, verdict = gate(rows)
        ok = ok and good
        result[preset] = rows
        out += table(preset, rows, f"{note}; corpus {corpus}, cache {cache}; "
                     f"{time.perf_counter() - t0:.0f} s") + [""] + verdict + [""]
    text = "\n".join(out) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)
    print(json.dumps({"parity": result, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
