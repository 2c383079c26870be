"""One-command checkpoint validation through the port:
`python -m llamatpu_torch.cli validate -m model.gguf` (the port of
llamatpu/bench/validate.py, minus its --impl choice):

  1. load + family detection
  2. tokenizer round-trip fidelity over the adversarial text set
  3. chat-format encode sanity (BOS policy, stop tokens resolvable)
  4. a finite forward pass + deterministic greedy sample
  5. golden-token comparison (exact ids) when a fixture exists;
     --update-golden records one
  6. quick perplexity over a built-in paragraph (finite; compared against
     the fixture's recorded value within 1% when present)

Exit code 0 = all checks pass. The JAX package's fixtures
(fixtures/golden/<name>.json) hold its f32 `validate` results, so the port
is held to them with --dtype f32.
"""
from __future__ import annotations

import json
import os

from llamatpu_torch.tokenizer.adversarial import ADVERSARIAL_TEXTS

PROBE_TEXTS = [
    "Hello, world!",
    "The quick brown fox jumps over the lazy dog.",
    "numbers 1234 12,345.67 and code: def f(x): return x*2",
] + ADVERSARIAL_TEXTS

PPL_PARAGRAPH = (
    "The development of large language models has transformed natural "
    "language processing. Modern systems are trained on vast corpora of "
    "text and can generate coherent, contextually appropriate responses "
    "to a wide range of prompts. Evaluation typically measures perplexity "
    "on held-out data, alongside task-specific benchmarks."
)


def validate(args) -> int:
    import numpy as np

    from llamatpu_torch.cli import cache_dtype, load, param_dtype
    from llamatpu_torch.format.chat_format import Message, Role
    from llamatpu_torch.runtime.engine import Engine

    failures: list[str] = []

    def check(name, ok, detail=""):
        mark = "PASS" if ok else "FAIL"
        print(f"[{mark}] {name}" + (f": {detail}" if detail else ""))
        if not ok:
            failures.append(name)

    # 1. load + detection
    model, metrics = load(args)
    cfg = model.cfg
    check("load", True,
          f"family={model.family.name} quant={model.quant_label} "
          f"dim={cfg.dim} layers={cfg.n_layers} vocab={cfg.vocab_size}")

    # 2. tokenizer round trips
    tok = model.tokenizer
    bad = []
    for t in PROBE_TEXTS:
        try:
            if tok.decode(tok.encode(t)) != t:
                bad.append(t)
        except Exception as e:  # noqa: BLE001 — report, don't crash validation
            bad.append(f"{t!r} -> {type(e).__name__}: {e}")
    check("tokenizer-roundtrip", not bad, f"{len(PROBE_TEXTS)-len(bad)}/{len(PROBE_TEXTS)}"
          + (f" failing: {bad[:2]}" if bad else ""))

    # 3. chat format
    fmt = model.chat_format
    try:
        ids = fmt.build_prompt([Message(Role.USER, args.prompt)])
        stops = fmt.stop_tokens()
        check("chat-format", len(ids) > 0 and all(isinstance(i, int) for i in ids),
              f"{len(ids)} prompt tokens, {len(stops)} stop tokens")
    except Exception as e:  # noqa: BLE001
        ids = tok.encode(args.prompt)
        check("chat-format", False, f"{type(e).__name__}: {e}")
        stops = set()

    # 4. forward + greedy sample
    engine = Engine(model, temperature=0.0, prefill_chunk=args.prefill_chunk,
                    cache_dtype=cache_dtype(args), rowq=args.rowq, device=args.device,
                    metrics=metrics, impl=args.impl)
    res = engine.generate(ids, 32, stop_tokens=stops)
    sample_ids = list(res.tokens)
    text = tok.decode(sample_ids)
    check("greedy-sample", len(sample_ids) > 0, f"{len(sample_ids)} tokens: {text[:80]!r}")

    # 6. quick ppl (before the golden compare so the fixture can record it)
    from llamatpu_torch.bench.perplexity import perplexity_of_text

    ppl = perplexity_of_text(model, PPL_PARAGRAPH, chunk=64, device=engine.device,
                             weights=engine.weights, impl=args.impl)["ppl"]
    check("ppl-finite", bool(np.isfinite(ppl)) and ppl > 1.0, f"ppl={ppl:.4f}")

    # 5. golden fixture
    name = os.path.splitext(os.path.basename(args.model))[0]
    golden_path = args.golden or os.path.join("fixtures", "golden", f"{name}.json")
    if args.update_golden:
        os.makedirs(os.path.dirname(golden_path) or ".", exist_ok=True)
        with open(golden_path, "w") as f:
            json.dump({"prompt": args.prompt, "tokens": sample_ids,
                       "ppl": round(ppl, 6), "quant": model.quant_label,
                       "family": model.family.name}, f, indent=1)
        print(f"[gold] wrote {golden_path}")
    elif os.path.exists(golden_path):
        with open(golden_path) as f:
            g = json.load(f)
        if g.get("prompt") != args.prompt:
            check("golden-tokens", False,
                  f"fixture prompt {g.get('prompt')!r} != --prompt; rerun with it")
        else:
            check("golden-tokens", sample_ids == g["tokens"],
                  f"{len(sample_ids)} ids vs fixture")
            if "ppl" in g:
                rel = abs(ppl - g["ppl"]) / g["ppl"]
                check("golden-ppl", rel < 0.01, f"{ppl:.4f} vs {g['ppl']:.4f} ({rel:.2%})")
    else:
        print(f"[gold] no fixture at {golden_path} (use --update-golden to record)")

    print("validation:", "OK" if not failures else f"FAILED ({', '.join(failures)})")
    return 0 if not failures else 1
