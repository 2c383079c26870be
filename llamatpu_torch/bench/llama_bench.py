"""llama-bench style benchmark matrix (the port of llamatpu/bench/llama_bench.py).

Test specs pp N (prompt processing), tg N (token generation), pg N+M, depth
-d (an untimed KV prefill before the timed window), warm-up + reps with the
mean and population standard deviation, md/csv/json/jsonl/sql output (`render`
gives the JAX package's bytes for the same results). The timed windows cover
the forward path only: synthetic random tokens from seed 42, no tokenizer;
greedy sampling runs on the device inside the decode window. On the card each
timed window ends in torch.cuda.synchronize(), so it holds the device's work.
"""
from __future__ import annotations

import json
import statistics
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class BenchResult:
    test: str          # "pp512" | "tg128" | "pp512@d256" | "pg512+128" | "tg128@b8"
    n_tokens: int
    avg_s: float
    std_s: float

    @property
    def tok_s(self) -> float:
        return self.n_tokens / self.avg_s if self.avg_s > 0 else 0.0

    @property
    def tok_s_std(self) -> float:
        if self.avg_s <= 0:
            return 0.0
        return self.tok_s * (self.std_s / self.avg_s)


def _rand_tokens(n: int, vocab: int, seed: int = 42) -> list[int]:
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


def _sync(engine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def _decode(engine, cur: int, pos: int, n: int) -> int:
    """Decode windows after token `cur` at `pos` until n tokens or the cache
    ends; returns the tokens decoded."""
    done = 0
    while done < n:
        w = engine.decode_window_run(cur, pos, n - done)
        if not w:
            break
        cur, pos, done = w[-1], pos + len(w), done + len(w)
    return done


def bench_pp(engine, n: int, depth: int, reps: int, warmup: int = 1) -> BenchResult:
    toks = _rand_tokens(n, engine.cfg.vocab_size)
    depth_toks = _rand_tokens(depth, engine.cfg.vocab_size, seed=7) if depth else []
    times = []
    for rep in range(warmup + reps):
        engine.reset()
        if depth:
            engine.prefill(depth_toks, 0)
        _sync(engine)
        t0 = time.perf_counter()
        tok, _ = engine.prefill(toks, depth)
        int(tok[0])
        _sync(engine)
        dt = time.perf_counter() - t0
        if rep >= warmup:
            times.append(dt)
    return BenchResult(f"pp{n}" + (f"@d{depth}" if depth else ""), n,
                       statistics.mean(times), statistics.pstdev(times))


def bench_tg(engine, n: int, depth: int, reps: int, warmup: int = 1) -> BenchResult:
    """Autoregressive decode through the engine's decode windows
    (`Engine.decode_window_run`), the path `run` decodes with."""
    vocab = engine.cfg.vocab_size
    depth_toks = _rand_tokens(max(depth, 1), vocab, seed=7)
    times = []
    generated = n
    for rep in range(warmup + reps):
        engine.reset()
        tok, _ = engine.prefill(depth_toks, 0)  # untimed: establishes pos
        cur = int(tok[0])
        _sync(engine)
        t0 = time.perf_counter()
        done = _decode(engine, cur, len(depth_toks), n)
        _sync(engine)
        dt = time.perf_counter() - t0
        if rep >= warmup:
            times.append(dt)
            generated = done
    if generated < n:
        # the cache ended mid-window: report the tokens decoded, not n
        warnings.warn(f"tg{n}@d{depth}: only {generated} tokens fit the cache; "
                      "reporting actual count", stacklevel=2)
    return BenchResult(f"tg{n}" + (f"@d{depth}" if depth else ""), generated,
                       statistics.mean(times), statistics.pstdev(times))


def bench_pg(engine, p: int, t: int, reps: int, warmup: int = 1) -> BenchResult:
    """A timed prefill of p tokens followed by t decoded tokens (`pg p+t`)."""
    toks = _rand_tokens(p, engine.cfg.vocab_size)
    times = []
    generated = t
    for rep in range(warmup + reps):
        engine.reset()
        _sync(engine)
        t0 = time.perf_counter()
        tok, _ = engine.prefill(toks, 0)
        n = _decode(engine, int(tok[0]), p, t)
        _sync(engine)
        dt = time.perf_counter() - t0
        if rep >= warmup:
            times.append(dt)
            generated = n
    return BenchResult(f"pg{p}+{t}", p + generated,
                       statistics.mean(times), statistics.pstdev(times))


def bench_tg_batch(batch_engine, n: int, depth: int, reps: int, warmup: int = 1) -> BenchResult:
    """Aggregate batched decode throughput: B lanes decode n tokens each
    (`BatchEngine.generate_batch`, prompt ingestion included)."""
    b = batch_engine.batch_size
    vocab = batch_engine.cfg.vocab_size
    prompts = [_rand_tokens(max(depth, 4), vocab, seed=100 + i) for i in range(b)]
    times = []
    for rep in range(warmup + reps):
        _sync(batch_engine)
        t0 = time.perf_counter()
        batch_engine.generate_batch(prompts, n)
        _sync(batch_engine)
        dt = time.perf_counter() - t0
        if rep >= warmup:
            times.append(dt)
    return BenchResult(f"tg{n}@b{b}", b * n, statistics.mean(times), statistics.pstdev(times))


def render(results: list[BenchResult], fmt: str, model_name: str, quant: str) -> str:
    rows = [
        {"model": model_name, "quant": quant, "test": r.test, "n": r.n_tokens,
         "avg_s": round(r.avg_s, 4), "std_s": round(r.std_s, 4),
         "tok_s": round(r.tok_s, 2), "tok_s_std": round(r.tok_s_std, 2)}
        for r in results
    ]
    if fmt == "json":
        return json.dumps(rows, indent=2)
    if fmt == "jsonl":
        return "\n".join(json.dumps(r) for r in rows)
    if fmt == "csv":
        hdr = "model,quant,test,n,avg_s,std_s,tok_s,tok_s_std"
        return hdr + "\n" + "\n".join(
            f'{r["model"]},{r["quant"]},{r["test"]},{r["n"]},{r["avg_s"]},{r["std_s"]},'
            f'{r["tok_s"]},{r["tok_s_std"]}'
            for r in rows)
    if fmt == "sql":
        stmts = ["CREATE TABLE IF NOT EXISTS bench(model TEXT, quant TEXT, test TEXT, "
                 "n INT, avg_s REAL, std_s REAL, tok_s REAL, tok_s_std REAL);"]
        for r in rows:
            stmts.append(
                "INSERT INTO bench VALUES("
                f"'{r['model']}','{r['quant']}','{r['test']}',{r['n']},"
                f"{r['avg_s']},{r['std_s']},{r['tok_s']},{r['tok_s_std']});")
        return "\n".join(stmts)
    out = ["| model | quant | test | tok/s |", "|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r['model']} | {r['quant']} | {r['test']} | "
                   f"{r['tok_s']:.2f} ± {r['tok_s_std']:.2f} |")
    return "\n".join(out)


def run_bench(args) -> None:
    """The `bench` command: every depth x (pp, tg), then the pg specs, then
    (with --batch > 1) batched tg at the deepest depth; prints the rendered
    table."""
    from llamatpu_torch.cli import cache_dtype, param_dtype
    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.runtime.batch_engine import BatchEngine
    from llamatpu_torch.runtime.engine import Engine

    model = load_model(args.model, max_tokens=0, param_dtype=param_dtype(args),
                       load_tokenizer=False)
    need = max([p + d for p in args.pp for d in args.depth]
               + [t + d + 1 for t in args.tg for d in args.depth])
    cache_len = min(model.cfg.context_length, max(need, 256))
    engine = Engine(model, cache_len=cache_len, prefill_chunk=args.prefill_chunk,
                    temperature=0.0, cache_dtype=cache_dtype(args), rowq=args.rowq,
                    device=args.device, impl=args.impl)
    results = []
    for d in args.depth:
        for p in args.pp:
            results.append(bench_pp(engine, p, d, args.reps))
        for t in args.tg:
            results.append(bench_tg(engine, t, d, args.reps))
    for spec in args.pg:
        results.append(bench_pg(engine, *_pg(spec), args.reps))
    del engine
    if args.batch > 1:
        be = BatchEngine(model, batch_size=args.batch, cache_len=cache_len,
                         prefill_chunk=args.prefill_chunk, cache_dtype=cache_dtype(args),
                         rowq=args.rowq, device=args.device, impl=args.impl)
        for t in args.tg:
            results.append(bench_tg_batch(be, t, max(args.depth), args.reps))
    name = model.metadata.get("general.name", "unknown")
    print(render(results, args.output, name, model.quant_label))


def _pg(spec: str) -> tuple[int, int]:
    p, t = (int(x) for x in spec.split("+"))
    return p, t
