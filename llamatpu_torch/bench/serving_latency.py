"""Serving-path latency benchmark (the port of llamatpu/bench/
serving_latency.py): TTFT and inter-token gaps under concurrent load through
the ContinuousBatcher.

Measures, per run:
  - TTFT p50/p99 (submit -> first token: queueing + chunked prefill);
  - inter-token gap p50/p99 across all streams (tokens reach a stream a
    decode window at a time, so gaps within a window are ~0 and window
    boundaries dominate);
  - aggregate decode throughput;
  - the ADVERSARY: with lanes decoding, a long-prompt request lands
    mid-stream; the running lanes' worst inter-token stall during its
    admission and prefill (bounded by interleave_decode_steps, not the
    prompt);
  - prefix-cache warm TTFT and cached tokens (paged engine);
  - the scheduler timeline: where each step's wall time went.
Numbers are reported as measured (host clock, unrounded).
"""
from __future__ import annotations

import threading
import time

import numpy as np


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


class _Timed:
    def __init__(self, batcher, prompt, max_new):
        from llamatpu_torch.runtime.scheduler import BatchRequest

        self.submit_t = time.perf_counter()
        self.stream = batcher.submit(BatchRequest(prompt, max_new))
        self.token_t: list[float] = []
        self.thread = threading.Thread(target=self._drain, daemon=True)
        self.thread.start()

    def _drain(self):
        for _ in self.stream:
            self.token_t.append(time.perf_counter())

    def join(self):
        self.thread.join(timeout=600)

    @property
    def ttft(self):
        return self.token_t[0] - self.submit_t if self.token_t else float("nan")

    @property
    def gaps(self):
        return [b - a for a, b in zip(self.token_t, self.token_t[1:])]


def run_latency_bench(engine, *, n_requests=16, prompt_len=128, max_new=64,
                      adversary_prompt_len=1024, interleave_decode_steps=4,
                      seed=42) -> dict:
    """engine: BatchEngine or PagedBatchEngine (already constructed). The
    result's `scheduler_errors` lists the batcher's recorded exceptions."""
    from llamatpu_torch.runtime.scheduler import ContinuousBatcher

    rng = np.random.default_rng(seed)
    vocab = engine.cfg.vocab_size

    def prompt(n):
        return rng.integers(0, vocab, n).tolist()

    batcher = ContinuousBatcher(engine, stop_tokens=set(),
                                interleave_decode_steps=interleave_decode_steps)
    batcher.record_timeline = True
    try:
        # warm-up: every kernel built and launched once, at every window
        # limit the measurement hits (warm1's long prompt covers the
        # adversary's chunks and the full decode window; warm2 lands during
        # warm1's decode, so the interleave-limited window runs too)
        dw = getattr(engine, "decode_window", 8)
        warm = _Timed(batcher, prompt(adversary_prompt_len), 2 * dw + 2)
        while not warm.token_t and warm.thread.is_alive():
            time.sleep(0.005)
        warm2 = _Timed(batcher, prompt(prompt_len), dw + 2)
        warm.join()
        warm2.join()

        # phase 1: steady concurrent load
        reqs = [_Timed(batcher, prompt(prompt_len), max_new)
                for i in range(n_requests)]

        # phase 2: adversary long prompt lands while lanes are decoding.
        # Event-driven gate (not a sleep, which raced fast engines): wait
        # until at least one stream has produced a token AND is still live,
        # then land the adversary immediately.
        def _decoding_lanes():
            return sum(1 for r in reqs if r.token_t and r.thread.is_alive())

        gate_deadline = time.perf_counter() + 120.0
        while time.perf_counter() < gate_deadline:
            if _decoding_lanes() or not any(r.thread.is_alive() for r in reqs):
                break
            time.sleep(0.001)
        lanes_active = _decoding_lanes()
        adv_t0 = time.perf_counter()
        adv = _Timed(batcher, prompt(adversary_prompt_len), 8)
        adv.join()
        adv_t1 = adv.token_t[0] if adv.token_t else time.perf_counter()
        for r in reqs:
            r.join()

        gaps = [g for r in reqs for g in r.gaps]
        # stalls of ALREADY-RUNNING streams during the adversary's
        # admission+prefill window: any inter-token gap OVERLAPPING
        # [adv_t0, adv_t1] counts — the worst stall typically starts before
        # the adversary lands and ends after its prefill completes, so
        # containment-only matching missed exactly the gap being measured.
        stall = [b - a for r in reqs
                 for a, b in zip(r.token_t, r.token_t[1:])
                 if a <= adv_t1 and b >= adv_t0]
        total_tokens = sum(len(r.token_t) for r in reqs)
        all_token_t = [t for r in reqs for t in r.token_t]
        t_span = (max(all_token_t) - min(r.submit_t for r in reqs)
                  if all_token_t else 0.0)
        out = {
            "n_requests": n_requests, "prompt_len": prompt_len, "max_new": max_new,
            "ttft_p50_s": _pct([r.ttft for r in reqs], 50),
            "ttft_p99_s": _pct([r.ttft for r in reqs], 99),
            "itg_p50_ms": _pct(gaps, 50) * 1e3,
            "itg_p99_ms": _pct(gaps, 99) * 1e3,
            "agg_decode_tok_s":
                total_tokens / max(t_span, 1e-9) if all_token_t else None,
            "adversary_prompt_len": adversary_prompt_len,
            "adversary_ttft_s": adv.ttft,
            "lanes_active_at_adversary": lanes_active,
            # null (not NaN — invalid JSON) when every stream finished before
            # the adversary landed (lanes_active_at_adversary says how many)
            "stall_during_adversary_p99_ms":
                _pct(stall, 99) * 1e3 if stall else None,
        }
        # scheduler-step timeline summary: where the wall time went
        tl = batcher.timeline
        if tl:
            dts = [e["dt"] for e in tl]
            out["sched_steps"] = len(tl)
            out["sched_total_s"] = sum(dts)
            out["sched_prefill_s"] = sum(e.get("prefill_s", 0.0) for e in tl)
            out["sched_decode_s"] = sum(e.get("decode_s", 0.0) for e in tl)
            out["sched_step_p99_ms"] = _pct(dts, 99) * 1e3
            out["sched_step_max_ms"] = max(dts) * 1e3
            dec = [e for e in tl if "decode_s" in e]
            if dec:
                out["sched_decode_ms_per_tok"] = (
                    sum(e["decode_s"] for e in dec)
                    / max(1, sum(e["emitted"] for e in dec)) * 1e3)

        # phase 3: prefix-cache warm repeat (paged engines)
        if getattr(engine, "prefix_cache", False):
            p = prompt(prompt_len)
            cold = _Timed(batcher, p, 8)
            cold.join()
            warm2 = _Timed(batcher, p, 8)
            warm2.join()
            out["prefix_cold_ttft_s"] = cold.ttft
            out["prefix_warm_ttft_s"] = warm2.ttft
            out["prefix_cached_tokens"] = warm2.stream.cached_tokens
            out["prefix_hit_rate"] = warm2.stream.cached_tokens / prompt_len
        out["scheduler_errors"] = [repr(e) for e in batcher.errors]
        return out
    finally:
        batcher.shutdown()
