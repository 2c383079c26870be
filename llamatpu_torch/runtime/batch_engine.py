"""Static batched decode engine (the port of llamatpu/runtime/batch_engine.py):
B independent sequences share one decode step over a dense [L, B, KV, S, W]
KV cache, with per-lane positions, sampling parameters and stop detection.
It is the substrate of the continuous-batching scheduler (runtime/
scheduler.py): lanes prefill one at a time and decode together.

Per-lane semantics:
- prefill: a lane's prompt runs as a [1, T] window written straight into
  cache row `lane` (`forward_tokens(..., batch_offset=lane)`), in chunks of
  `prefill_chunk`, the final partial chunk padded as `Engine` does;
- decode window: `limit` steps for all lanes, each lane at its own position
  (a [B] vector on the device), sampling (temperature 0 = argmax) and the
  stop check on the device, ONE device-to-host copy of the [W, B] token slab
  per window (-1 marks a lane inactive at that step);
- inactive lanes re-feed their last token and their KV writes are PARKED in
  the last physical row (past the logical length, never attended): with
  interleaved chunked prefill another request may be mid-prefill in that
  lane, and a write at its stale position would corrupt the fresh KV.

A window is one step over static state (runtime/decode_graph.py), run
eagerly on the CPU and replayed as a captured CUDA graph on the card, one
graph per sampling mode (all lanes greedy, or any lane sampled). The JAX
package's device loop (`lax.while_loop`) exits early once every lane has
stopped; a window here runs all `limit` steps with the stopped lanes parked,
and the slab is the same. `reset()` zeroes the cache in place.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from llamatpu_torch.models.loader import LoadedModel
from llamatpu_torch.models.transformer import (forward_tokens, init_cache, pad_chunk_len,
                                               physical_cache_len)
from llamatpu_torch.models.weights import serving_weights
from llamatpu_torch.ops import sampling
from llamatpu_torch.runtime.decode_graph import StepGraphs, stop_ids, tensors_key, zeroed_cache
from llamatpu_torch.ops.matmul import check_impl
from llamatpu_torch.runtime.engine import resolve_device
from llamatpu_torch.utils.metrics import RunMetrics, Timer


def window_inputs(engine, temps, topps):
    """Per-lane temperature and top-p as host arrays [B], and whether any
    lane samples (all-greedy windows take the greedy step, which skips the
    draw)."""
    b = engine.batch_size
    t = np.zeros(b, np.float32) if temps is None else np.asarray(temps, np.float32)
    p = np.zeros(b, np.float32) if topps is None else np.asarray(topps, np.float32)
    return t, p, bool((t != 0).any())


def prefill_chunks(engine, tokens: list[int], start_pos: int, temperature: float,
                   top_p: float, forward) -> int:
    """Chunked prefill of one lane (the padded final chunk as in `Engine`);
    forward(chunk [1, c] tensor, pos, logit_index) -> logits [1, V]. Returns
    the token sampled from the last real token's logits."""
    c = engine.prefill_chunk
    dev = engine.device
    temp = torch.full((1,), float(temperature), device=dev)
    topp = torch.full((1,), float(top_p), device=dev)
    tok = None
    i = 0
    while i < len(tokens):
        chunk = tokens[i:i + c]
        r = len(chunk)
        if r < c:  # pad the final partial chunk to the next granule
            chunk = chunk + [0] * (pad_chunk_len(r, c) - r)
        arr = torch.tensor([chunk], dtype=torch.int64, device=dev)
        logits = forward(arr, start_pos + i, r - 1)
        tok = sampling.sample_lanes(logits, temp, topp, engine.generator,
                                    any_sampled=temperature != 0.0)
        i += r
    return int(tok[0])


def generate_batch(engine, prompts: list[list[int]], max_new_tokens: int,
                   stop_tokens=frozenset(), temps=None, topps=None) -> list[list[int]]:
    """Static batched generation: prefill each lane, decode all together.
    Returns the per-sequence token lists (a stop token included). Shared by
    BatchEngine and PagedBatchEngine, as in the JAX package."""
    b_size = engine.batch_size
    if len(prompts) > b_size:
        raise ValueError(f"{len(prompts)} prompts for {b_size} lanes")
    engine.reset()
    tokens = np.zeros(b_size, np.int32)
    pos = np.zeros(b_size, np.int32)
    active = np.zeros(b_size, bool)
    outs: list[list[int]] = [[] for _ in prompts]

    t0 = time.perf_counter()
    for b, p in enumerate(prompts):
        t = engine.prefill_lane(b, p, 0, 0.0 if temps is None else float(temps[b]),
                                0.0 if topps is None else float(topps[b]))
        tokens[b] = t
        pos[b] = len(p)
        active[b] = True
        outs[b].append(t)
        if t in stop_tokens:
            active[b] = False
    engine.metrics.prefill_s += time.perf_counter() - t0
    engine.metrics.prefill_tokens += sum(len(p) for p in prompts)

    remaining = max_new_tokens - 1
    t0 = time.perf_counter()
    while remaining > 0 and active.any():
        slab = engine.decode_window_run(tokens, pos, active, stop_tokens, temps, topps,
                                        limit=remaining)
        steps = 0
        for b in range(len(prompts)):
            col = slab[:, b]
            emitted = [int(t) for t in col[col >= 0]]
            for t in emitted:
                outs[b].append(t)
                if t in stop_tokens:
                    active[b] = False
            if emitted:
                tokens[b] = emitted[-1]
            pos[b] += len(emitted)
            if pos[b] + 2 >= engine.cache_len:
                active[b] = False
            steps = max(steps, len(emitted))
        if steps == 0:
            break
        remaining -= steps
    engine.metrics.decode_s += time.perf_counter() - t0
    engine.metrics.decode_tokens += sum(len(o) for o in outs)
    return outs


class BatchEngine:
    def __init__(
        self,
        model: LoadedModel,
        batch_size: int = 8,
        cache_len: int | None = None,
        prefill_chunk: int = 128,
        cache_dtype: torch.dtype = torch.bfloat16,
        seed: int = 42,
        decode_window: int = 16,
        metrics: RunMetrics | None = None,
        rowq: bool = False,
        rowq_experts: bool | None = None,
        device: str | torch.device | None = None,
        impl: str = "auto",
    ):
        self.device = resolve_device(device)
        self.impl = check_impl(impl)
        self.model = model
        self.cfg = model.cfg
        self.batch_size = batch_size
        self.cache_len = cache_len or self.cfg.context_length
        self.prefill_chunk = min(prefill_chunk, self.cache_len)
        self.cache_dtype = cache_dtype
        self.decode_window = max(1, int(decode_window))
        self.metrics = metrics or RunMetrics()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        with Timer() as t:
            self.weights = serving_weights(self.cfg, model.weights, rowq=rowq,
                                           rowq_experts=rowq_experts, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.metrics.weight_upload_s = t.elapsed
        self.decode_steps = 0    # device decode steps run (all lanes at once)
        self.prefill_chunks = 0  # lane prefill chunks run
        self.cache = self._new_cache()
        self._graphs = StepGraphs(self.device, self.metrics)

    def _new_cache(self):
        return init_cache(self.cfg, self.batch_size, self.cache_dtype,
                          physical_cache_len(self.cache_len, self.prefill_chunk), self.device)

    def reset(self) -> None:
        """A zero cache: zeroed in place while its geometry holds (the
        captured steps keep their addresses), else allocated anew."""
        self.cache = zeroed_cache(self.cache, physical_cache_len(self.cache_len,
                                                                 self.prefill_chunk),
                                  self.cache_dtype, self._new_cache, self._graphs)

    def prefill_lane(self, lane: int, tokens: list[int], start_pos: int = 0,
                     temperature: float = 0.0, top_p: float = 0.0) -> int:
        """Ingest a prompt (or one chunk of it) into cache row `lane` at
        start_pos; returns the token sampled from its last real token."""
        def forward(arr, pos, logit_index):
            self.prefill_chunks += 1
            logits, self.cache = forward_tokens(self.cfg, self.weights, arr, self.cache, pos,
                                                logit_index=logit_index, s_limit=self.cache_len,
                                                batch_offset=lane, impl=self.impl)
            return logits

        return prefill_chunks(self, tokens, start_pos, temperature, top_p, forward)

    def _step(self, sampled: bool) -> None:
        """One decode step of every lane over the static state: inactive lanes
        re-feed their last token with their KV write parked in the last
        physical row; out[step] = the sampled ids (-1 for inactive lanes);
        a lane stops at a stop id or two rows before cache_len."""
        st = self._graphs.state
        park = self.cache.kv.shape[3] - 1
        logits, _ = forward_tokens(self.cfg, self.weights, st.tok[:, None], self.cache,
                                   torch.where(st.act, st.pos, park), last_logit_only=True,
                                   s_limit=self.cache_len, impl=self.impl)
        nxt = sampling.sample_lanes(logits, st.temps, st.topps, self.generator, sampled)
        nxt = torch.where(st.act, nxt, st.tok)  # inactive lanes re-feed their last token
        st.record(torch.where(st.act, nxt, -1))
        stopped = sampling.is_stop(nxt, st.stops)
        bounded = st.pos + 2 < self.cache_len
        st.pos.copy_(torch.where(st.act, st.pos + 1, st.pos))
        st.act &= ~stopped & bounded
        st.tok.copy_(nxt)

    def decode_window_run(self, tokens: np.ndarray, pos: np.ndarray, active: np.ndarray,
                          stop_tokens=frozenset(), temps=None, topps=None,
                          limit: int | None = None) -> np.ndarray:
        """One batched decode window. tokens/pos/active: [B] host arrays.
        Returns the [decode_window, B] int32 token slab (-1 = lane inactive
        at that step); the caller derives each lane's new tokens and position
        from it."""
        limit = max(0, self.decode_window if limit is None else min(limit, self.decode_window))
        temps, topps, sampled = window_inputs(self, temps, topps)
        st = self._graphs.state_for(self.batch_size, self.decode_window)
        geometry = (tensors_key(self.cache.kv, self.cache.scale), self.cache_len)
        run = self._graphs.runner(geometry, sampled, lambda: self._step(sampled),
                                  st.act.zero_, self.generator, self.impl)
        st.fill(tokens, pos, active, temps, topps, stop_ids(stop_tokens))
        run(limit)
        self.decode_steps += limit
        return st.out.cpu().numpy()  # the window's one device-to-host copy

    def generate_batch(self, prompts, max_new_tokens, stop_tokens=frozenset(), temps=None,
                       topps=None):
        return generate_batch(self, prompts, max_new_tokens, stop_tokens, temps, topps)
