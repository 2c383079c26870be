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

The JAX package's device loop (`lax.while_loop`) exits early once every lane
has stopped; the eager window runs all `limit` steps with the stopped lanes
parked, and the slab is the same.
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
from llamatpu_torch.runtime.engine import resolve_device
from llamatpu_torch.utils.metrics import RunMetrics, Timer


def stops_tensor(stop_tokens, device, pad_to: int = 8) -> torch.Tensor:
    """Fixed-size stop-token vector padded with -1 (the JAX package's
    `Engine._stops_array`): no emitted id is -1, so padding never matches."""
    stops = sorted(stop_tokens)[:pad_to]
    arr = np.full((pad_to,), -1, np.int64)
    arr[:len(stops)] = stops
    return torch.from_numpy(arr).to(device)


def lane_params(engine, temps, topps):
    """Per-lane temperature and top-p as device tensors, and whether any lane
    samples (all-greedy windows skip the draw)."""
    b = engine.batch_size
    t = np.zeros(b, np.float32) if temps is None else np.asarray(temps, np.float32)
    p = np.zeros(b, np.float32) if topps is None else np.asarray(topps, np.float32)
    dev = engine.device
    return (torch.from_numpy(t).to(dev), torch.from_numpy(p).to(dev), bool((t != 0).any()))


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
    ):
        self.device = resolve_device(device)
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

    def _new_cache(self):
        return init_cache(self.cfg, self.batch_size, self.cache_dtype,
                          physical_cache_len(self.cache_len, self.prefill_chunk), self.device)

    def reset(self) -> None:
        self.cache = self._new_cache()

    def prefill_lane(self, lane: int, tokens: list[int], start_pos: int = 0,
                     temperature: float = 0.0, top_p: float = 0.0) -> int:
        """Ingest a prompt (or one chunk of it) into cache row `lane` at
        start_pos; returns the token sampled from its last real token."""
        def forward(arr, pos, logit_index):
            self.prefill_chunks += 1
            logits, self.cache = forward_tokens(self.cfg, self.weights, arr, self.cache, pos,
                                                logit_index=logit_index,
                                                s_limit=self.cache_len, batch_offset=lane)
            return logits

        return prefill_chunks(self, tokens, start_pos, temperature, top_p, forward)

    def decode_window_run(self, tokens: np.ndarray, pos: np.ndarray, active: np.ndarray,
                          stop_tokens=frozenset(), temps=None, topps=None,
                          limit: int | None = None) -> np.ndarray:
        """One batched decode window. tokens/pos/active: [B] host arrays.
        Returns the [decode_window, B] int32 token slab (-1 = lane inactive
        at that step); the caller derives each lane's new tokens and position
        from it."""
        limit = self.decode_window if limit is None else min(limit, self.decode_window)
        dev = self.device
        temps_d, topps_d, any_sampled = lane_params(self, temps, topps)
        stops = stops_tensor(stop_tokens, dev)
        tok = torch.from_numpy(np.asarray(tokens, np.int64)).to(dev)
        posd = torch.from_numpy(np.asarray(pos, np.int32)).to(dev)
        act = torch.from_numpy(np.asarray(active, bool)).to(dev)
        park = torch.full_like(posd, self.cache.kv.shape[3] - 1)
        out = torch.full((self.decode_window, self.batch_size), -1, dtype=torch.int32,
                         device=dev)
        for i in range(max(limit, 0)):
            logits, self.cache = forward_tokens(self.cfg, self.weights, tok[:, None],
                                                self.cache, torch.where(act, posd, park),
                                                last_logit_only=True, s_limit=self.cache_len)
            self.decode_steps += 1
            nxt = sampling.sample_lanes(logits, temps_d, topps_d, self.generator,
                                        any_sampled).long()
            nxt = torch.where(act, nxt, tok)  # inactive lanes re-feed their last token
            out[i] = torch.where(act, nxt, -1).to(torch.int32)
            stopped = torch.isin(nxt, stops)
            bounded = posd + 2 < self.cache_len
            posd = torch.where(act, posd + 1, posd)
            act = act & ~stopped & bounded
            tok = nxt
        return out.cpu().numpy()  # the window's one device-to-host copy

    def generate_batch(self, prompts, max_new_tokens, stop_tokens=frozenset(), temps=None,
                       topps=None):
        return generate_batch(self, prompts, max_new_tokens, stop_tokens, temps, topps)
