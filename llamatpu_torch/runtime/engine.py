"""Single-sequence inference engine of the port: chunked prefill and windowed
decode (greedy or sampled) on one card.

The port of llamatpu/runtime/engine.py `Engine`:
- prefill runs the prompt in chunks of `prefill_chunk`, the final partial
  chunk padded to the next PAD_GRANULE multiple, the logits taken at the last
  REAL token (`logit_index = r - 1`); pad rows written past the real length
  sit beyond every later query's mask and are overwritten before use;
- decode runs windows of up to `decode_window` steps with the sampling and
  the stop check on the device and ONE device-to-host copy per window;
- sampling: temperature 0 is argmax; otherwise temperature + top-p nucleus
  draws from a torch.Generator on the engine's device, seeded from `seed`
  (ops/sampling.py). Per-call temperature/top_p override the defaults, as
  `_resolve_sampling` does in the JAX package;
- the KV cache is updated IN PLACE (the JAX package donated it).

Within a window every step is enqueued without waiting for the device, so a
stop token does not end the window early: the steps after it still run, and
their cache rows lie past the returned length (overwritten before they are
attended, as with padded prefill rows). Capturing the decode step in a CUDA
graph is a later slice of the port.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from llamatpu_torch.models.loader import LoadedModel
from llamatpu_torch.models.transformer import (forward_tokens, init_cache, pad_chunk_len,
                                               physical_cache_len)
from llamatpu_torch.models.weights import serving_weights
from llamatpu_torch.ops import sampling
from llamatpu_torch.utils.metrics import RunMetrics, Timer


@dataclass
class GenerationResult:
    tokens: list[int]
    stop_reason: str  # "stop_token" | "length" | "cancelled"
    metrics: RunMetrics


def resolve_device(device) -> torch.device:
    """None means the card. Asking for CUDA where there is none raises: the
    port never carries on quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' (--device cpu) to "
                           "run the plain PyTorch versions of the kernels")
    return device


class Engine:
    def __init__(
        self,
        model: LoadedModel,
        cache_len: int | None = None,
        prefill_chunk: int = 128,
        cache_dtype: torch.dtype = torch.bfloat16,
        temperature: float = 0.0,
        top_p: float = 0.0,
        seed: int = 42,
        decode_window: int = 16,
        rowq: bool = False,
        device: str | torch.device | None = None,
        metrics: RunMetrics | None = None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.default_temperature = temperature
        self.default_top_p = top_p
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cfg = model.cfg
        self.cache_len = cache_len or self.cfg.context_length
        self.prefill_chunk = min(prefill_chunk, self.cache_len)
        self.cache_dtype = cache_dtype
        self.decode_window = max(1, int(decode_window))
        self.metrics = metrics or RunMetrics()
        with Timer() as t:
            self.weights = serving_weights(self.cfg, model.weights, rowq=rowq,
                                           device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.metrics.weight_upload_s = t.elapsed
        self.cache = self._new_cache()

    def _new_cache(self):
        plen = physical_cache_len(self.cache_len, self.prefill_chunk)
        return init_cache(self.cfg, 1, self.cache_dtype, plen, self.device)

    def reset(self, seed: int | None = None) -> None:
        self.cache = self._new_cache()
        if seed is not None:
            self.generator.manual_seed(seed)

    def _resolve_sampling(self, temperature, top_p) -> tuple[float, float]:
        t = self.default_temperature if temperature is None else temperature
        p = self.default_top_p if top_p is None else top_p
        return float(t), float(p)

    def _sample(self, logits: torch.Tensor, temp: float, top_p: float) -> torch.Tensor:
        return sampling.sample(logits, temp, top_p, self.generator)

    def _forward(self, tokens: torch.Tensor, pos: int, **kw):
        logits, self.cache = forward_tokens(self.cfg, self.weights, tokens, self.cache, pos,
                                            s_limit=self.cache_len, **kw)
        return logits

    def prefill(self, tokens: list[int], start_pos: int = 0, temperature=None, top_p=None):
        """Run the prompt through the model in causal chunks; returns (next
        token [1] int32 on the device, last real token's logits [1, V]).
        Advances the KV cache in place."""
        temp, top_p = self._resolve_sampling(temperature, top_p)
        c = self.prefill_chunk
        tok = logits = None
        i = 0
        while i < len(tokens):
            chunk = tokens[i:i + c]
            r = len(chunk)
            if r < c:  # pad the final partial chunk to the next granule
                chunk = chunk + [0] * (pad_chunk_len(r, c) - r)
            arr = torch.tensor([chunk], dtype=torch.int64, device=self.device)
            logits = self._forward(arr, start_pos + i, logit_index=r - 1)
            tok = self._sample(logits, temp, top_p)
            i += r
        return tok, logits

    def decode_window_run(self, token: int, pos: int, limit: int,
                          stop_tokens=frozenset(), temperature=None, top_p=None) -> list[int]:
        """One decode window: up to `limit` (<= decode_window) tokens after
        `token` at position `pos`. Returns the generated ids, the stop token
        included if one was hit."""
        temp, top_p = self._resolve_sampling(temperature, top_p)
        limit = min(limit, self.decode_window, self.cache_len - pos - 1)
        if limit <= 0:
            return []
        dev = self.device
        stops = (torch.tensor(sorted(stop_tokens), dtype=torch.int32, device=dev)
                 if stop_tokens else None)
        tok = torch.full((1, 1), token, dtype=torch.int64, device=dev)
        out = torch.empty(limit + 1, dtype=torch.int32, device=dev)  # ids, then count
        count = torch.zeros((), dtype=torch.int32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for i in range(limit):
            nxt = self._sample(self._forward(tok, pos + i, last_logit_only=True),
                               temp, top_p)
            out[i] = nxt[0]
            count += (~done).to(torch.int32)
            if stops is not None:
                done |= torch.isin(nxt, stops).any()
            tok = nxt.view(1, 1)
        out[limit] = count
        host = out.cpu().tolist()  # the window's one device-to-host copy
        return host[:host[limit]]

    def decode_step(self, token: int, pos: int, temperature=None, top_p=None) -> int:
        out = self.decode_window_run(token, pos, 1, frozenset(), temperature, top_p)
        return out[0] if out else -1

    def generate(self, prompt_tokens: list[int], max_new_tokens: int,
                 stop_tokens: set[int] = frozenset(), on_token=None, echo: bool = False,
                 start_pos: int = 0, temperature=None, top_p=None) -> GenerationResult:
        """Generation: prompt ingestion, then decode windows with the
        stop-token check and a streaming callback (which may return truthy to
        cancel after that token). echo: the prompt ids go to the callback
        first."""
        m = self.metrics
        if not prompt_tokens:
            raise ValueError("empty prompt")
        if echo and on_token:
            for t in prompt_tokens:
                on_token(t)
        total = start_pos + len(prompt_tokens)
        if total > self.cache_len:
            raise ValueError(f"prompt ({total}) exceeds cache length {self.cache_len}")

        t0 = time.perf_counter()
        tok_arr, _ = self.prefill(prompt_tokens, start_pos, temperature, top_p)
        first = int(tok_arr[0])  # waits for the prefill
        m.prefill_s += time.perf_counter() - t0
        m.prefill_tokens += len(prompt_tokens)

        out: list[int] = [first]
        stop_reason = "length"
        tok, pos = first, total
        t0 = time.perf_counter()
        cancelled = bool(on_token(tok)) if on_token else False
        if tok in stop_tokens:
            stop_reason = "stop_token"
        elif cancelled:
            stop_reason = "cancelled"
        else:
            remaining = max_new_tokens - 1
            while remaining > 0 and pos + 1 < self.cache_len:
                window = self.decode_window_run(tok, pos, remaining, stop_tokens,
                                                temperature, top_p)
                if not window:
                    break
                for t in window:
                    out.append(t)
                    if on_token and on_token(t):
                        cancelled = True
                        break
                if cancelled:
                    stop_reason = "cancelled"
                    break
                if window[-1] in stop_tokens:
                    stop_reason = "stop_token"
                    break
                tok = window[-1]
                pos += len(window)
                remaining -= len(window)
        m.decode_s += time.perf_counter() - t0
        m.decode_tokens += len(out)
        return GenerationResult(out, stop_reason, m)
