"""Single-sequence inference engine of the port: chunked prefill and windowed
greedy decode on one card.

The port of llamatpu/runtime/engine.py `Engine` (greedy path):
- prefill runs the prompt in chunks of `prefill_chunk`, the final partial
  chunk padded to the next PAD_GRANULE multiple, the logits taken at the last
  REAL token (`logit_index = r - 1`); pad rows written past the real length
  sit beyond every later query's mask and are overwritten before use;
- decode runs windows of up to `decode_window` steps with the argmax and the
  stop check on the device and ONE device-to-host copy per window;
- the KV cache is updated IN PLACE (the JAX package donated it).

Within a window every step is enqueued without waiting for the device, so a
stop token does not end the window early: the steps after it still run, and
their cache rows lie past the returned length (overwritten before they are
attended, as with padded prefill rows). Capturing the decode step in a CUDA
graph, and sampled decoding, are later slices of the port.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from llamatpu_torch.models.synthetic import LoadedModel
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
        raise RuntimeError("no CUDA device available; pass device='cpu' to run the "
                           "plain PyTorch versions of the kernels")
    return device


class Engine:
    def __init__(
        self,
        model: LoadedModel,
        cache_len: int | None = None,
        prefill_chunk: int = 128,
        cache_dtype: torch.dtype = torch.bfloat16,
        temperature: float = 0.0,
        decode_window: int = 16,
        rowq: bool = False,
        device: str | torch.device | None = None,
        metrics: RunMetrics | None = None,
    ):
        self.device = resolve_device(device)
        if not rowq:
            raise NotImplementedError(
                "the port serves q8_row (rowq=True); Q8_0 block-scale serving is "
                "the quant-breadth slice")
        self.model = model
        self.temperature = temperature
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

    def reset(self) -> None:
        self.cache = self._new_cache()

    def _forward(self, tokens: torch.Tensor, pos: int, **kw):
        logits, self.cache = forward_tokens(self.cfg, self.weights, tokens, self.cache, pos,
                                            s_limit=self.cache_len, **kw)
        return logits

    def prefill(self, tokens: list[int], start_pos: int = 0):
        """Run the prompt through the model in causal chunks; returns (next
        token [1] int32 on the device, last real token's logits [1, V]).
        Advances the KV cache in place."""
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
            tok = sampling.sample(logits, self.temperature)
            i += r
        return tok, logits

    def decode_window_run(self, token: int, pos: int, limit: int,
                          stop_tokens=frozenset()) -> list[int]:
        """One decode window: up to `limit` (<= decode_window) tokens after
        `token` at position `pos`. Returns the generated ids, the stop token
        included if one was hit."""
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
            nxt = sampling.sample(self._forward(tok, pos + i, last_logit_only=True),
                                  self.temperature)
            out[i] = nxt[0]
            count += (~done).to(torch.int32)
            if stops is not None:
                done |= torch.isin(nxt, stops).any()
            tok = nxt.view(1, 1)
        out[limit] = count
        host = out.cpu().tolist()  # the window's one device-to-host copy
        return host[:host[limit]]

    def decode_step(self, token: int, pos: int) -> int:
        out = self.decode_window_run(token, pos, 1)
        return out[0] if out else -1

    def generate(self, prompt_tokens: list[int], max_new_tokens: int,
                 stop_tokens: set[int] = frozenset(), on_token=None,
                 start_pos: int = 0) -> GenerationResult:
        """Greedy generation: prompt ingestion, then decode windows with the
        stop-token check and a streaming callback (which may return truthy to
        cancel after that token)."""
        m = self.metrics
        if not prompt_tokens:
            raise ValueError("empty prompt")
        total = start_pos + len(prompt_tokens)
        if total > self.cache_len:
            raise ValueError(f"prompt ({total}) exceeds cache length {self.cache_len}")

        t0 = time.perf_counter()
        tok_arr, _ = self.prefill(prompt_tokens, start_pos)
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
                window = self.decode_window_run(tok, pos, remaining, stop_tokens)
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
