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

A decode window is one step over static state (runtime/decode_graph.py),
guarded by the window's condition as the JAX `while_loop`'s `cond` guards
it: run eagerly up to `limit` times on the CPU, captured once as a CUDA
graph whose step sits under a conditional node and replayed up to `limit`
times on the card. A window ends at a stop token: no step after it runs, so
no cache row past the returned length is written, and `decode_steps` counts
the steps run. With `aot_compile` (the default, as in the JAX package) the
default sampling mode's step is captured at construction and its time
recorded in `metrics.compile_s`. `reset()` zeroes the cache in place, so the
captured addresses stay valid; a new geometry (`cache_len`,
`prefill_chunk`, `cache_dtype` changed) gets a new cache and new graphs.

Prompt-lookup speculative decoding (`spec_decode=K`, the JAX `spec_decode_
n_fn`): the engine keeps the token-id history [1, physical_len] on the
device beside the cache (each padded prefill chunk is recorded; reset()
zeroes it in place, reseed() keeps it). A decode step is then one verify
forward of K + 1 rows: K drafts from the last bigram's latest earlier
continuation in the history, verified greedily (the accepted argmax
prefix) or by rejection sampling (`sampling.spec_verify_sample`), emitting
up to K + 1 tokens. A window is `limit` guarded replays of the verify step
(a live forward emits at least one token, so they always suffice) and one
small copy of the state to the host; a forward after the window is done
does not run, and writes nothing, as in the JAX loop. Greedy spec output is
the plain greedy stream wherever the forward is batch-invariant (f32 here;
under bf16 on the card, argmax near-ties may part, as the JAX package
notes).

`impl` ("auto": the port's kernels; "int8": the exact int8 mode,
models/transformer.py) reaches every forward: prefill chunks, the decode
step and the verify forward (at K + 1 <= 16 rows it takes the int8 dot).
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
from llamatpu_torch.ops.matmul import check_impl
from llamatpu_torch.runtime.decode_graph import StepGraphs, stop_ids, tensors_key, zeroed_cache
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
        rowq_experts: bool | None = None,
        device: str | torch.device | None = None,
        metrics: RunMetrics | None = None,
        aot_compile: bool = True,
        spec_decode: int = 0,
        impl: str = "auto",
    ):
        self.device = resolve_device(device)
        self.impl = check_impl(impl)
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
        # prompt-lookup speculative decoding: K drafts a verify forward (0 = off)
        self.spec_k = max(0, int(spec_decode))
        self._ids = None  # [1, physical_len] int32 token-id history on the device (spec)
        self.spec_reads = 0  # host reads of the verify state: one a window
        with Timer() as t:
            self.weights = serving_weights(self.cfg, model.weights, rowq=rowq,
                                           rowq_experts=rowq_experts, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.metrics.weight_upload_s = t.elapsed
        self.cache = self._new_cache()
        self.decode_steps = 0  # decode steps (verify forwards) run on the device
        self._graphs = StepGraphs(self.device, self.metrics)
        if aot_compile and self.device.type == "cuda":
            # the default mode's decode step, captured ahead of the first window
            self._window(self.default_temperature != 0.0)
            self.reset()

    def _new_cache(self):
        plen = physical_cache_len(self.cache_len, self.prefill_chunk)
        if self.spec_k:
            self._ids = torch.zeros((1, plen), dtype=torch.int32, device=self.device)
        return init_cache(self.cfg, 1, self.cache_dtype, plen, self.device)

    def reset(self, seed: int | None = None) -> None:
        """A zero cache (and token-id history), as the JAX package's fresh
        one: zeroed in place while its geometry holds (the captured steps
        keep their addresses), else allocated anew for the engine's current
        cache_len, prefill_chunk and cache_dtype."""
        cache = self.cache
        self.cache = zeroed_cache(cache, physical_cache_len(self.cache_len, self.prefill_chunk),
                                  self.cache_dtype, self._new_cache, self._graphs)
        if self.cache is cache and self._ids is not None:
            self._ids.zero_()
        if seed is not None:
            self.generator.manual_seed(seed)

    def reseed(self, seed: int) -> None:
        """Restart the sampling generator WITHOUT dropping the KV cache (the
        service's prefix reuse keeps the cache across requests; rows past
        the written length are never attended)."""
        self.generator.manual_seed(seed)

    def _resolve_sampling(self, temperature, top_p) -> tuple[float, float]:
        t = self.default_temperature if temperature is None else temperature
        p = self.default_top_p if top_p is None else top_p
        return float(t), float(p)

    def _sample(self, logits: torch.Tensor, temp: float, top_p: float) -> torch.Tensor:
        return sampling.sample(logits, temp, top_p, self.generator)

    def _forward(self, tokens: torch.Tensor, pos: int, **kw):
        logits, self.cache = forward_tokens(self.cfg, self.weights, tokens, self.cache, pos,
                                            s_limit=self.cache_len, impl=self.impl, **kw)
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
            if self._ids is not None:  # the padded chunk joins the draft corpus
                at = min(start_pos + i, self._ids.shape[1] - len(chunk))  # XLA's clamp
                self._ids[0, at:at + len(chunk)] = arr[0]
            logits = self._forward(arr, start_pos + i, logit_index=r - 1)
            tok = self._sample(logits, temp, top_p)
            i += r
        return tok, logits

    def _step(self, sampled: bool) -> None:
        """One decode step over the static state: the forward at the device
        position, the sample (greedy, or a draw with the state's temperature
        and top-p), out[step], the lane's `act` cleared at a stop (the
        state's `live`, the JAX `cond`, is then false), and the next token
        and position. No host value is read."""
        st = self._graphs.state
        logits, _ = forward_tokens(self.cfg, self.weights, st.tok.view(1, 1), self.cache, st.pos,
                                   last_logit_only=True, s_limit=self.cache_len, impl=self.impl)
        nxt = sampling.sample_lanes(logits, st.temps, st.topps, self.generator, sampled)
        st.record(nxt)
        st.act &= ~sampling.is_stop(nxt, st.stops)
        st.tok.copy_(nxt)
        st.pos += 1

    def _spec_step(self, sampled: bool) -> None:
        """One verify forward of the JAX `spec_decode_n_fn` loop body, over
        the static state (SpecState) with no host read: draft K tokens from
        the last bigram's latest earlier continuation in the id history,
        verify [tok, drafts] in one forward of K + 1 rows, emit the accepted
        prefix and one token, clipped at a stop, the budget and the cache's
        end. The state's guard runs it only while not `done`, as the JAX
        loop's `cond` does. Starts of K + 1 row writes and reads clamp as
        XLA's dynamic slices do (so does the emitted count's last index: a
        capture's warm-up may find the budget spent)."""
        st, ids, k = self._graphs.state, self._ids[0], self.spec_k
        dev, s_phys = ids.device, ids.shape[0]
        pos = st.pos.long()
        a = ids.index_select(0, (pos - 1).clamp(min=0))
        iota = torch.arange(s_phys - 1, device=dev)
        hit = (iota <= pos - 2) & (ids[:-1] == a) & (ids[1:] == st.tok)
        jstar = torch.where(hit, iota, -1).max()
        start = torch.clamp(jstar + 2, 0, s_phys - k)
        drafts = ids.index_select(0, start + torch.arange(k, device=dev))
        drafts = torch.where(jstar >= 0, drafts, st.tok)
        w = torch.cat([st.tok, drafts])                               # [K + 1]
        rows = torch.clamp(pos, 0, s_phys - k - 1) + torch.arange(k + 1, device=dev)
        ids.index_copy_(0, rows, w)
        logits, _ = forward_tokens(self.cfg, self.weights, w.view(1, k + 1), self.cache, st.pos,
                                   s_limit=self.cache_len, impl=self.impl)
        if sampled:
            cand, m = sampling.spec_verify_sample(logits[0], drafts, st.temps, st.topps,
                                                  self.generator)
        else:
            cand = sampling.greedy(logits[0])
            m = torch.cumprod((cand[:-1] == drafts).to(torch.int64), 0).sum()
        idxs = torch.arange(k + 1, device=dev)
        stop_at = torch.where(sampling.is_stop(cand, st.stops) & (idxs <= m), idxs, k + 1).min()
        e = torch.where(stop_at <= m, stop_at + 1, m + 1)
        e = torch.minimum(e, st.limit - st.cnt)                       # budget
        e = torch.minimum(e, torch.clamp(self.cache_len - 1 - st.pos, min=1))
        hit_stop = (stop_at <= m) & (stop_at + 1 <= e)
        slots = torch.clamp(st.cnt.long(), 0, st.window - 1) + idxs
        st.out.index_copy_(0, slots, cand)
        e = e.to(torch.int32)
        st.tok.copy_(cand.index_select(0, (e - 1).clamp(min=0).long()))
        st.pos += e
        st.cnt += e
        st.done |= hit_stop | (st.pos + 1 >= self.cache_len) | (st.cnt >= st.limit)

    def _park(self, pos: int):
        """The warm-up step's state. The plain step: the last physical row,
        which no query attends (the cache's slack past cache_len). The
        verify step: the window's position, where its cache rows are those
        the window's first forward rewrites; it returns the putting back of
        the id history, which the warm-up writes and the first forward's
        drafts read."""
        st = self._graphs.state
        st.pos.fill_(pos if self.spec_k else self.cache.kv.shape[3] - 1)
        st.tok.zero_()
        if self.spec_k:
            saved = self._ids.clone()
            return lambda: self._ids.copy_(saved)
        return None

    def _window(self, sampled: bool, pos: int = 0):
        """The runner of this window's steps (runtime/decode_graph.py),
        capturing the step for the current geometry and mode if needed (the
        verify step parks at `pos`, the window's start)."""
        self._graphs.state_for(1, self.decode_window, self.spec_k)
        geometry = (tensors_key(self.cache.kv, self.cache.scale, self._ids), self.cache_len)
        step = self._spec_step if self.spec_k else self._step
        return self._graphs.runner(geometry, sampled, lambda: step(sampled),
                                   lambda: self._park(pos), self.generator, self.impl)

    def decode_window_run(self, token: int, pos: int, limit: int,
                          stop_tokens=frozenset(), temperature=None, top_p=None) -> list[int]:
        """One decode window: up to `limit` (<= decode_window) tokens after
        `token` at position `pos`, ending at a stop. Returns the generated
        ids, the stop token included if one was hit."""
        temp, top_p = self._resolve_sampling(temperature, top_p)
        limit = min(limit, self.decode_window, self.cache_len - pos - 1)
        if limit <= 0:
            return []
        run = self._window(temp != 0.0, pos)
        st = self._graphs.state
        if self.spec_k:
            return self._spec_window(run, token, pos, limit, stop_tokens, temp, top_p)
        st.fill([token], [pos], [True], [temp], [top_p], stop_ids(stop_tokens))
        run(limit)
        out, steps = st.host()  # the one device-to-host copy
        run.done(steps)
        self.decode_steps += steps
        return out[:steps, 0].tolist()

    def _spec_window(self, run, token: int, pos: int, limit: int, stop_tokens, temp: float,
                     top_p: float) -> list[int]:
        """A speculative window: `limit` guarded verify forwards (the JAX
        loop runs them while cnt < limit and not done), then one
        device-to-host copy of the state, which holds the tokens."""
        st = self._graphs.state
        st.fill(token, pos, temp, top_p, stop_ids(stop_tokens), limit)
        run(limit)
        host = st.host()
        self.spec_reads += 1
        cnt, steps, _ = host[-3:]
        run.done(steps)
        self.decode_steps += steps
        ex = self.metrics.extra
        ex["spec_emitted"] = ex.get("spec_emitted", 0) + cnt
        ex["spec_forwards"] = ex.get("spec_forwards", 0) + steps
        if ex["spec_forwards"]:
            # mean drafted tokens accepted per verify forward (0 = no speedup)
            ex["spec_accept_rate"] = round(ex["spec_emitted"] / ex["spec_forwards"] - 1.0, 4)
        return host[:cnt]

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
