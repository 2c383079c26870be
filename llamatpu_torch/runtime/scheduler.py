"""Continuous batching scheduler (the port of llamatpu/runtime/scheduler.py):
a request queue feeding a BatchEngine or PagedBatchEngine. Requests join a
running batch between decode windows: a free lane is prefilled while the
other lanes keep decoding, each lane streams tokens to its own consumer, and
lanes free up independently on stop or length.

Scheduling loop (one background thread, which launches every kernel; HTTP
handler threads only consume TokenStreams):
  1. assign: pop pending requests into free lanes (no device work yet); a
     paged engine maps cached prompt blocks and reserves the prompt's span,
     or the request waits in the backlog (backpressure);
  2. prefill-interleave: advance the OLDEST prefilling lane by ONE chunk (a
     chunk costs about one weight pass, i.e. about one decode step, so
     running lanes are never frozen behind a long prompt);
  3. decode: one window for all active lanes; while a lane is still
     prefilling the window is capped at `interleave_decode_steps`, and near
     the cache end it shrinks to the power-of-two floor of the tightest
     lane's room;
  4. route: distribute the [W, B] token slab to the streams, enforcing each
     request's budget on the host (lanes may overshoot by less than a window
     on the device, into slack rows or the trash block); finish lanes on a
     stop token or the budget.

Every exception of the loop finishes the in-flight streams (so consumers are
not stranded, as in the JAX package) and is recorded in `errors`, which
tests and `chip_smoke.py` assert empty.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field

import numpy as np


@dataclass
class BatchRequest:
    prompt_tokens: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 0.0
    stream: "TokenStream" = None


class TokenStream:
    """Per-request token channel: the scheduler pushes ids, the consumer
    iterates."""

    _END = object()

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self.finish_reason: str | None = None
        self.cancelled = False
        self.cached_tokens = 0  # prompt tokens served from the KV prefix cache

    def push(self, token_id: int) -> None:
        self._q.put(token_id)

    def cancel(self, reason: str = "stop") -> None:
        """Consumer-side abort (e.g. a stop string matched): the scheduler
        frees this lane at its next step; the consumer stops iterating now."""
        self.finish_reason = reason
        self.cancelled = True

    def finish(self, reason: str) -> None:
        if self.finish_reason is None:
            self.finish_reason = reason
        self._q.put(self._END)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                return
            yield item


@dataclass
class _Lane:
    req: BatchRequest | None = None
    produced: int = 0
    # verified KV history: every token whose KV provably landed in the cache
    # (the prompt, then each token fed back to the device). The last sampled
    # token is NOT in `fed` until the next window feeds it: it sits in
    # `next_tok`. Drives paged prefix-cache registration at release.
    fed: list = field(default_factory=list)
    next_tok: int = -1
    # chunked-prefill state: prompt tokens not yet fed and the lane's next
    # prefill write position; an empty rem means the lane decodes
    prefill_rem: list = field(default_factory=list)
    prefill_pos: int = 0
    seq: int = 0  # assignment order (FCFS prefill advancement)


class ContinuousBatcher:
    def __init__(self, engine, stop_tokens: set[int], interleave_decode_steps: int = 4):
        self.engine = engine
        self.stop_tokens = set(stop_tokens)
        # decode-window cap while a prefill is in flight: a prefill chunk costs
        # ~one decode step, so TTFT for a P-token prompt is about
        # ceil(P / chunk) * (1 + this) decode steps
        self.interleave_decode_steps = max(1, int(interleave_decode_steps))
        self._seq = 0
        self.B = engine.batch_size
        self._lanes = [_Lane() for _ in range(self.B)]
        self._pending: queue.Queue[BatchRequest] = queue.Queue()
        self._backlog: list[BatchRequest] = []
        self._tokens = np.zeros(self.B, np.int32)
        self._pos = np.zeros(self.B, np.int32)
        self._active = np.zeros(self.B, bool)
        self._temps = np.zeros(self.B, np.float32)
        self._topps = np.zeros(self.B, np.float32)
        self._wake = threading.Event()
        self._shutdown = False
        self.errors: list[BaseException] = []
        # optional per-step timeline (bench/serving_latency.py): where each
        # step's wall time went
        self.record_timeline = False
        self.timeline: list[dict] = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API -------------------------------------------------------
    def submit(self, req: BatchRequest) -> TokenStream:
        req.stream = TokenStream()
        self._pending.put(req)
        self._wake.set()
        return req.stream

    def shutdown(self) -> None:
        self._shutdown = True
        self._wake.set()
        self._thread.join(timeout=30)

    # -- scheduler loop ---------------------------------------------------
    def _free_lane(self) -> int | None:
        for i, lane in enumerate(self._lanes):
            if lane.req is None:
                return i
        return None

    def _admit(self) -> None:
        eng = self.engine
        paged = hasattr(eng, "reserve_lane")
        while True:
            lane = self._free_lane()
            if lane is None:
                return
            req = self._backlog.pop(0) if self._backlog else None
            if req is None:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    return
            budget = min(req.max_new_tokens, eng.cache_len - len(req.prompt_tokens) - 2)
            if budget <= 0 or len(req.prompt_tokens) >= eng.cache_len:
                req.stream.finish("length")
                continue
            if paged and not eng.can_admit(len(req.prompt_tokens)):
                # paged pool backpressure: hold until blocks free up
                self._backlog.append(req)
                return
            reuse = 0
            if paged:  # map cached prompt blocks, then reserve the whole span
                reuse = eng.acquire_prefix_for(lane, req.prompt_tokens)
                req.stream.cached_tokens = reuse
                if not eng.reserve_lane(lane, len(req.prompt_tokens)):
                    # can_admit raced another lane's growth: roll back this
                    # lane's blocks (prefix refs included) and hold the request
                    eng.release_lane(lane)
                    req.stream.cached_tokens = 0
                    self._backlog.append(req)
                    return
            ln = self._lanes[lane]
            ln.req = req
            ln.produced = 0
            ln.fed = list(req.prompt_tokens[:reuse])
            ln.next_tok = -1
            ln.prefill_rem = list(req.prompt_tokens[reuse:])
            ln.prefill_pos = reuse
            ln.seq = self._seq
            self._seq += 1
            self._temps[lane] = req.temperature
            self._topps[lane] = req.top_p

    def _prefilling(self) -> list[int]:
        return sorted((i for i, ln in enumerate(self._lanes)
                       if ln.req is not None and ln.prefill_rem),
                      key=lambda i: self._lanes[i].seq)

    def _advance_prefill(self, lane: int) -> None:
        """Feed ONE chunk of the lane's remaining prompt. On the final chunk
        the sampled first token goes live and the lane joins decode."""
        ln = self._lanes[lane]
        c = self.engine.prefill_chunk
        chunk = ln.prefill_rem[:c]
        final = len(ln.prefill_rem) <= c
        tok = self.engine.prefill_lane(lane, chunk, ln.prefill_pos, ln.req.temperature,
                                       ln.req.top_p)
        ln.prefill_pos += len(chunk)
        ln.prefill_rem = ln.prefill_rem[len(chunk):]
        ln.fed.extend(chunk)
        if not final:  # intermediate chunk: the sampled token is discarded
            return
        ln.produced = 1
        ln.next_tok = tok
        self._tokens[lane] = tok
        self._pos[lane] = ln.prefill_pos
        ln.req.stream.push(tok)
        if tok in self.stop_tokens:
            self._finish_lane(lane, "stop")
        else:
            self._active[lane] = True

    def _finish_lane(self, lane: int, reason: str) -> None:
        ln = self._lanes[lane]
        if ln.req is not None:
            ln.req.stream.finish(reason)
        fed = ln.fed
        self._lanes[lane] = _Lane()
        self._active[lane] = False
        release = getattr(self.engine, "release_lane", None)
        if release is not None:
            # paged pool: recycle the lane's blocks; the verified history
            # registers its full blocks into the prefix cache
            release(lane, fed_tokens=fed)

    def _loop(self) -> None:
        while not self._shutdown:
            try:
                self._step()
            except Exception as e:  # a scheduler fault must not strand consumers
                traceback.print_exc()
                self.errors.append(e)
                for i in range(self.B):
                    if self._lanes[i].req is not None:
                        self._finish_lane(i, "length")

    def _step(self) -> None:
        rec = {"t0": time.perf_counter()} if self.record_timeline else None
        for b in range(self.B):  # consumer-side cancels free the lane here
            ln = self._lanes[b]
            if ln.req is not None and ln.req.stream.cancelled:
                self._finish_lane(b, "stop")
        self._admit()
        prefilling = self._prefilling()
        if prefilling:
            tp0 = time.perf_counter()
            self._advance_prefill(prefilling[0])
            if rec is not None:
                rec["prefill_s"] = time.perf_counter() - tp0
                rec["n_prefilling"] = len(prefilling)
            prefilling = self._prefilling()
        if not self._active.any():
            if not prefilling:  # fully idle: sleep until work arrives
                self._wake.wait(timeout=0.05)
                self._wake.clear()
            elif rec is not None:
                rec["dt"] = time.perf_counter() - rec["t0"]
                self.timeline.append(rec)
            return
        # the window limit takes a few values only (the JAX package compiled
        # one program per value); budgets are enforced on the host below
        limit = self.interleave_decode_steps if prefilling else self.engine.decode_window
        # near the cache end, shrink to the pow2 floor of the tightest room
        room = min(int(self.engine.cache_len) - 2 - int(self._pos[i])
                   for i in range(self.B) if self._active[i])
        while limit > 1 and limit > room:
            limit //= 2
        limit = max(1, limit)
        td0 = time.perf_counter()
        slab = self.engine.decode_window_run(self._tokens, self._pos, self._active,
                                             self.stop_tokens, self._temps, self._topps,
                                             limit=limit)
        if rec is not None:
            rec["decode_s"] = time.perf_counter() - td0
            rec["limit"] = int(limit)
            rec["n_active"] = int(self._active.sum())
            rec["emitted"] = int((slab >= 0).sum())
        for b in range(self.B):
            ln = self._lanes[b]
            if ln.req is None or not self._active[b]:
                continue
            col = slab[:, b]
            emitted = [int(t) for t in col[col >= 0]]
            emitted = emitted[:ln.req.max_new_tokens - ln.produced]  # host-side budget
            if emitted:
                # the window fed next_tok (KV written), then every emitted
                # token but the last (its KV write is not yet confirmed)
                ln.fed.extend([ln.next_tok] + emitted[:-1])
                ln.next_tok = emitted[-1]
            stopped = False
            for t in emitted:
                ln.req.stream.push(t)
                ln.produced += 1
                if t in self.stop_tokens:
                    stopped = True
                    break
            self._pos[b] += len(emitted)
            if emitted:
                self._tokens[b] = emitted[-1]
            if stopped:
                self._finish_lane(b, "stop")
            elif (ln.produced >= ln.req.max_new_tokens
                  or self._pos[b] + 2 >= self.engine.cache_len):
                self._finish_lane(b, "length")
        if rec is not None:
            rec["dt"] = time.perf_counter() - rec["t0"]
            self.timeline.append(rec)
