"""Paged batched engine (the port of llamatpu/runtime/paged_engine.py):
BatchEngine's surface over a shared KV block pool.

Same lane semantics as BatchEngine (per-lane positions, sampling and stop),
but the KV lives in a PagedKVCache: the host BlockAllocator grows each
lane's block table on demand (prefill chunks, decode windows) and recycles
blocks when a lane finishes, so memory is bounded by the tokens in flight,
not lanes x max context. The block tables go to the device once per decode
window (a copy into the step's static [B, MAXBLK] tables, after the host
allocator has grown them) and once per prefill chunk. Decode attention is K8
(ops/attention.py) through the tables; an inactive lane's table row is the
trash block, so its stale-position writes can land in no other request's
blocks (`paged_engine.py:117-118`). A window is one step over static state
(runtime/decode_graph.py), replayed as a captured CUDA graph on the card,
and ends once every lane has stopped, as BatchEngine's does. The block
pre-allocation still covers `limit` steps.

With prefix_cache=True (the default) admission maps cached full blocks of
the prompt into the lane's table and prefills only the novel suffix; release
registers the lane's verified full blocks (prompt + confirmed generated
tokens) for reuse (runtime/paged_cache.py). Exact for any sampling mode:
cached blocks hold the values a fresh prefill would write.
"""
from __future__ import annotations

import numpy as np
import torch

from llamatpu_torch.models.loader import LoadedModel
from llamatpu_torch.models.transformer import forward_tokens
from llamatpu_torch.models.weights import serving_weights
from llamatpu_torch.ops import sampling
from llamatpu_torch.runtime.batch_engine import generate_batch, prefill_chunks, window_inputs
from llamatpu_torch.runtime.decode_graph import StepGraphs, stop_ids, tensors_key
from llamatpu_torch.ops.matmul import check_impl
from llamatpu_torch.runtime.engine import resolve_device
from llamatpu_torch.runtime.paged_cache import BlockAllocator, block_hashes, init_paged_cache
from llamatpu_torch.utils.metrics import RunMetrics, Timer


class PagedBatchEngine:
    def __init__(
        self,
        model: LoadedModel,
        batch_size: int = 8,
        n_blocks: int | None = None,
        block_size: int = 16,
        max_len: int | None = None,
        prefill_chunk: int = 128,
        cache_dtype: torch.dtype = torch.bfloat16,
        seed: int = 42,
        decode_window: int = 16,
        metrics: RunMetrics | None = None,
        prefix_cache: bool = True,
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
        self.block_size = block_size
        self.max_len = max_len or self.cfg.context_length
        self.max_blocks_per_lane = -(-self.max_len // block_size)
        # default pool: half of the dense allocation (the paged win) + trash block
        self.n_blocks = n_blocks or max(self.max_blocks_per_lane + 1,
                                        batch_size * self.max_blocks_per_lane // 2)
        self.cache_len = self.max_blocks_per_lane * block_size  # lane view length
        self.prefill_chunk = min(prefill_chunk, self.max_len)
        self.cache_dtype = cache_dtype
        self.decode_window = max(1, int(decode_window))
        self.metrics = metrics or RunMetrics()
        self.prefix_cache = prefix_cache
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.alloc = BlockAllocator(self.n_blocks, batch_size, self.max_blocks_per_lane)
        with Timer() as t:
            self.weights = serving_weights(self.cfg, model.weights, rowq=rowq,
                                           rowq_experts=rowq_experts, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.metrics.weight_upload_s = t.elapsed
        self.decode_steps = 0    # device decode steps run (all lanes at once)
        self.prefill_chunks = 0  # lane prefill chunks run
        self.cache = init_paged_cache(self.cfg, self.n_blocks, block_size, cache_dtype,
                                      self.device)
        self._graphs = StepGraphs(self.device, self.metrics)
        self._tables_d = torch.empty(self.alloc.tables.shape, dtype=torch.int32,
                                     device=self.device)  # the step's static tables

    # -- scheduler hooks ---------------------------------------------------
    def can_admit(self, prompt_len: int) -> bool:
        need = -(-(prompt_len + self.decode_window + 1) // self.block_size)
        return self.alloc.can_allocate(need)

    def reserve_lane(self, lane: int, prompt_len: int) -> bool:
        """Reserve the lane's FULL prompt span (+ one decode window of
        headroom) at admission, so chunked prefill allocates nothing
        mid-flight and another lane's growth can never starve it. False
        (partial allocation kept: the caller releases the lane) when the pool
        cannot cover it. Call after acquire_prefix_for."""
        return self.alloc.ensure(lane, prompt_len + self.decode_window + 1, self.block_size)

    def acquire_prefix_for(self, lane: int, tokens: list[int]) -> int:
        """Map cached full blocks of the prompt into the lane's table; returns
        the number of prompt tokens thereby served from the prefix cache (the
        caller prefills only tokens[reuse:])."""
        if not self.prefix_cache:
            return 0
        # the final prompt token must run through prefill (its logits give
        # the first sampled token), so reuse stops at len - 1
        max_blocks = (len(tokens) - 1) // self.block_size
        return self.alloc.acquire_prefix(lane, block_hashes(tokens, self.block_size),
                                         max_blocks) * self.block_size

    def admit_lane(self, lane: int, tokens: list[int], temperature: float = 0.0,
                   top_p: float = 0.0) -> tuple[int, int]:
        """Map cached blocks, prefill the novel suffix. Returns (first sampled
        token, prompt tokens reused)."""
        reuse = self.acquire_prefix_for(lane, tokens)
        return self.prefill_lane(lane, tokens[reuse:], reuse, temperature, top_p), reuse

    def release_lane(self, lane: int, fed_tokens: list[int] | None = None) -> None:
        """Recycle the lane's blocks. fed_tokens: the lane's verified token
        history (every token whose KV provably landed in the pool); with the
        prefix cache on, its full blocks are registered for reuse."""
        hashes = None
        if self.prefix_cache and fed_tokens:
            hashes = block_hashes(fed_tokens, self.block_size)
        self.alloc.release(lane, hashes)

    # -- engine surface (mirrors BatchEngine) ------------------------------
    def _tables(self, rows=slice(None)) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(self.alloc.tables[rows])).to(self.device)

    def prefill_lane(self, lane: int, tokens: list[int], start_pos: int = 0,
                     temperature: float = 0.0, top_p: float = 0.0) -> int:
        # exactly the prompt's span: chunk-pad rows either share a partly
        # filled real block (masked, then overwritten by decode before any
        # read) or hit an unallocated table entry, i.e. the trash block
        if not self.alloc.ensure(lane, start_pos + len(tokens), self.block_size):
            raise RuntimeError("paged KV pool exhausted")

        def forward(arr, pos, logit_index):
            self.prefill_chunks += 1
            logits, self.cache = forward_tokens(self.cfg, self.weights, arr, self.cache, pos,
                                                logit_index=logit_index,
                                                tables=self._tables(slice(lane, lane + 1)),
                                                impl=self.impl)
            return logits

        return prefill_chunks(self, tokens, start_pos, temperature, top_p, forward)

    def decode_window_run(self, tokens: np.ndarray, pos: np.ndarray, active: np.ndarray,
                          stop_tokens=frozenset(), temps=None, topps=None,
                          limit: int | None = None) -> np.ndarray:
        """One batched decode window (BatchEngine.decode_window_run's slab)."""
        b_size = self.batch_size
        limit = self.decode_window if limit is None else min(limit, self.decode_window)
        # pre-allocate the blocks every active lane could need this window
        for b in range(b_size):
            if active[b] and not self.alloc.ensure(b, int(pos[b]) + limit + 2, self.block_size):
                limit = min(limit, self.alloc.lane_len_capacity(b, self.block_size)
                            - int(pos[b]) - 2)
        if limit <= 0:
            return np.full((self.decode_window, b_size), -1, np.int32)
        temps, topps, sampled = window_inputs(self, temps, topps)
        st = self._graphs.state_for(b_size, self.decode_window)
        geometry = (tensors_key(self.cache.kv_pool, self.cache.scale), self.alloc.trash_block)
        run = self._graphs.runner(geometry, sampled, lambda: self._step(sampled), st.act.zero_,
                                  self.generator, self.impl)
        st.fill(tokens, pos, active, temps, topps, stop_ids(stop_tokens))
        self._tables_d.copy_(torch.from_numpy(self.alloc.tables))  # the tables, once a window
        run(limit)
        slab, steps = st.host()  # the window's one device-to-host copy
        run.done(steps)
        self.decode_steps += steps
        return slab.numpy()

    def _step(self, sampled: bool) -> None:
        """One decode step of every lane over the static state (BatchEngine's
        step): an inactive lane's table row is the trash block."""
        st = self._graphs.state
        tables = torch.where(st.act[:, None], self._tables_d, self.alloc.trash_block)
        logits, _ = forward_tokens(self.cfg, self.weights, st.tok[:, None], self.cache, st.pos,
                                   last_logit_only=True, tables=tables, impl=self.impl)
        nxt = sampling.sample_lanes(logits, st.temps, st.topps, self.generator, sampled)
        nxt = torch.where(st.act, nxt, st.tok)
        st.record(torch.where(st.act, nxt, -1))
        st.pos.copy_(torch.where(st.act, st.pos + 1, st.pos))
        st.act &= ~sampling.is_stop(nxt, st.stops)
        st.tok.copy_(nxt)

    def generate_batch(self, prompts, max_new_tokens, stop_tokens=frozenset(), temps=None,
                       topps=None):
        return generate_batch(self, prompts, max_new_tokens, stop_tokens, temps, topps)

    def reset(self) -> None:
        """A fresh allocator (lane tables and the prefix cache dropped) and the
        pool zeroed in place (the captured steps keep their addresses)."""
        self.alloc = BlockAllocator(self.n_blocks, self.batch_size, self.max_blocks_per_lane)
        self.cache.kv_pool.zero_()
        if self.cache.scale is not None:
            self.cache.scale.zero_()
