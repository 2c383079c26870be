"""The device-side decode window of the port: one decode step written over
static state, run `limit` times per window.

The JAX package runs a window as one device program, a `lax.while_loop`
over the step (llamatpu/runtime/engine.py:252-273, batch_engine.py:106-138,
paged_engine.py:103-132), built ahead of time by `Engine._aot_compile`
(engine.py:294-318). Here a window is the same step body over tensors that
keep their addresses from window to window (`StepState`):
- on the CPU the engine runs the body eagerly `limit` times;
- on CUDA the body is captured once as a `torch.cuda.CUDAGraph` and the graph
  is replayed `limit` times, so the host enqueues one launch a step instead
  of every op of every layer.
The engine fills the state with `copy_` / `fill_` before the replays and
reads the window's output with one device-to-host copy after them. There is
no eager fallback on CUDA: a failed capture or replay raises.

A graph bakes in what its capture saw, so `StepGraphs` keys it by:
- the geometry: the cache tensors' addresses, shapes and dtypes and the
  engine's host constants the step reads (cache_len, the trash block); a
  new geometry, or a new state (`state_for`: B or W changed), drops every
  graph of the engine;
- the sampling mode (greedy skips the draw, as the JAX `_programs(greedy)`
  keeps two programs);
- the engine's `impl` ("auto" or the exact "int8" mode): a step captured
  in one mode never replays in the other;
- the call-time switches the forward reads (`switches`).

Capture: the step first runs once eagerly on the engine's own side stream,
from a parked state (every write lands in a row or block no query reads), so
the kernels are built and their setups, plans and workspaces exist (the stripe
kernels' arrival counters, `ops/attention._arrived`, are keyed by that
stream). Then the step is captured from the parked state again, on that
stream, with `capture_error_mode="thread_local"` (the scheduler decodes from
its own thread), the engine's generator registered with the graph so every
replay draws new numbers, into a memory pool the engine's graphs share and
free with it. The generator's state is put back after the warm-up and after
the capture: a window from the graph draws what an eager window from the
same state draws. The cyclic garbage collector (process-wide) is off while
a step is captured: an engine left in a reference cycle (a service, a
thread) is freed by the collector, and a graph destroyed during a capture
invalidates that capture.

Launch counts: the wrappers count on the host, which a replay does not run.
The counts a capture made are recorded and every counter is put back to its
value before the warm-up; each replay then adds the recorded counts, so a
window of n steps counts n times one step's launches, as an eager window
does.

Known difference: the JAX loop ends at a stop token (`cond`); a window here
runs all `limit` steps, stopped lanes parked, and returns the same tokens.

The speculative verify step (Engine with spec_decode=K) is keyed by K too
and runs over `SpecState`; the engine replays it in rounds and reads the
state between them (runtime/engine.py), its forwards after `done` parked.
"""
from __future__ import annotations

import contextlib
import gc
import os
import sys
import time
from dataclasses import dataclass

import torch


def launch_counters() -> list:
    """Every kernel wrapper of the loaded port modules: the functions that
    carry a `.launches` count."""
    seen = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("llamatpu_torch.") and mod is not None:
            for f in vars(mod).values():
                if callable(f) and isinstance(getattr(f, "launches", None), int):
                    seen[id(f)] = f
    return list(seen.values())


def switches() -> tuple:
    """The call-time switches a decode step reads, which a graph bakes in:
    every LLAMATPU_NO_* variable and `layer_fused._W2_KTILE`."""
    from llamatpu_torch.ops import layer_fused

    env = tuple(sorted((k, v) for k, v in os.environ.items() if k.startswith("LLAMATPU_NO_")))
    return env + (("_W2_KTILE", bool(layer_fused._W2_KTILE)),)


def tensors_key(*tensors) -> tuple:
    """Address, shape and dtype of each tensor (None skipped)."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors if t is not None)


class StepState:
    """The static tensors of a decode step, on the engine's device: the
    tokens [B] and positions [B] int32, the active lanes [B], per-lane
    temperature and top-p [B], the stop ids padded with -1 (STOPS), the step
    index, the [W, B] output slab (-1 = no token), and the tokens counted
    up to the first stop and whether one was hit (Engine's window). The
    paged engine adds its block tables."""

    STOPS = 8
    spec = 0  # the draft length of the verify step's state (SpecState)

    def __init__(self, batch: int, window: int, device: torch.device):
        i32 = torch.int32
        self.batch, self.window = batch, window
        self.tok = torch.zeros(batch, dtype=i32, device=device)
        self.pos = torch.zeros(batch, dtype=i32, device=device)
        self.act = torch.zeros(batch, dtype=torch.bool, device=device)
        self.temps = torch.zeros(batch, dtype=torch.float32, device=device)
        self.topps = torch.zeros(batch, dtype=torch.float32, device=device)
        self.stops = torch.full((self.STOPS,), -1, dtype=i32, device=device)
        self.step = torch.zeros(1, dtype=torch.long, device=device)
        self.out = torch.full((window, batch), -1, dtype=i32, device=device)
        self.count = torch.zeros(1, dtype=i32, device=device)
        self.done = torch.zeros(1, dtype=torch.bool, device=device)

    def fill(self, tokens, pos, active, temps, topps, stop_ids) -> None:
        """A window's inputs from the host (copies into the static tensors),
        and a fresh step index and slab."""
        self.tok.copy_(torch.as_tensor(tokens, dtype=torch.int32).reshape(self.batch))
        self.pos.copy_(torch.as_tensor(pos, dtype=torch.int32).reshape(self.batch))
        self.act.copy_(torch.as_tensor(active, dtype=torch.bool).reshape(self.batch))
        self.temps.copy_(torch.as_tensor(temps, dtype=torch.float32).reshape(self.batch))
        self.topps.copy_(torch.as_tensor(topps, dtype=torch.float32).reshape(self.batch))
        self.stops.copy_(stop_ids)
        self.step.zero_()
        self.out.fill_(-1)
        self.count.zero_()
        self.done.zero_()

    def record(self, ids: torch.Tensor) -> None:
        """out[step] = ids [B], then the step index advances (on the device)."""
        self.out.index_copy_(0, self.step, ids.view(1, self.batch))
        self.step += 1

    def rewind(self) -> None:
        """Before a capture's warm-up: out[0] for the step index."""
        self.step.zero_()


class SpecState:
    """The static tensors of a speculative verify step (one sequence, K
    drafts, the JAX `spec_decode_n_fn` loop's carry): the token and position
    [1] int32, temperature and top-p [1], the stop ids (StepState.STOPS),
    the window's budget `limit` and its emitted count `cnt`, the verify
    forwards run `nfwd`, `done` (a stop emitted, the cache's end or the
    budget reached: every later forward is parked), and the [W + K] output
    slab (-1 = no token), as the JAX `out`."""

    batch = 1

    def __init__(self, window: int, spec: int, device: torch.device):
        i32 = torch.int32
        self.window, self.spec = window, spec
        self.tok = torch.zeros(1, dtype=i32, device=device)
        self.pos = torch.zeros(1, dtype=i32, device=device)
        self.temps = torch.zeros(1, dtype=torch.float32, device=device)
        self.topps = torch.zeros(1, dtype=torch.float32, device=device)
        self.stops = torch.full((StepState.STOPS,), -1, dtype=i32, device=device)
        self.limit = torch.zeros(1, dtype=i32, device=device)
        self.cnt = torch.zeros(1, dtype=i32, device=device)
        self.nfwd = torch.zeros(1, dtype=i32, device=device)
        self.done = torch.zeros(1, dtype=torch.bool, device=device)
        self.out = torch.full((window + spec,), -1, dtype=i32, device=device)

    def fill(self, token: int, pos: int, temp: float, top_p: float, stop_ids,
             limit: int) -> None:
        """A window's inputs from the host, a zero count and a fresh slab."""
        self.tok.fill_(token)
        self.pos.fill_(pos)
        self.temps.fill_(temp)
        self.topps.fill_(top_p)
        self.stops.copy_(stop_ids)
        self.limit.fill_(limit)
        self.cnt.zero_()
        self.nfwd.zero_()
        self.done.zero_()
        self.out.fill_(-1)

    def rewind(self) -> None:
        """Before a capture's warm-up: a parked step, which writes no state."""
        self.cnt.zero_()
        self.done.fill_(True)

    def host(self) -> list[int]:
        """The slab, cnt, nfwd and done in one device-to-host copy."""
        return torch.cat([self.out, self.cnt, self.nfwd, self.done.to(torch.int32)]).tolist()


def zeroed_cache(cache, rows: int, dtype, new, graphs: "StepGraphs"):
    """A dense KV cache for reset(): `cache` zeroed in place while it has
    `rows` physical rows of `dtype` (the captured steps keep its
    addresses), else new() and no graph (a new geometry)."""
    if cache.kv.shape[3] == rows and cache.kv.dtype == dtype:
        cache.kv.zero_()
        if cache.scale is not None:
            cache.scale.zero_()
        return cache
    graphs.clear()
    return new()


def stop_ids(stop_tokens, pad_to: int = StepState.STOPS) -> torch.Tensor:
    """The fixed-size stop vector on the host, padded with -1 (the JAX
    package's `Engine._stops_array`): no emitted id is -1."""
    stops = sorted(stop_tokens)[:pad_to]
    return torch.tensor(stops + [-1] * (pad_to - len(stops)), dtype=torch.int32)


@dataclass
class Captured:
    """One captured step and the launches its capture counted."""
    graph: object
    counts: dict
    seconds: float

    def __call__(self, n: int) -> None:
        for _ in range(n):
            self.graph.replay()
        for f, c in self.counts.items():
            f.launches += c * n


class StepGraphs:
    """One engine's decode windows: eager steps on the CPU, replays of a
    captured step on CUDA (module docstring). Owned by the engine: its
    graphs and their memory pool are freed with it."""

    def __init__(self, device: torch.device, metrics=None):
        self.device = device
        self.metrics = metrics
        self.graphs: dict = {}
        self.geometry = None
        self.pool = None
        self.stream = None
        self.state: StepState | None = None
        self._eager = False

    def clear(self) -> None:
        self.graphs.clear()
        self.geometry = self.pool = None

    def state_for(self, batch: int, window: int, spec: int = 0):
        """The static state for B lanes and a window of W steps (with
        spec = K, the verify step's SpecState); a new one (and no graph)
        when B, W or K changed."""
        st = self.state
        if st is None or (st.batch, st.window, st.spec) != (batch, window, spec):
            self.clear()
            st = self.state = (SpecState(window, spec, self.device) if spec
                               else StepState(batch, window, self.device))
        return st

    @contextlib.contextmanager
    def _eager_windows(self):
        """Inside, windows run the step eagerly on the card too: the yardstick
        that chip_smoke.py holds the graphs against, and nothing else."""
        self._eager = True
        try:
            yield
        finally:
            self._eager = False

    def runner(self, geometry, sampled: bool, step, park, generator=None, impl: str = "auto"):
        """A callable running `step` n times: eagerly on the CPU; on CUDA the
        replays of the graph for (geometry, the state's draft length K,
        sampled, impl, switches), captured now if there is none (`park` puts the
        state where the warm-up step writes only rows or blocks no query
        reads). Fill the state after this call: the capture's warm-up step
        runs on it."""
        if self.device.type != "cuda" or self._eager:
            def eager(n: int) -> None:
                for _ in range(n):
                    step()
            return eager
        if geometry != self.geometry:
            self.clear()
            self.geometry = geometry
        key = (sampled, impl, switches()) if not self.state.spec else \
            (self.state.spec, sampled, impl, switches())
        captured = self.graphs.get(key)
        if captured is None:
            captured = self.graphs[key] = self.capture(step, park, generator)
        return captured

    def capture(self, step, park, generator=None) -> Captured:
        dev = self.device
        counters = launch_counters()
        before = [f.launches for f in counters]
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        gen_state = None if generator is None else generator.get_state()

        def parked():  # the state's rewind, the engine's park for the rest
            self.state.rewind()
            park()
        parked()
        side, main = self.stream, torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):  # warm-up: kernels, setups, workspaces
            step()
        main.wait_stream(side)
        warm = [f.launches for f in counters]
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            generator.set_state(gen_state)
            graph.register_generator_state(generator)
        parked()
        # no cyclic collection mid-capture: it may free another engine's
        # graph, and destroying a graph invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                step()
        finally:
            if collecting:
                gc.enable()
        if generator is not None:
            generator.set_state(gen_state)
        counts = {f: f.launches - w for f, w in zip(counters, warm) if f.launches != w}
        for f, b in zip(counters, before):
            f.launches = b
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.compile_s += seconds
        return Captured(graph, counts, seconds)
