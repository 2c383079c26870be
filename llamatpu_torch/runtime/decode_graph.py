"""The device-side decode window of the port: one decode step written over
static state, guarded by the window's condition and run up to `limit` times
per window.

The JAX package runs a window as one device program, a `lax.while_loop`
over the step (llamatpu/runtime/engine.py:252-273, batch_engine.py:106-138,
paged_engine.py:103-132), built ahead of time by `Engine._aot_compile`
(engine.py:294-318); its `cond` ends the window at a stop. Here a window is
the same step body over tensors that keep their addresses from window to
window (`StepState`, `SpecState`), and each step is guarded by the state's
`live` predicate, the JAX `cond`: `guard()` sets `live` from the state and
adds it to `steps`, the count of steps run, and the body runs only while
`live` holds:
- on the CPU the engine runs guard and body eagerly, reading `live` on the
  host before each body, and stops when it turns false;
- on CUDA guard and body are captured once as a `torch.cuda.CUDAGraph`: the
  guard, then a conditional IF node on `live` (csrc/graph_cond.cu) whose body
  graph is the step. The host enqueues `limit` replays; a replay after `live`
  turned false runs only the guard and the node. So the window ends where
  the JAX loop ends it, and no step after a stop writes the cache.
The engine fills the state with `copy_` / `fill_` before the replays and
reads the window's output and `steps` with one device-to-host copy after
them, then calls the runner's `done(steps)`. There is no eager fallback on
CUDA and no unguarded replay: a failed capture or replay raises.

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

Capture: the step first runs once eagerly on the stream its body is captured
on, from a parked state (every write lands in a row or block no query reads,
or is put back), so the kernels are built and their setups, plans and
workspaces exist (the stripe kernels' arrival counters, `ops/attention.
_arrived`, are keyed by that stream). Then the guard is captured on the
engine's side stream and the body, from the parked state again, on the body
stream into the IF node's body graph, with `capture_error_mode=
"thread_local"` (the scheduler decodes from its own thread) and the engine's
generator registered with the graph so every replay draws new numbers. The
guard's temporaries go to a memory pool the engine's graphs share, the
body's to a second pool (`torch.cuda.MemPool`) that every graph captured
into it keeps alive. The whole body is under the node. The generator's
state is put back after the warm-up and after the capture. Every replay
advances the generator by the capture's whole increment, guarded off or
not; `done(steps)` sets it to its value before the window plus `steps`
increments, so a window from the graph draws what an eager window from the
same state draws, and so does the next window. The cyclic garbage collector
(process-wide) is off while a step is captured: an engine left in a
reference cycle (a service, a thread) is freed by the collector, and a
graph destroyed during a capture invalidates that capture.

Launch counts: the wrappers count on the host, which a replay does not run.
The counts a capture made are recorded and every counter is put back to its
value before the warm-up; `done(steps)` then adds `steps` times the recorded
counts, so a window counts what an eager window of the same steps counts.
`cond_guard`, the node's predicate kernel, counts every replay it runs in.

The speculative verify step (Engine with spec_decode=K) is keyed by K too
and runs over `SpecState`: its `live` is `~done`, and `done` folds in the
budget and the cache's end, so `limit` guarded replays always suffice (a
live forward emits at least one token) and a window takes one host read.
"""
from __future__ import annotations

import contextlib
import gc
import os
import sys
import time
from dataclasses import dataclass, field

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
    tokens [B] and positions [B] int32, the active lanes [B] (Engine's one
    lane turns inactive at a stop), per-lane temperature and top-p [B], the
    stop ids padded with -1 (STOPS), the step index, the [W, B] output slab
    (-1 = no token), the window's predicate `live` (0-d bool: any lane
    active, the JAX batch loop's `cond`) and the steps run [1] int32. The
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
        self.live = torch.zeros((), dtype=torch.bool, device=device)
        self.steps = torch.zeros(1, dtype=i32, device=device)

    def fill(self, tokens, pos, active, temps, topps, stop_ids) -> None:
        """A window's inputs from the host (copies into the static tensors),
        and a fresh step index, slab and step count."""
        self.tok.copy_(torch.as_tensor(tokens, dtype=torch.int32).reshape(self.batch))
        self.pos.copy_(torch.as_tensor(pos, dtype=torch.int32).reshape(self.batch))
        self.act.copy_(torch.as_tensor(active, dtype=torch.bool).reshape(self.batch))
        self.temps.copy_(torch.as_tensor(temps, dtype=torch.float32).reshape(self.batch))
        self.topps.copy_(torch.as_tensor(topps, dtype=torch.float32).reshape(self.batch))
        self.stops.copy_(stop_ids)
        self.step.zero_()
        self.out.fill_(-1)
        self.steps.zero_()

    def guard(self) -> None:
        """live = any lane active; steps += live (on the device)."""
        torch.any(self.act, out=self.live)
        self.steps += self.live

    def record(self, ids: torch.Tensor) -> None:
        """out[step] = ids [B], then the step index advances (on the device)."""
        self.out.index_copy_(0, self.step, ids.view(1, self.batch))
        self.step += 1

    def rewind(self) -> None:
        """Before a capture's warm-up: out[0] for the step index."""
        self.step.zero_()

    def host(self) -> tuple[torch.Tensor, int]:
        """The slab [W, B] and the steps run, in one device-to-host copy."""
        flat = torch.cat([self.out.view(-1), self.steps]).cpu()
        return flat[:-1].view(self.window, self.batch), int(flat[-1])


class SpecState:
    """The static tensors of a speculative verify step (one sequence, K
    drafts, the JAX `spec_decode_n_fn` loop's carry): the token and position
    [1] int32, temperature and top-p [1], the stop ids (StepState.STOPS),
    the window's budget `limit` and its emitted count `cnt`, the verify
    forwards run `steps` (the JAX `nfwd`), `done` (a stop emitted, the
    cache's end or the budget reached), the predicate `live` (0-d bool,
    ~done: the JAX loop's `cond`, whose `cnt < limit` `done` folds in), and
    the [W + K] output slab (-1 = no token), as the JAX `out`."""

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
        self.steps = torch.zeros(1, dtype=i32, device=device)
        self.done = torch.zeros(1, dtype=torch.bool, device=device)
        self.live = torch.zeros((), dtype=torch.bool, device=device)
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
        self.steps.zero_()
        self.done.zero_()
        self.out.fill_(-1)

    def guard(self) -> None:
        """live = not done; steps += live (on the device)."""
        torch.logical_not(self.done.view(()), out=self.live)
        self.steps += self.live

    def rewind(self) -> None:
        """Before a capture's warm-up: nothing to rewind (the step clamps
        every slot and row it writes)."""

    def host(self) -> list[int]:
        """The slab, cnt, steps and done in one device-to-host copy."""
        return torch.cat([self.out, self.cnt, self.steps, self.done.to(torch.int32)]).tolist()


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


def cond_guard(capture_stream, body_stream, pred: torch.Tensor) -> None:
    """While `capture_stream` is captured: capture the IF node on `pred` (a
    0-d CUDA bool) there and start capturing `body_stream` into its body
    (csrc/graph_cond.cu); `cond_end` ends the body. Counts one launch of its
    predicate kernel a call; a captured step's replays add theirs."""
    from llamatpu_torch import _build

    lib = _build.load("graph_cond")
    _build.check(lib, lib.lt_cond_begin(capture_stream.cuda_stream, body_stream.cuda_stream,
                                        pred.data_ptr()), "cond_guard")
    cond_guard.launches += 1


cond_guard.launches = 0


def cond_end(body_stream) -> None:
    from llamatpu_torch import _build

    lib = _build.load("graph_cond")
    _build.check(lib, lib.lt_cond_end(body_stream.cuda_stream), "cond_end")


class Eager:
    """A window's steps run eagerly: before each body the guard, and a host
    read of `live`, which ends the window once it is false."""

    def __init__(self, state, step):
        self.state, self.step = state, step

    def __call__(self, n: int) -> None:
        for _ in range(n):
            self.state.guard()
            if not bool(self.state.live):
                break
            self.step()

    def done(self, steps: int) -> None:
        """The wrappers counted their launches as they ran."""


@dataclass
class Captured:
    """One captured guarded step, the launches its body's capture counted,
    the engine's generator (None: not registered) and the body's memory
    pool, which lives as long as the graph."""
    graph: object
    counts: dict
    seconds: float
    generator: object = None
    pool: object = None
    _start: tuple = field(default=(0, None), init=False, repr=False)  # (n, offset)

    def __call__(self, n: int) -> None:
        """Enqueue n guarded replays."""
        self._start = (n, None if self.generator is None else self.generator.get_offset())
        for _ in range(n):
            self.graph.replay()
        cond_guard.launches += n

    def done(self, steps: int) -> None:
        """After the window's read: credit `steps` steps' launches, and set
        the generator to where `steps` eager steps would have left it (each
        replay advanced it by one step's increment)."""
        for f, c in self.counts.items():
            f.launches += c * steps
        n, start = self._start
        if start is not None and n:
            step_inc = (self.generator.get_offset() - start) // n
            self.generator.set_offset(start + steps * step_inc)


class StepGraphs:
    """One engine's decode windows: guarded eager steps on the CPU, guarded
    replays of a captured step on CUDA (module docstring). Owned by the
    engine: its graphs and their memory pools are freed with it."""

    def __init__(self, device: torch.device, metrics=None):
        self.device = device
        self.metrics = metrics
        self.graphs: dict = {}
        self.geometry = None
        self.pool = self.body_pool = None
        self.stream = self.body_stream = None
        self.state: StepState | None = None
        self._eager = False

    def clear(self) -> None:
        self.graphs.clear()
        self.geometry = self.pool = self.body_pool = None

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
        """The window's runner: `run(n)` runs up to n guarded steps, and
        `run.done(steps)` follows the window's read. Eager on the CPU; on CUDA
        the replays of the graph for (geometry, the state's draft length K,
        sampled, impl, switches), captured now if there is none (`park` puts
        the state where the warm-up step writes only rows or blocks no query
        reads, and may return a callable that puts back what it did write).
        Fill the state after this call: the capture's warm-up step runs on
        it."""
        if self.device.type != "cuda" or self._eager:
            return Eager(self.state, step)
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
        dev, st = self.device, self.state
        counters = launch_counters()
        before = [f.launches for f in counters]
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
            self.body_stream = torch.cuda.Stream(dev)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.body_pool = torch.cuda.MemPool()
        t0 = time.perf_counter()
        gen_state = None if generator is None else generator.get_state()

        def parked():  # the state's rewind, the engine's park for the rest
            st.rewind()
            return park()
        side, body, main = self.stream, self.body_stream, torch.cuda.current_stream(dev)
        undo = parked()
        body.wait_stream(main)
        with torch.cuda.stream(body):  # warm-up: kernels, setups, workspaces
            st.guard()
            step()
        main.wait_stream(body)
        if callable(undo):
            undo()
        warm = [f.launches for f in counters]
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            generator.set_state(gen_state)
            graph.register_generator_state(generator)
        parked()
        side.wait_stream(main)
        # no cyclic collection mid-capture: it may free another engine's
        # graph, and destroying a graph invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                st.guard()
                cond_guard(side, body, st.live)
                try:
                    with torch.cuda.stream(body), torch.cuda.use_mem_pool(self.body_pool):
                        step()
                finally:
                    cond_end(body)
        finally:
            if collecting:
                gc.enable()
        if generator is not None:
            generator.set_state(gen_state)
        counts = {f: f.launches - w for f, w in zip(counters, warm)
                  if f.launches != w and f is not cond_guard}
        for f, b in zip(counters, before):
            f.launches = b
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.compile_s += seconds
        return Captured(graph, counts, seconds, generator, self.body_pool)
