"""The port's decode window (llamatpu_torch/runtime/decode_graph.py): one
step over static state, run eagerly here and replayed as a CUDA graph on the
card.

- the step body, run eagerly, gives the JAX package's `decode_window_run`
  tokens for Engine (q8_row and Q8_0), BatchEngine and PagedBatchEngine,
  with a parked lane and a stop token, on tiny f32 models;
- one step reads no host value and builds no tensor from host data (dense,
  paged, int8 KV, a 2-lane MoE step, greedy and sampled);
- reset() zeroes the cache in place, and windows after it equal a fresh
  engine's;
- the capture's launch bookkeeping, with the CUDA graph and the IF node
  replaced by CPU stand-ins.
"""
import contextlib
import gc
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.runtime.batch_engine import BatchEngine as JBatchEngine
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu.runtime.paged_engine import PagedBatchEngine as JPagedBatchEngine
from llamatpu_torch import _build
from llamatpu_torch.models.synthetic import build_synthetic_model as t_build
from llamatpu_torch.models.transformer import physical_cache_len
from llamatpu_torch.ops import attention, layer_fused, moe_grouped, sampling
from llamatpu_torch.runtime import decode_graph
from llamatpu_torch.runtime.batch_engine import BatchEngine
from llamatpu_torch.runtime.engine import Engine
from llamatpu_torch.runtime.paged_engine import PagedBatchEngine
from llamatpu_torch.utils.metrics import RunMetrics

TINY = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab_size=300)
MOE = dict(dim=128, hidden_dim=512, moe_hidden_dim=128, n_experts=8, n_experts_used=2,
           n_heads=2, n_kv_heads=2, head_dim=64, vocab_size=300)
# Qwen3-0.6B shrunk: q/k norm, q width 512 != dim 256, head 128
QWEN3 = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=128, vocab_size=300)
PROMPTS = [[(7 * i + 3) % 300 for i in range(n)] for n in (5, 19, 11)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one intra-op thread: the test workers and the JAX
    compiler share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(preset="llama32-1b", overrides=TINY, seed=5):
    kw = dict(n_layers=2, dtype="f32", seed=seed, context_length=128, overrides=overrides)
    return t_build(preset, **kw), j_build(preset, **kw)


def _first_new(col, start: int) -> int:
    """Index (>= start) of the first id in col that does not occur before it."""
    return next(i for i in range(start, len(col)) if col[i] not in col[:i])


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("rowq", [True, False])
def test_engine_windows_match_jax(rowq):
    """Engine (q8_row: K2 + K3; Q8_0: K5 + K6), f32: a 20-token prompt, then
    two greedy windows of 5 (the static state refilled between them) equal
    the JAX Engine's decode_window_run; after a reset, a window with a stop
    token ends at it in both."""
    tm, jm = _models()
    kw = dict(cache_len=128, prefill_chunk=32, decode_window=8, rowq=rowq)
    je = JEngine(jm, impl="pallas", cache_dtype=jnp.float32, aot_compile=False, **kw)
    te = Engine(tm, cache_dtype=torch.float32, device="cpu", **kw)
    prompt = PROMPTS[1] + [1]

    def windows(stops=frozenset()):
        out = []
        for e in (je, te):
            e.reset()
            tok, pos = int(e.prefill(prompt)[0][0]), len(prompt)
            got = [tok]
            for _ in range(2):
                w = e.decode_window_run(tok, pos, 5, stops)
                got += w
                if not w or w[-1] in stops:
                    break
                tok, pos = w[-1], pos + len(w)
            out.append(got)
        return out

    ref, got = windows()
    assert got == ref and len(got) == 11
    k = _first_new(ref, 3)  # a stop token inside the first window
    assert k <= 5
    ref_s, got_s = windows({ref[k]})
    assert got_s == ref_s == ref[:k + 1]


@pytest.mark.parametrize("paged", [False, True])
def test_batch_windows_match_jax(paged):
    """Three lanes, f32, decode window 6: lanes 0 and 2 prefilled and
    active, lane 1 parked (inactive, its own prompt in the cache); the [W, B]
    slab equals the JAX engine's (impl="pallas"), without stops and with a
    stop token that lane 2 hits inside the window. Dense: q8_row (K2 + K6 +
    K9); paged: Q8_0 through K8."""
    tm, jm = _models()
    common = dict(batch_size=3, prefill_chunk=16, decode_window=6, rowq=not paged)
    if paged:
        je = JPagedBatchEngine(jm, block_size=8, max_len=128, impl="pallas",
                               cache_dtype=jnp.float32, **common)
        te = PagedBatchEngine(tm, block_size=8, max_len=128, cache_dtype=torch.float32,
                              device="cpu", **common)
    else:
        je = JBatchEngine(jm, cache_len=128, impl="pallas", cache_dtype=jnp.float32, **common)
        te = BatchEngine(tm, cache_len=128, cache_dtype=torch.float32, device="cpu", **common)
    active = np.array([True, False, True])

    def window(e, stops=frozenset()):
        e.reset()
        toks = np.array([e.prefill_lane(b, p) for b, p in enumerate(PROMPTS)], np.int32)
        pos = np.array([len(p) for p in PROMPTS], np.int32)
        return np.asarray(e.decode_window_run(toks, pos, active, stops))

    ref = window(je)
    got = window(te)
    assert got.shape == (6, 3) and np.array_equal(got, ref)
    assert (got[:, 1] == -1).all() and (got[:, [0, 2]] >= 0).all()
    k = _first_new(ref[:, 2].tolist(), 2)
    assert k < 5
    stop = {int(ref[k, 2])}
    ref_s, got_s = window(je, stop), window(te, stop)
    assert np.array_equal(got_s, ref_s)
    assert (got_s[k + 1:, 2] == -1).all() and np.array_equal(got_s[:k + 1, 2], ref[:k + 1, 2])


# ----------------------------------------------------- no host data in a step
BANNED = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.lift_fresh.default)


def _in_plain_version() -> bool:
    """Whether the caller runs inside a kernel's plain version (a function of
    llamatpu_torch.ops named *_plain): on the card that call is the kernel's
    launch, and the plain version's host reads are not in the step."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.endswith("_plain") and \
                f.f_globals.get("__name__", "").startswith("llamatpu_torch.ops"):
            return True
        f = f.f_back
    return False


class NoHostData(TorchDispatchMode):
    """Raises on a read of a tensor's value into the host (`.item()`,
    `int(t)`, `bool(t)`: aten._local_scalar_dense) and on a tensor built from
    host data (`torch.tensor(...)`: aten.lift_fresh), outside the kernels'
    plain versions. Either would be baked into a captured graph or fail the
    capture."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in BANNED and not _in_plain_version():
            raise AssertionError(f"host data in a decode step: {func}")
        return func(*args, **(kwargs or {}))


def test_the_mode_catches_host_reads_and_host_built_tensors():
    """The mode sees `.item()`, `int(t)`, `bool(t)` and `torch.tensor(...)`,
    the parent's MoE routing tail among them
    (`torch.cat([starts[1:], torch.tensor([nk])])`), and lets the device
    forms pass."""
    a = torch.arange(6)
    for bad in (lambda: a[1].item(), lambda: int(a[2]), lambda: bool((a > 3).any()),
                lambda: torch.tensor([3]), lambda: torch.cat([a[1:], torch.tensor([6])]) - a):
        with NoHostData(), pytest.raises(AssertionError, match="host data"):
            bad()
    with NoHostData():
        torch.cat([a[1:], a.new_full((1,), 6)])
        torch.where(a > 2, a, -1)
        sampling.is_stop(a, torch.full((8,), -1))


@pytest.mark.parametrize("n,tm", [(2, 8), (5, 8), (33, 32)])
def test_moe_routing_builds_no_host_tensor_and_matches_jax(n, tm):
    """sort_by_expert for N > 1 under the mode, bit-equal to the JAX
    package's routing tables."""
    from llamatpu.ops import moe_grouped as jmg

    top = np.stack([np.random.default_rng(n + i).choice(8, 2, replace=False)
                    for i in range(n)]).astype(np.int32)
    top_t = torch.from_numpy(top)
    with NoHostData():
        got = moe_grouped.sort_by_expert(top_t, 8, tm)
    want = jmg.sort_by_expert(jnp.asarray(top), 8, tm)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _step_case(kind):
    """(engine, lanes) for one decode-step case, its static state filled by
    a first window."""
    if kind == "moe":
        tm, _ = _models("qwen15-moe-a2.7b", MOE, seed=3)
    elif kind == "qwen3":
        tm, _ = _models("qwen3-0.6b", QWEN3)
    else:
        tm, _ = _models()
    lanes = 1 if kind in ("engine", "qwen3") else 2
    kw = dict(prefill_chunk=16, decode_window=4, device="cpu")
    if kind in ("engine", "qwen3"):
        e = Engine(tm, cache_len=64, rowq=True, cache_dtype=torch.float32, **kw)
        tok = int(e.prefill(PROMPTS[0])[0][0])
        e.decode_window_run(tok, 5, 2)
        return e
    cdt = torch.int8 if kind == "int8" else torch.float32
    if kind == "paged":
        e = PagedBatchEngine(tm, batch_size=lanes, block_size=8, max_len=64, cache_dtype=cdt,
                             **kw)
    else:
        e = BatchEngine(tm, batch_size=lanes, cache_len=64, cache_dtype=cdt,
                        rowq=kind == "dense", **kw)
    toks = [e.prefill_lane(b, p) for b, p in enumerate(PROMPTS[:lanes])]
    pos = [len(p) for p in PROMPTS[:lanes]]
    e.decode_window_run(np.array(toks), np.array(pos), np.ones(lanes, bool), limit=2)
    return e


@pytest.mark.parametrize("kind", ["engine", "dense", "paged", "int8", "moe", "qwen3"])
def test_one_step_makes_no_host_read(kind):
    """One greedy and one sampled step run to their end under NoHostData:
    Engine (q8_row, K2 + K3), a 2-lane dense BatchEngine (q8_row), a 2-lane
    paged engine (K8), a 2-lane int8-KV BatchEngine (K6-int8), a 2-lane
    MoE BatchEngine (the N > 1 routing, K10) and a Qwen3 Engine (K2, the q/k
    norm, K3). The step advances the state on the device."""
    e = _step_case(kind)
    st = e._graphs.state
    st.temps.fill_(0.7)
    st.topps.fill_(0.9)
    before = st.step.clone()
    with NoHostData():
        e._step(False)
        e._step(True)
    assert int(st.step) == int(before) + 2
    assert ((st.out[:int(st.step)] >= -1) & (st.out[:int(st.step)] < 300)).all()


# ------------------------------------------------------------ reset in place
def test_reset_keeps_the_cache_in_place_and_windows_equal_a_fresh_engine():
    """reset() zeroes the cache where it lies (Engine, BatchEngine and the
    paged pool keep their data_ptr), and two windows after it equal a fresh
    engine's; a changed cache geometry gets a new cache."""
    tm, _ = _models()
    kw = dict(prefill_chunk=16, decode_window=4, cache_dtype=torch.float32, device="cpu")

    def engine_windows(e):
        tok = int(e.prefill(PROMPTS[1])[0][0])
        a = e.decode_window_run(tok, 19, 4)
        return a + e.decode_window_run(a[-1], 23, 4)

    e = Engine(tm, cache_len=64, rowq=True, **kw)
    first = engine_windows(e)
    ptr = e.cache.kv.data_ptr()
    e.reset()
    assert e.cache.kv.data_ptr() == ptr and not e.cache.kv.any()
    assert engine_windows(e) == first == engine_windows(Engine(tm, cache_len=64, rowq=True, **kw))
    e.cache_len = 96  # configure-style change of geometry: a new cache
    e.reset()
    assert e.cache.kv.shape[3] == physical_cache_len(96, 16) == 128 and not e.cache.kv.any()

    def batch_windows(b):
        toks = np.array([b.prefill_lane(i, p) for i, p in enumerate(PROMPTS[:2])])
        pos = np.array([len(p) for p in PROMPTS[:2]])
        s1 = b.decode_window_run(toks, pos, np.ones(2, bool))
        s2 = b.decode_window_run(s1[-1], pos + 4, np.ones(2, bool))
        return np.concatenate([s1, s2])

    for make in (lambda: BatchEngine(tm, batch_size=2, cache_len=64, **kw),
                 lambda: PagedBatchEngine(tm, batch_size=2, block_size=8, max_len=64, **kw)):
        b = make()
        first = batch_windows(b)
        t = b.cache.kv if isinstance(b, BatchEngine) else b.cache.kv_pool
        ptr = t.data_ptr()
        b.reset()
        assert t.data_ptr() == ptr and not t.any()
        assert np.array_equal(batch_windows(b), first)
        assert np.array_equal(batch_windows(make()), first)


# ------------------------------------------------------ launch bookkeeping
class _Stream:
    def __init__(self, handle=0):
        self.cuda_stream = handle

    def wait_stream(self, other):
        pass


class _Graph:
    """A CPU stand-in for torch.cuda.CUDAGraph: capture runs the guard's and
    the step's host code once (as a real capture does), a replay runs none
    and advances each registered generator by `increment`."""
    made = []
    increment = 0

    def __init__(self):
        self.replays = 0
        self.generators = []
        _Graph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1
        for gen in self.generators:
            if isinstance(gen, _Gen):
                gen.set_offset(gen.get_offset() + self.increment)


class _Gen(torch.Generator):
    """A CPU generator with the CUDA generator's Philox offset."""
    offset = 0

    def get_offset(self):
        return self.offset

    def set_offset(self, offset):
        self.offset = offset


class _CondLib:
    """The stand-in of csrc/graph_cond.cu: records the IF node's predicate,
    the streams and the order of the calls (`events`)."""

    def __init__(self, events):
        self.events = events

    def lt_cond_begin(self, capture_stream, body_stream, pred):
        self.events.append(("begin", capture_stream, body_stream, pred))
        return 0

    def lt_cond_end(self, body_stream):
        self.events.append(("end", body_stream))
        return 0


@contextlib.contextmanager
def _capture(graph, pool=None, stream=None, capture_error_mode=None):
    assert capture_error_mode == "thread_local" and stream is not None and pool is not None
    assert not gc.isenabled()  # no collection may free a graph mid-capture
    _capture.events.append(("capture", stream.cuda_stream))
    yield
    _capture.events.append(("captured",))


@pytest.fixture
def fake_cuda(monkeypatch):
    _Graph.made = []
    _Graph.increment = 0
    events = _capture.events = []
    streams = iter(range(1, 100))

    @contextlib.contextmanager
    def mem_pool(pool, device=None):
        events.append(("pool", pool))
        yield
        events.append(("unpool", pool))

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream(next(streams)))
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "MemPool", lambda: "body-pool")
    monkeypatch.setattr(torch.cuda, "use_mem_pool", mem_pool)
    monkeypatch.setattr(_build, "load", lambda name: _CondLib(events))
    monkeypatch.delenv("LLAMATPU_NO_ATTN_TAIL", raising=False)
    paged, tail = attention.decode_attention_paged, layer_fused.layer_tail_fused_rowq
    saved = paged.launches, tail.launches, decode_graph.cond_guard.launches
    yield events
    paged.launches, tail.launches, decode_graph.cond_guard.launches = saved


def test_replays_add_the_captured_launch_counts(fake_cuda, monkeypatch):
    """The step stand-in counts 2 K8 and 3 K9 launches and draws from the
    generator. A capture (from step index 0, whatever the last window left)
    (warm-up + capture) leaves every counter as it found it and the
    generator's state too; after n replays and the window's read of s steps
    run, the counters hold s (not n) times the captured counts, and the
    predicate kernel's count n, and the generator is where s eager steps
    leave it (each replay advanced it by one step's increment); the same
    key replays the same graph, a switch or a new geometry captures anew;
    compile_s records the captures."""
    paged, tail = attention.decode_attention_paged, layer_fused.layer_tail_fused_rowq
    assert paged in decode_graph.launch_counters() and tail in decode_graph.launch_counters()
    gen = _Gen().manual_seed(3)
    gen.offset = 100
    _Graph.increment = 8
    parks = []

    def step():  # the warm-up and the capture run from step index 0
        assert g.state.step.item() == 0
        paged.launches += 2
        tail.launches += 3
        torch.rand(4, generator=gen)

    m = RunMetrics()
    g = decode_graph.StepGraphs(torch.device("cuda"), m)
    g.state = decode_graph.StepState(1, 4, torch.device("cpu"))
    g.state.step.fill_(4)  # where a full window left it
    paged.launches, tail.launches = 5, 7
    cond = decode_graph.cond_guard.launches
    state = gen.get_state()
    run = g.runner(("geom", 1), False, step, lambda: parks.append(1), gen)
    assert (paged.launches, tail.launches) == (5, 7) and parks == [1, 1] and gc.isenabled()
    assert decode_graph.cond_guard.launches == cond
    assert torch.equal(gen.get_state(), state)
    assert run.counts == {paged: 2, tail: 3} and m.compile_s > 0
    assert _Graph.made[0].generators == [gen]
    run(4)
    assert (paged.launches, tail.launches) == (5, 7) and _Graph.made[0].replays == 4
    assert decode_graph.cond_guard.launches == cond + 4 and gen.get_offset() == 132
    run.done(3)  # the window stopped after 3 steps
    assert (paged.launches, tail.launches) == (11, 16) and gen.get_offset() == 124
    assert g.runner(("geom", 1), False, step, lambda: parks.append(1), gen) is run
    assert len(_Graph.made) == 1 and parks == [1, 1]
    sampled = g.runner(("geom", 1), True, step, lambda: None, gen)
    monkeypatch.setenv("LLAMATPU_NO_ATTN_TAIL", "1")
    switched = g.runner(("geom", 1), False, step, lambda: None, gen)
    assert len({id(run), id(sampled), id(switched)}) == 3 and len(g.graphs) == 3
    g.runner(("geom", 2), False, step, lambda: None, gen)
    assert len(g.graphs) == 1 and len(_Graph.made) == 4
    assert (paged.launches, tail.launches) == (11, 16)


def test_engine_captures_at_construction_and_counts_replays(fake_cuda):
    """On a (stand-in) card the capture that Engine(aot_compile=True) makes
    at construction (`_window` of the default mode) records compile_s, its
    warm-up writes only the park row, and reset() zeroes it; a window of
    limit n enqueues n guarded replays of the graph, and the other sampling
    mode captures its own graph, with the generator registered."""
    tm, _ = _models()
    e = Engine(tm, cache_len=64, prefill_chunk=16, decode_window=4, rowq=True,
               cache_dtype=torch.float32, device="cpu", aot_compile=False)
    e.generator = _Gen().manual_seed(42)
    assert e.metrics.compile_s == 0.0 and not e._graphs.graphs
    e._graphs.state_for(1, 4)  # the static state on the CPU, then the graph path
    e._graphs.device = torch.device("cuda")
    e._window(False)
    assert len(_Graph.made) == 1 and e.metrics.compile_s > 0
    assert e.metrics.to_dict()["compile_s"] == round(e.metrics.compile_s, 4)
    park = e.cache.kv.shape[3] - 1  # the warm-up wrote the park row only
    assert e.cache.kv[:, :, :, park].any() and not e.cache.kv[:, :, :, :park].any()
    e.reset()
    assert not e.cache.kv.any()
    e.decode_window_run(3, 5, 4)
    assert _Graph.made[0].replays == 4
    e.decode_window_run(3, 5, 2, temperature=0.8, top_p=0.9)
    assert len(_Graph.made) == 2 and _Graph.made[1].generators == [e.generator]
    assert _Graph.made[1].replays == 2 and _Graph.made[0].generators == [e.generator]


def test_stop_ids_and_is_stop():
    """The stop vector is padded with -1 to 8 ids (sorted, the first 8 kept,
    as the JAX package's `_stops_array`); is_stop equals torch.isin."""
    s = decode_graph.stop_ids({9, 2, 5})
    assert s.tolist() == [2, 5, 9, -1, -1, -1, -1, -1] and s.dtype == torch.int32
    assert decode_graph.stop_ids(set(range(20, 0, -1))).tolist() == list(range(1, 9))
    ids = torch.tensor([[1, 5, -7], [9, 0, 2]], dtype=torch.int32)
    assert torch.equal(sampling.is_stop(ids, s), torch.isin(ids, s[:3]))
    assert not sampling.is_stop(ids, decode_graph.stop_ids(())).any()
