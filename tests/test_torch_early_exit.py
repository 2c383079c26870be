"""Early exit inside the port's decode window (llamatpu_torch/runtime/
decode_graph.py): each step runs under the state's `live` predicate, the
JAX `while_loop`'s `cond`, so a window ends where the JAX package's ends,
against the JAX package on the CPU (tiny f32 models, 2 layers, widths 128-
256; Pallas in interpret mode on the JAX side, as tests/conftest.py sets):

- Engine, q8_row and Q8_0: a stop at the first, a middle and the last step
  of a window, and no stop: the tokens, the steps run, the whole KV cache
  equal the JAX engine's, and the rows past the stop keep their bytes;
- BatchEngine and PagedBatchEngine: lanes stopping at different steps end
  the window at the last stop; a window with no lane active runs no step;
- speculative decode, K = 3 and 4: windows with a stop, the steps run, one
  read of the state a window, the cache and the id history equal JAX's;
- the capture, on tests/test_torch_decode_graph.py's stand-in card: the
  step sits under one IF node on `live`, and a window's launches are its
  steps run times the captured counts.

Each stop is the id that first occurs at step j of a stream run with no
stop, so the window with it ends at step j.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode_graph import (PROMPTS, _first_new, _Gen, _Graph,  # noqa: F401
                                     _models, fake_cuda)
from test_torch_spec_decode import RANDOM, _drive, _engines, f32  # noqa: F401

from llamatpu.runtime.batch_engine import BatchEngine as JBatchEngine
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu.runtime.paged_engine import PagedBatchEngine as JPagedBatchEngine
from llamatpu_torch.ops import attention
from llamatpu_torch.runtime import decode_graph
from llamatpu_torch.runtime.batch_engine import BatchEngine
from llamatpu_torch.runtime.decode_graph import SpecState
from llamatpu_torch.runtime.engine import Engine
from llamatpu_torch.runtime.paged_engine import PagedBatchEngine
from llamatpu_torch.utils.metrics import RunMetrics

W = 8  # the Engine windows' limit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one intra-op thread: the test workers and the JAX
    compiler share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv(cache) -> np.ndarray:
    return np.asarray(cache.kv_pool if hasattr(cache, "kv_pool") else cache.kv)


# ------------------------------------------------------------------ Engine
@pytest.mark.parametrize("rowq", [True, False])
@pytest.mark.parametrize("where", ["first", "mid", "last", "none"])
def test_engine_window_ends_at_the_stop_as_jax(rowq, where):
    """Engine (q8_row: K2 + K3; Q8_0: K5 + K6), f32 cache: a window of
    limit 8 after a 20-token prompt with the stop that first occurs at step
    j (0, 3 or 7 of the stream; or no stop) gives JAX's tokens exactly, runs
    j + 1 steps (`decode_steps`; JAX's count), leaves the whole cache within
    1e-5 of the JAX engine's (the same f32 forwards on both sides) and the
    rows from pos + j + 1 on byte-equal to theirs before the window."""
    tm, jm = _models()
    kw = dict(cache_len=128, prefill_chunk=32, decode_window=W, rowq=rowq)
    je = JEngine(jm, impl="pallas", cache_dtype=jnp.float32, aot_compile=False, **kw)
    te = Engine(tm, cache_dtype=torch.float32, device="cpu", **kw)
    prompt = PROMPTS[1] + [1]
    pos = len(prompt)

    def window(e, stops=frozenset()):
        e.reset()
        tok = int(e.prefill(prompt)[0][0])
        return e.decode_window_run(tok, pos, W, stops)

    stream = window(je)
    assert len(stream) == W and window(te) == stream
    if where == "none":
        j, stops = W - 1, frozenset()
    else:
        j = _first_new(stream, {"first": 0, "mid": 3, "last": W - 1}[where])
        stops = {stream[j]}
    assert j == {"first": 0, "mid": 3}.get(where, W - 1)
    want = window(je, stops)
    te.reset()
    tok = int(te.prefill(prompt)[0][0])
    before = te.cache.kv[:, :, :, pos + j + 1:].clone()
    steps = te.decode_steps
    got = te.decode_window_run(tok, pos, W, stops)
    assert got == want == stream[:j + 1]
    np.testing.assert_allclose(te.cache.kv.numpy(), _kv(je.cache), rtol=0, atol=1e-5)
    assert torch.equal(te.cache.kv[:, :, :, pos + j + 1:].view(torch.int32),
                       before.view(torch.int32))
    assert te.decode_steps - steps == j + 1 == len(want)


# ---------------------------------------------------------- batched engines
@pytest.mark.parametrize("paged", [False, True])
def test_batch_window_ends_when_every_lane_stopped(paged):
    """Three active lanes, f32, decode window 6 (dense: q8_row, K2 + K6 +
    K9; paged: Q8_0 through K8): stops that end the lanes at different
    steps, all before the window's end: the slab equals JAX's exactly, the
    steps run equal JAX's (its slab's rows with a token), and the cache or
    pool is within 1e-5 of JAX's, the trash block included (the same f32
    forwards on both sides). Dense: the last lane to stop never parked, so
    its slack row keeps its bytes. Then a window with no lane active runs
    no step and changes no byte of the cache or pool, as in JAX."""
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
    active = np.ones(3, bool)

    def start(e):
        e.reset()
        toks = np.array([e.prefill_lane(b, p) for b, p in enumerate(PROMPTS)], np.int32)
        return toks, np.array([len(p) for p in PROMPTS], np.int32)

    ref = np.asarray(je.decode_window_run(*start(je), active))
    assert (ref >= 0).all()
    stops = {int(ref[_first_new(ref[:, b].tolist(), j), b]) for b, j in enumerate((0, 1, 3))}
    ends = [next(i + 1 for i, t in enumerate(ref[:, b]) if t in stops) for b in range(3)]
    assert len(set(ends)) == 3 and max(ends) < 6
    want = np.asarray(je.decode_window_run(*start(je), active, stops))
    toks, pos = start(te)
    last = int(np.argmax(ends))
    if not paged:
        park = te.cache.kv.shape[3] - 1
        slack = te.cache.kv[:, last, :, park].clone()
    steps = te.decode_steps
    got = te.decode_window_run(toks, pos, active, stops)
    assert np.array_equal(got, want)
    assert te.decode_steps - steps == max(ends) == int((want >= 0).any(axis=1).sum())
    np.testing.assert_allclose(_kv(te.cache), _kv(je.cache), rtol=0, atol=1e-5)
    if not paged:
        assert torch.equal(te.cache.kv[:, last, :, park], slack)
    else:
        trash = te.alloc.trash_block
        np.testing.assert_allclose(te.cache.kv_pool[:, trash].numpy(),
                                   _kv(je.cache)[:, trash], rtol=0, atol=1e-5)
    # no lane active at the start: no step
    idle = np.zeros(3, bool)
    before = te.cache.kv_pool.clone() if paged else te.cache.kv.clone()
    jbefore = _kv(je.cache).copy()
    steps = te.decode_steps
    got = te.decode_window_run(toks, pos, idle, stops)
    jgot = np.asarray(je.decode_window_run(toks, pos, idle, stops))
    assert (got == -1).all() and (jgot == -1).all() and te.decode_steps == steps
    assert torch.equal(te.cache.kv_pool if paged else te.cache.kv, before)
    assert np.array_equal(_kv(je.cache), jbefore)


# ------------------------------------------------------------ speculative
@pytest.mark.parametrize("k", [3, 4])
def test_spec_window_ends_at_the_stop_as_jax(f32, k, monkeypatch):
    """Dense f32 weights, decode window 6, K drafts: a 40-token run with the
    stop that first occurs at step 8 or after of the no-stop stream: every
    window, the id history after it (exact) and the spec metrics equal
    JAX's; decode_steps == spec_forwards; one SpecState.host() call a
    window; after the window that stops, the whole cache is within 1e-5 of
    the JAX engine's (the same f32 forwards on both sides) and the history
    equals its `_ids`."""
    je, te = _engines(f32, k)
    first, wins, _, _ = _drive(je, RANDOM, 40)
    stream = [first] + sum(wins, [])
    j = _first_new(stream, 8)
    stops = {stream[j]}
    reads = []
    host = SpecState.host
    monkeypatch.setattr(SpecState, "host", lambda st: (reads.append(1), host(st))[1])
    out = []
    for e in (je, te):
        e.reset()
        e.metrics.extra.clear()
        out.append(_drive(e, RANDOM, 40, stops))
    (jf, jw, jids, jex), (tf, tw, tids, tex) = out
    assert (tf, tw) == (jf, jw) and tex == jex
    assert [tf] + sum(tw, []) == stream[:j + 1]
    assert all(np.array_equal(a, b) for a, b in zip(tids, jids)) and len(tids) == len(jids)
    np.testing.assert_allclose(te.cache.kv.numpy(), _kv(je.cache), rtol=0, atol=1e-5)
    assert np.array_equal(te._ids.numpy(), np.asarray(je._ids))
    assert len(reads) == len(tw) == te.spec_reads
    assert te.decode_steps == tex["spec_forwards"]


# ---------------------------------------------------------------- capture
def test_the_captured_step_sits_under_one_if_node_on_live(fake_cuda):
    """On the stand-in card a capture runs the guard on the side stream, then
    opens one IF node on the state's `live` (its predicate kernel captured
    on the side stream, the body on the body stream), runs the step under it
    with the body's memory pool, and closes it; the warm-up ran guard and
    step once. A window of n replays that ran s steps credits s x the
    captured launches and n predicate launches. Eagerly, the guard ends the
    window at the first false `live` (exact counts throughout)."""
    paged = attention.decode_attention_paged
    g = decode_graph.StepGraphs(torch.device("cuda"), RunMetrics())
    st = g.state = decode_graph.StepState(2, 6, torch.device("cpu"))
    guards, bodies = [], []
    guard = st.guard

    def counted_guard():
        guards.append(1)
        guard()
    st.guard = counted_guard

    def step():
        bodies.append(len(fake_cuda))
        paged.launches += 3

    paged.launches = 0
    cond = decode_graph.cond_guard.launches
    run = g.runner(("geom",), False, step, lambda: None, _Gen())
    assert [e[0] for e in fake_cuda] == ["capture", "begin", "pool", "unpool", "end",
                                         "captured"]
    begin = fake_cuda[1]
    assert begin[1] == g.stream.cuda_stream and begin[2] == g.body_stream.cuda_stream
    assert begin[1] != begin[2] and begin[3] == st.live.data_ptr()
    assert fake_cuda[2][1] == g.body_pool and run.pool == g.body_pool
    assert bodies == [0, 3] and len(guards) == 2  # the warm-up's, then the body's capture
    assert run.counts == {paged: 3} and paged.launches == 0
    assert decode_graph.cond_guard.launches == cond
    run(5)
    run.done(2)
    assert paged.launches == 6 and decode_graph.cond_guard.launches == cond + 5
    assert _Graph.made[0].replays == 5
    # the eager runner: the lanes stop after two steps
    g.device = torch.device("cpu")
    st.fill([1, 2], [0, 0], [True, True], [0, 0], [0, 0], decode_graph.stop_ids(()))
    del bodies[:], guards[:]

    def two_steps():
        bodies.append(1)
        if len(bodies) == 2:
            st.act.zero_()
    eager = g.runner(("geom",), False, two_steps, lambda: None)
    eager(6)
    eager.done(2)
    assert len(bodies) == 2 and len(guards) == 3 and int(st.steps) == 2
