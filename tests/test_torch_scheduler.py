"""The port's continuous batcher on the CPU (runtime/scheduler.py over
BatchEngine and PagedBatchEngine): staggered submissions with interleaved
chunked prefill, prefix-cache reuse, pool backpressure, cancel and stop
tokens, each stream held to a single Engine's greedy ids, and every
scheduler fault recorded in `errors`."""
import threading

import pytest
import torch

from llamatpu_torch.models.synthetic import build_synthetic_model
from llamatpu_torch.runtime.batch_engine import BatchEngine
from llamatpu_torch.runtime.engine import Engine
from llamatpu_torch.runtime.paged_engine import PagedBatchEngine
from llamatpu_torch.runtime.scheduler import BatchRequest, ContinuousBatcher

TINY = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab_size=300)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one intra-op thread: the test workers and the JAX
    compiler share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sched_model():
    return build_synthetic_model("llama32-1b", n_layers=2, dtype="f32", seed=13,
                                 context_length=128, overrides=TINY)


def _single(model, prompt, n, stop=frozenset()):
    e = Engine(model, cache_len=128, prefill_chunk=8, decode_window=4,
               cache_dtype=torch.float32, device="cpu")
    return e.generate(prompt, n, stop_tokens=stop).tokens


def _run(batcher, reqs):
    results = [None] * len(reqs)

    def go(i):
        results[i] = list(batcher.submit(reqs[i]).__iter__())

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    return results


@pytest.mark.parametrize("paged", [False, True])
def test_staggered_submissions_match_single_engine(sched_model, paged):
    """Four requests on 2 lanes, a multi-chunk prompt admitted into a reused
    lane while the other lane decodes (interleaved prefill): each stream is
    the single Engine's greedy ids; no scheduler error."""
    m = sched_model
    kw = dict(batch_size=2, prefill_chunk=8, decode_window=4, cache_dtype=torch.float32,
              device="cpu")
    e = (PagedBatchEngine(m, block_size=4, max_len=128, n_blocks=48, **kw) if paged
         else BatchEngine(m, cache_len=128, **kw))
    b = ContinuousBatcher(e, stop_tokens=set(), interleave_decode_steps=2)
    prompts = [[5, 9, 23], [41, 8], list(range(2, 42, 2)), [14, 3, 7]]
    ns = [4, 24, 6, 5]
    try:
        out = _run(b, [BatchRequest(p, n) for p, n in zip(prompts, ns)])
    finally:
        b.shutdown()
    assert out == [_single(m, p, n) for p, n in zip(prompts, ns)]
    assert b.errors == []


def test_prefix_cache_warm_equals_cold_and_backpressure(sched_model):
    """Paged engine: a warm request (its prompt's full blocks cached by an
    earlier one) gives the cold ids with cached_tokens > 0; a pool that fits
    one prompt span at a time still completes both requests."""
    m = sched_model
    kw = dict(batch_size=2, block_size=4, max_len=128, prefill_chunk=8, decode_window=4,
              cache_dtype=torch.float32, device="cpu")
    pfx = list(range(3, 35, 2))
    e = PagedBatchEngine(m, n_blocks=40, **kw)
    b = ContinuousBatcher(e, stop_tokens=set(), interleave_decode_steps=2)
    try:
        list(b.submit(BatchRequest(pfx + [90], 2)))
        s = b.submit(BatchRequest(pfx + [50, 51], 6))
        warm = list(s)
    finally:
        b.shutdown()
    assert s.cached_tokens == 16 and warm == _single(m, pfx + [50, 51], 6) and b.errors == []
    p1, p2 = list(range(2, 42, 2)), list(range(3, 43, 2))
    e = PagedBatchEngine(m, n_blocks=9, prefix_cache=False, **kw)
    b = ContinuousBatcher(e, stop_tokens=set(), interleave_decode_steps=2)
    try:
        s1, s2 = b.submit(BatchRequest(p1, 4)), b.submit(BatchRequest(p2, 4))
        out1, out2 = list(s1), list(s2)
    finally:
        b.shutdown()
    assert out1 == _single(m, p1, 4) and out2 == _single(m, p2, 4)
    assert s1.finish_reason == s2.finish_reason == "length" and b.errors == []


def test_cancel_frees_the_lane_and_stop_tokens_finish(sched_model):
    """A consumer-side cancel frees the lane for the next request; a stop
    token finishes its stream with "stop"; budgets are exact under windows
    larger than max_new; a fault in the engine is recorded in errors and
    finishes the streams."""
    m = sched_model
    e = BatchEngine(m, batch_size=1, cache_len=128, prefill_chunk=8, decode_window=8,
                    cache_dtype=torch.float32, device="cpu")
    chain = _single(m, [5, 9], 8)
    b = ContinuousBatcher(e, stop_tokens={chain[3]})
    try:
        s = b.submit(BatchRequest([5, 9], 64))
        assert list(s) == chain[:4] and s.finish_reason == "stop"
        s = b.submit(BatchRequest([41, 8], 64))
        next(iter(s))
        s.cancel()
        s2 = b.submit(BatchRequest([14, 3, 7], 3))
        assert list(s2) == _single(m, [14, 3, 7], 3) and s2.finish_reason == "length"
        assert b.errors == []
        e.decode_window_run = None  # the next decode window raises
        s3 = b.submit(BatchRequest([14, 3, 7], 3))
        assert len(list(s3)) == 1 and s3.finish_reason == "length"
    finally:
        b.shutdown()
    assert len(b.errors) == 1 and isinstance(b.errors[0], TypeError)
