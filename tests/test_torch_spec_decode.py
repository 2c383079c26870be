"""The port's prompt-lookup speculative decode (llamatpu_torch/runtime/
engine.py `Engine(spec_decode=K)`, ops/sampling.py `spec_verify_sample`)
against the JAX package's `Engine(spec_decode=K)` on tiny models:

- each decode window equals the JAX `spec_decode_n_fn` window in tokens,
  `spec_emitted` and `spec_forwards`, and the token-id history equals JAX
  `_ids` after the prefill and after every window: f32 dense weights at K =
  3 and 4, q8_row (K2, K9 and K1 at K + 1 rows, Pallas in interpret mode on
  the JAX side), random and repetitive prompts, a stop token, a tight
  budget, a multi-turn continuation and a window at the physical end of a
  cache whose slack is under K + 1 (the writes' and reads' clamps);
- greedy spec equals the port's plain greedy, and sampled spec at
  temperature 1e-6 equals greedy spec;
- `spec_verify_sample` on given uniforms equals the numpy formulas over the
  JAX `filtered_scaled_logits`, its first token's marginal is the filtered
  softmax, and it never emits a token outside the nucleus;
- the verify step reads no host value; a parked forward changes no state;
  any round plan gives the same window; reset() zeroes the history where it
  lies; the capture keys and parks the verify step;
- `run --spec-decode` and a batch-1 `serve --spec-decode` give the text of
  their plain counterparts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode_graph import NoHostData, _Graph, fake_cuda  # noqa: F401
from tiny_models import build_tiny_gguf

from llamatpu.gguf import GGMLType
from llamatpu.models import loader as jloader
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.ops import sampling as jsampling
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu_torch import cli
from llamatpu_torch.models import loader as tloader
from llamatpu_torch.models.synthetic import build_synthetic_model as t_build
from llamatpu_torch.models.transformer import physical_cache_len
from llamatpu_torch.ops import layer_fused, quant_matmul, sampling
from llamatpu_torch.runtime.decode_graph import switches
from llamatpu_torch.runtime.engine import Engine

RANDOM = [5, 9, 23, 41, 8, 2]
REPETITIVE = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]
SPEC_KEYS = ("spec_emitted", "spec_forwards", "spec_accept_rate")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one intra-op thread: the test workers and the JAX
    compiler share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    """The tiny F32 Llama GGUF (context 64) as dense f32 weights, port and
    JAX (the JAX spec tests' model)."""
    path = tmp_path_factory.mktemp("spec") / "m.gguf"
    build_tiny_gguf(path, family="llama", quant=GGMLType.F32, seed=23)
    return (tloader.load_model(str(path), param_dtype=torch.float32, load_tokenizer=False),
            jloader.load_model(str(path), mode="dequant", param_dtype=jnp.float32,
                               load_tokenizer=False))


@pytest.fixture(scope="module")
def rowq():
    """Synthetic Q8_0 weights at widths the JAX q8_row kernels tile (dim
    256), a 32-id vocab: its greedy stream repeats, so drafts are accepted."""
    kw = dict(n_layers=2, dtype="f32", seed=1, context_length=128,
              overrides=dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64,
                             vocab_size=32))
    return t_build("llama32-1b", **kw), j_build("llama32-1b", **kw)


def _engines(models, k, rowq=False, **kw):
    tm, jm = models
    kw = dict(dict(decode_window=6), **kw)
    if rowq:
        je = JEngine(jm, impl="pallas", rowq=True, cache_dtype=jnp.float32, aot_compile=False,
                     spec_decode=k, **kw)
    else:
        je = JEngine(jm, cache_dtype=jnp.float32, aot_compile=False, spec_decode=k, **kw)
    return je, Engine(tm, rowq=rowq, cache_dtype=torch.float32, device="cpu", spec_decode=k,
                      **kw)


def _drive(e, prompt, n, stops=frozenset(), start_pos=0, temperature=None):
    """generate()'s loop, window by window: (first token, the windows, the
    id history after the prefill and after each window, the spec metrics)."""
    tok = int(e.prefill(prompt, start_pos, temperature)[0][0])
    ids = [np.array(e._ids)]
    first, wins, pos, left = tok, [], start_pos + len(prompt), n - 1
    while left > 0 and tok not in stops and pos + 1 < e.cache_len:
        w = e.decode_window_run(tok, pos, left, stops, temperature)
        if not w:
            break
        wins.append(w)
        ids.append(np.array(e._ids))
        if w[-1] in stops:
            break
        tok, pos, left = w[-1], pos + len(w), left - len(w)
    return first, wins, ids, {k: e.metrics.extra.get(k) for k in SPEC_KEYS}


def _same(je, te, *args, **kw):
    """Both engines from a reset, one generation each: equal first tokens,
    windows, histories and metrics; returns the port's run."""
    je.reset()
    te.reset()
    je.metrics.extra.clear()
    te.metrics.extra.clear()
    want, got = _drive(je, *args, **kw), _drive(te, *args, **kw)
    assert got[:2] == want[:2]
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        assert np.array_equal(g, w)
    assert got[3] == want[3]
    return got


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("k,prompt,n", [(3, RANDOM, 40), (4, RANDOM, 56), (4, REPETITIVE, 24)])
def test_f32_windows_equal_jax(f32, k, prompt, n):
    """Dense f32 weights, decode window 6: every window, the history and
    the metrics equal JAX's; the K = 4 random prompt's stream accepts
    drafts (the model repeats tokens), up to K at a forward."""
    je, te = _engines(f32, k)
    first, wins, _, ex = _same(je, te, prompt, n)
    assert 1 + sum(map(len, wins)) == n
    assert ex["spec_forwards"] >= len(wins)
    if (k, n) == (4, 56):
        assert ex["spec_accept_rate"] > 0.1


def test_rowq_windows_equal_jax(rowq):
    """q8_row (K2, K9 and the K1 head at K + 1 = 5 rows; the JAX package's
    Pallas kernels in interpret mode), decode window 8: the windows, the
    history and the metrics of 60 tokens equal JAX's, with drafts accepted."""
    je, te = _engines(rowq, 4, rowq=True, cache_len=128, prefill_chunk=32, decode_window=8)
    prompt = [(7 * i + 3) % 32 for i in range(19)]
    first, wins, _, ex = _same(je, te, prompt, 60)
    assert ex["spec_accept_rate"] > 0.1 and len(wins) == 8


def test_stop_budget_and_multiturn_equal_jax(f32):
    """A stop token inside a run of accepted drafts ends the window there
    in both; a budget of 3 emits exactly 3; a continuation that re-feeds
    the last token at its position (a chat session's next turn) equals JAX's
    on the cache and history the first turn left."""
    je, te = _engines(f32, 4)
    first, wins, _, _ = _same(je, te, RANDOM, 56)
    stream = [first] + sum(wins, [])
    stop = {stream[20]}  # inside the accepted run of 21s
    got = _same(je, te, RANDOM, 56, stops=stop)
    out = [got[0]] + sum(got[1], [])
    assert out[-1] in stop and out == stream[:stream.index(stream[20]) + 1]
    got = _same(je, te, RANDOM, 3)
    assert 1 + sum(map(len, got[1])) == 3
    # two turns on one cache: the second starts where the first's last token goes
    je.reset()
    te.reset()
    for e in (je, te):
        e.metrics.extra.clear()
    t1 = [_drive(e, [11, 12, 13, 14], 6) for e in (je, te)]
    assert t1[0][:2] == t1[1][:2]
    last = t1[1][1][-1][-1]
    start = 4 + 1 + sum(map(len, t1[1][1])) - 1
    t2 = [_drive(e, [last, 20, 21], 12, start_pos=start) for e in (je, te)]
    assert t2[1][:2] == t2[0][:2] and t2[1][3] == t2[0][3]
    for g, w in zip(t2[1][2], t2[0][2]):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("k", [4, 8])
def test_window_at_the_physical_end_clamps_as_jax(f32, k):
    """Cache 62 with prefill chunk 2: 64 physical rows, a slack of 2 under
    K + 1, so the forward at position 60 writes its K + 1 cache rows, and
    the history its window, from row 63 - K (XLA's clamp), and at K = 8 a
    draft read from a late bigram clamps its start to row 56: the run to
    the cache's end equals JAX's."""
    assert physical_cache_len(62, 2) == 64
    je, te = _engines(f32, k, cache_len=62, prefill_chunk=2)
    at, step = [], te._spec_step

    def spy(sampled):  # the positions of the live forwards
        if not te._graphs.state.done.item():
            at.append(te._graphs.state.pos.item())
        step(sampled)

    te._spec_step = spy
    first, wins, ids, ex = _same(je, te, RANDOM * 3, 64)
    assert 18 + 1 + sum(map(len, wins)) == 62  # the last token at position 61
    assert max(at) == 60 and ex["spec_forwards"] == len(at)


# ------------------------------------------------------------ within the port
@pytest.mark.parametrize("kind", ["f32", "rowq"])
def test_greedy_spec_equals_plain_greedy(f32, rowq, kind):
    """Speculation changes only how many forwards produce the greedy stream:
    spec at K = 2 and 4 equals the plain Engine's tokens (and stop reason)."""
    if kind == "f32":
        tm, kw, prompts = f32[0], dict(decode_window=6), (RANDOM, REPETITIVE)
    else:
        tm, kw = rowq[0], dict(rowq=True, cache_len=128, prefill_chunk=32, decode_window=8)
        prompts = ([(7 * i + 3) % 32 for i in range(19)], [1, 2, 3] * 5)
    plain = Engine(tm, cache_dtype=torch.float32, device="cpu", **kw)
    for k in (2, 4):
        spec = Engine(tm, cache_dtype=torch.float32, device="cpu", spec_decode=k, **kw)
        for p in prompts:
            plain.reset()
            want = plain.generate(p, 40)
            got = spec.generate(p, 40)
            spec.reset()
            assert (got.tokens, got.stop_reason) == (want.tokens, want.stop_reason)


def test_sampled_at_a_tiny_temperature_equals_greedy_spec(f32):
    """Rejection sampling at temperature 1e-6 (top-p 1): the nucleus is the
    argmax, a draft is accepted iff it is the argmax and the residual draw
    is the argmax, so the stream is greedy spec's, window for window."""
    spec = Engine(f32[0], cache_dtype=torch.float32, device="cpu", decode_window=6,
                  spec_decode=4)
    greedy = spec.generate(RANDOM, 40).tokens
    spec.reset()
    assert spec.generate(RANDOM, 40, temperature=1e-6, top_p=1.0).tokens == greedy
    assert spec.metrics.extra["spec_accept_rate"] > 0.1


def test_sampled_spec_runs_with_telemetry(f32):
    """Sampled windows (0.8 / 0.9) run to the budget; the metrics count the
    forwards, and one seed gives one stream."""
    runs = []
    for _ in range(2):
        e = Engine(f32[0], cache_dtype=torch.float32, device="cpu", decode_window=4,
                   spec_decode=4, seed=7)
        runs.append(e.generate(REPETITIVE[:8], 20, temperature=0.8, top_p=0.9).tokens)
        ex = e.metrics.extra
        assert len(runs[-1]) == 20 and 1 <= ex["spec_forwards"] <= ex["spec_emitted"] == 19
    assert runs[0] == runs[1]


# ------------------------------------------------------ spec_verify_sample
def _np_verify(logits, drafts, temp, topp, u_acc, u_res):
    """The JAX function's formulas in numpy, over JAX filtered_scaled_logits:
    (m, the residual row, cand)."""
    k = len(drafts)
    fl = np.asarray(jsampling.filtered_scaled_logits(jnp.asarray(logits), jnp.float32(temp),
                                                     jnp.float32(topp)))
    p = np.exp(fl - fl.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    acc = (u_acc < p[np.arange(k), drafts]).astype(np.int64)
    m = int(np.cumprod(acc).sum())
    row = fl[m].copy()
    if m < k:
        row[drafts[min(m, k - 1)]] = -np.inf
    if not np.isfinite(row).any():
        row = fl[m].copy()
    gumbel = -np.log(-np.log(np.maximum(u_res, np.finfo(np.float32).tiny)))
    cand = np.append(drafts, 0)
    cand[m] = int(np.argmax(row + gumbel))
    return m, row, cand


@pytest.mark.parametrize("case", ["reject_first", "reject_mid", "accept_all", "degenerate",
                                  "outside_nucleus"])
def test_spec_verify_sample_equals_the_formulas(case):
    """On given uniforms: the first-rejection count m (cumprod), the
    residual row (the rejected draft masked; the bonus row unmasked; the
    degenerate guard's unmasked fallback) and cand equal the numpy formulas
    over JAX filtered_scaled_logits."""
    rng = np.random.default_rng(len(case))
    k, v = 3, 16
    logits = rng.normal(0, 2.0, (k + 1, v)).astype(np.float32)
    drafts = logits[:k].argmax(-1).astype(np.int64)
    u_acc = np.full(k, 0.5, np.float32)
    temp, topp = 0.8, 0.9
    if case == "reject_first":
        u_acc[0] = 0.999
    elif case == "reject_mid":
        u_acc[:] = [0.0, 0.0, 0.999]
    elif case == "accept_all":
        u_acc[:] = 0.0
    elif case == "degenerate":  # nucleus {d_0}, rejected only by round-off
        logits[0] = -30.0
        logits[0, drafts[0]] = 30.0
        u_acc[0] = 1.0
    else:  # a draft outside the nucleus: p = 0, never accepted
        drafts[0] = int(logits[0].argmin())
        u_acc[:] = 0.0
    u_res = rng.random(v).astype(np.float32)
    m, row, cand = _np_verify(logits, drafts, temp, topp, u_acc, u_res)
    want_m = {"reject_first": 0, "reject_mid": 2, "accept_all": 3, "degenerate": 0,
              "outside_nucleus": 0}[case]
    assert m == want_m
    fl = sampling.filtered_scaled_logits(torch.from_numpy(logits), temp, topp)
    np.testing.assert_allclose(fl.numpy(), np.asarray(jsampling.filtered_scaled_logits(
        jnp.asarray(logits), jnp.float32(temp), jnp.float32(topp))), rtol=1e-6)
    d = torch.from_numpy(drafts).to(torch.int32)
    got_row = sampling.spec_residual_row(fl, d, torch.tensor(m))
    np.testing.assert_allclose(got_row.numpy(), row, rtol=1e-6)
    masked = m < k and case != "degenerate" and np.isfinite(fl[m, drafts[m]].item())
    assert np.isfinite(row).sum() == np.isfinite(fl[m].numpy()).sum() - masked
    for t, p in ((temp, topp), (torch.tensor([temp]), torch.tensor([topp]))):
        got, got_m = sampling.spec_verify_sample(torch.from_numpy(logits), d, t, p,
                                                 draws=(torch.from_numpy(u_acc),
                                                        torch.from_numpy(u_res)))
        assert int(got_m) == m and got.dtype == torch.int32
        assert got.tolist() == cand.tolist()


def test_spec_verify_sample_marginal_and_nucleus():
    """The first emitted token (drafts[0] if accepted, else the residual
    draw) is distributed as the filtered softmax of row 0 (the JAX test's
    6 sigma band over 20000 draws from one generator), and no emitted token
    (cand[:m + 1]) ever lies outside its row's nucleus."""
    v, k, n = 16, 3, 20000
    logits = np.random.default_rng(3).normal(0, 2.0, (k + 1, v)).astype(np.float32)
    drafts = torch.tensor([4, 11, 2], dtype=torch.int32)
    temp, topp = 0.8, 0.9
    lt = torch.from_numpy(logits)
    fl = sampling.filtered_scaled_logits(lt, temp, topp)
    gen = torch.Generator().manual_seed(0)
    firsts = np.zeros(v, np.int64)
    for _ in range(n):
        cand, m = sampling.spec_verify_sample(lt, drafts, temp, topp, gen)
        firsts[int(cand[0])] += 1
        emitted = cand[:int(m) + 1].long()
        assert torch.isfinite(fl[torch.arange(len(emitted)), emitted]).all()
    target = np.asarray(jax.nn.softmax(jsampling.filtered_scaled_logits(
        jnp.asarray(logits[0]), jnp.float32(temp), jnp.float32(topp))))
    np.testing.assert_allclose(firsts / n, target, atol=0.022)  # sd <= 0.0035; 6 sigma
    assert firsts[target == 0.0].sum() == 0


# ------------------------------------------------------- the verify step
def _spec_engine(f32, k=4, **kw):
    e = Engine(f32[0], cache_dtype=torch.float32, device="cpu", decode_window=6, spec_decode=k,
               **kw)
    tok = int(e.prefill(REPETITIVE)[0][0])
    e.decode_window_run(tok, len(REPETITIVE), 4)
    return e


def test_the_verify_step_makes_no_host_read(f32, rowq):
    """A greedy and a sampled verify forward run under NoHostData (f32 and
    q8_row: K2, K9 and K1 at K + 1 rows) and advance the state on the
    device."""
    tm = rowq[0]
    q = Engine(tm, rowq=True, cache_len=128, prefill_chunk=32, decode_window=8,
               cache_dtype=torch.float32, device="cpu", spec_decode=4)
    q.decode_window_run(int(q.prefill(list(range(19)))[0][0]), 19, 2)
    for e in (_spec_engine(f32), q):
        st = e._graphs.state
        n = st.nfwd.item() + 2
        st.done.zero_()
        st.limit.fill_(st.cnt.item() + 10)
        st.temps.fill_(0.7)
        st.topps.fill_(0.9)
        with NoHostData():
            e._spec_step(False)
            e._spec_step(True)
        assert st.nfwd.item() == n and not st.done.item()


def test_parked_forwards_change_no_state(f32):
    """After a window's `done`, further forwards (greedy and sampled) leave
    the ids, tok, pos, cnt, nfwd, done and the slab as they were."""
    e = _spec_engine(f32)
    st = e._graphs.state
    assert st.done.item()
    names = ("tok", "pos", "cnt", "nfwd", "done", "out")
    before = [getattr(st, n).clone() for n in names] + [e._ids.clone()]
    e._spec_step(False)
    e._spec_step(True)
    after = [getattr(st, n) for n in names] + [e._ids]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


@pytest.mark.parametrize("plan", ["one", "all"])
def test_any_round_plan_gives_the_same_window(f32, plan, monkeypatch):
    """One forward a round, or the whole budget in one round (the rest
    parked): the same windows, history and metrics as the engine's own
    plan; the rounds and parked forwards are counted."""
    def run():
        e = Engine(f32[0], cache_dtype=torch.float32, device="cpu", decode_window=6,
                   spec_decode=4)
        return _drive(e, RANDOM, 56), e

    ref, e0 = run()
    monkeypatch.setattr(Engine, "_spec_round",
                        (lambda self, r, *a: 1) if plan == "one" else (lambda self, r, *a: r))
    got, e = run()
    assert got[:2] == ref[:2] and got[3] == ref[3]
    assert all(np.array_equal(a, b) for a, b in zip(got[2], ref[2]))
    fwd = ref[3]["spec_forwards"]
    if plan == "one":
        assert e.spec_rounds == fwd and e.spec_parked == 0
    else:
        assert e.spec_rounds == len(ref[1]) and e.spec_parked == e.decode_steps - fwd > 0
    assert e0.decode_steps == fwd + e0.spec_parked and e0.spec_rounds >= len(ref[1])


def test_round_plan_follows_the_acceptance(f32):
    """The plan replays ceil(left / (1 + a)) forwards, a the engine's mean
    accepted drafts a forward (K before any), never more than is left."""
    e = Engine(f32[0], cache_dtype=torch.float32, device="cpu", spec_decode=4)
    assert e._spec_round(32, 0, 0) == 7
    assert e._spec_round(32, 20, 20) == 32
    assert e._spec_round(32, 40, 20) == 16
    assert e._spec_round(3, 100, 10) == 1


def test_reset_zeroes_the_history_in_place_and_reseed_keeps_it(f32):
    """reset() zeroes the ids where they lie (a captured step keeps their
    address) and a run after it equals a fresh engine's; reseed() keeps
    them, as it keeps the cache; a new geometry gets new ids."""
    e = _spec_engine(f32)
    ptr, ids = e._ids.data_ptr(), e._ids.clone()
    assert ids.any()
    e.reseed(3)
    assert torch.equal(e._ids, ids)
    e.reset()
    assert e._ids.data_ptr() == ptr and not e._ids.any()
    assert e._ids.shape == (1, physical_cache_len(e.cache_len, e.prefill_chunk))
    fresh = Engine(f32[0], cache_dtype=torch.float32, device="cpu", decode_window=6,
                   spec_decode=4)
    assert e.generate(RANDOM, 20).tokens == fresh.generate(RANDOM, 20).tokens
    assert torch.equal(e._ids, fresh._ids)
    e.cache_len = 32
    e.reset()
    assert e._ids.shape == (1, physical_cache_len(32, e.prefill_chunk)) and not e._ids.any()


def test_the_capture_keys_and_parks_the_verify_step(f32, fake_cuda):
    """On a (stand-in) card the verify step's graph is keyed by K, the
    sampling mode, the engine's impl and the switches, apart from any plain step's; its
    warm-up and capture run parked at the window's position, writing no
    id; n replays add n times the captured launches."""
    e = Engine(f32[0], cache_dtype=torch.float32, device="cpu", decode_window=6,
               spec_decode=4, aot_compile=False)
    e.prefill(REPETITIVE)
    ids = e._ids.clone()
    e._graphs.state_for(1, 6, 4)
    e._graphs.device = torch.device("cuda")
    run = e._window(False, len(REPETITIVE))
    assert list(e._graphs.graphs) == [(4, False, "auto", switches())]
    st = e._graphs.state
    assert st.done.item() and st.pos.item() == len(REPETITIVE) and torch.equal(e._ids, ids)
    e._window(True, len(REPETITIVE))
    assert len(_Graph.made) == 2 and _Graph.made[1].generators == [e.generator]
    run(3)
    assert _Graph.made[0].replays == 3


# ------------------------------------------------------------ run and serve
@pytest.fixture(scope="module")
def llama_gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("spec_cli") / "llama_q8_0.gguf"
    build_tiny_gguf(path, family="llama", quant=GGMLType.Q8_0, seed=0, with_tokenizer=True)
    return path


def test_run_spec_decode_prints_the_plain_text(llama_gguf, capsys, monkeypatch):
    """`run --spec-decode 4 --device cpu` at temperature 0 prints the text
    of the plain run and reports the spec metrics; without a card the
    default device raises."""
    argv = ["run", "-m", str(llama_gguf), "-p", "hello world", "--device", "cpu", "-n", "48",
            "--temperature", "0", "--metrics-format", "json"]
    assert cli.main(argv) == 0
    plain = capsys.readouterr()
    assert cli.main(argv + ["--spec-decode", "4"]) == 0
    spec = capsys.readouterr()
    assert spec.out == plain.out and plain.out.strip()
    assert '"spec_forwards"' in spec.err and '"spec_forwards"' not in plain.err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "-m", str(llama_gguf), "-p", "hi", "--spec-decode", "4"])


def test_serve_spec_decode_answers_as_the_plain_service(llama_gguf):
    """A batch-1 `serve --spec-decode 2` service answers two greedy
    requests that share a prefix (the second reuses the first's cache and
    ids) with the plain service's text; the batched service takes no
    speculation, as the JAX `serve` does."""
    from llamatpu_torch.server import service
    from llamatpu_torch.server.openai_server import build_service

    base = ["serve", "-m", str(llama_gguf), "--device", "cpu", "-n", "96"]
    reqs = [service.Request([{"role": "system", "content": "be brief"},
                             {"role": "user", "content": text}], max_tokens=24,
                            temperature=0.0) for text in ("hello there", "hello again")]
    texts = []
    for extra in ([], ["--spec-decode", "2"]):
        args = cli.build_parser().parse_args(base + extra)
        model, _ = cli.load(args)
        svc = build_service(args, model)
        assert svc.engine.spec_k == (2 if extra else 0)
        res = [svc.generate(r) for r in reqs]
        texts.append([(r.text, r.completion_tokens, r.finish_reason) for r in res])
        if extra:
            assert svc.engine.metrics.extra["prefix_cached_tokens"] > 0
            assert svc.engine.metrics.extra["spec_forwards"] > 0
    assert texts[1] == texts[0] and texts[0][0][0]
    args = cli.build_parser().parse_args(base + ["--spec-decode", "2", "--batch-size", "2"])
    svc = build_service(args, cli.load(args)[0])
    try:
        assert not hasattr(svc.engine, "spec_k") or not svc.engine.spec_k
    finally:
        svc.batcher.shutdown()


def test_spec_windows_count_no_launch_on_the_cpu(f32, rowq):
    """On the CPU the wrappers take their plain versions and count nothing,
    through the verify forward's K2, K9 and K1 too."""
    wrappers = (quant_matmul.rowq_gemv, layer_fused.qkv_norm_fused_rowq,
                layer_fused.layer_tail_fused_rowq, layer_fused.layer_attn_tail_fused_rowq)
    saved = [w.launches for w in wrappers]
    e = Engine(rowq[0], rowq=True, cache_len=128, prefill_chunk=32, decode_window=8,
               cache_dtype=torch.float32, device="cpu", spec_decode=4)
    e.generate([1, 2, 3] * 5, 12)
    assert [w.launches for w in wrappers] == saved


def test_spec_bench_rows_on_the_cpu():
    """bench/spec_bench.py on the CPU at a tiny width and its own geometry
    (cache 1024, prefill chunk 512, window 32, tg128): scripts/bench_spec.py's
    prompt (32 seeded ids tiled to 512), a plain and a K = 4 row with the
    same greedy tokens, the spec telemetry of the timed run, forwards run =
    spec_forwards + parked, and no kernel launch counted (the plain versions
    ran)."""
    from llamatpu_torch.bench import spec_bench

    base = np.random.default_rng(42).integers(0, 32, 32)
    want = []
    while len(want) < 512:
        want.extend(int(t) for t in base)
    assert spec_bench.tiled_prompt(32) == want[:512]
    model = t_build("llama32-1b", n_layers=2, dtype="f32", seed=1, context_length=1152,
                    overrides=dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2,
                                   head_dim=64, vocab_size=32))
    plain, spec = spec_bench.bench_rows(model, k=4, device="cpu")
    assert (plain["K"], spec["K"]) == (0, 4) and plain["tg"] == spec["tg"] == 128
    assert spec["tokens"] == plain["tokens"] and plain["forwards_run"] == 128
    assert spec["forwards_run"] == spec["spec_forwards"] + spec["parked"]
    assert spec["rounds"] >= 4 and spec["prefill_chunks"] == 1
    assert plain["launches"] == spec["launches"] == {}
    assert spec_bench.card_name("cpu") == "cpu"
