"""Slice 3's batched decode on the CPU against the JAX package: K9's plain
version (`layer_tail_fused_rowq`) against `_tail_kernel` in interpret mode;
`forward_tokens` with per-lane positions and `batch_offset`; the greedy ids
of BatchEngine and PagedBatchEngine against the JAX engines (impl="pallas");
and per-lane sampling against llamatpu's nucleus. On the CPU no kernel launch
is counted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamatpu.models import transformer as jtr
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.models.weights import QTensor as JQTensor
from llamatpu.models.weights import prepare_qtensor, rowq_requant
from llamatpu.models.weights import serving_weights as j_serving
from llamatpu.ops import sampling as jsampling
from llamatpu.ops.layer_fused import layer_tail_fused_rowq as j_tail
from llamatpu.runtime.batch_engine import BatchEngine as JBatchEngine
from llamatpu.runtime.paged_engine import PagedBatchEngine as JPagedBatchEngine
from llamatpu_torch.models import transformer as ttr
from llamatpu_torch.models.synthetic import build_synthetic_model as t_build
from llamatpu_torch.models.weights import from_numpy_weights
from llamatpu_torch.ops import attention, layer_fused, sampling
from llamatpu_torch.runtime.batch_engine import BatchEngine
from llamatpu_torch.runtime.paged_engine import PagedBatchEngine

TINY = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab_size=300)
L, D, F, H = 2, 128, 128, 128
EPS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one intra-op thread: the test workers and the JAX
    compiler share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ K9
def _rowq(o, i, seed):
    rng = np.random.default_rng(seed)
    qs = rng.integers(-127, 128, size=(L, o, i), dtype=np.int8)
    scales = rng.random((L, o, i // 32), dtype=np.float32) * 0.01 + 0.005
    return rowq_requant(prepare_qtensor(JQTensor(qs, scales, "q8_0")))


@pytest.fixture(scope="module")
def tail_ws():
    jw = {"wo": _rowq(D, H, 1), "w13": _rowq(2 * F, D, 2), "w2": _rowq(D, F, 3),
          "ffn_norm": np.random.default_rng(5).normal(size=(L, D)).astype(np.float32)}
    return jw, from_numpy_weights(jw)


@pytest.mark.parametrize("t", [1, 5, 8, 17, 32])
@pytest.mark.parametrize("rs", [1.0, 0.5])
def test_tail_plain_matches_pallas(tail_ws, t, rs):
    """K9's plain version against layer_tail_fused_rowq(interpret=True) on
    tests/test_layer_fused.py-style q8_row weights, every layer, f32:
    rtol = 5e-4, atol = 1e-3 (that file's gate)."""
    jw, tw = tail_ws
    rng = np.random.default_rng(t)
    attn = rng.normal(size=(1, t, H)).astype(np.float32) * 0.1
    x = rng.normal(size=(1, t, D)).astype(np.float32) * 0.1
    for li in range(L):
        want = j_tail(jw["wo"], jw["w13"], jw["w2"], jnp.asarray(jw["ffn_norm"]),
                      jnp.asarray(attn), jnp.asarray(x), jnp.int32(li), EPS, rs, interpret=True)
        got = layer_fused.layer_tail_fused_rowq(tw["wo"], tw["w13"], tw["w2"], tw["ffn_norm"],
                                                _t(attn), _t(x), li, EPS, rs)
        assert got.shape == x.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=1e-3)
    assert layer_fused.layer_tail_fused_rowq.launches == 0


def test_tail_declines_above_32_rows_and_non_rowq(tail_ws):
    jw, tw = tail_ws
    x, attn = torch.zeros((33, D)), torch.zeros((33, H))
    assert j_tail(jw["wo"], jw["w13"], jw["w2"], jnp.asarray(jw["ffn_norm"]), jnp.zeros((33, H)),
                  jnp.zeros((33, D)), jnp.int32(0), EPS, interpret=True) is None
    assert layer_fused.layer_tail_fused_rowq(tw["wo"], tw["w13"], tw["w2"], tw["ffn_norm"],
                                             attn, x, 0, EPS) is None
    bq = from_numpy_weights({"w": prepare_qtensor(JQTensor(
        np.ones((L, D, H), np.int8), np.ones((L, D, H // 32), np.float32), "q8_0"))})["w"]
    assert layer_fused.layer_tail_fused_rowq(bq, tw["w13"], tw["w2"], tw["ffn_norm"],
                                             attn[:1], x[:1], 0, EPS) is None
    # bf16 activations: the dots take bf16-rounded operands (h and act round
    # to bf16, 2^-8 relative), the output is bf16: within 1% of the largest
    # f32 output
    xb = (torch.randn((4, D)) * 0.1).to(torch.bfloat16)
    ab = (torch.randn((4, H)) * 0.1).to(torch.bfloat16)
    got = layer_fused.layer_tail_fused_rowq(tw["wo"], tw["w13"], tw["w2"], tw["ffn_norm"],
                                            ab, xb, 1, EPS)
    want = layer_fused.layer_tail_fused_rowq(tw["wo"], tw["w13"], tw["w2"], tw["ffn_norm"],
                                             ab.float(), xb.float(), 1, EPS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0,
                               atol=1e-2 * want.abs().max().item())


# ----------------------------------------------------------- forward / engines
def _models(seed=5, ctx=128):
    kw = dict(n_layers=2, dtype="f32", seed=seed, context_length=ctx, overrides=TINY)
    return t_build("llama32-1b", **kw), j_build("llama32-1b", **kw)


@pytest.mark.parametrize("rowq", [False, True])
def test_forward_lane_prefill_and_vector_decode_match_jax(rowq):
    """Dense batched cache, f32: a 9-row prefill of lane 2 through
    batch_offset (K2 + K9 at 9 rows under rowq), then one decode step of 3
    lanes at positions (9, 4, park) where the parked lane sits at the last
    physical row (K6, and K2 + K9 at 3 rows under rowq), against llamatpu's
    forward_tokens(impl="pallas"): logits and cache, rtol = atol = 5e-4."""
    _, jm = _models()
    cfg = jm.cfg
    jw = j_serving(cfg, jm.weights, rowq=rowq)
    tw = from_numpy_weights(jax.device_get(jw))
    s_phys = ttr.physical_cache_len(64, 16)
    jcache = jtr.init_cache(cfg, 3, jnp.float32, s_phys)
    tcache = ttr.init_cache(cfg, 3, torch.float32, s_phys, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 300, (1, 9))
    jl, jcache = jtr.forward_tokens(cfg, jw, jnp.asarray(toks, jnp.int32), jcache, 0,
                                    impl="pallas", batch_offset=2, s_limit=64, logit_index=8)
    tl, tcache = ttr.forward_tokens(cfg, tw, _t(toks), tcache, 0, batch_offset=2, s_limit=64,
                                    logit_index=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=5e-4)
    pos = np.asarray([9, 4, s_phys - 1], np.int32)
    step = rng.integers(0, 300, (3, 1))
    jl, jcache = jtr.forward_tokens(cfg, jw, jnp.asarray(step, jnp.int32), jcache,
                                    jnp.asarray(pos), impl="pallas", last_logit_only=True,
                                    s_limit=64)
    tl, tcache = ttr.forward_tokens(cfg, tw, _t(step), tcache, _t(pos), last_logit_only=True,
                                    s_limit=64)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(tcache.kv.numpy(), np.asarray(jcache.kv), rtol=5e-4, atol=5e-4)


PROMPTS = [[(7 * i + 3) % 300 for i in range(n)] for n in (5, 19, 40)]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("rowq", [False, True])
def test_batch_engines_greedy_ids_match_jax(paged, rowq):
    """generate_batch on 3 prompts of different lengths (chunks of 16, the
    last padded), decode window 4, f32: the port's BatchEngine /
    PagedBatchEngine give the JAX engines' (impl="pallas") greedy ids, with
    and without rowq."""
    tm, jm = _models()
    common = dict(batch_size=4, prefill_chunk=16, decode_window=4, rowq=rowq)
    if paged:
        je = JPagedBatchEngine(jm, block_size=8, max_len=128, impl="pallas",
                               cache_dtype=jnp.float32, **common)
        te = PagedBatchEngine(tm, block_size=8, max_len=128, cache_dtype=torch.float32,
                              device="cpu", **common)
    else:
        je = JBatchEngine(jm, cache_len=128, impl="pallas", cache_dtype=jnp.float32, **common)
        te = BatchEngine(tm, cache_len=128, cache_dtype=torch.float32, device="cpu", **common)
    ref = je.generate_batch(PROMPTS, 10)
    got = te.generate_batch(PROMPTS, 10)
    assert got == ref
    assert te.metrics.decode_tokens == 30 and te.decode_steps >= 9
    stops = {ref[1][4]}
    assert te.generate_batch(PROMPTS, 10, stop_tokens=stops) == \
        je.generate_batch(PROMPTS, 10, stop_tokens=stops)
    assert attention.decode_attention_paged.launches == 0
    assert layer_fused.layer_tail_fused_rowq.launches == 0


def test_decode_window_parks_inactive_lanes():
    """An inactive lane emits -1 for the whole window and its KV writes land
    only in the parked row (dense) or the trash block (paged): the other
    rows and blocks are untouched."""
    tm, _ = _models()
    e = BatchEngine(tm, batch_size=2, cache_len=64, prefill_chunk=16, decode_window=4,
                    cache_dtype=torch.float32, device="cpu")
    e.prefill_lane(0, [1, 2, 3])
    before = e.cache.kv.clone()
    slab = e.decode_window_run(np.array([5, 7]), np.array([3, 9]), np.array([True, False]))
    assert slab.shape == (4, 2) and (slab[:, 1] == -1).all() and (slab[:, 0] >= 0).all()
    changed = (e.cache.kv != before).any(dim=(0, 2, 4))       # [B, S]
    assert changed[1].nonzero().flatten().tolist() == [e.cache.kv.shape[3] - 1]
    assert changed[0].nonzero().flatten().tolist() == [3, 4, 5, 6]
    p = PagedBatchEngine(tm, batch_size=2, block_size=4, max_len=32, prefill_chunk=16,
                         decode_window=4, cache_dtype=torch.float32, device="cpu")
    p.prefill_lane(0, [1, 2, 3])
    p.alloc.ensure(1, 12, 4)  # lane 1 holds blocks, but is inactive
    before = p.cache.kv_pool.clone()
    p.decode_window_run(np.array([5, 7]), np.array([3, 9]), np.array([True, False]))
    changed = (p.cache.kv_pool != before).any(dim=(0, 2, 3, 4)).nonzero().flatten().tolist()
    lane0 = set(p.alloc.tables[0, :2].tolist())
    assert set(changed) <= lane0 | {p.alloc.trash_block} and p.alloc.trash_block in changed


# ------------------------------------------------------------------ sampling
def test_per_lane_nucleus_equals_jax_and_greedy_lanes_exact():
    """sample_dynamic's per-lane filter equals JAX's filtered_scaled_logits
    lane by lane; temperature-0 lanes of sample_lanes are the exact argmax;
    every draw lies inside its lane's nucleus."""
    rng = np.random.default_rng(3)
    lg = rng.normal(size=(4, 64)).astype(np.float32) * 3
    temps = np.array([0.3, 0.0, 1.0, 0.7], np.float32)
    topps = np.array([0.95, 0.9, 0.5, 0.99], np.float32)
    got = sampling.filtered_scaled_logits(_t(lg), _t(temps)[:, None], _t(topps)[:, None])
    for b in range(4):
        if temps[b] == 0:
            continue
        want = np.asarray(jsampling.filtered_scaled_logits(jnp.asarray(lg[b]),
                                                           jnp.float32(temps[b]),
                                                           jnp.float32(topps[b])))
        assert np.array_equal(got[b].numpy(), want)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        ids = sampling.sample_lanes(_t(lg), _t(temps), _t(topps), gen).numpy()
        assert ids[1] == np.argmax(lg[1])
        for b in (0, 2, 3):
            assert np.isfinite(got[b, ids[b]].item())
    assert np.array_equal(sampling.sample_lanes(_t(lg), _t(temps * 0), _t(topps), gen,
                                                any_sampled=False).numpy(),
                          np.asarray(jsampling.greedy(jnp.asarray(lg))))


def test_per_lane_draws_follow_the_nucleus():
    """Chi-square of 4000 draws per lane against softmax of the lane's
    filtered logits (16-token vocab, two lanes with different parameters)."""
    rng = np.random.default_rng(8)
    lg = np.repeat(rng.normal(size=(2, 16)).astype(np.float32) * 2, 2000, axis=0)
    temps = np.repeat(np.array([0.8, 1.5], np.float32), 2000)
    topps = np.repeat(np.array([0.9, 0.7], np.float32), 2000)
    ids = sampling.sample_dynamic(_t(lg), _t(temps), _t(topps),
                                  torch.Generator().manual_seed(42)).numpy()
    for b, sl in ((0, slice(0, 2000)), (1, slice(2000, 4000))):
        probs = torch.softmax(sampling.filtered_scaled_logits(
            _t(lg[sl][:1]), float(temps[sl][0]), float(topps[sl][0]))[0], -1).numpy()
        counts = np.bincount(ids[sl], minlength=16)
        keep = probs > 0
        assert counts[~keep].sum() == 0
        expected = probs[keep] * 2000
        chi2 = float((((counts[keep] - expected) ** 2) / expected).sum())
        assert chi2 < 40.0, (b, chi2)  # dof <= 15: p < 1e-3 at ~37.7


def test_one_lane_batch_engine_takes_k3_where_jax_does(monkeypatch):
    """A one-lane BatchEngine on q8_row weights at widths that are multiples
    of 128 (where the JAX VMEM fit accepts the megakernel): its decode
    positions are a device vector, and the port takes K3 (its plain version
    on the CPU) every layer and decode step where the JAX BatchEngine's
    decode program holds `layer_attn_tail_fused_rowq` (traced once: JAX
    records trace-time calls) and no separate attention kernel; neither
    takes K6 (and K9 after it) instead. The greedy ids are the JAX
    engine's."""
    import llamatpu.ops.layer_fused as jlf
    import llamatpu.ops.pallas_attention as jpa

    calls = {}

    def rec(mod, name, side):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            if out is not None:  # the JAX megakernel returns None where it declines
                calls[(side, name)] = calls.get((side, name), 0) + 1
            return out
        monkeypatch.setattr(mod, name, wrapped)

    rec(jlf, "layer_attn_tail_fused_rowq", "jax")
    rec(jpa, "decode_attention_fused_write", "jax")
    rec(layer_fused, "layer_attn_tail_plain", "port")
    rec(attention, "decode_attention_fused_write_plain", "port")
    tm, jm = _models()
    common = dict(batch_size=1, prefill_chunk=16, decode_window=4, rowq=True)
    je = JBatchEngine(jm, cache_len=128, impl="pallas", cache_dtype=jnp.float32, **common)
    te = BatchEngine(tm, cache_len=128, cache_dtype=torch.float32, device="cpu", **common)
    ref = je.generate_batch(PROMPTS[1:2], 6)
    got = te.generate_batch(PROMPTS[1:2], 6)
    assert got == ref
    assert calls.get(("jax", "layer_attn_tail_fused_rowq"), 0) >= 1
    traced = calls[("jax", "layer_attn_tail_fused_rowq")]
    assert calls == {("jax", "layer_attn_tail_fused_rowq"): traced,
                     ("port", "layer_attn_tail_plain"): tm.cfg.n_layers * te.decode_steps}
    assert layer_fused.layer_attn_tail_fused_rowq.launches == 0
