"""Slice 2's kernels and path on the CPU against the JAX package: the plain
versions of K5 (block-quant matmul), K7 (packed4 matmul) and K6 (fused KV
append + decode attention) against the Pallas kernels in interpret mode; the
block-quant forward and greedy Engine against llamatpu's impl="pallas"; and
sampling against llamatpu's nucleus. On the CPU every wrapper takes its plain
version and no launch is counted."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamatpu.models import transformer as jtr
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.models.weights import QTensor as JQTensor
from llamatpu.models.weights import prepare_qtensor
from llamatpu.models.weights import serving_weights as j_serving
from llamatpu.ops import sampling as jsampling
from llamatpu.ops.pallas_attention import decode_attention_fused_write as j_fused_write
from llamatpu.ops.pallas_matmul import _quant_matmul_2d, _quant_matmul_2d_li, quant_matmul_pallas
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu_torch.models import transformer as ttr
from llamatpu_torch.models.synthetic import build_synthetic_model as t_build
from llamatpu_torch.models.weights import QTensor, from_numpy_weights, serving_weights
from llamatpu_torch.ops import attention, quant_matmul, sampling
from llamatpu_torch.ops.matmul import matmul
from llamatpu_torch.runtime.engine import Engine

TINY = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab_size=300)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_weight(rng, shape, kind, pack4):
    """A stacked block-quant weight as the JAX package serves it (interleaved
    or packed4 columns, padded rows) and the same weight in the port's layout."""
    lo, hi = (-8, 8) if kind == "q4_0" else (-127, 128)
    qs = rng.integers(lo, hi, size=shape, dtype=np.int8)
    # scales of real checkpoints: weights ~0.1, outputs O(1)
    sc = (rng.random((*shape[:-1], shape[-1] // 32), dtype=np.float32) * 0.001 + 0.0005)
    sc = sc * (16 if kind == "q4_0" else 1)
    jw = prepare_qtensor(JQTensor(qs, sc, kind), pack4=pack4)
    return jw, from_numpy_weights({"w": jw})["w"]


@pytest.mark.parametrize("t", [1, 5, 128])
@pytest.mark.parametrize("kind,pack4", [("q8_0", False), ("q4_0", False), ("q4_0", True)])
def test_block_matmul_plain_matches_pallas(kind, pack4, t):
    """K5 (canonical) / K7 (packed4) plain versions against `_quant_matmul_2d`
    and `_quant_matmul_2d_li` in interpret mode, f32: rtol = atol = 1e-5.
    O = 200 is not a multiple of the JAX tiles (padded rows sliced off)."""
    rng = np.random.default_rng(t)
    jw, tw = _jax_weight(rng, (2, 200, 256), kind, pack4)
    assert tw.layout == ("packed4" if pack4 else "canonical")
    x = rng.normal(size=(t, 256)).astype(np.float32)
    want = np.asarray(_quant_matmul_2d_li(jnp.asarray(jw.qs), jnp.asarray(jw.scales),
                                          jnp.asarray(x), 1, interpret=True,
                                          layout=jw.layout))[:, :200]
    kern = quant_matmul.packed4_matmul if pack4 else quant_matmul.block_matmul
    got = kern(_t(x), tw.qs[1], tw.scales[1])[:, :200]  # JAX-padded rows dropped
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # unstacked kernel, through the dispatch (logical rows sliced, cast to x)
    want0 = np.asarray(_quant_matmul_2d(jnp.asarray(jw.qs[0]), jnp.asarray(jw.scales[0]),
                                        jnp.asarray(x), interpret=True, layout=jw.layout))
    got0 = matmul(tw, _t(x)[None], li=0)[0]
    np.testing.assert_allclose(got0.numpy(), want0[:, :200], rtol=1e-5, atol=1e-5)
    assert quant_matmul.block_matmul.launches == quant_matmul.packed4_matmul.launches == 0


def test_block_matmul_rounds_the_weight_to_bf16_before_the_dot():
    """bf16 activations: the dequantized weight is rounded to bf16 first, so
    the plain version equals an f32 dot of bf16-rounded operands exactly."""
    rng = np.random.default_rng(9)
    qs = _t(rng.integers(-127, 128, size=(64, 128), dtype=np.int8))
    sc = _t(rng.random((64, 4), dtype=np.float32) * 0.01 + 0.001)
    x = _t(rng.normal(size=(3, 128)).astype(np.float32)).to(torch.bfloat16)
    w = (qs.float() * sc.repeat_interleave(32, -1)).to(torch.bfloat16).float()
    got = quant_matmul.block_matmul(x, qs, sc)
    assert got.dtype == torch.float32
    assert torch.equal(got, x.float() @ w.T)
    assert not torch.equal(got, x.float() @ (qs.float() * sc.repeat_interleave(32, -1)).T)


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_fused_write_plain_matches_pallas(cache_dtype):
    """K6's plain version against decode_attention_fused_write(interpret=True)
    at positions crossing the 32-row tiles, two batch rows at different
    positions: the cache bit-equal everywhere, attention within 1e-5."""
    rng = np.random.default_rng(3)
    jdt = jnp.float32 if cache_dtype == torch.float32 else jnp.bfloat16
    L, B, KV, G, HD, S = 2, 2, 2, 4, 64, 128
    kvc = jnp.asarray(rng.normal(size=(L, B, KV, S, 2 * HD)).astype(np.float32), jdt)
    tc = _t(np.asarray(kvc.astype(jnp.float32))).to(cache_dtype)
    for pos in ([0, 31], [32, 63], [64, 127], [100, 5]):
        q = rng.normal(size=(B, KV, G, HD)).astype(np.float32)
        kvn = rng.normal(size=(B, KV, 2 * HD)).astype(np.float32)
        pv = np.asarray(pos, np.int32)
        jout, kvc = j_fused_write(jnp.asarray(q), jnp.asarray(kvn), kvc, jnp.asarray(pv),
                                  0.125, 1, hd=HD, interpret=True)
        out, tc = attention.decode_attention_fused_write(_t(q), _t(kvn), tc, _t(pv), 0.125, 1,
                                                         HD)
        assert torch.equal(tc.float(), _t(np.asarray(kvc.astype(jnp.float32))))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    assert attention.decode_attention_fused_write.launches == 0
    with pytest.raises(NotImplementedError, match="int8-KV"):
        attention.decode_attention_fused_write(_t(q), _t(kvn), tc.to(torch.int8), _t(pv),
                                               0.125, 1, HD)


def _models(ctx=256, pack4=False):
    kw = dict(n_layers=2, dtype="f32", seed=11, context_length=ctx, overrides=TINY)
    tm, jm = t_build("llama32-1b", **kw), j_build("llama32-1b", **kw)
    return tm, jm


def test_forward_block_path_matches_jax_pallas():
    """A 128-token prefill (K5 for every projection) and one decode step (K5 +
    K6 + the unfused tail) against llamatpu forward_tokens(impl="pallas") on
    its own served Q8_0 weights, f32: rtol = atol = 5e-4."""
    import jax

    tm, jm = _models()
    cfg = tm.cfg
    jw = j_serving(jm.cfg, jm.weights)
    tw = from_numpy_weights(jax.device_get(jw))
    ref = serving_weights(cfg, tm.weights, device="cpu")
    assert torch.equal(ref["layers"]["wqkv"].qs, tw["layers"]["wqkv"].qs)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 128))
    cache = ttr.init_cache(cfg, 1, torch.float32, device="cpu")
    jcache = jtr.init_cache(jm.cfg, 1, jnp.float32)
    logits, cache = ttr.forward_tokens(cfg, tw, _t(toks), cache, 0)
    jlogits, jcache = jtr.forward_tokens(jm.cfg, jw, jnp.asarray(toks, jnp.int32), jcache, 0,
                                         impl="pallas")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=5e-4, atol=5e-4)
    logits, cache = ttr.forward_tokens(cfg, tw, torch.tensor([[17]]), cache, 128,
                                       last_logit_only=True)
    jlogits, jcache = jtr.forward_tokens(jm.cfg, jw, jnp.asarray([[17]], jnp.int32), jcache,
                                         128, impl="pallas", last_logit_only=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(cache.kv.numpy(), np.asarray(jcache.kv), rtol=5e-4, atol=5e-4)


def test_engine_greedy_tokens_match_jax_engine():
    """Block-quant serving (rowq=False, the default): a 130-token prompt (a
    128-row chunk and a padded 2-row chunk), then 8 greedy tokens in decode
    windows, equal to llamatpu's Engine(impl="pallas")."""
    tm, jm = _models()
    prompt = [(11 * i + 5) % TINY["vocab_size"] for i in range(130)]
    kw = dict(cache_len=256, prefill_chunk=128, decode_window=4)
    je = JEngine(jm, impl="pallas", cache_dtype=jnp.float32, aot_compile=False, **kw)
    ref = je.generate(prompt, 8).tokens
    te = Engine(tm, cache_dtype=torch.float32, device="cpu", **kw)
    assert te.weights["wcls"].kind == "q8_0"
    assert te.generate(prompt, 8).tokens == ref


# ------------------------------------------------------------------ sampling
def _logits(seed=0, v=64, rows=3):
    return np.random.default_rng(seed).normal(size=(rows, v)).astype(np.float32) * 3


@pytest.mark.parametrize("temperature,top_p", [(0.3, 0.95), (1.0, 0.5), (0.7, 0.99), (2.0, 1e-9)])
def test_nucleus_equals_jax_filtered_scaled_logits(temperature, top_p):
    """Scaled logits and nucleus mask bit for bit. (The two frameworks' exp
    differ in the last ulp, so a cut that falls within rounding of a
    cumulative sum, as top_p = 1 does at the tail, may land one token apart:
    those cases are not compared.)"""
    lg = _logits()
    want = np.asarray(jsampling.filtered_scaled_logits(jnp.asarray(lg), jnp.float32(temperature),
                                                       jnp.float32(top_p)))
    got = sampling.filtered_scaled_logits(_t(lg), temperature, top_p).numpy()
    assert np.array_equal(got, want)


def test_nucleus_ties_keep_index_order_like_jax():
    """Equal probabilities straddling the top-p cut: the stable descending
    sort keeps the lower index, as jnp.argsort(descending=True) does."""
    lg = np.array([[0.0, 1.0, 1.0, 1.0, 0.5, 1.0]], np.float32)
    for top_p in (0.3, 0.5, 0.7):
        want = np.asarray(jsampling.filtered_scaled_logits(jnp.asarray(lg), jnp.float32(1.0),
                                                           jnp.float32(top_p)))
        got = sampling.filtered_scaled_logits(_t(lg), 1.0, top_p).numpy()
        assert np.array_equal(got, want)
    kept = np.isfinite(sampling.filtered_scaled_logits(_t(lg), 1.0, 0.5).numpy()[0])
    assert kept.nonzero()[0].tolist() == [1, 2, 3]  # of four equal tokens, the lowest ids


def test_draws_stay_inside_the_nucleus_and_follow_it():
    """Draws lie inside the nucleus, follow its distribution (chi-square over
    a 16-token vocab, 4000 draws), the same seed gives the same ids, and
    temperature 0 is the argmax."""
    lg = _logits(seed=4, v=16, rows=1)
    temp, top_p = 0.8, 0.9
    fl = sampling.filtered_scaled_logits(_t(lg), temp, top_p)[0]
    probs = torch.softmax(fl, -1).numpy()
    gen = torch.Generator().manual_seed(42)
    rows = _t(np.repeat(lg, 4000, axis=0))
    ids = sampling.sample(rows, temp, top_p, gen).numpy()
    assert ids.dtype == np.int32 and np.isfinite(fl.numpy()[ids]).all()
    counts = np.bincount(ids, minlength=16)
    keep = probs > 0
    expected = probs[keep] * len(ids)
    chi2 = float((((counts[keep] - expected) ** 2) / expected).sum())
    assert chi2 < 40.0, (chi2, counts, expected)  # dof <= 15: p < 1e-3 at ~37.7
    again = sampling.sample(rows, temp, top_p, torch.Generator().manual_seed(42)).numpy()
    assert np.array_equal(ids, again)
    lg2 = _logits(seed=5)
    assert np.array_equal(sampling.sample(_t(lg2), 0.0, 0.9, gen).numpy(),
                          np.asarray(jsampling.greedy(jnp.asarray(lg2))))


def test_engine_sampled_generation_is_seeded():
    """Engine(temperature, top_p, seed): the same seed gives the same ids,
    reset(seed=...) restarts the stream, another seed another stream; greedy
    per-call overrides (temperature=0) match the greedy engine."""
    tm, _ = _models(64)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    e = Engine(tm, temperature=1.5, top_p=0.95, seed=7, device="cpu", cache_len=64,
               prefill_chunk=32, decode_window=4)
    a = e.generate(prompt, 12).tokens
    e.reset(seed=7)
    assert e.generate(prompt, 12).tokens == a
    e.reset(seed=8)
    assert e.generate(prompt, 12).tokens != a
    e.reset()
    greedy = e.generate(prompt, 12, temperature=0.0).tokens
    g = Engine(tm, device="cpu", cache_len=64, prefill_chunk=32, decode_window=4)
    assert g.generate(prompt, 12).tokens == greedy
    echoed = []
    e.reset(seed=7)
    e.generate(prompt, 3, on_token=echoed.append, echo=True)
    assert echoed[: len(prompt)] == prompt and len(echoed) == len(prompt) + 3


def test_dispatch_routes_and_dense_weights():
    """Dense (F32 checkpoint) weights go through torch.matmul with f32
    accumulation, cast back to x's dtype; a Q4_K weight with offsets
    matches `quant_matmul_pallas(interpret=True)` (f32, 1e-5)."""
    rng = np.random.default_rng(2)
    w = _t(rng.normal(size=(2, 40, 64)).astype(np.float32))
    x = _t(rng.normal(size=(1, 3, 64)).astype(np.float32)).to(torch.bfloat16)
    y = matmul(w, x, li=1)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 3, 40)
    assert torch.equal(y, (x.float() @ w[1].T).to(torch.bfloat16))
    qs = rng.integers(-8, 8, size=(40, 64), dtype=np.int8)
    sc = rng.random((40, 2), dtype=np.float32) * 0.02
    offs = rng.random((40, 2), dtype=np.float32) * 0.02 - 0.01
    jw = prepare_qtensor(JQTensor(qs, sc, "q4_k", offs=offs))
    xf = x.float()
    want = np.asarray(quant_matmul_pallas(jw, jnp.asarray(xf.numpy()), interpret=True))
    got = matmul(QTensor(_t(qs), _t(sc), "q4_k", offs=_t(offs)), xf)
    np.testing.assert_allclose(got.numpy(), want[..., :40], rtol=1e-5, atol=1e-5)
