"""The int8 KV cache in the port against the JAX package: `quantize_kv` /
`dequantize_kv` and the paged scale writes bit for bit, the int8 plain
versions of K14 (fused, unfused), K15, K6 and K8 against the Pallas kernels'
quant=True variants in interpret mode, the forward at a long int8 cache, the
three engines' greedy ids against the JAX engines, warm prefixes against
cold ones, and `cli run --kv-dtype int8`. On the CPU every wrapper takes its
plain version and no launch is counted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tiny_models import build_tiny_gguf

import llamatpu.ops.pallas_attention as jpa
from llamatpu.gguf import GGMLType
from llamatpu.models import transformer as jtr
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.models.weights import serving_weights as j_serving
from llamatpu.ops import kv_quant as jkq
from llamatpu.runtime import paged_cache as jpc
from llamatpu.runtime.batch_engine import BatchEngine as JBatchEngine
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu.runtime.paged_engine import PagedBatchEngine as JPagedBatchEngine
from llamatpu_torch import cli
from llamatpu_torch.models import transformer as ttr
from llamatpu_torch.models.loader import load_model
from llamatpu_torch.models.synthetic import build_synthetic_model as t_build
from llamatpu_torch.models.weights import from_numpy_weights
from llamatpu_torch.ops import attention, kv_quant
from llamatpu_torch.runtime import paged_cache as tpc
from llamatpu_torch.runtime.batch_engine import BatchEngine
from llamatpu_torch.runtime.engine import Engine
from llamatpu_torch.runtime.paged_engine import PagedBatchEngine
from llamatpu_torch.runtime.scheduler import BatchRequest, ContinuousBatcher
from llamatpu_torch.server.service import InferenceService, Request

TINY = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab_size=300)
L, KV, G, HD = 2, 2, 4, 64
SCALE = 0.125
INT8_WRAPPERS = (attention.decode_attention_fused_write_q, attention.decode_attention_split_q,
                 attention.decode_attention_split_fused_write_q, attention.decode_attention_q,
                 attention.decode_attention_paged_q)


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


def _quantized_cache(rng, shape_lead, s):
    """An int8 packed cache [..., KV, S, 2 HD] and its scale rows [..., KV, 2, S]
    from quantize_kv (JAX), a few rows zero (scale 0)."""
    k = rng.normal(size=shape_lead + (KV, s, HD)).astype(np.float32)
    v = rng.normal(size=shape_lead + (KV, s, HD)).astype(np.float32)
    k[..., :3, :] = 0.0
    kq, ks = jkq.quantize_kv(jnp.asarray(k))
    vq, vs = jkq.quantize_kv(jnp.asarray(v))
    return jnp.concatenate([kq, vq], axis=-1), jnp.stack([ks, vs], axis=-2)


def _new_rows(rng, b):
    """This token's quantized K|V rows [B, KV, 2 HD] int8 and scales [B, KV, 2]."""
    k = jnp.asarray(rng.normal(size=(b, KV, HD)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(b, KV, HD)), jnp.float32)
    (kq, ks), (vq, vs) = jkq.quantize_kv(k), jkq.quantize_kv(v)
    return jnp.concatenate([kq, vq], axis=-1), jnp.stack([ks, vs], axis=-1)


def test_quantize_and_dequantize_bit_equal_to_jax():
    """quantize_kv (f32 and bf16 inputs, zero rows, values at rounding
    halves) and dequantize_kv give JAX's int8 values and scales bit for bit."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 4, 64)) * 7.0).astype(np.float32)
    x[0, 1] = 0.0
    x[1, 2, :, :4] = np.float32(127.0) * np.array([0.5, 1.5, -2.5, 1.0], np.float32)[None]
    for xs, jx in ((_t(x), jnp.asarray(x)),
                   (_t(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16))):
        q, s = kv_quant.quantize_kv(xs)
        jq, js = jkq.quantize_kv(jx)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(),
                                                                           np.asarray(js))
        assert s[0, 1].eq(0).all() and q[0, 1].eq(0).all()
        # q [3, 5, S = 4, hd] with its scale rows [3, 5, 1, S]
        got = kv_quant.dequantize_kv(q, s[..., None, :])
        want = jkq.dequantize_kv(jq, js[..., None, :])
        assert np.array_equal(got.numpy(), np.asarray(want))


POSITIONS = ([0, 63], [64, 255], [130, 5])


def test_split_q_plain_matches_pallas():
    """K14's int8 plain versions against decode_attention_split_fused_write_q
    and decode_attention_split_q (interpret mode, s_tile 64): the int8 cache
    and scale rows after each fused write bit-equal, outputs within
    rtol = atol = 1e-5; tile 0, both sides of a tile boundary, the last row,
    two lanes at different positions."""
    rng = np.random.default_rng(4)
    kvc, sc = _quantized_cache(rng, (L, 2), 256)
    tc, ts = _t(kvc), _t(sc)
    for pos in POSITIONS:
        q = rng.normal(size=(2, KV, G, HD)).astype(np.float32)
        kvn, sn = _new_rows(rng, 2)
        pv = np.asarray(pos, np.int32)
        jout, kvc, sc = jpa.decode_attention_split_fused_write_q(
            jnp.asarray(q), kvn, sn, kvc, sc, jnp.asarray(pv), SCALE, 1, hd=HD, s_tile=64,
            interpret=True)
        out, tc2, ts2 = attention.decode_attention_split_fused_write_q(
            _t(q), _t(kvn), _t(sn), tc, ts, _t(pv), SCALE, 1, HD, 64)
        assert tc2 is tc and ts2 is ts  # written in place
        assert np.array_equal(tc.numpy(), np.asarray(kvc))
        assert np.array_equal(ts.numpy(), np.asarray(sc))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
        for li in range(L):
            want = jpa.decode_attention_split_q(jnp.asarray(q), kvc, sc, jnp.asarray(pv), SCALE,
                                                hd=HD, s_tile=64, interpret=True, layer_index=li)
            got = attention.decode_attention_split_q(_t(q), tc, ts, _t(pv), SCALE, HD, 64, li)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert all(w.launches == 0 for w in INT8_WRAPPERS)


def test_full_q_and_fused_write_q_plain_match_pallas():
    """K15's int8 plain version against decode_attention_q (interpret mode,
    s_use below the physical length, a lane at the last physical row) and
    K6's int8 variant against decode_attention_fused_write_q: the cache and
    scale rows bit-equal, outputs within rtol = atol = 1e-5."""
    rng = np.random.default_rng(5)
    S, s_use = 160, 136
    kvc, sc = _quantized_cache(rng, (L, 2), S)
    tc, ts = _t(kvc), _t(sc)
    for pos in ([0, 31], [32, 135], [100, S - 1]):
        q = rng.normal(size=(2, KV, G, HD)).astype(np.float32)
        pv = np.asarray(pos, np.int32)
        want = jpa.decode_attention_q(jnp.asarray(q), kvc, sc, jnp.asarray(pv), SCALE, hd=HD,
                                      interpret=True, s_use=s_use, layer_index=1)
        got = attention.decode_attention_q(_t(q), tc, ts, _t(pv), SCALE, HD, s_use, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        kvn, sn = _new_rows(rng, 2)
        jout, kvc, sc = jpa.decode_attention_fused_write_q(jnp.asarray(q), kvn, sn, kvc, sc,
                                                           jnp.asarray(pv), SCALE, 0, hd=HD,
                                                           interpret=True)
        out, _, _ = attention.decode_attention_fused_write_q(_t(q), _t(kvn), _t(sn), tc, ts,
                                                             _t(pv), SCALE, 0, HD)
        assert np.array_equal(tc.numpy(), np.asarray(kvc))
        assert np.array_equal(ts.numpy(), np.asarray(sc))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="int8-KV"):
        attention.decode_attention_fused_write(_t(q), _t(kvn), tc, _t(pv), SCALE, 0, HD)
    assert all(w.launches == 0 for w in INT8_WRAPPERS)


def _tables(rng, bs, positions, n_blocks, maxblk, parked=()):
    trash = n_blocks - 1
    free = list(rng.permutation(n_blocks - 1))
    tables = np.full((len(positions), maxblk), trash, np.int32)
    for b, pos in enumerate(positions):
        if b not in parked:
            for j in range(pos // bs + 1):
                tables[b, j] = free.pop()
    return tables


@pytest.mark.parametrize("bs", [8, 16])
def test_paged_q_plain_matches_pallas(bs):
    """K8's int8 plain version against decode_attention_paged(scale_pool=,
    interpret=True): shuffled tables, a parked lane, positions across block
    edges; rtol = atol = 1e-5. The JAX signature (scale_pool=) reaches it."""
    rng = np.random.default_rng(bs)
    positions = [0, bs - 1, bs, 3 * bs + 5, 7]
    n_blocks, maxblk = 14, 5
    tables = _tables(rng, bs, positions, n_blocks, maxblk, parked=(4,))
    kq, sq = _quantized_cache(rng, (L, n_blocks), bs)        # [L, NBLK, KV, BS, W], [.., 2, BS]
    q = rng.normal(size=(len(positions), KV, G, HD)).astype(np.float32)
    pv = np.asarray(positions, np.int32)
    for li in range(L):
        want = jpa.decode_attention_paged(jnp.asarray(q), kq, jnp.asarray(tables),
                                          jnp.asarray(pv), SCALE, scale_pool=sq, hd=HD,
                                          interpret=True, layer_index=li)
        got = attention.decode_attention_paged(_t(q), _t(kq), _t(tables), _t(pv), SCALE, HD, li,
                                               scale_pool=_t(sq))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        assert torch.equal(got, attention.decode_attention_paged_q(
            _t(q), _t(kq), _t(sq), _t(tables), _t(pv), SCALE, HD, li))
    with pytest.raises(NotImplementedError, match="int8-KV"):
        attention.decode_attention_paged(_t(q), _t(kq), _t(tables), _t(pv), SCALE, HD, 0)
    assert all(w.launches == 0 for w in INT8_WRAPPERS)


@pytest.mark.parametrize("t_len", [1, 5])
def test_paged_scale_write_and_gather_bit_equal(t_len):
    """paged_write_scale_stacked (decode T = 1, prefill T > 1) and
    paged_gather_scale give JAX's scale pool and lane view bit for bit."""
    rng = np.random.default_rng(t_len)
    bs, n_blocks, maxblk = 8, 12, 4
    positions = [3, 8, 15] if t_len == 1 else [0, 4, 10]
    tables = _tables(rng, bs, [p + t_len - 1 for p in positions], n_blocks, maxblk)
    spool = jnp.asarray(rng.random(size=(2, n_blocks, KV, 2, bs)), jnp.float32)
    snew = rng.random(size=(3, t_len, KV, 2)).astype(np.float32)
    want = jpc.paged_write_scale_stacked(spool, 1, jnp.asarray(snew), jnp.asarray(tables),
                                         jnp.asarray(positions, jnp.int32), bs)
    tsp = _t(spool)
    got = tpc.paged_write_scale_stacked(tsp, 1, _t(snew), _t(tables), _t(positions), bs)
    assert got is tsp and np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(tpc.paged_gather_scale(got[1], _t(tables)).numpy(),
                          np.asarray(jpc.paged_gather_scale(want[1], jnp.asarray(tables))))


def _models(ctx, layers=2, seed=5):
    kw = dict(n_layers=layers, dtype="f32", seed=seed, context_length=ctx, overrides=TINY)
    return t_build("llama32-1b", **kw), j_build("llama32-1b", **kw)


def test_forward_long_int8_cache_matches_jax():
    """forward_tokens at a long int8 cache (17408 rows: K14-int8 fused)
    against llamatpu's forward_tokens(impl="pallas"): an 8-token window at
    pos 1020 (the quantized write, the dequantized prefill view), then decode
    steps at 1028 and 1023; logits within rtol = atol = 5e-4, the int8 cache
    and its scale rows within one quantum and 5e-4."""
    _, jm = _models(17408)
    cfg = jm.cfg
    jw = j_serving(cfg, jm.weights, rowq=True)
    tw = from_numpy_weights(jax.device_get(jw))
    s_phys = 17408
    jc, tc = jtr.init_cache(cfg, 1, jnp.int8, s_phys), ttr.init_cache(cfg, 1, torch.int8, s_phys,
                                                                      device="cpu")
    assert tc.quantized and tc.scale.shape == (2, 1, 2, 2, s_phys)
    toks = np.random.default_rng(0).integers(0, 300, (1, 8))
    jl, jc = jtr.forward_tokens(cfg, jw, jnp.asarray(toks, jnp.int32), jc, 1020, impl="pallas",
                                s_limit=s_phys - 128)
    tl, tc = ttr.forward_tokens(cfg, tw, _t(toks), tc, 1020, s_limit=s_phys - 128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=5e-4)
    for p, tok in ((1028, 5), (1023, 77)):
        step = np.asarray([[tok]])
        jl, jc = jtr.forward_tokens(cfg, jw, jnp.asarray(step, jnp.int32), jc, p, impl="pallas",
                                    last_logit_only=True, s_limit=s_phys - 128)
        tl, tc = ttr.forward_tokens(cfg, tw, _t(step), tc, p, last_logit_only=True,
                                    s_limit=s_phys - 128)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=5e-4)
    assert np.abs(tc.kv.numpy().astype(np.int32) - np.asarray(jc.kv, np.int32)).max() <= 1
    np.testing.assert_allclose(tc.scale.numpy(), np.asarray(jc.scale), rtol=5e-4, atol=5e-4)
    assert all(w.launches == 0 for w in INT8_WRAPPERS)


PROMPTS = [[(7 * i + 3) % 300 for i in range(n)] for n in (5, 19, 40)]


@pytest.mark.parametrize("kind", ["engine", "batch", "paged"])
def test_engines_int8_greedy_ids_match_jax(kind):
    """With an int8 KV cache, Engine (two prefill chunks, decode windows;
    Q8_0 weights) and BatchEngine and PagedBatchEngine (3 prompts, chunks of
    16; q8_row weights, K2 + K9) give the JAX engines' (impl="pallas",
    cache_dtype=int8) greedy ids. A 128-row q8_row prefill takes the w8a8
    GEMM, whose per-token int8 activation rounding compounds the int8 cache's
    rounding flips between two packages layer by layer, so the Engine case
    serves the Q8_0 weights as block quants."""
    tm, jm = _models(256)
    if kind == "engine":
        kw = dict(cache_len=256, prefill_chunk=128, decode_window=4, rowq=False)
        prompt = [(7 * i + 3) % 300 for i in range(130)]
        ref = JEngine(jm, impl="pallas", cache_dtype=jnp.int8, aot_compile=False,
                      **kw).generate(prompt, 8).tokens
        got = Engine(tm, cache_dtype=torch.int8, device="cpu", **kw).generate(prompt, 8).tokens
    else:
        common = dict(batch_size=4, prefill_chunk=16, decode_window=4, rowq=True)
        if kind == "paged":
            je = JPagedBatchEngine(jm, block_size=8, max_len=128, impl="pallas",
                                   cache_dtype=jnp.int8, **common)
            te = PagedBatchEngine(tm, block_size=8, max_len=128, cache_dtype=torch.int8,
                                  device="cpu", **common)
            assert te.cache.quantized
        else:
            je = JBatchEngine(jm, cache_len=128, impl="pallas", cache_dtype=jnp.int8, **common)
            te = BatchEngine(tm, cache_len=128, cache_dtype=torch.int8, device="cpu", **common)
            assert te.cache.quantized
        ref = je.generate_batch(PROMPTS, 10)
        got = te.generate_batch(PROMPTS, 10)
    assert got == ref
    assert all(w.launches == 0 for w in INT8_WRAPPERS)


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("kvint8") / "llama_q8_0.gguf"
    build_tiny_gguf(path, family="llama", quant=GGMLType.Q8_0, seed=0, with_tokenizer=True)
    return path


def test_int8_warm_prefix_equals_cold(gguf):
    """With an int8 cache, a warm request equals a cold one: the single-engine
    service reuses its cached prefix (K and V rows with their scales), and
    the paged batcher maps cached full blocks (scale rows with them)."""
    model = load_model(str(gguf), param_dtype=torch.float32)
    kw = dict(cache_len=256, prefill_chunk=16, decode_window=4, cache_dtype=torch.int8,
              device="cpu")
    system = {"role": "system", "content": "You answer in one short line, always politely."}
    first = Request([system, {"role": "user", "content": "hello there"}], max_tokens=6)
    second = Request([system, {"role": "user", "content": "count to three"}], max_tokens=8)
    warm_svc = InferenceService(model, Engine(model, **kw))
    warm_svc.generate(first)
    warm = warm_svc.generate(second)
    cold = InferenceService(model, Engine(model, **kw)).generate(second)
    assert warm.cached_tokens > 0 and cold.cached_tokens == 0
    assert (warm.text, warm.completion_tokens) == (cold.text, cold.completion_tokens)

    pkw = dict(batch_size=2, block_size=4, max_len=128, prefill_chunk=8, decode_window=4,
               cache_dtype=torch.int8, device="cpu")
    pfx = list(range(3, 35, 2))
    b = ContinuousBatcher(PagedBatchEngine(model, n_blocks=40, **pkw), stop_tokens=set(),
                          interleave_decode_steps=2)
    try:
        list(b.submit(BatchRequest(pfx + [90], 2)))
        s = b.submit(BatchRequest(pfx + [50, 51], 6))
        warm_ids = list(s)
    finally:
        b.shutdown()
    cold_ids = PagedBatchEngine(model, n_blocks=40, **pkw).generate_batch([pfx + [50, 51]], 6)
    assert s.cached_tokens == 16 and b.errors == [] and warm_ids == cold_ids[0]


def test_cli_run_kv_int8_on_cpu(gguf, capsys):
    """`cli run --kv-dtype int8 --device cpu` streams text and exits 0."""
    argv = ["run", "-m", str(gguf), "-p", "hello world", "--device", "cpu", "-n", "40",
            "--kv-dtype", "int8", "--temperature", "0", "--metrics-format", "none"]
    assert cli.main(argv) == 0
    assert capsys.readouterr().out.strip()
    assert all(w.launches == 0 for w in INT8_WRAPPERS)
