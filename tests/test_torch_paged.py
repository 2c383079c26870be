"""The paged KV pool of the port against the JAX package: K8's plain version
(`decode_attention_paged`) against `_paged_kernel` in interpret mode, the
block hashes, the allocator's tables step by step, the pool writes bit for
bit, and `forward_tokens` over a paged pool against llamatpu's
impl="pallas" forward. On the CPU every wrapper takes its plain version and
no launch is counted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tiny_models import build_tiny_gguf

from llamatpu.gguf import GGMLType
from llamatpu.models import loader as jloader
from llamatpu.models import transformer as jtr
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.models.weights import serving_weights as j_serving
from llamatpu.ops.pallas_attention import decode_attention_paged as j_paged
from llamatpu.runtime import paged_cache as jpc
from llamatpu_torch.models import transformer as ttr
from llamatpu_torch.models.loader import load_model
from llamatpu_torch.models.weights import from_numpy_weights
from llamatpu_torch.models.weights import serving_weights as t_serving
from llamatpu_torch.ops import attention
from llamatpu_torch.runtime import paged_cache as tpc

KV, G, HD = 2, 4, 64
TINY = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab_size=300)


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


def _tables(rng, bs, positions, n_blocks, maxblk, parked=()):
    """Shuffled block ids: each lane owns the blocks its rows 0..pos need,
    the rest of its row (and a parked lane's whole row) is the trash block."""
    trash = n_blocks - 1
    free = list(rng.permutation(n_blocks - 1))
    tables = np.full((len(positions), maxblk), trash, np.int32)
    for b, pos in enumerate(positions):
        if b in parked:
            continue
        for j in range(pos // bs + 1):
            tables[b, j] = free.pop()
    return tables


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_plain_matches_pallas(bs, dtype):
    """K8's plain version against decode_attention_paged(layer_index=li,
    interpret=True): shuffled tables, trash entries past each lane's
    allocation, a parked lane (every entry the trash block), positions
    across block edges (0, BS-1, BS, 3*BS+5); rtol = atol = 1e-5."""
    rng = np.random.default_rng(bs)
    positions = [0, bs - 1, bs, 3 * bs + 5, 7]
    L, n_blocks, maxblk = 2, 14, 5
    tables = _tables(rng, bs, positions, n_blocks, maxblk, parked=(4,))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pool = jnp.asarray(rng.normal(size=(L, n_blocks, KV, bs, 2 * HD)).astype(np.float32), jdt)
    q = rng.normal(size=(len(positions), KV, G, HD)).astype(np.float32)
    pv = np.asarray(positions, np.int32)
    tpool = _t(np.asarray(pool.astype(jnp.float32))).to(dtype)
    for li in range(L):
        want = np.asarray(j_paged(jnp.asarray(q, jdt), pool, jnp.asarray(tables), jnp.asarray(pv),
                                  0.125, hd=HD, interpret=True, layer_index=li))
        got = attention.decode_attention_paged(_t(q).to(dtype), tpool, _t(tables), _t(pv), 0.125,
                                               HD, li)
        assert got.dtype == torch.float32 and got.shape == (len(positions), KV, G, HD)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # unstacked pool (no layer index) reads the same layer
    got0 = attention.decode_attention_paged(_t(q).to(dtype), tpool[0], _t(tables), _t(pv), 0.125)
    want0 = attention.decode_attention_paged_plain(_t(q).to(dtype), tpool, _t(tables), _t(pv),
                                                   0.125, HD, 0)
    assert torch.equal(got0, want0)
    assert attention.decode_attention_paged.launches == 0
    with pytest.raises(NotImplementedError, match="int8-KV"):
        attention.decode_attention_paged(_t(q), tpool.to(torch.int8), _t(tables), _t(pv), 0.1,
                                         HD, 0)


def test_block_hashes_byte_equal():
    rng = np.random.default_rng(0)
    for n, bs in ((0, 4), (3, 4), (16, 4), (37, 8), (64, 16)):
        toks = rng.integers(0, 128256, n).tolist()
        assert tpc.block_hashes(toks, bs) == jpc.block_hashes(toks, bs)
    a = tpc.block_hashes(list(range(32)), 8)
    b = tpc.block_hashes([99] + list(range(1, 32)), 8)
    assert all(x != y for x, y in zip(a, b))  # a change in block 0 changes every digest


def test_block_allocator_scripted_matches_jax():
    """acquire_prefix / ensure / release with prefix registration, eviction
    of the least recently used cached block and exhaustion: the same return
    values and tables as the JAX allocator at every step."""
    bs = 4
    t, j = tpc.BlockAllocator(9, 3, 6), jpc.BlockAllocator(9, 3, 6)
    seq_a = list(range(10, 30))
    seq_b = list(range(10, 22)) + [77, 78, 79, 80]
    script = [
        ("ensure", 0, 10), ("ensure", 1, 7), ("release", 0, seq_a[:10]),
        ("acquire", 2, seq_b), ("ensure", 2, 14), ("ensure", 0, 12), ("ensure", 0, 30),
        ("release", 1, None), ("release", 2, seq_b[:14]), ("acquire", 1, seq_a),
        ("ensure", 1, 20), ("ensure", 2, 24), ("release", 1, seq_a[:20]), ("ensure", 2, 24),
        ("release", 0, None), ("release", 2, None), ("acquire", 0, seq_a), ("ensure", 0, 17),
    ]
    results = []
    for op, lane, arg in script:
        if op == "ensure":
            r = (t.ensure(lane, arg, bs), j.ensure(lane, arg, bs))
        elif op == "acquire":
            h = tpc.block_hashes(arg, bs)
            r = (t.acquire_prefix(lane, h, (len(arg) - 1) // bs),
                 j.acquire_prefix(lane, h, (len(arg) - 1) // bs))
        else:
            h = None if arg is None else tpc.block_hashes(arg, bs)
            r = (t.release(lane, h), j.release(lane, h))
        assert r[0] == r[1], (op, lane, r)
        results.append(r[0])
        assert np.array_equal(t.tables, j.tables), (op, lane)
        assert (t.free_blocks(), t.cached_blocks()) == (j.free_blocks(), j.cached_blocks())
        for lane_ in range(3):
            assert t.lane_len_capacity(lane_, bs) == j.lane_len_capacity(lane_, bs)
    # the script reaches prefix hits (2 and 3 blocks), exhaustion, and an
    # ensure that succeeds only by evicting every cached block
    assert results[3] == 2 and results[9] == 3 and results[5] is False and results[13] is True
    assert not t.ensure(0, 4 * 7, bs)  # past the lane's table


@pytest.mark.parametrize("t_len", [1, 5])
def test_paged_write_stacked_bit_equal(t_len):
    """One index write per layer for all lanes (decode T = 1, prefill T > 1)
    gives the pool JAX's `paged_write_stacked` gives, bit for bit; bf16 pool,
    f32 rows (the cast inside the write)."""
    rng = np.random.default_rng(t_len)
    bs, n_blocks, maxblk = 8, 12, 4
    positions = [3, 8, 15] if t_len == 1 else [0, 4, 10]
    tables = _tables(rng, bs, [p + t_len - 1 for p in positions], n_blocks, maxblk)
    pool = jnp.asarray(rng.normal(size=(2, n_blocks, KV, bs, 2 * HD)), jnp.bfloat16)
    new = rng.normal(size=(3, t_len, KV, 2 * HD)).astype(np.float32)
    want = jpc.paged_write_stacked(pool, 1, jnp.asarray(new), jnp.asarray(tables),
                                   jnp.asarray(positions, jnp.int32), bs)
    tpool = _t(np.asarray(pool.astype(jnp.float32))).to(torch.bfloat16)
    got = tpc.paged_write_stacked(tpool, 1, _t(new), _t(tables), _t(positions), bs)
    assert got is tpool  # in place
    assert torch.equal(got.float(), _t(np.asarray(want.astype(jnp.float32))))
    view = tpc.paged_gather(got[1], _t(tables))
    jview = jpc.paged_gather(want[1], jnp.asarray(tables))
    assert torch.equal(view.float(), _t(np.asarray(jview.astype(jnp.float32))))


def test_paged_write_past_the_table_goes_to_the_trash_block():
    """Rows past the lane's table (a padded final chunk) land in the trash
    block, never in the lane's last real block."""
    bs = 4
    pool = torch.zeros((1, 5, 1, bs, 8))
    tables = torch.tensor([[0, 1]], dtype=torch.int32)
    tpc.paged_write_stacked(pool, 0, torch.ones((1, 4, 1, 8)), tables, torch.tensor([6]), bs)
    assert pool[0, 1, 0, 2:].eq(1).all() and pool[0, 4].eq(1).any()
    assert pool[0, 1, 0, :2].eq(0).all() and pool[0, 0].eq(0).all()


@pytest.mark.parametrize("rowq", [False, True])
def test_forward_paged_matches_jax_pallas(rowq):
    """forward_tokens over a paged pool against llamatpu's forward_tokens
    (impl="pallas") on its own served weights, f32, rtol = atol = 5e-4:
    a 12-row lane prefill (the gathered view + plain masked attention; under
    rowq K2 and K9 at 12 <= 32 rows), then one decode step of 3 lanes at
    different positions (K8, and K2 + K9 under rowq) with a parked lane; the
    pools after both equal too."""
    kw = dict(n_layers=2, dtype="f32", seed=3, context_length=128, overrides=TINY)
    jm = j_build("llama32-1b", **kw)
    cfg = jm.cfg
    jw = j_serving(cfg, jm.weights, rowq=rowq)
    tw = from_numpy_weights(jax.device_get(jw))
    bs, n_blocks, maxblk = 8, 16, 4
    rng = np.random.default_rng(4)
    jcache = jpc.init_paged_cache(cfg, n_blocks, bs, jnp.float32)
    tcache = tpc.init_paged_cache(cfg, n_blocks, bs, torch.float32, device="cpu")
    tables = _tables(rng, bs, [13, 20, 9], n_blocks, maxblk)
    toks = rng.integers(0, 300, (1, 12))
    jl, jcache = jtr.forward_tokens(cfg, jw, jnp.asarray(toks, jnp.int32), jcache, 0,
                                    impl="pallas", tables=jnp.asarray(tables[1:2]))
    tl, tcache = ttr.forward_tokens(cfg, tw, _t(toks), tcache, 0, tables=_t(tables[1:2]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=5e-4)
    step = rng.integers(0, 300, (3, 1))
    pos = np.asarray([5, 12, 9], np.int32)
    dec_tables = tables.copy()
    dec_tables[2] = n_blocks - 1  # lane 2 parked at the trash block
    jl, jcache = jtr.forward_tokens(cfg, jw, jnp.asarray(step, jnp.int32), jcache,
                                    jnp.asarray(pos), impl="pallas", last_logit_only=True,
                                    tables=jnp.asarray(dec_tables))
    tl, tcache = ttr.forward_tokens(cfg, tw, _t(step), tcache, _t(pos), last_logit_only=True,
                                    tables=_t(dec_tables))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], rtol=5e-4, atol=5e-4)
    keep = np.arange(n_blocks) != n_blocks - 1  # the trash block holds whatever landed last
    np.testing.assert_allclose(tcache.kv_pool.numpy()[:, keep], np.asarray(jcache.kv_pool)[:, keep],
                               rtol=5e-4, atol=5e-4)
    assert attention.decode_attention_paged.launches == 0
    # an int8 pool carries its zeroed scale pool; other dtypes raise
    p8 = tpc.init_paged_cache(cfg, 4, 8, torch.int8, device="cpu")
    assert p8.quantized and p8.scale.shape == (2, 4, cfg.n_kv_heads, 2, 8)
    with pytest.raises(NotImplementedError, match="bf16, f32 or int8"):
        tpc.init_paged_cache(cfg, 4, 8, torch.float16, device="cpu")


def test_forward_paged_block_quant_gguf_matches_jax(tmp_path):
    """A Q8_0 GGUF (tests/tiny_models.py) loaded by each package as block
    quants, f32: a 10-token lane prefill into a shuffled paged pool, then one
    decode step of 3 lanes at per-lane positions (K5 at 3 rows, K8), against
    llamatpu's forward_tokens(impl="pallas"); logits and the pool within
    rtol = atol = 5e-4."""
    path = tmp_path / "q8.gguf"
    build_tiny_gguf(path, family="llama", quant=GGMLType.Q8_0, seed=3)
    jm = jloader.load_model(str(path), param_dtype=jnp.float32, load_tokenizer=False)
    tm = load_model(str(path), param_dtype=torch.float32, load_tokenizer=False)
    cfg = jm.cfg
    jw = j_serving(cfg, jm.weights)
    tw = t_serving(tm.cfg, tm.weights, device="cpu")
    assert tw["layers"]["wqkv"].kind == "q8_0"
    bs, n_blocks, maxblk = 8, 12, 4
    rng = np.random.default_rng(6)
    tables = _tables(rng, bs, [17, 9, 20], n_blocks, maxblk)
    jcache = jpc.init_paged_cache(cfg, n_blocks, bs, jnp.float32)
    tcache = tpc.init_paged_cache(tm.cfg, n_blocks, bs, torch.float32, device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (1, 10))
    jl, jcache = jtr.forward_tokens(cfg, jw, jnp.asarray(toks, jnp.int32), jcache, 0,
                                    impl="pallas", tables=jnp.asarray(tables[0:1]))
    tl, tcache = ttr.forward_tokens(tm.cfg, tw, _t(toks), tcache, 0, tables=_t(tables[0:1]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=5e-4)
    step = rng.integers(0, cfg.vocab_size, (3, 1))
    pos = np.asarray([10, 3, 20], np.int32)
    jl, jcache = jtr.forward_tokens(cfg, jw, jnp.asarray(step, jnp.int32), jcache,
                                    jnp.asarray(pos), impl="pallas", last_logit_only=True,
                                    tables=jnp.asarray(tables))
    tl, tcache = ttr.forward_tokens(tm.cfg, tw, _t(step), tcache, _t(pos), last_logit_only=True,
                                    tables=_t(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(tcache.kv_pool.numpy(), np.asarray(jcache.kv_pool),
                               rtol=5e-4, atol=5e-4)
