"""Long context in the port against the JAX package: K14 (`_split_kernel`'s
dense callers: fused, unfused, stats) and K15 (`_full_kernel`) plain versions
against the Pallas kernels in interpret mode, the cross-shard combine of K14's
statistics, the forward at long bf16 and f32 caches against llamatpu's
impl="pallas" forward, and the decode dispatch: for every row of the JAX
package's kernel table the port calls the counterpart of the kernel the JAX
forward calls. On the CPU every wrapper takes its plain version and no
launch is counted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llamatpu.ops.layer_fused as jlf
import llamatpu.ops.pallas_attention as jpa
from llamatpu.models import transformer as jtr
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.models.weights import serving_weights as j_serving
from llamatpu.runtime import paged_cache as jpc
from llamatpu_torch.models import transformer as ttr
from llamatpu_torch.models.weights import from_numpy_weights
from llamatpu_torch.ops import attention, layer_fused
from llamatpu_torch.runtime import paged_cache as tpc

TINY = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab_size=300)
L, KV, G, HD = 2, 2, 4, 64
SCALE = 0.125


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


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _dtypes(name):
    return {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[name]


# positions: tile 0, both sides of a 64-row tile boundary, the last row, and
# two lanes at different positions in each call
POSITIONS = ([0, 63], [64, 255], [130, 5])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_split_plain_matches_pallas(dt):
    """K14's plain versions (fused, unfused, stats) against
    decode_attention_split_fused_write / decode_attention_split /
    decode_attention_split_stats (interpret mode, s_tile 64, stacked cache):
    the cache after each fused write bit-equal, outputs and m, l within
    rtol = atol = 1e-5."""
    jdt, tdt = _dtypes(dt)
    rng = np.random.default_rng(1)
    S = 256
    kvc = jnp.asarray(rng.normal(size=(L, 2, KV, S, 2 * HD)).astype(np.float32), jdt)
    tc = _t(_f32(kvc)).to(tdt)
    for pos in POSITIONS:
        q = rng.normal(size=(2, KV, G, HD)).astype(np.float32)
        kvn = rng.normal(size=(2, KV, 2 * HD)).astype(np.float32)
        pv = np.asarray(pos, np.int32)
        jq, jpv = jnp.asarray(q, jdt), jnp.asarray(pv)
        jout, kvc = jpa.decode_attention_split_fused_write(jq, jnp.asarray(kvn, jdt), kvc, jpv,
                                                           SCALE, 1, hd=HD, s_tile=64,
                                                           interpret=True)
        out, tc2 = attention.decode_attention_split_fused_write(_t(q).to(tdt), _t(kvn).to(tdt),
                                                                tc, _t(pv), SCALE, 1, HD, 64)
        assert tc2 is tc  # written in place
        assert torch.equal(tc.float(), _t(_f32(kvc)))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
        for li in range(L):
            want = jpa.decode_attention_split(jq, kvc, jpv, SCALE, hd=HD, s_tile=64,
                                              interpret=True, layer_index=li)
            got = attention.decode_attention_split(_t(q).to(tdt), tc, _t(pv), SCALE, HD, 64, li)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        jo, jm, jl = jpa.decode_attention_split_stats(jq, kvc[0], jpv, SCALE, hd=HD, s_tile=64,
                                                      interpret=True)
        o, m, l = attention.decode_attention_split_stats(_t(q).to(tdt), tc[0], _t(pv), SCALE, HD,
                                                         64)
        assert m.shape == l.shape == (2, KV, G, 1)
        for got, want in ((o, jo), (m, jm), (l, jl)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="tile"):
        attention.decode_attention_split(_t(q), tc, _t(pv), SCALE, HD, 96, 0)
    assert attention.decode_attention_split_fused_write.launches == 0
    assert attention.decode_attention_split.launches == 0


def test_split_stats_two_shard_combine_equals_one_call():
    """Two half-stripe shards of the port's K14 stats, combined with
    exp(m - max m) * l weights (the sequence-parallel combine), equal one K14
    call over the whole stripe (as test_split_stats_cross_shard_combine)."""
    rng = np.random.default_rng(21)
    B, S = 2, 256
    q = _t(rng.standard_normal((B, KV, G, HD)).astype(np.float32))
    kvc = _t(rng.standard_normal((B, KV, S, 2 * HD)).astype(np.float32))
    for pos_list in ([10, 100], [127, 128], [200, 255], [5, 60]):
        pos = torch.tensor(pos_list)
        want = attention.decode_attention_split(q, kvc, pos, 0.2, HD, 64)
        parts = []
        for sh in range(2):
            off = sh * 128
            o, m, l = attention.decode_attention_split_stats(
                q, kvc[:, :, off:off + 128].contiguous(), torch.clamp(pos - off, 0, 127), 0.2,
                HD, 64)
            valid = ((pos - off) >= 0)[:, None, None, None]
            parts.append((o, torch.where(valid, m, torch.full_like(m, -1e30)), l, valid))
        m_g = torch.maximum(parts[0][1], parts[1][1])
        num = den = 0.0
        for o, m, l, valid in parts:
            w = torch.where(valid, torch.exp(m - m_g) * l, torch.zeros_like(l))
            num, den = num + w * o, den + w
        np.testing.assert_allclose((num / den).numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_full_plain_matches_pallas(dt):
    """K15's plain version against decode_attention (interpret mode) over the
    first s_use rows of a stacked cache, lanes below s_use and one at the
    last physical row (a parked lane, which attends every s_use row);
    rtol = atol = 1e-5."""
    jdt, tdt = _dtypes(dt)
    rng = np.random.default_rng(2)
    S, s_use = 136, 104
    kvc = jnp.asarray(rng.normal(size=(L, 2, KV, S, 2 * HD)).astype(np.float32), jdt)
    tc = _t(_f32(kvc)).to(tdt)
    for pos in ([0, 63], [64, 103], [100, S - 1]):
        q = rng.normal(size=(2, KV, G, HD)).astype(np.float32)
        pv = np.asarray(pos, np.int32)
        for li, su in ((0, s_use), (1, None)):
            want = jpa.decode_attention(jnp.asarray(q, jdt), kvc, jnp.asarray(pv), SCALE, hd=HD,
                                        interpret=True, s_use=su, layer_index=li)
            got = attention.decode_attention(_t(q).to(tdt), tc, _t(pv), SCALE, HD, su, li)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert attention.decode_attention.launches == 0


def _models(ctx, layers=2):
    jm = j_build("llama32-1b", n_layers=layers, dtype="f32", seed=5, context_length=ctx,
                 overrides=TINY)
    jw = j_serving(jm.cfg, jm.weights, rowq=True)
    return jm.cfg, jw, from_numpy_weights(jax.device_get(jw))


@pytest.mark.parametrize("dt,s_phys", [("f32", 5120), ("bf16", 9216)])
def test_forward_long_cache_matches_jax(dt, s_phys):
    """forward_tokens at a long cache (f32 from 4096 rows, bf16 from 8192)
    against llamatpu's forward_tokens(impl="pallas"): an 8-token window at
    pos 1020, then decode steps at 1028 and 1023 (the fused K14 across the
    1024-row tile boundary); logits within rtol = atol = 5e-4, the caches
    too."""
    jdt, tdt = _dtypes(dt)
    cfg, jw, tw = _models(s_phys)
    jc, tc = jtr.init_cache(cfg, 1, jdt, s_phys), ttr.init_cache(cfg, 1, tdt, s_phys,
                                                                 device="cpu")
    lim = s_phys - 128
    toks = np.random.default_rng(0).integers(0, 300, (1, 8))
    jl, jc = jtr.forward_tokens(cfg, jw, jnp.asarray(toks, jnp.int32), jc, 1020, impl="pallas",
                                s_limit=lim)
    tl, tc = ttr.forward_tokens(cfg, tw, _t(toks), tc, 1020, s_limit=lim)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=5e-4)
    for p, tok in ((1028, 5), (1023, 77)):
        step = np.asarray([[tok]])
        jl, jc = jtr.forward_tokens(cfg, jw, jnp.asarray(step, jnp.int32), jc, p, impl="pallas",
                                    last_logit_only=True, s_limit=lim)
        tl, tc = ttr.forward_tokens(cfg, tw, _t(step), tc, p, last_logit_only=True, s_limit=lim)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(tc.kv.float().numpy(), _f32(jc.kv), rtol=5e-4, atol=5e-4)
    assert attention.decode_attention_split_fused_write.launches == 0


# One decode step per row of the JAX package's kernel table: (cache dtype,
# physical length, switch, paged) -> the JAX function called and the port's
# plain version that the CPU wrapper takes. switch: True sets
# LLAMATPU_NO_FUSED_ATTN; NO_ATTN_TAIL sets LLAMATPU_NO_ATTN_TAIL, and then the
# step takes K6 + K9 (the layer tail is recorded too) instead of K3.
NO_ATTN_TAIL = "LLAMATPU_NO_ATTN_TAIL"
DISPATCH = [
    ("bf16", 1152, False, False, "layer_attn_tail_fused_rowq", "layer_attn_tail_plain"),
    ("f32", 1152, False, False, "layer_attn_tail_fused_rowq", "layer_attn_tail_plain"),
    ("int8", 1152, False, False, "decode_attention_fused_write_q",
     "decode_attention_fused_write_q_plain"),
    ("bf16", 9216, False, False, "decode_attention_split_fused_write",
     "decode_attention_split_fused_write_plain"),
    ("f32", 4096, False, False, "decode_attention_split_fused_write",
     "decode_attention_split_fused_write_plain"),
    ("int8", 17408, False, False, "decode_attention_split_fused_write_q",
     "decode_attention_split_fused_write_q_plain"),
    ("f32", 4128, False, False, "decode_attention", "decode_attention_plain"),
    ("bf16", 1152, True, False, "decode_attention", "decode_attention_plain"),
    ("int8", 1152, True, False, "decode_attention_q", "decode_attention_q_plain"),
    ("bf16", 9216, True, False, "decode_attention_split", "decode_attention_split_plain"),
    ("int8", 17408, True, False, "decode_attention_split_q", "decode_attention_split_q_plain"),
    ("int8", 64, False, True, "decode_attention_paged", "decode_attention_paged_q_plain"),
    ("bf16", 1152, NO_ATTN_TAIL, False, "decode_attention_fused_write+layer_tail_fused_rowq",
     "decode_attention_fused_write_plain+layer_tail_plain"),
]
JAX_NAMES = ("decode_attention", "decode_attention_q", "decode_attention_split",
             "decode_attention_split_q", "decode_attention_fused_write",
             "decode_attention_fused_write_q", "decode_attention_split_fused_write",
             "decode_attention_split_fused_write_q", "decode_attention_paged")
PORT_PLAIN = [n + "_plain" for n in JAX_NAMES] + ["decode_attention_paged_q_plain"]


@pytest.mark.parametrize("dt,s_phys,no_fused,paged,jax_fn,port_fn", DISPATCH)
def test_decode_dispatch_follows_jax(monkeypatch, dt, s_phys, no_fused, paged, jax_fn, port_fn):
    """A q8_row decode step at B = 1 on a 1-layer model (pos 1030, or 40 on
    short caches): the JAX forward's kernel choice and the plain version the
    port calls, recorded, are the table's; the logits agree within
    rtol = atol = 5e-4."""
    calls = {"jax": [], "port": []}

    def rec(side, name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if out is not None:  # the JAX megakernel returns None where it declines
                calls[side].append(name)
            return out
        return wrapped

    for name in JAX_NAMES:
        monkeypatch.setattr(jpa, name, rec("jax", name, getattr(jpa, name)))
    monkeypatch.setattr(jlf, "layer_attn_tail_fused_rowq",
                        rec("jax", "layer_attn_tail_fused_rowq", jlf.layer_attn_tail_fused_rowq))
    for name in PORT_PLAIN:
        monkeypatch.setattr(attention, name, rec("port", name, getattr(attention, name)))
    monkeypatch.setattr(layer_fused, "layer_attn_tail_plain",
                        rec("port", "layer_attn_tail_plain", layer_fused.layer_attn_tail_plain))
    if no_fused == NO_ATTN_TAIL:
        monkeypatch.setenv(NO_ATTN_TAIL, "1")
        monkeypatch.setattr(jlf, "layer_tail_fused_rowq",
                            rec("jax", "layer_tail_fused_rowq", jlf.layer_tail_fused_rowq))
        monkeypatch.setattr(layer_fused, "layer_tail_plain",
                            rec("port", "layer_tail_plain", layer_fused.layer_tail_plain))
    elif no_fused:
        monkeypatch.setenv("LLAMATPU_NO_FUSED_ATTN", "1")
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[dt]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dt]
    cfg, jw, tw = _models(max(s_phys, 2048), layers=1)
    pos = 1030 if s_phys > 2048 else 40
    step = np.asarray([[11]])
    kw = dict(last_logit_only=True)
    if paged:
        tables = np.arange(4, dtype=np.int32)[None]
        jc = jpc.init_paged_cache(cfg, 5, 16, jdt)
        tc = tpc.init_paged_cache(cfg, 5, 16, tdt, device="cpu")
        jkw, tkw = dict(kw, tables=jnp.asarray(tables)), dict(kw, tables=_t(tables))
    else:
        jc, tc = jtr.init_cache(cfg, 1, jdt, s_phys), ttr.init_cache(cfg, 1, tdt, s_phys,
                                                                     device="cpu")
        jkw = tkw = dict(kw, s_limit=s_phys - 128)
    jl, _ = jtr.forward_tokens(cfg, jw, jnp.asarray(step, jnp.int32), jc, pos, impl="pallas",
                               **jkw)
    tl, _ = ttr.forward_tokens(cfg, tw, _t(step), tc, pos, **tkw)
    assert calls == {"jax": jax_fn.split("+"), "port": port_fn.split("+")}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=5e-4)
