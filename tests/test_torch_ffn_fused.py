"""K20 and the JAX package's VMEM-fit dispatch in the port, on the CPU:
(a) the port's fit predicates (`ffn_fused._pick_to`, `_vmem_need`,
`layer_fused._fit_tail_tiles`, `_fit_tail_tiles_kt`, `_fit_attn_tail`, and
the dispatch predicates `qkv_fits`, `tail_fits`, `attn_tail_fits`,
`ffn_fits`) equal the JAX package's over every synthetic preset and the
Phi-3-medium, Qwen2.5-14B and Mistral-Nemo-12B geometries, T = 1..32, bf16
and f32 (the JAX wrappers run with their pallas calls stubbed, so their own
checks decide); (b) K20's plain version against `ffn_fused_rowq` in interpret
mode; (c) with the VMEM budget lowered in both packages, a 24-lane
BatchEngine on a tiny q8_row model declines K9 and takes K20 on both sides,
with equal greedy ids. No launch is counted on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llamatpu.ops.ffn_fused as jff
import llamatpu.ops.layer_fused as jlf
from llamatpu.models.synthetic import PRESETS
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.models.weights import QTensor as JQTensor
from llamatpu.models.weights import prepare_qtensor, rowq_requant
from llamatpu.runtime.batch_engine import BatchEngine as JBatchEngine
from llamatpu_torch.models.synthetic import build_synthetic_model as t_build
from llamatpu_torch.models.weights import from_numpy_weights
from llamatpu_torch.ops import ffn_fused, layer_fused
from llamatpu_torch.runtime.batch_engine import BatchEngine


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


# ----------------------------------------------------------- (a) predicates
# (dim, hidden, heads, kv heads, head dim): the JAX presets' dense geometry
# (an MoE preset's dense FFN width) and three published configs where the
# fits decline: Phi-3-medium-4k, Qwen2.5-14B, Mistral-Nemo-12B
GEOMETRIES = {name: (p["dim"], p["hidden_dim"], p["n_heads"], p["n_kv_heads"], p["head_dim"])
              for name, p in PRESETS.items()}
GEOMETRIES.update({"phi3-medium": (5120, 17920, 40, 10, 128),
                   "qwen25-14b": (5120, 13824, 40, 8, 128),
                   "mistral-nemo-12b": (5120, 14336, 32, 8, 128)})
CACHES = (1152, 4224)  # physical rows of a bf16/f32 cache the fused attention takes


def _shape_q(o, i):
    """A stacked one-layer q8_row QTensor with the right shapes and no memory."""
    return JQTensor(np.broadcast_to(np.int8(0), (1, o, i)),
                    np.broadcast_to(np.float32(1), (1, o, 1)), "q8_row")


@pytest.fixture
def jax_accepts(monkeypatch):
    """The JAX wrappers with their pallas calls stubbed: each returns True
    where the wrapper would launch its kernel, False where it returns None."""
    class Launched:  # what a stubbed kernel returns; the wrappers reshape and cast it
        def reshape(self, *shape):
            return self

        def astype(self, dtype):
            return self

    def stub(*a, **k):
        return Launched()
    for name in ("_qkv_2d", "_tail_2d", "_tail_2d_kt"):
        monkeypatch.setattr(jlf, name, stub)
    monkeypatch.setattr(jlf, "_attn_tail_2d", lambda *a, **k: (Launched(), None))
    monkeypatch.setattr(jff, "_ffn_fused_2d", stub)

    def accepts(kind, t, d, f, nh, kvh, hd, dt, s_len=None):
        o_qkv, hdim = (nh + 2 * kvh) * hd, nh * hd
        x = jnp.zeros((t, d), dt)
        if kind == "qkv":
            y = jlf.qkv_norm_fused_rowq(_shape_q(o_qkv, d), jnp.ones((1, d)), x, 0, 1e-5)
        elif kind == "tail":
            y = jlf.layer_tail_fused_rowq(_shape_q(d, hdim), _shape_q(2 * f, d), _shape_q(d, f),
                                          jnp.ones((1, d)), jnp.zeros((t, hdim), dt), x, 0, 1e-5)
        elif kind == "ffn":
            y = jff.ffn_fused_rowq(_shape_q(2 * f, d), _shape_q(d, f), x, 0)
        else:  # the attention megakernel at one token over a packed cache
            kvc = np.broadcast_to(np.zeros((), dt), (1, 1, kvh, s_len, 2 * hd))
            y = jlf.layer_attn_tail_fused_rowq(
                _shape_q(d, hdim), _shape_q(2 * f, d), _shape_q(d, f), jnp.ones((1, d)),
                jnp.zeros((1, kvh, nh // kvh, hd), dt), jnp.zeros((1, kvh, 2 * hd), dt), kvc,
                jnp.zeros((1, 1, d), dt), jnp.zeros((1,), jnp.int32), 0, 1e-5, hd ** -0.5, hd)
            y = None if y is None else y[0]
        return y is not None
    return accepts


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_fit_predicates_equal_jax(name, jax_accepts):
    """For T = 1..32 in bf16 and f32: the port's copies of the JAX fit
    functions return the JAX functions' tiles, and each dispatch predicate
    accepts exactly where the JAX wrapper launches its kernel (every width
    here is a multiple of 128, so the port's width exception does not
    apply). At Phi-3-medium this is K3 declined at B = 1, K9 up to 16 rows
    and K20 at 17-24 bf16 rows, which the parent commit did not follow."""
    d, f, nh, kvh, hd = GEOMETRIES[name]
    hdim, o13, o_qkv = nh * hd, 2 * f, (nh + 2 * kvh) * hd
    assert layer_fused._aligned(d, o13, o_qkv)
    for o, i in ((d, hdim), (o13, d), (d, f), (o_qkv, d)):
        assert ffn_fused._pick_to(o, i) == jff._pick_to(o, i)
    for xb, jdt in ((2, jnp.bfloat16), (4, jnp.float32)):
        for t in range(1, 33):
            assert layer_fused._fit_tail_tiles(t, d, hdim, o13, f, xb) == \
                jlf._fit_tail_tiles(t, d, hdim, o13, f, xb)
            assert layer_fused._fit_tail_tiles_kt(t, d, hdim, o13, f, xb) == \
                jlf._fit_tail_tiles_kt(t, d, hdim, o13, f, xb)
            tp = -(-t // 8) * 8
            to13, to2 = jff._pick_to(o13, d), jff._pick_to(d, f)
            assert ffn_fused._vmem_need(tp, d, f, o13, to13, to2, xb, xb) == \
                jff._vmem_need(tp, d, f, o13, to13, to2, xb, xb)
            assert layer_fused.qkv_fits(t, o_qkv, d, xb) == \
                jax_accepts("qkv", t, d, f, nh, kvh, hd, jdt)
            assert layer_fused.tail_fits(t, d, hdim, f, xb) == \
                jax_accepts("tail", t, d, f, nh, kvh, hd, jdt)
            assert ffn_fused.ffn_fits(t, d, f, xb) == jax_accepts("ffn", t, d, f, nh, kvh, hd, jdt)
        for s_len in CACHES:
            assert layer_fused._fit_attn_tail(1, d, hdim, o13, f, kvh, nh // kvh, 2 * hd, s_len,
                                              xb, xb) == \
                jlf._fit_attn_tail(1, d, hdim, o13, f, kvh, nh // kvh, 2 * hd, s_len, xb, xb)
            assert layer_fused.attn_tail_fits(d, hdim, f, kvh, nh // kvh, hd, s_len, xb, xb) == \
                jax_accepts("attn_tail", 1, d, f, nh, kvh, hd, jdt, s_len)
    if name == "phi3-medium":
        assert not layer_fused.attn_tail_fits(d, hdim, f, kvh, 4, hd, 1152, 2, 2)
        take = ["K9" if layer_fused.tail_fits(t, d, hdim, f, 2) else
                "K20" if ffn_fused.ffn_fits(t, d, f, 2) else "two calls" for t in range(1, 33)]
        assert take == ["K9"] * 16 + ["K20"] * 8 + ["two calls"] * 8


def test_width_exception_and_budget_read_at_call_time(monkeypatch):
    """At widths that are not multiples of 128 the JAX package has no tile
    and the port keeps K2, K3 and K9 (the known difference); K20 declines
    there on both sides. The budget is read at each call."""
    assert jff._pick_to(320, 64) == 0
    assert layer_fused.qkv_fits(8, 320, 64, 4) and layer_fused.tail_fits(8, 64, 64, 96, 4)
    assert layer_fused.attn_tail_fits(64, 64, 96, 2, 2, 16, 64, 4, 4)
    assert not layer_fused.attn_tail_fits(3072, 3072, 8192, 32, 1, 96, 1152, 2, 2)  # vhd 96
    assert not ffn_fused.ffn_fits(8, 64, 96, 4)
    assert layer_fused.tail_fits(24, 384, 384, 384, 4)
    monkeypatch.setattr(ffn_fused, "_VMEM_BUDGET", BUDGET)
    assert not layer_fused.tail_fits(24, 384, 384, 384, 4)
    assert layer_fused.tail_fits(16, 384, 384, 384, 4) and ffn_fused.ffn_fits(24, 384, 384, 4)


# ------------------------------------------------------------- (b) K20 plain
L, D, F = 3, 256, 512


def _rowq(o, i, seed):
    rng = np.random.default_rng(seed)
    qs = rng.integers(-127, 128, size=(L, o, i), dtype=np.int8)
    scales = rng.random((L, o, i // 32), dtype=np.float32) * 0.01 + 0.005
    return rowq_requant(prepare_qtensor(JQTensor(qs, scales, "q8_0")))


@pytest.fixture(scope="module")
def ffn_ws():
    jw = {"w13": _rowq(2 * F, D, 11), "w2": _rowq(D, F, 12)}
    return jw, from_numpy_weights(jw)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 4, 17, 24])
def test_k20_plain_matches_pallas(ffn_ws, t, dt):
    """K20's plain version against the JAX `ffn_fused_rowq(interpret=True)`
    on the same numpy inputs, every layer: f32 at rtol = 5e-4, atol = 1e-3
    (tests/test_layer_fused.py's gate); bf16 within 1e-2 of the largest
    output (K9's bf16 gate in tests/test_torch_batch.py: act and the output
    round to bf16)."""
    jw, tw = ffn_ws
    x = (np.random.default_rng(t).normal(size=(t, 1, D)) * 0.5).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    if dt == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    for li in range(L):
        want = jff.ffn_fused_rowq(jw["w13"], jw["w2"], jx, jnp.int32(li), interpret=True)
        got = ffn_fused.ffn_fused_rowq(tw["w13"], tw["w2"], tx, li)
        assert got.shape == tx.shape and got.dtype == tx.dtype
        want = np.asarray(want.astype(jnp.float32))
        if dt == "f32":
            np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=1e-3)
        else:
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                       atol=1e-2 * np.abs(want).max())
    assert ffn_fused.ffn_fused_rowq(tw["w13"], tw["w2"], torch.zeros((33, D)), 0) is None
    assert ffn_fused.ffn_fused_rowq.launches == 0


# -------------------------------------------- (c) lowered budget, 24 lanes
# widths (multiples of 128, so the JAX package fuses and tiles them) whose
# smallest tail tiles need more VMEM than the FFN's tiles: a budget of 500 000
# bytes declines K9 at 24 f32 rows and keeps K20 (and K9 at 16-row chunks)
TINY = dict(dim=384, hidden_dim=384, n_heads=6, n_kv_heads=2, head_dim=64, vocab_size=300)
BUDGET = 500_000


def test_lowered_budget_24_lanes_take_k20_on_both_sides(monkeypatch):
    """The budget lowered in both packages (built after the patch, so no
    earlier trace is reused): the port's BatchEngine and the JAX BatchEngine
    (impl="pallas"), q8_row, f32, 24 lanes, give equal greedy ids, and both
    took the fused FFN at the 24-row decode steps and K9 nowhere there."""
    for mod in (jlf, jff, ffn_fused):
        monkeypatch.setattr(mod, "_VMEM_BUDGET", BUDGET)
    rows = {"jax_ffn": set(), "port_ffn": set(), "jax_tail": set(), "port_tail": set()}

    def spy(key, fn):
        def wrapped(*a, **k):
            y = fn(*a, **k)
            if y is not None:
                rows[key].add(int(np.prod(y.shape[:-1])))
            return y
        return wrapped
    monkeypatch.setattr(jff, "ffn_fused_rowq", spy("jax_ffn", jff.ffn_fused_rowq))
    monkeypatch.setattr(jlf, "layer_tail_fused_rowq", spy("jax_tail", jlf.layer_tail_fused_rowq))
    monkeypatch.setattr(ffn_fused, "ffn_fused_plain", spy("port_ffn", ffn_fused.ffn_fused_plain))
    monkeypatch.setattr(layer_fused, "layer_tail_plain",
                        spy("port_tail", layer_fused.layer_tail_plain))
    kw = dict(n_layers=2, dtype="f32", seed=4, context_length=64, overrides=TINY)
    common = dict(batch_size=24, cache_len=64, prefill_chunk=16, decode_window=4, rowq=True)
    te = BatchEngine(t_build("llama32-1b", **kw), cache_dtype=torch.float32, device="cpu",
                     **common)
    je = JBatchEngine(j_build("llama32-1b", **kw), impl="pallas", cache_dtype=jnp.float32,
                      **common)
    prompts = [[(5 * i + 3 * j + 1) % 300 for j in range(3 + i % 11)] for i in range(24)]
    assert te.generate_batch(prompts, 5) == je.generate_batch(prompts, 5)
    assert 24 in rows["jax_ffn"] and rows["port_ffn"] == rows["jax_ffn"]
    assert 24 not in rows["jax_tail"] | rows["port_tail"]
    assert rows["port_tail"] == rows["jax_tail"] and rows["jax_tail"]
    assert ffn_fused.ffn_fused_rowq.launches == 0
    jax.clear_caches()
