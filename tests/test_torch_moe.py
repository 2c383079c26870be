"""The port's MoE slice on the CPU against the JAX package: `sort_by_expert`
bit-equal; the plain versions of K10-K13 (the grouped expert matmuls)
against `grouped_matmul` in interpret mode; the MoE load transforms
(`fold_shared_expert`, the MoE `fuse_layer_weights`, `rowq_convert_weights`
with the expert stacks, the synthetic preset) bit-equal through the bridge;
and `_moe_ffn` and `forward_tokens` against impl="pallas", folded and
unfolded. On the CPU no kernel launch is counted.

The shrunken Qwen1.5-MoE preset keeps every width a multiple of 128, so the
JAX package pads no rows and both packages fold its shared expert (hidden 512
over moe_hidden 128: four virtual experts)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamatpu.models import synthetic as jsyn
from llamatpu.models import transformer as jtr
from llamatpu.models import weights as jw
from llamatpu.ops import moe_grouped as jmg
from llamatpu_torch.models import synthetic as tsyn
from llamatpu_torch.models import transformer as ttr
from llamatpu_torch.models import weights as tw
from llamatpu_torch.ops import moe_grouped as tmg

MOE = dict(dim=128, hidden_dim=512, moe_hidden_dim=128, n_experts=8, n_experts_used=2,
           n_heads=2, n_kv_heads=2, head_dim=64, vocab_size=300)
KERNELS = (tmg.grouped_block_matmul, tmg.grouped_packed4_matmul, tmg.grouped_rowq_matmul,
           tmg.grouped_dense_matmul)


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


def _models(seed=3, n_layers=2, **over):
    kw = dict(n_layers=n_layers, dtype="f32", seed=seed, context_length=256,
              overrides={**MOE, **over})
    return (tsyn.build_synthetic_model("qwen15-moe-a2.7b", **kw),
            jsyn.build_synthetic_model("qwen15-moe-a2.7b", **kw))


def _routing(n, k, e, seed):
    """Distinct expert ids per token (as top-k gives), expert 3 never used."""
    rng = np.random.default_rng(seed)
    ids = [i for i in range(e) if i != 3]
    return np.stack([rng.choice(ids, size=k, replace=False) for _ in range(n)]).astype(np.int32)


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("tm", [8, 32, 128])
@pytest.mark.parametrize("n", [1, 2, 16, 33, 200])
def test_sort_by_expert_bit_equal(n, tm):
    """row_token, row_src and tile_expert equal the JAX package's, k = 6 of
    E = 12 experts (one never routed to), N = 1 through the fast path."""
    top_i = _routing(n, 6, 12, seed=n * tm)
    got = tmg.sort_by_expert(_t(top_i), 12, tm)
    want = jmg.sort_by_expert(jnp.asarray(top_i), 12, tm)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape[0] == tmg.sorted_rows(n, 6, 12, tm)


# ----------------------------------------------------------------- K10-K13
def _jax_stack(rng, shape, kind, pack4):
    """A stacked expert weight [L, E, O, I] as the JAX package serves it, and
    the same weight through the bridge."""
    if kind == "f32":
        w = (rng.normal(size=shape) / np.sqrt(shape[-1])).astype(np.float32)
        return w, _t(w)
    base = "q4_0" if kind == "q4_0" else "q8_0"
    lo, hi = (-8, 8) if base == "q4_0" else (-127, 128)
    qs = rng.integers(lo, hi, size=shape, dtype=np.int8)
    sc = rng.random((*shape[:-1], shape[-1] // 32), dtype=np.float32) * 0.001 + 0.0005
    w = jw.prepare_qtensor(jw.QTensor(qs, sc * (16 if base == "q4_0" else 1), base),
                           pack4=pack4)
    if kind == "q8_row":
        w = jw.rowq_requant(w)
    return w, tw.from_numpy_weights({"w": w})["w"]


@pytest.mark.parametrize("tm", [8, 32])
@pytest.mark.parametrize("kind,pack4", [("q8_0", False), ("q4_0", False), ("q4_0", True),
                                        ("q8_row", False), ("f32", False)])
def test_grouped_plain_matches_pallas(kind, pack4, tm):
    """Each plain version against `grouped_matmul(..., interpret=True)` on
    layer 1 of a stacked [2, E, O, I] weight, on the same routing tables
    (an expert with zero rows, -1 tail tiles), f32: rtol = atol = 2e-4, the
    JAX package's own gate (tests/test_moe_grouped.py)."""
    rng = np.random.default_rng(tm + len(kind))
    e, o, i, n, k = 6, 128, 256, 5 if tm == 8 else 24, 2
    jwt, twt = _jax_stack(rng, (2, e, o, i), kind, pack4)
    top_i = _routing(n, k, e, seed=7)
    rt, rs, te = tmg.sort_by_expert(_t(top_i), e, tm)
    assert (te == -1).any() and 3 not in te.tolist()
    x = rng.normal(size=(rt.shape[0], i)).astype(np.float32)
    x[(rt == n).numpy()] = 0.0  # pad rows gather the zero row
    want = np.asarray(jmg.grouped_matmul(jwt, jnp.asarray(x), jnp.asarray(te.numpy()), tm,
                                         interpret=True, li=1))
    got = tmg.grouped_matmul(twt, _t(x), te, tm, li=1, row_token=rt, n_tokens=n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert not got[(te.repeat_interleave(tm) == -1)].any()
    assert all(f.launches == 0 for f in KERNELS)


def test_grouped_dispatch_routes_by_weight_kind(monkeypatch):
    """grouped_matmul takes K10 for canonical Q8_0 / Q4_0, K11 for packed4,
    K12 for q8_row and K13 for dense stacks; native K-quants take K10 on
    their values and K13 on their offset term (offsets padded as the load
    pads them)."""
    calls = []
    for f in KERNELS:
        monkeypatch.setattr(tmg, f.__name__, lambda *a, _n=f.__name__, **k:
                            calls.append(_n) or torch.zeros((8, 32)))
    x, te = torch.zeros((8, 64)), torch.zeros(1, dtype=torch.int32)
    q = torch.zeros((1, 32, 64), dtype=torch.int8)
    for w in (tw.QTensor(q, torch.zeros((1, 32, 2)), "q8_0"),
              tw.QTensor(q[..., :32], torch.zeros((1, 32, 2)), "q4_0", layout="packed4"),
              tw.QTensor(q, torch.zeros((1, 32, 1)), "q8_row"), torch.zeros((1, 32, 64))):
        tmg.grouped_matmul(w, x, te, 8)
    assert calls == [f.__name__ for f in KERNELS]
    calls.clear()
    tmg.grouped_matmul(tw.pad_offsets(tw.QTensor(q, torch.zeros((1, 32, 2)), "q4_k",
                                                 offs=torch.zeros((1, 32, 2)))), x, te, 8)
    assert calls == ["grouped_block_matmul", "grouped_dense_matmul"]


def test_grouped_bf16_rounds_act_once_from_f32():
    """grouped_ffn's act is silu(gate) * up in f32 rounded once to the
    activation dtype (not the dense chain's silu(gate.f32).to(bf16) * up),
    and its combine is deterministic: the same call twice gives the same
    bits."""
    tm_, _ = _models(n_layers=1)
    sw = tw.serving_weights(tm_.cfg, tm_.weights, device="cpu")["layers"]
    rng = np.random.default_rng(2)
    hf = _t(rng.normal(size=(9, 128)).astype(np.float32)).to(torch.bfloat16)
    top_i = _t(_routing(9, 2, 8, 1)).long()
    top_w = torch.rand((9, 2))
    a = tmg.moe_ffn_grouped(tm_.cfg, hf, top_w, top_i, sw, tm=32, li=0, n_experts=12)
    b = tmg.moe_ffn_grouped(tm_.cfg, hf, top_w, top_i, sw, tm=32, li=0, n_experts=12)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    rt, rs, te = tmg.sort_by_expert(top_i, 12, 32)
    xs = torch.cat([hf, hf.new_zeros((1, 128))])[rt.long()]
    g13 = tmg.grouped_matmul(sw["gu_exps"], xs, te, 32, li=0)
    act = (torch.nn.functional.silu(g13[:, :128]) * g13[:, 128:]).to(torch.bfloat16)
    down = tmg.grouped_matmul(sw["down_exps"], act, te, 32, li=0)
    w_pad = torch.cat([top_w.reshape(-1), torch.zeros(1)])[rs.long()]
    onehot = (rt[None, :] == torch.arange(9)[:, None]).float()
    np.testing.assert_allclose(a.numpy(), (onehot @ (down * w_pad[:, None])).numpy(),
                               rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- weights
def _assert_qt_equal(a, b, key):
    assert (a.kind, a.layout) == (b.kind, b.layout), key
    np.testing.assert_array_equal(np.asarray(a.qs), np.asarray(b.qs), key)
    np.testing.assert_array_equal(np.asarray(a.scales), np.asarray(b.scales), key)


def _assert_layers_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], tw.QTensor):
            _assert_qt_equal(got[k], want[k], k)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), k)


def test_synthetic_moe_preset_bit_exact():
    """The same RNG stream as the JAX package's preset, so every array is
    equal (the JAX side bridged: interleaved columns made canonical)."""
    port, ref = _models()
    assert port.cfg.__dict__ == {**ref.cfg.__dict__, "family": port.cfg.family}
    _assert_layers_equal(port.weights["layers"], tw.from_numpy_weights(ref.weights)["layers"])
    assert port.weights["layers"]["gate_exps"].qs.shape == (2, 8, 128, 128)


@pytest.mark.parametrize("pack4", [False, True])
def test_fold_and_fuse_bit_exact(pack4):
    """fold_shared_expert and the MoE fuse_layer_weights equal the JAX
    package's through the bridge (Q8_0, and Q4_0 packed4: the port cuts the
    down chunks in its own canonical packed layout); the fold appends S = 4
    virtual experts and consumes the shared_* keys."""
    rng = np.random.default_rng(1)
    L, E, MH, D, S = 2, 3, 64, 128, 4
    kind = "q4_0" if pack4 else "q8_0"
    shapes = {"gate_exps": (L, E, MH, D), "up_exps": (L, E, MH, D), "down_exps": (L, E, D, MH),
              "shared_gate": (L, S * MH, D), "shared_up": (L, S * MH, D),
              "shared_down": (L, D, S * MH)}
    jl = {}
    for k, shape in shapes.items():
        lo, hi = (-8, 8) if pack4 else (-127, 128)
        jl[k] = jw.QTensor(rng.integers(lo, hi, size=shape, dtype=np.int8),
                           rng.random((*shape[:-1], shape[-1] // 32), dtype=np.float32), kind)
    # the JAX package's serving layout: columns interleaved (and packed), rows unpadded
    jl = {k: jw.QTensor(jw.interleave_columns(np.asarray(v.qs)), v.scales, kind,
                        layout="interleaved") for k, v in jl.items()}
    if pack4:
        jl = {k: jw.QTensor(jw.pack4_columns(np.asarray(v.qs)), v.scales, kind, layout="packed4")
              for k, v in jl.items()}
    tl = tw.from_numpy_weights(jl)
    folded = tw.fold_shared_expert(None, tl)
    _assert_layers_equal(folded, tw.from_numpy_weights(jw.fold_shared_expert(None, jl)))
    assert folded["gate_exps"].qs.shape[1] == E + S and "shared_gate" not in folded
    cfg = type("C", (), {"is_moe": True})()
    fused = tw.fuse_layer_weights(cfg, {"layers": tl})["layers"]
    want = tw.from_numpy_weights(jax.device_get(jw.fuse_layer_weights(cfg, {"layers": jl})))
    _assert_layers_equal(fused, want["layers"])
    assert set(fused) == {"gu_exps", "down_exps"}


def test_fold_escape_hatch_and_unfoldable_stacks(monkeypatch):
    """LLAMATPU_NO_SHARED_FOLD (the JAX package's name) keeps the shared
    expert explicit, fused as shared_g13; so does a shared hidden size that
    is not a multiple of the routed one."""
    port, _ = _models(n_layers=1)
    monkeypatch.setenv("LLAMATPU_NO_SHARED_FOLD", "1")
    lw = tw.fuse_layer_weights(port.cfg, port.weights)["layers"]
    assert {"gu_exps", "shared_g13", "shared_down"} <= set(lw)
    assert lw["gu_exps"].qs.shape[1] == 8
    monkeypatch.delenv("LLAMATPU_NO_SHARED_FOLD")
    odd, _ = _models(n_layers=1, hidden_dim=384, moe_hidden_dim=256)
    assert "shared_g13" in tw.fuse_layer_weights(odd.cfg, odd.weights)["layers"]


@pytest.mark.parametrize("experts", [True, False])
def test_moe_rowq_convert_bit_exact(experts):
    """The MoE tree's q8_row conversion, the expert stacks converted layer
    by layer (experts=True) or kept Q8_0, equals the JAX package's
    serving_weights(..., rowq=True, rowq_experts=...)."""
    port, ref = _models()
    got = tw.serving_weights(port.cfg, port.weights, rowq=True, rowq_experts=experts,
                             device="cpu")
    want = tw.from_numpy_weights(jax.device_get(
        jw.serving_weights(ref.cfg, ref.weights, rowq=True, rowq_experts=experts)))
    _assert_layers_equal(got["layers"], want["layers"])
    _assert_qt_equal(got["wcls"], tw.QTensor(want["wcls"].qs[:300], want["wcls"].scales[:300],
                                             "q8_row"), "wcls")
    assert got["layers"]["gu_exps"].kind == ("q8_row" if experts else "q8_0")
    # per layer equals per matrix (the JAX package's loop)
    one = port.weights["layers"]["gate_exps"]
    per_layer = tw.rowq_requant(one)
    flat = tw.rowq_requant(tw.QTensor(one.qs.reshape(-1, 128, 128), one.scales.reshape(-1, 128, 4),
                                      "q8_0"))
    assert np.array_equal(per_layer.qs.reshape(-1, 128, 128), flat.qs)
    assert np.array_equal(per_layer.scales.reshape(-1, 128, 1), flat.scales)


# ----------------------------------------------------------------- forward
def _layer_tree(jsw, li):
    return jax.tree.map(lambda a: a[li], jsw["layers"])


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("n", [1, 2, 16, 33])
def test_moe_ffn_matches_jax_pallas(n, fold, monkeypatch):
    """_moe_ffn of layer 1 against the JAX package's impl="pallas" (grouped
    kernels in interpret mode) on its own served weights through the bridge,
    f32: rtol = atol = 2e-4. fold=False sets LLAMATPU_NO_SHARED_FOLD for
    both packages (the explicit shared expert)."""
    if not fold:
        monkeypatch.setenv("LLAMATPU_NO_SHARED_FOLD", "1")
    _, jm = _models(seed=9)
    jsw = jw.serving_weights(jm.cfg, jm.weights)
    tsw = tw.from_numpy_weights(jax.device_get(jsw))
    assert ("shared_g13" in tsw["layers"]) is not fold
    h = np.random.default_rng(n).normal(size=(1, n, 128)).astype(np.float32)
    want = np.asarray(jtr._moe_ffn(jm.cfg, jnp.asarray(h), _layer_tree(jsw, 1), "pallas"))
    got = ttr._moe_ffn(jm.cfg, _t(h), tsw["layers"], 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rowq", [False, True])
def test_forward_matches_jax_and_folded_equals_unfolded(rowq, monkeypatch):
    """A 33-token prefill (tm = 32 over 33 x 6 assignments) and two decode
    steps (tm = 8, the N = 1 fast path) through forward_tokens against the
    JAX package's impl="pallas", f32: logits and cache within 5e-4. Without
    rowq the unfolded model (explicit shared expert) gives the same logits
    within 3e-4 (with rowq the two requantize the shared expert's down rows
    over different widths). qkv bias is live (nonzero biases)."""
    tm_, jm = _models(seed=4)
    rng = np.random.default_rng(0)
    for k in ("q_bias", "k_bias", "v_bias"):
        b = rng.normal(size=jm.weights["layers"][k].shape).astype(np.float32) * 0.1
        jm.weights["layers"][k] = b
        tm_.weights["layers"][k] = b
    cfg = tm_.cfg
    jsw = jw.serving_weights(jm.cfg, jm.weights, rowq=rowq)
    tsw = tw.serving_weights(cfg, tm_.weights, rowq=rowq, device="cpu")
    toks = rng.integers(0, 300, (1, 33))

    def run_port(weights):
        cache = ttr.init_cache(cfg, 1, torch.float32, device="cpu")
        out = [ttr.forward_tokens(cfg, weights, _t(toks), cache, 0)[0]]
        for pos, tok in ((33, 5), (34, 77)):
            out.append(ttr.forward_tokens(cfg, weights, torch.tensor([[tok]]), cache, pos,
                                          last_logit_only=True)[0])
        return out, cache

    got, cache = run_port(tsw)
    jcache = jtr.init_cache(jm.cfg, 1, jnp.float32)
    want = [jtr.forward_tokens(jm.cfg, jsw, jnp.asarray(toks, jnp.int32), jcache, 0,
                               impl="pallas")]
    jcache = want[0][1]
    for pos, tok in ((33, 5), (34, 77)):
        want.append(jtr.forward_tokens(jm.cfg, jsw, jnp.asarray([[tok]], jnp.int32), jcache, pos,
                                       impl="pallas", last_logit_only=True))
        jcache = want[-1][1]
    for g, (w, _) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(cache.kv.numpy(), np.asarray(jcache.kv), rtol=5e-4, atol=5e-4)
    if not rowq:
        monkeypatch.setenv("LLAMATPU_NO_SHARED_FOLD", "1")
        unfolded, _ = run_port(tw.serving_weights(cfg, tm_.weights, device="cpu"))
        for a, b in zip(unfolded, got):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4, atol=3e-4)
    assert all(f.launches == 0 for f in KERNELS)
