"""The port's quantization-parity harness (llamatpu_torch/bench/parity.py) on
the CPU against the JAX package's (llamatpu/bench/parity.py): every
variant's weights bit for bit (the 13 on tests/test_parity_gate.py's
"llama" shape, its MoE shape's six, and the heavy spectrum), the ppl of
six variants on one shared corpus (JAX's sample_corpus), and the port's
own parity_table on the gate's five shapes inside the gate's bounds."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamatpu.bench import parity as jp
from llamatpu.bench.perplexity import perplexity as j_perplexity
from llamatpu.models.transformer import _index_qtensor
from llamatpu.ops import int8_prefill as j_int8_prefill
from llamatpu_torch.bench import parity as tp
from llamatpu_torch.models.weights import QTensor, from_numpy_weights
from llamatpu_torch.ops import int8_prefill as t_int8_prefill
from llamatpu_torch.ops.matmul import matmul

_COMMON = dict(vocab_size=512, context_length=128)
# tests/test_parity_gate.py's SHAPES (preset, variants, overrides[, spectrum])
SHAPES = {
    "llama": ("llama32-1b", None,
              dict(n_layers=2, dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64,
                   **_COMMON)),
    "qwen2-bias": ("qwen25-1.5b", ("f32", "q8_0", "q4_0"),
                   dict(n_layers=2, dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2,
                        head_dim=64, **_COMMON)),
    "qwen2-moe": ("qwen15-moe-a2.7b", ("f32", "q8_0", "q4_0", "q4_0-pack4", "q4_k", "q8_row"),
                  dict(n_layers=2, dim=128, hidden_dim=256, n_heads=4, n_kv_heads=4,
                       head_dim=32, n_experts=8, n_experts_used=4, moe_hidden_dim=64,
                       **_COMMON)),
    "granite": ("granite-3.2-2b", ("f32", "q8_0", "q4_0"),
                dict(n_layers=2, dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64,
                     **_COMMON)),
    "llama-heavy": ("llama32-1b", ("f32", "q8_0", "q8_row", "q8_row-noeq", "q4_0"),
                    dict(n_layers=2, dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2,
                         head_dim=64, **_COMMON), "heavy"),
}
_HEAVY_BOUNDS = {"q8_0": 0.05, "q8_0-int8dot": 0.05, "q8_0-kvint8": 0.06,
                 "q8_row": 0.09, "q8_row-a8": 0.12, "q4_0": 4.0, "q4_k": 4.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one intra-op thread: the test workers and the JAX
    compiler share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def masters():
    """(port master, JAX master) of each shape, seed 1 as the gate's."""
    out = {}
    for name, (preset, _, ov, *spec) in SHAPES.items():
        t, j = tp.build_master(preset, seed=1, **ov), jp.build_master(preset, seed=1, **ov)
        if spec:
            t, j = tp.apply_spectrum(t, spec[0]), jp.apply_spectrum(j, spec[0])
        out[name] = (t, j)
    return out


def _same(port, jax_value, key):
    """A port weight equals the JAX package's bit for bit, read through the
    weights bridge (padded rows sliced to the logical ones)."""
    j = from_numpy_weights(jax_value)
    if isinstance(port, QTensor):
        assert isinstance(j, QTensor) and (port.kind, port.layout) == (j.kind, j.layout), key
        lo = j.logical_out or j.qs.shape[-2]
        for a, b in ((port.qs, j.qs), (port.scales, j.scales), (port.offs, j.offs)):
            assert (a is None) == (b is None), key
            if a is not None:
                assert np.array_equal(np.asarray(a), b[..., :lo, :].numpy()), key
        return
    a = port if isinstance(port, torch.Tensor) else torch.from_numpy(np.asarray(port))
    assert a.dtype == j.dtype and torch.equal(a, j), key


def _variant_cases():
    for name in ("llama", "qwen2-moe"):
        variants = SHAPES[name][1] or tp.VARIANTS
        for v in variants:
            yield name, v
    yield "llama-heavy", "q8_row"


@pytest.mark.parametrize("shape,variant", list(_variant_cases()))
def test_make_variant_weights_bit_equal(masters, shape, variant):
    t_master, j_master = masters[shape]
    tm, tkw = tp.make_variant(t_master, variant)
    jm, jkw = jp.make_variant(j_master, variant)
    assert tkw["impl"] == ("int8" if jkw["impl"] == "int8" else "auto")
    assert (tkw["dtype"] == torch.int8) == (jkw["dtype"] == jnp.int8)
    assert sorted(tm.weights["layers"]) == sorted(jm.weights["layers"])
    for k, v in tm.weights["layers"].items():
        _same(v, jm.weights["layers"][k], k)
    for k in ("tok_emb", "wcls", "final_norm"):
        _same(tm.weights[k], jm.weights[k], k)


def test_apply_spectrum_bit_equal(masters):
    t, j = masters["llama-heavy"]
    for k in ("wq", "w2"):
        assert np.array_equal(np.asarray(t.weights["layers"][k]), np.asarray(j.weights["layers"][k]))
    assert np.array_equal(np.asarray(t.weights["wcls"]), np.asarray(j.weights["wcls"]))


@pytest.fixture(scope="module")
def corpus(masters):
    """JAX's sample of the llama master: the corpus both packages score."""
    return jp.sample_corpus(masters["llama"][1], 96)


def _jax_ppl(master, variant, corpus):
    model, kw = jp.make_variant(master, variant)
    saved = j_int8_prefill.INT8_MXU_MIN_T
    if variant.endswith("-a8"):
        j_int8_prefill.INT8_MXU_MIN_T = 1
    try:
        return j_perplexity(model, corpus, chunk=16, cache_len=64, stride=32, **kw)
    finally:
        j_int8_prefill.INT8_MXU_MIN_T = saved


@pytest.mark.parametrize("variant,rel", [("f32", 1e-4), ("q8_0", 1e-4), ("q8_0-int8dot", 1e-4),
                                         ("q8_row", 1e-4), ("q4_k", 1e-4), ("q8_row-a8", 1e-3)])
def test_ppl_matches_jax_on_one_corpus(masters, corpus, variant, rel):
    """One variant scored by both packages on JAX's corpus (cache 64, stride
    32, chunk 16): within 1e-4 relative. q8_row-a8 quantizes every
    projection's activations per token: a 1-ulp difference of the f32
    rmsnorm or attention between the packages moves some int8 roundings by
    a step, so its ppl is held at 1e-3 (5.8e-4 measured); its projections
    are held bit for bit on the same inputs, and the ppl at 1e-4 with the
    ties rounded as JAX rounds them (the next two tests)."""
    t_master, j_master = masters["llama"]
    want = _jax_ppl(j_master, variant, corpus)
    model, kw = tp.make_variant(t_master, variant)
    got = tp.score_variant(model, variant, corpus, 64, kw, "cpu")
    assert got["tokens"] == want["tokens"]
    assert abs(got["ppl"] - want["ppl"]) / want["ppl"] < rel, (got, want)


def test_a8_projection_bit_equal(masters, monkeypatch):
    """q8_row-a8's w8a8 projection (INT8_MXU_MIN_T = 1, read at call time):
    the port's matmul equals JAX quant_matmul_pallas bit for bit on the
    same 16 rows."""
    t_master, j_master = masters["llama"]
    tm, _ = tp.make_variant(t_master, "q8_row-a8")
    jm, _ = jp.make_variant(j_master, "q8_row-a8")
    monkeypatch.setattr(t_int8_prefill, "INT8_MXU_MIN_T", 1)
    monkeypatch.setattr(j_int8_prefill, "INT8_MXU_MIN_T", 1)
    jmm = sys.modules["llamatpu.ops.matmul"]
    x = np.random.default_rng(2).normal(size=(1, 16, 256)).astype(np.float32)
    for k in ("wq", "wo", "w1"):
        want = np.asarray(jmm.matmul(_index_qtensor(jm.weights["layers"][k], 1),
                                     jnp.asarray(x), "pallas"))
        got = matmul(from_numpy_weights(tm.weights["layers"][k]), torch.from_numpy(x), 1)
        assert np.array_equal(got.numpy(), want), k


def test_a8_ppl_differs_from_jax_only_at_int8_ties(masters, corpus, monkeypatch):
    """Why q8_row-a8's ppl is held to JAX's at 1e-3 and not 1e-4: every
    projection quantizes its input rows to int8 per token, and the port's
    f32 inputs differ from the JAX package's by an ulp or two where the two
    sum in another order. An input within that of a half int8 step rounds to
    the next step on one side: with this seed, the first is layer 1's wq
    input (its attention rmsnorm), in the first chunk's row 3, column 209,
    at -11.500007 steps in the port and -11.499987 in JAX (-12 against
    -11). Held here, over the same windows: every quantized input agrees
    within 4e-6, the int8 values differ only within 1e-4 of a half step and
    by one step, and with JAX's int8 value put in at those ties the ppl is
    within 1e-4 of JAX's."""
    import llamatpu.ops.int8_prefill as jip

    from llamatpu_torch.ops import matmul as tmatmul

    t_master, j_master = masters["llama"]
    ref, ties = [], []
    jq8, tq = jip.quantize_activation_rows, tmatmul.quantize_activation_rows

    def j_rec(x2):
        xi8, ax = jq8(x2)
        jax.debug.callback(lambda a, b: ref.append((np.asarray(a, np.float32), np.asarray(b))),
                           x2, xi8, ordered=True)
        return xi8, ax

    monkeypatch.setattr(jip, "quantize_activation_rows", j_rec)
    want = _jax_ppl(j_master, "q8_row-a8", corpus)
    jax.effects_barrier()
    monkeypatch.setattr(jip, "quantize_activation_rows", jq8)
    calls = iter(range(len(ref)))

    def t_tied(x2):
        xi8, ax = tq(x2)
        n = next(calls)
        x, (jx, jq_) = x2.float().numpy(), ref[n]
        np.testing.assert_allclose(x, jx, rtol=0, atol=4e-6)
        apart = xi8.numpy() != jq_
        if apart.any():
            s = x * 127.0 / np.abs(x).max(axis=-1, keepdims=True)
            assert np.abs(np.abs(s[apart]) % 1.0 - 0.5).max() < 1e-4, s[apart]
            assert np.abs(xi8.numpy().astype(int) - jq_.astype(int))[apart].max() == 1
            ties.extend((n, int(r), int(c), round(float(s[r, c]), 6))
                        for r, c in zip(*np.nonzero(apart)))
            xi8 = torch.from_numpy(jq_.copy())
        return xi8, ax

    monkeypatch.setattr(tmatmul, "quantize_activation_rows", t_tied)
    model, kw = tp.make_variant(t_master, "q8_row-a8")
    got = tp.score_variant(model, "q8_row-a8", corpus, 64, kw, "cpu")
    assert next(calls, None) is None, "the port quantized fewer inputs than JAX"
    # a chunk: 2 layers x (wq, wk, wv, wo, w1, w3, w2) + the head; call 7 is layer 1's wq
    assert ties[0] == (7, 3, 209, -11.500007), ties
    assert got["tokens"] == want["tokens"]
    assert abs(got["ppl"] - want["ppl"]) / want["ppl"] < 1e-4, (got, want, ties)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_port_parity_table_inside_the_gate(shape):
    """The port's own parity_table (its corpus, its codecs, its kernels'
    plain versions) on the gate's shapes and arguments: every variant scores
    the whole corpus and stays inside tests/test_parity_gate.py's bounds."""
    preset, variants, ov, *spec = SHAPES[shape]
    kw = {} if variants is None else {"variants": variants}
    rows = {r["variant"]: r for r in tp.parity_table(
        preset, corpus_len=96, cache_len=64, seed=1, spectrum=spec[0] if spec else None,
        device="cpu", **kw, **ov)}
    assert len({r["tokens"] for r in rows.values()}) == 1

    def bound(key, default):
        return _HEAVY_BOUNDS.get(key, default) if shape.endswith("-heavy") else default

    assert abs(rows["q8_0"]["rel"]) < bound("q8_0", 0.02)
    if "q8_0-int8dot" in rows:
        assert abs(rows["q8_0-int8dot"]["rel"]) < 0.02
    if "q8_0-kvint8" in rows:
        assert abs(rows["q8_0-kvint8"]["rel"]) < 0.03
    if "q8_row" in rows:
        assert abs(rows["q8_row"]["rel"]) < bound("q8_row", 0.05)
    if "q8_row-a8" in rows:
        assert abs(rows["q8_row-a8"]["rel"]) < bound("q8_row-a8", 0.08)
    if "q8_row-noeq" in rows and shape.endswith("-heavy"):
        assert rows["q8_row"]["ppl"] <= rows["q8_row-noeq"]["ppl"] * 1.005
    assert abs(rows["q4_0"]["rel"]) < bound("q4_0", 0.6)
    if "q4_k" in rows:
        assert abs(rows["q4_k"]["rel"]) < bound("q4_k", 0.6)
    for a, b in (("q4_0", "q4_0-pack4"), ("q4_k", "q4_k-pack4")):
        if b in rows:
            assert abs(rows[a]["ppl"] - rows[b]["ppl"]) / rows[a]["ppl"] < 1e-3
    if "bf16" in rows:
        assert abs(rows["bf16"]["rel"]) < 0.02


_TINY_PRESETS = {
    "llama32-1b": (("f32", "q8_0", "q8_0-int8dot"), dict(SHAPES["llama"][2], n_layers=1),
                   "tiny"),
    "qwen15-moe-a2.7b": (None, dict(SHAPES["qwen2-moe"][2], n_layers=1), "tiny"),
}


@pytest.mark.parametrize("moe", [False, True])
def test_main_writes_the_table_and_gates(monkeypatch, tmp_path, capsys, moe):
    """`main` (the runners' presets, here at tiny widths): the markdown table
    to --out, one JSON line of rows and verdict on stdout, exit 0 inside the
    gates and 1 when a delta passes its gate."""
    monkeypatch.setattr(tp, "PRESETS", _TINY_PRESETS)
    monkeypatch.setattr(tp, "MOE_VARIANTS", ("f32", "q8_0", "q8_row"))
    for name, value in (("CORPUS", 40), ("CACHE", 64), ("MOE_CORPUS", 40), ("MOE_CACHE", 64)):
        monkeypatch.setattr(tp, name, value)
    preset = "qwen15-moe-a2.7b" if moe else "llama32-1b"
    argv = (["--moe"] if moe else ["--preset", preset]) + ["--device", "cpu"]
    out = tmp_path / "parity.md"
    assert tp.main(argv + ["--out", str(out)]) == 0
    text = out.read_text()
    want = ("f32", "q8_0", "q8_row") if moe else _TINY_PRESETS[preset][0]
    assert f"## {preset}" in text and "Verdict:" in text
    assert all(f"| {v} |" in text for v in want)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["ok"] is True and list(res["parity"]) == [preset]
    assert [r["variant"] for r in res["parity"][preset]] == list(want)
    assert len({r["tokens"] for r in res["parity"][preset]}) == 1
    monkeypatch.setattr(tp, "Q8_REL_MAX", 0.0)  # any q8_0 delta passes the gate now
    assert tp.main(argv) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["ok"] is False and any("EXCEEDS" in ln for ln in lines)
