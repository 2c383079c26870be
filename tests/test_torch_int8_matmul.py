"""The exact int8 mode of the port (`--impl int8`, ops/int8_matmul.py) on the
CPU against the JAX package: the activation quantization and the int32
block sums bit for bit, `quant_matmul_int8` against JAX's (f32 1e-5, bf16
one bf16 ulp) and against the scalar oracle of tests/test_int8_matmul.py,
the T = 16 / 17 route, the grouped (expert) rows, the forward and the three
engines on a tiny Q8_0 Llama and a tiny Qwen2-MoE against JAX
`impl="int8"`, the CLI, and q8_row weights kept off K4's activation
quantization. No kernel launch is counted on the CPU."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_int8_matmul import ref_dot_q8_activation
from tiny_models import build_tiny_gguf

from llamatpu import cli as jcli
from llamatpu.gguf import GGMLType as JT
from llamatpu.gguf import quants as jq
from llamatpu.models import transformer as jtr
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.models.weights import quantize_array_q8_0
from llamatpu.models.weights import serving_weights as j_serving
from llamatpu.ops import int8_matmul as jim
from llamatpu.runtime.batch_engine import BatchEngine as JBatchEngine
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu.runtime.paged_engine import PagedBatchEngine as JPagedBatchEngine
from llamatpu_torch import cli
from llamatpu_torch.models import transformer as ttr
from llamatpu_torch.models.synthetic import build_synthetic_model as t_build
from llamatpu_torch.models.weights import from_numpy_weights
from llamatpu_torch.ops import int8_matmul as tim
from llamatpu_torch.ops import quant_matmul
from llamatpu_torch.ops.matmul import matmul
from llamatpu_torch.runtime.batch_engine import BatchEngine
from llamatpu_torch.runtime.engine import Engine
from llamatpu_torch.runtime.paged_engine import PagedBatchEngine

TINY = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab_size=300)
MOE = dict(dim=128, hidden_dim=256, moe_hidden_dim=64, n_heads=4, n_kv_heads=4, head_dim=32,
           n_experts=8, n_experts_used=4, vocab_size=300)


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


def _activations(t: int, i: int, seed: int) -> np.ndarray:
    """Rows with every trap of the quantization: exact +-0.5-step ties (a
    block of amax 127, so d = 1 and s = x), an all-zero block, a block whose
    d = amax / 127 is f16-subnormal, and a zero row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, i)).astype(np.float32)
    x[0, :32] = np.array([127.0, -2.5, 2.5, -3.5, 0.5, -0.5, 126.5, -126.5] * 4, np.float32)
    x[0, 32:64] = 0.0
    if t > 1:
        x[1, :32] *= 1e-4
    if t > 2:
        x[2] = 0.0
    return x


def _as(x: np.ndarray, dtype: str):
    """The same values as JAX and torch arrays (bf16 rounded once, RNE)."""
    if dtype == "f32":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _q8(o: int, i: int, seed: int):
    wf = np.random.default_rng(seed).normal(size=(o, i)).astype(np.float32)
    jw = quantize_array_q8_0(wf)
    return wf, jw, from_numpy_weights(jw)


# ------------------------------------------------------------ the function
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activation_blocks_bit_equal(dtype):
    """q int8 [T, NB, 32] and the f16-rounded d [T, NB] equal JAX
    `_quantize_activation`'s: ties round half away from zero, zero blocks
    give (0, 0), an f16-subnormal d keeps its subnormal value."""
    xj, xt = _as(_activations(4, 128, 0), dtype)
    qj, dj = jim._quantize_activation(xj)
    qt, dt = tim.quantize_activation_blocks(xt)
    assert qt.dtype == torch.int8 and dt.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert qt[0, 0, :8].tolist() == [127, -3, 3, -4, 1, -1, 127, -127]
    assert not qt[0, 1].any() and dt[0, 1] == 0 and not qt[2].any()
    assert 0 < dt[1, 0] < 2.0 ** -14  # subnormal in f16


def test_block_sums_are_exact_int32():
    """The int32 block sums equal an int64 numpy product, at the extremes
    (all +-127: 32 * 127 * 127 a block) and at random."""
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, (5, 4, 32)).astype(np.int8)
    q[0] = 127
    w = rng.integers(-127, 128, (7, 128)).astype(np.int8)
    w[3] = -127
    got = tim.block_sums_int(_t(q), _t(w))
    want = np.einsum("tbk,obk->bto", q.astype(np.int64), w.reshape(7, 4, 32).astype(np.int64))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert got[:, 0, 3].tolist() == [-32 * 127 * 127] * 4


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lead", [(1,), (7,), (2, 8)])
def test_quant_matmul_int8_matches_jax(dtype, lead):
    """y[..., O] against JAX quant_matmul_int8 on the same Q8_0 weights (row
    padding sliced as logical_out): f32 within rtol = atol = 1e-5, bf16
    within one bf16 ulp of the largest output."""
    i, o = 160, 72
    _, jw, tw = _q8(o, i, 2)
    t = int(np.prod(lead))
    x = _activations(t, i, 3).reshape(*lead, i)
    xj, xt = _as(x, dtype)
    want = np.asarray(jim.quant_matmul_int8(jw, xj).astype(jnp.float32))
    got = tim.quant_matmul_int8(tw, xt)
    assert got.dtype == xt.dtype and tuple(got.shape) == (*lead, o)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got.float().numpy() - want).max() <= ulp


def test_matches_scalar_reference():
    """The plain version against dotQ8Activation's scalar port (the oracle
    of tests/test_int8_matmul.py) at 1e-6."""
    o, i = 8, 96
    wf, _, tw = _q8(o, i, 5)
    w_raw = jq.quantize_q8_0(wf.reshape(-1)).reshape(o, -1)
    x = np.random.default_rng(6).normal(size=(3, i)).astype(np.float32)
    got = tim.quant_matmul_int8(tw, torch.from_numpy(x)).numpy()
    want = np.array([[ref_dot_q8_activation(w_raw[r], x[t]) for r in range(o)]
                     for t in range(3)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_t_limit_routes_like_jax(monkeypatch):
    """16 rows (over all leading dims) take the int8 dot and 17 the
    dequantised route, in both packages: JAX's XLA dot, the port's K5."""
    _, jw, tw = _q8(40, 64, 7)
    seen = []
    jmm = sys.modules["llamatpu.ops.matmul"]
    j_inner = jmm.matmul
    monkeypatch.setattr(jmm, "matmul", lambda *a, **k: seen.append("jax xla") or j_inner(*a, **k))
    for mod, name, tag in ((tim, "int8_dot", "int8"), (quant_matmul, "block_matmul", "k5")):
        inner = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _i=inner, _g=tag, **k: seen.append(_g)
                            or _i(*a, **k))
    for lead, want in (((2, 8), ["int8"]), ((17,), ["jax xla", "k5"])):
        seen.clear()
        x = np.random.default_rng(8).normal(size=(*lead, 64)).astype(np.float32)
        a = np.asarray(jim.quant_matmul_int8(jw, jnp.asarray(x)))
        b = tim.quant_matmul_int8(tw, torch.from_numpy(x)).numpy()
        assert seen == want
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_grouped_rows_match_one_row_calls():
    """int8_dot with experts: row r against expert experts[r] of a stacked
    [E, O, I] weight equals JAX quant_matmul_int8 on that expert, one row a
    call (the JAX MoE scan), at more rows than the T = 16 limit."""
    e, o, i = 3, 24, 96
    rng = np.random.default_rng(9)
    qs = rng.integers(-127, 128, (e, o, i)).astype(np.int8)
    sc = (rng.random((e, o, i // 32)) * 0.01 + 0.001).astype(np.float16).astype(np.float32)
    x = rng.normal(size=(20, i)).astype(np.float32)
    ex = rng.integers(0, e, 20)
    got = tim.int8_dot(_t(x), _t(qs), _t(sc), _t(ex)).numpy()
    from llamatpu.models.weights import QTensor as JQ
    for r in range(20):
        want = np.asarray(jim.quant_matmul_int8(JQ(jnp.asarray(qs[ex[r]]), jnp.asarray(sc[ex[r]]),
                                                   "q8_0"), jnp.asarray(x[r])))
        np.testing.assert_allclose(got[r], want, rtol=1e-5, atol=1e-5)


def test_matmul_impl_dispatch():
    """matmul(impl=...): "auto" and "int8" only; int8 takes the exact dot
    for canonical Q8_0 weights and K5 (the same function as JAX's dequant
    dot) for Q4_0 at every T."""
    _, _, tw = _q8(16, 64, 10)
    x = torch.randn(1, 3, 64)
    with pytest.raises(ValueError, match="JAX lowerings"):
        matmul(tw, x, impl="xla")
    assert torch.equal(matmul(tw, x, impl="int8"), tim.quant_matmul_int8(tw, x))
    m = t_build("llama32-1b", quant="q4_0", n_layers=1, dtype="f32", overrides=TINY)
    w = m.weights["layers"]["wq"]
    w = type(w)(torch.from_numpy(w.qs), torch.from_numpy(w.scales), w.kind)
    x = torch.randn(2, TINY["dim"])
    assert torch.equal(matmul(w, x, 0, "int8"), matmul(w, x, 0, "auto"))


# ------------------------------------------------------------ forward and engines
def _llama(seed=5):
    kw = dict(n_layers=2, quant="q8_0", dtype="f32", seed=seed, context_length=128,
              overrides=TINY)
    return t_build("llama32-1b", **kw), j_build("llama32-1b", **kw)


def _moe(seed=3):
    kw = dict(n_layers=2, quant="q8_0", dtype="f32", seed=seed, context_length=128,
              overrides=MOE)
    return t_build("qwen15-moe-a2.7b", **kw), j_build("qwen15-moe-a2.7b", **kw)


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_forward_int8_matches_jax(family):
    """A 12-token prefill (the int8 dot at 12 rows; MoE: 12 x (4 + 4 folded
    shared) expert rows in grouped calls), a 20-token chunk (K5 above 16
    rows) and two decode steps through forward_tokens(impl="int8") against
    JAX forward_tokens(impl="int8") on the same served weights, f32: logits
    within rtol = 5e-4, atol = 1e-3."""
    _, jm = _llama() if family == "llama" else _moe()
    cfg = jm.cfg
    jw = j_serving(cfg, jm.weights)
    tw = from_numpy_weights(jax.device_get(jw))
    rng = np.random.default_rng(1)
    jc = jtr.init_cache(cfg, 1, jnp.float32, 64)
    tc = ttr.init_cache(cfg, 1, torch.float32, 64, device="cpu")
    pos = 0
    for t in (12, 20, 1, 1):
        toks = rng.integers(0, 300, (1, t))
        jl, jc = jtr.forward_tokens(cfg, jw, jnp.asarray(toks, jnp.int32), jc, pos, impl="int8")
        tl, tc = ttr.forward_tokens(cfg, tw, _t(toks), tc, pos, impl="int8")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=1e-3)
        pos += t


PROMPTS = [[(7 * i + 3) % 300 for i in range(n)] for n in (5, 19, 40)]


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_engine_int8_greedy_matches_jax(family):
    """Engine(impl="int8"): two prefill chunks of 16 (the second padded) and
    decode windows of 4, f32: the greedy ids equal JAX Engine(impl="int8")'s."""
    tm, jm = _llama() if family == "llama" else _moe()
    prompt = [(5 * i + 1) % 300 for i in range(20)]
    kw = dict(cache_len=128, prefill_chunk=16, decode_window=4)
    ref = JEngine(jm, impl="int8", cache_dtype=jnp.float32, aot_compile=False,
                  **kw).generate(prompt, 10).tokens
    te = Engine(tm, impl="int8", cache_dtype=torch.float32, device="cpu", **kw)
    assert te.generate(prompt, 10).tokens == ref


@pytest.mark.parametrize("paged", [False, True])
def test_batch_engines_int8_greedy_match_jax(paged):
    """generate_batch on 3 prompts (chunks of 16, the last padded), 4 lanes,
    decode window 4, f32, impl="int8": the JAX engines' greedy ids."""
    tm, jm = _llama()
    common = dict(batch_size=4, prefill_chunk=16, decode_window=4)
    if paged:
        je = JPagedBatchEngine(jm, block_size=8, max_len=128, impl="int8",
                               cache_dtype=jnp.float32, **common)
        te = PagedBatchEngine(tm, block_size=8, max_len=128, cache_dtype=torch.float32,
                              device="cpu", impl="int8", **common)
    else:
        je = JBatchEngine(jm, cache_len=128, impl="int8", cache_dtype=jnp.float32, **common)
        te = BatchEngine(tm, cache_len=128, cache_dtype=torch.float32, device="cpu",
                         impl="int8", **common)
    assert te.generate_batch(PROMPTS, 10) == je.generate_batch(PROMPTS, 10)


def test_engines_reject_jax_lowerings():
    tm, _ = _llama()
    for impl in ("xla", "pallas"):
        with pytest.raises(ValueError, match="JAX lowerings"):
            Engine(tm, impl=impl, device="cpu", aot_compile=False)


def test_rowq_int8_mode_never_quantizes_activation_rows(monkeypatch):
    """q8_row weights at a 128-row prefill chunk: impl "auto" takes K4's
    per-token int8 activations (the JAX Pallas dispatch's w8a8 route);
    impl "int8" never does (JAX: the dequantised dot, outside any Pallas
    kernel) and its logits match JAX forward_tokens(impl="int8")."""
    _, jm = _llama()
    cfg = jm.cfg
    jw = j_serving(cfg, jm.weights, rowq=True)
    tw = from_numpy_weights(jax.device_get(jw))
    calls = []
    mm = sys.modules["llamatpu_torch.ops.matmul"]
    inner = mm.quantize_activation_rows
    monkeypatch.setattr(mm, "quantize_activation_rows",
                        lambda x2: calls.append(x2.shape[0]) or inner(x2))
    toks = np.random.default_rng(2).integers(0, 300, (1, 128))
    for impl in ("auto", "int8"):
        calls.clear()
        tc = ttr.init_cache(cfg, 1, torch.float32, 256, device="cpu")
        tl, _ = ttr.forward_tokens(cfg, tw, _t(toks), tc, 0, impl=impl)
        assert (len(calls) > 0) == (impl == "auto"), (impl, calls)
    jl, _ = jtr.forward_tokens(cfg, jw, jnp.asarray(toks, jnp.int32),
                               jtr.init_cache(cfg, 1, jnp.float32, 256), 0, impl="int8")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-4, atol=1e-3)


# ------------------------------------------------------------ the command line
@pytest.fixture(scope="module")
def tiny_q8(tmp_path_factory):
    path = tmp_path_factory.mktemp("int8") / "llama_q8_0.gguf"
    build_tiny_gguf(path, family="llama", quant=JT.Q8_0, seed=0, with_tokenizer=True)
    return str(path)


TEXT = "The capital of France is Paris. It lies on the Seine, and its museums hold art."


def _stdout_json(main, argv, capsys) -> dict:
    capsys.readouterr()
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_ppl_int8_matches_jax_cli(tiny_q8, capsys):
    """`ppl --impl int8 --chunk 16 --dtype f32` of the port on the CPU within
    1e-4 relative of the JAX CLI's on the same GGUF and text."""
    argv = ["ppl", "-m", tiny_q8, "--text", TEXT, "--impl", "int8", "--chunk", "16",
            "--dtype", "f32"]
    got = _stdout_json(cli.main, argv + ["--device", "cpu"], capsys)
    want = _stdout_json(jcli.main, argv, capsys)
    assert got["tokens"] == want["tokens"]
    assert abs(got["ppl"] - want["ppl"]) / want["ppl"] < 1e-4, (got, want)


def test_cli_run_and_validate_int8_and_jax_lowerings_raise(tiny_q8, tmp_path, capsys):
    """`run --impl int8` streams and exits 0, `validate --impl int8` passes
    its checks (no golden: the fixtures record impl auto), and `--impl xla`
    / `--impl pallas` raise, naming the JAX lowering."""
    assert cli.main(["run", "-m", tiny_q8, "-p", "hello", "-n", "40", "--device", "cpu",
                     "--impl", "int8", "--temperature", "0", "--metrics-format", "none"]) == 0
    assert capsys.readouterr().out.strip()
    assert cli.main(["validate", "-m", tiny_q8, "--device", "cpu", "--dtype", "f32",
                     "--impl", "int8", "--golden", str(tmp_path / "none.json")]) == 0
    assert "validation: OK" in capsys.readouterr().out
    for impl in ("xla", "pallas"):
        with pytest.raises(ValueError, match="JAX lowerings"):
            cli.main(["run", "-m", tiny_q8, "-p", "hi", "--device", "cpu", "--impl", impl])
