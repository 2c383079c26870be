"""Slice 6's kernels on the CPU against the JAX package: K16's plain version
(the port's layer tail with `_W2_KTILE` set) against `_tail_kernel_kt` in
interpret mode; K17's against `rowq_gemm_pallas(variant="bf16")`; and the
plain versions of the rate probes K18 (bench/roofline.py) and K19
(bench/dma_sweep.py) against the functions of scripts/bench_roofline.py and
scripts/bench_dma_sweep.py, loaded from scripts/ with their module globals
shrunk and every pallas_call run in TPU interpret mode; and the summation
order of K18a / K18i's tensor-core GEMV against the same script. On the CPU
no kernel launch is counted."""
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import llamatpu.ops.layer_fused as jlf
from llamatpu.models.weights import QTensor as JQTensor
from llamatpu.models.weights import prepare_qtensor, rowq_requant
from llamatpu.ops.pallas_gemm import rowq_gemm_pallas
from llamatpu_torch.bench import dma_sweep, roofline
from llamatpu_torch.models.weights import from_numpy_weights
from llamatpu_torch.ops import gemm, layer_fused, probes

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
EPS = 1e-5
PALLAS_CALL = pl.pallas_call


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


# ------------------------------------------------------------------ K16
L16, D16, H16, F16 = 2, 128, 128, 384  # F = 3 contraction tiles of 128 on both sides


def _rowq(o, i, seed):
    rng = np.random.default_rng(seed)
    qs = rng.integers(-127, 128, size=(L16, o, i), dtype=np.int8)
    scales = rng.random((L16, o, i // 32), dtype=np.float32) * 0.01 + 0.005
    return rowq_requant(prepare_qtensor(JQTensor(qs, scales, "q8_0")))


@pytest.fixture(scope="module")
def tail_ws():
    jw = {"wo": _rowq(D16, H16, 1), "w13": _rowq(2 * F16, D16, 2), "w2": _rowq(D16, F16, 3),
          "ffn_norm": np.random.default_rng(5).normal(size=(L16, D16)).astype(np.float32)}
    return jw, from_numpy_weights(jw)


@pytest.mark.parametrize("t", [1, 5, 32])
def test_k16_plain_matches_pallas_ktile(tail_ws, monkeypatch, t):
    """K16's plain version, reached through the port's layer_tail_fused_rowq
    with `_W2_KTILE` set, against llamatpu's with `lf._W2_KTILE = True`
    (`_tail_kernel_kt`, interpret=True), every layer, f32: rtol = 5e-4, atol
    = 1e-3 (the JAX gate of tests/test_layer_fused.py)."""
    jw, tw = tail_ws
    assert layer_fused.ktile_width(F16) == 128
    called = []
    monkeypatch.setattr(layer_fused, "_W2_KTILE", True)
    inner = layer_fused.layer_tail_kt_plain
    monkeypatch.setattr(layer_fused, "layer_tail_kt_plain",
                        lambda *a, **k: called.append(1) or inner(*a, **k))
    rng = np.random.default_rng(t)
    attn = rng.normal(size=(1, t, H16)).astype(np.float32) * 0.1
    x = rng.normal(size=(1, t, D16)).astype(np.float32) * 0.1
    saved = jlf._W2_KTILE
    jlf._W2_KTILE = True
    try:
        for li in range(L16):
            for rs in (1.0, 0.5):
                want = jlf.layer_tail_fused_rowq(
                    jw["wo"], jw["w13"], jw["w2"], jnp.asarray(jw["ffn_norm"]), jnp.asarray(attn),
                    jnp.asarray(x), jnp.int32(li), EPS, rs, interpret=True)
                got = layer_fused.layer_tail_fused_rowq(tw["wo"], tw["w13"], tw["w2"],
                                                        tw["ffn_norm"], _t(attn), _t(x), li, EPS,
                                                        rs)
                assert got.shape == x.shape and got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=1e-3)
    finally:
        jlf._W2_KTILE = saved
    assert len(called) == 2 * L16
    assert layer_fused.layer_tail_kt_fused_rowq.launches == 0


def test_k16_equals_k9_up_to_summation_order(tail_ws):
    """K16 and K9 compute one function: their plain versions agree to f32
    summation order, in f32 and in bf16 (bf16 output: one bf16 ulp)."""
    _, tw = tail_ws
    g = torch.Generator().manual_seed(3)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        attn = (torch.randn((8, H16), generator=g) * 0.1).to(dt)
        x = (torch.randn((8, D16), generator=g) * 0.1).to(dt)
        a = layer_fused.layer_tail_kt_plain(tw["wo"], tw["w13"], tw["w2"], tw["ffn_norm"], attn,
                                            x, 1, EPS)
        b = layer_fused.layer_tail_plain(tw["wo"], tw["w13"], tw["w2"], tw["ffn_norm"], attn, x,
                                         1, EPS)
        assert a.dtype == dt
        d = (a.float() - b.float()).abs().max().item()
        assert d <= tol * b.float().abs().max().item(), (dt, d)


# ------------------------------------------------------------------ K17
@pytest.mark.parametrize("t,o,i", [(64, 256, 512), (128, 384, 256), (8, 128, 1024)])
def test_k17_plain_matches_pallas_bf16(t, o, i):
    """rowq_gemm(variant="bf16") on the CPU (K17's plain version) against
    rowq_gemm_pallas(variant="bf16", interpret=True): the products are exact
    integers and only the f32 summation order differs, rtol = 1e-6."""
    rng = np.random.default_rng(t + o + i)
    qs = rng.integers(-127, 128, size=(o, i), dtype=np.int8)
    sc = (rng.random((o, 1), dtype=np.float32) + 0.5) / 127
    xi8 = rng.integers(-127, 128, size=(t, i), dtype=np.int8)
    ax = rng.random((t, 1), dtype=np.float32) * 0.01
    want = rowq_gemm_pallas(jnp.asarray(qs), jnp.asarray(sc), jnp.asarray(xi8), jnp.asarray(ax),
                            interpret=True, variant="bf16")
    assert want is not None
    got = gemm.rowq_gemm(_t(qs), _t(sc), _t(xi8), _t(ax), variant="bf16")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # and K4's exact int32 path agrees with it to the same order
    np.testing.assert_allclose(gemm.rowq_gemm(_t(qs), _t(sc), _t(xi8), _t(ax)).numpy(),
                               np.asarray(want), rtol=1e-6)
    assert gemm.rowq_gemm_bf16.launches == 0 and gemm.rowq_gemm.launches == 0


def test_k17_keeps_k4_shape_rules():
    xi8 = torch.zeros((8, 131_072 + 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflows"):
        gemm.rowq_gemm(torch.zeros((16, xi8.shape[1]), dtype=torch.int8),
                       torch.ones((16, 1)), xi8, torch.ones((8, 1)), variant="bf16")
    with pytest.raises(ValueError, match="variant"):
        gemm.rowq_gemm(torch.zeros((16, 32), dtype=torch.int8), torch.ones((16, 1)),
                       torch.zeros((8, 32), dtype=torch.int8), torch.ones((8, 1)),
                       variant="fp8")


# ------------------------------------------------------- K18 and K19 scripts
SL, SO, SI = 2, 1024, 512  # the scripts' L, O, I shrunk (I == TO = 512: I >= TO)


def _load_script(name: str, monkeypatch):
    """scripts/<name>.py as a fresh module with its globals shrunk and every
    pallas_call in TPU interpret mode (pltpu.InterpretParams)."""
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.L, mod.O, mod.I = SL, SO, SI
    if hasattr(mod, "NB"):
        mod.NB = SI // mod.BLOCK
        mod.TO = 512
        tt = mod.TT
        mod.X_SPEC = pl.BlockSpec((tt, SI), lambda o: (0, 0), memory_space=pltpu.VMEM)
        mod.OUT_SPEC = pl.BlockSpec((tt, mod.TO), lambda o: (0, o), memory_space=pltpu.VMEM)
        mod.OUT_SHAPE = mod.jax.ShapeDtypeStruct((tt, SO), jnp.float32)
        mod.X3 = pl.BlockSpec((1, tt, SI), lambda l, o: (0, 0, 0), memory_space=pltpu.VMEM)
        mod.OUT3_SPEC = pl.BlockSpec((1, tt, mod.TO), lambda l, o: (l, 0, o),
                                     memory_space=pltpu.VMEM)
        mod.OUT3_SHAPE = mod.jax.ShapeDtypeStruct((SL, tt, SO), jnp.float32)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        PALLAS_CALL, interpret=pltpu.InterpretParams()))
    return mod


@pytest.fixture(scope="module")
def stacks():
    """The scripts' inputs from a numpy seed: bf16 and int8 stacks, Q8_0
    scales [L, O, I / 32], x bf16 [8, I]."""
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((SL, SO, SI)).astype(ml_dtypes.bfloat16)
    qs = rng.integers(-127, 128, size=(SL, SO, SI), dtype=np.int8)
    ss = np.abs(rng.standard_normal((SL, SO, SI // 32))).astype(np.float32) * 0.01
    x = (rng.standard_normal((8, SI)) * 0.1).astype(ml_dtypes.bfloat16)
    return {"bf16": bf, "qs": qs, "ss": ss, "x": x}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _jax(a):
    return jnp.asarray(a)


# (function name, weights, integer result): the 2-D steps take layer 0
K18 = [("step_pallas_bf16", ("bf16",), False), ("step_q8_current", ("qs", "ss"), False),
       ("step_q8_bf16mul", ("qs", "ss"), False), ("step_q8_int8dot", ("qs", "ss"), True),
       ("step_q8_int8dot_blockscale", ("qs", "ss"), False), ("step_dma_probe", ("bf16",), False),
       ("call3_q8_current", ("qs", "ss"), False), ("call3_q8_int8dot", ("qs", "ss"), True),
       ("call3_bf16", ("bf16",), False), ("call3_dma_probe", ("bf16",), False)]


@pytest.mark.parametrize("name,keys,integer", K18, ids=[k[0] for k in K18])
def test_k18_plain_matches_roofline_script(stacks, monkeypatch, name, keys, integer):
    """Each K18 function on CPU tensors (its plain version) against the
    script's function: integer results exactly; f32 sums at rtol = 1e-5 (the
    same products summed in another order: the script's dots in XLA on the
    CPU, the plain version's in torch). The dma probes move values without
    sums and are held exactly."""
    mod = _load_script("bench_roofline", monkeypatch)
    stacked = name.startswith("call3")
    pick = (lambda a: a) if stacked else (lambda a: a[0])
    want = np.asarray(getattr(mod, name)(tuple(_jax(pick(stacks[k])) for k in keys),
                                         _jax(stacks["x"])))
    got = getattr(roofline, name)(tuple(_torch(pick(stacks[k])) for k in keys),
                                  _torch(stacks["x"])).numpy()
    assert got.shape == want.shape == (8, SO)
    if integer or "dma_probe" in name:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert getattr(roofline, name).launches == 0


def test_k18_dma_probe_int8_and_library_rows(stacks, monkeypatch):
    """step_dma_probe on int8 weights (exact), and the two library rows
    (torch.matmul) against the script's XLA rows."""
    mod = _load_script("bench_roofline", monkeypatch)
    x = stacks["x"]
    want = np.asarray(mod.step_dma_probe((_jax(stacks["qs"][1]),), _jax(x)))
    np.testing.assert_array_equal(
        roofline.step_dma_probe((_torch(stacks["qs"][1]),), _torch(x)).numpy(), want)
    want = np.asarray(mod.step_xla_bf16((_jax(stacks["bf16"][0]),), _jax(x)))
    got = roofline.step_xla_bf16((_torch(stacks["bf16"][0]),), _torch(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    want = np.asarray(mod.call_big_xla_bf16((_jax(stacks["bf16"]),), _jax(x)))
    got = roofline.call_big_xla_bf16((_torch(stacks["bf16"]),), _torch(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _gemv_tc_walk_plain(x, w, plan, stage_k=probes.STAGE_K):
    """The tensor-core GEMV (csrc/probes.cu probe_gemv_tc_kernel; K18a / K18i
    on bf16 w, K18b / c / g on the dequantized int8 w) in its summation order, in f32: each unit (layer,
    rows, K slice) of each CTA's walk sums PARTS column parts, part p taking
    the 16-column steps j = p + PARTS * i (i = 0, 1, ...) of each
    stage_k-column ring stage in order, into two sums, of the even i and of
    the odd i; a part is the even sum plus the odd one, the parts are added
    in order, and the K slices' partial sums in slice order."""
    xf, wf = x.float(), w.float()
    lay, o, _ = wf.shape
    part = torch.zeros((plan.nks, lay, xf.shape[0], o))
    starts = [plan.slice(k)[0] for k in range(plan.nks)]
    for c in range(plan.ctas):
        for layer, r0, r1, k0, k1 in plan.units(c):
            sums = [[torch.zeros((xf.shape[0], r1 - r0)) for _ in range(2)]
                    for _ in range(probes.PARTS)]
            for k in range(k0, k1, stage_k):
                for j in range(min(stage_k, k1 - k) // 16):
                    cols = slice(k + 16 * j, k + 16 * j + 16)
                    p, i = j % probes.PARTS, j // probes.PARTS
                    sums[p][i % 2] = sums[p][i % 2] + xf[:, cols] @ wf[layer, r0:r1, cols].T
            acc = sums[0][0] + sums[0][1]
            for even, odd in sums[1:]:
                acc = acc + (even + odd)
            part[starts.index(k0), layer, :, r0:r1] = acc
    y = part[0]
    for ks in range(1, plan.nks):
        y = y + part[ks]
    return y


@pytest.mark.parametrize("plan_of", ["card", "7 sms", "split"])
@pytest.mark.parametrize("name", ["step_pallas_bf16", "call3_bf16"])
def test_k18_tc_walk_order_matches_roofline_script(stacks, monkeypatch, name, plan_of):
    """The tensor-core GEMV's summation order, run in plain torch under its
    plan on the H100 (132 SMs), on 7 SMs, and with two K slices and their
    second pass, against the script's function at the K18 tolerance (rtol
    1e-5, atol 1e-5 of the largest output), and against the plain version."""
    mod = _load_script("bench_roofline", monkeypatch)
    stacked = name == "call3_bf16"
    w = stacks["bf16"] if stacked else stacks["bf16"][:1]
    plan = (probes.GemvPlan(SO, SI, w.shape[0], 2, 64) if plan_of == "split" else
            probes.plan_gemv(SO, SI, w.shape[0], 132 if plan_of == "card" else 7))
    got = _gemv_tc_walk_plain(_torch(stacks["x"]), _torch(w), plan)[0].numpy()
    ws = (_jax(stacks["bf16"]),) if stacked else (_jax(stacks["bf16"][0]),)
    want = np.asarray(getattr(mod, name)(ws, _jax(stacks["x"])))
    assert got.shape == want.shape == (8, SO)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    plain = getattr(roofline, name + "_plain")((_torch(w if stacked else w[0]),),
                                               _torch(stacks["x"])).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5 * np.abs(plain).max())


K19 = [("probe_blockspec", (256,), "qs"), ("probe_blockspec", (1024,), "qs"),
       ("probe_manual_dma", (2, 512), "qs"), ("probe_manual_dma", (8, 256), "qs"),
       ("probe_manual_dma", (4, 512), "bf16"), ("int8dot_manual_dma", (4, 512), "qs"),
       ("int8dot_manual_dma", (8, 256), "qs")]


@pytest.mark.parametrize("name,args,w", K19, ids=[f"{k[0]}{k[1]}-{k[2]}" for k in K19])
def test_k19_plain_matches_dma_sweep_script(stacks, monkeypatch, name, args, w):
    """Each K19 probe on CPU tensors (its plain version) against the script's,
    in TPU interpret mode, where a copy lands at its wait (the intended
    function: see the next test): int8 weights and the int8 dot exactly
    (integer values summed in f32 below 2^24); bf16 sums at rtol = 1e-5."""
    mod = _load_script("bench_dma_sweep", monkeypatch)
    ws_j = (_jax(stacks[w]),) if name != "int8dot_manual_dma" else (_jax(stacks[w]), None)
    ws_t = (_torch(stacks[w]),) if name != "int8dot_manual_dma" else (_torch(stacks[w]), None)
    want = np.asarray(getattr(mod, name)(*args)(ws_j, _jax(stacks["x"])))
    got = getattr(dma_sweep, name)(*args)(ws_t, _torch(stacks["x"])).numpy()
    assert got.shape == want.shape == (8, SO)
    if w == "qs":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert getattr(dma_sweep, name).launches == 0


def test_k19_manual_dma_plain_interpret_reads_the_next_chunk(stacks, monkeypatch):
    """scripts/bench_dma_sweep.py:107-108 starts the copy of chunk c + depth
    into slot c % depth before reading that slot. Plain interpret=True copies
    at start, so there the read sees chunk c + depth and the result differs
    from the intended sum the port computes (and TPU interpret mode gives)."""
    mod = _load_script("bench_dma_sweep", monkeypatch)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(PALLAS_CALL, interpret=True))
    ws = (_jax(stacks["qs"]),)
    plain_interp = np.asarray(mod.probe_manual_dma(2, 256)(ws, _jax(stacks["x"])))
    port = dma_sweep.probe_manual_dma(2, 256)((_torch(stacks["qs"]),),
                                              _torch(stacks["x"])).numpy()
    assert not np.array_equal(plain_interp, port)
    # what it computed instead: chunk c reads chunk c + depth while one exists
    wflat = stacks["qs"].reshape(-1, SI).astype(np.float32)
    n = wflat.shape[0] // 256
    idx = [c + 2 if c + 2 < n else c for c in range(n)]
    expect = sum(wflat[j * 256:j * 256 + 8, :128] for j in idx) \
        + stacks["x"][:, :1].astype(np.float32)
    np.testing.assert_array_equal(plain_interp[:, :128], expect)
