"""K2 (`qkv_norm_fused_rowq`) and K1 (`rowq_gemv`) with bf16 activations on
the tensor-core template (csrc/rowq_tc.cuh, the kernels' `rtc::K2` and
`rtc::K1` instances) on the CPU. The CUDA kernels run only on the card
(chip_smoke.py `check_k1`, `check_k2`, `check_rowq_edges`,
`check_phi3_geometry`); here what surrounds them and their arithmetic are
held to the JAX package:

- the plans (`ffn_fused.plan_tc`) of every K1 and K2 shape of the catalog
  and of tiny widths: every (16-row block, contraction slice) exactly once,
  the CTAs' shares within one unit, the x slice within its shared memory;
  K1's passes of at most 32 rows covering T = 33 and 127 rows once;
- K2's walk emulated in torch (the norm phase's bf16 h, the slices' sums in
  plan order, the row scales) against JAX `qkv_norm_fused_rowq(...,
  interpret=True)` on the same numpy inputs, within 1e-2 of the largest
  output (bf16 h: the bf16 gate of the tail tests);
- K1's walk times the row scales against JAX
  `pallas_matmul._rowq_matmul_2d(interpret=True)`, within 1e-5 relative to
  the largest output (exact products, f32 sums in another order);
- the launchers with a fake library: bad shapes raise before the device,
  plans and scratch reach the C call, f32 and widths that are not
  multiples of 16 take gemv.cuh's tiled GEMV (K1 above 32 such rows its
  row-pass GEMV);
- bench/qkv_ab.py's variants, which edit the kernels' sources.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tail_tc import _forced, walk_phase

import llamatpu.ops.layer_fused as jlf
import llamatpu.ops.pallas_matmul as jpm
from llamatpu.models.weights import QTensor as JQTensor
from llamatpu.models.weights import prepare_qtensor, rowq_requant
from llamatpu_torch import _build
from llamatpu_torch.bench import qkv_ab
from llamatpu_torch.models.weights import from_numpy_weights
from llamatpu_torch.ops import ffn_fused as ff
from llamatpu_torch.ops import layer_fused as lf
from llamatpu_torch.ops import quant_matmul as qm

EPS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one intra-op thread: the test workers and the JAX
    compiler share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- the plans
# (O, I) of each projection K1 or K2 takes: K2's wqkv; K1's vocab head, and
# the batched step's wo, w13 and w2 where the fused tails decline
K2_SHAPES = {"llama32-1b": (3072, 2048), "phi3-medium": (7680, 5120),
             "qwen15-moe": (6144, 2048), "tiny": (384, 256)}
K1_SHAPES = {"llama32-1b head": (128256, 2048), "llama32-1b w2": (2048, 8192),
             "phi3-medium wo": (5120, 5120), "phi3-medium w13": (35840, 5120),
             "phi3-medium w2": (5120, 17920), "tiny": (300, 256)}


def _check_plan(p: ff.TcPlan, sms: int) -> None:
    """Every (output row, column) once, in blocks of 16 g rows and slices of
    ksl columns; the CTAs' contiguous shares within one unit of each other;
    the slices added in order; the x slice and three ring stages fit."""
    assert p.g in ff.TC_GROUPS and p.ksl % 128 == 0
    assert (p.splits - 1) * p.ksl < p.i <= p.splits * p.ksl
    assert p.tp * (2 * p.ksl + 32) <= ff.tc_x_bytes(p.tp, p.pair, p.g, p.splits > 1)
    assert p.ctas == min(p.units, sms) and list(p.order) == list(range(p.splits))
    seen = np.zeros((p.splits, p.nrb), dtype=np.int32)
    shares, nxt = [], 0
    for c in range(p.ctas):
        us = p.units_of(c)
        assert us.start == nxt and len(us) >= 1
        nxt = us.stop
        shares.append(len(us))
        for u in us:
            o0, o1, k0, k1 = p.unit(u)
            assert o0 % p.rows == 0 and 0 < o1 - o0 <= p.rows and o1 <= p.o
            assert k0 % p.ksl == 0 and 0 < k1 - k0 <= p.ksl
            seen[k0 // p.ksl, o0 // p.rows] += 1
    assert nxt == p.units and (seen == 1).all() and max(shares) - min(shares) <= 1


@pytest.mark.parametrize("sms", [1, 3, 7, 132])
@pytest.mark.parametrize("t", [1, 8, 17, 24, 32])
@pytest.mark.parametrize("geo", list(K2_SHAPES))
def test_k2_plan_covers_each_block_and_slice_once(geo, t, sms):
    """K2's GEMV phase at every wqkv shape: `_check_plan`."""
    o, d = K2_SHAPES[geo]
    _check_plan(ff.plan_tc(t, o, d, False, sms), sms)


def _passes(t: int, n: int) -> list[tuple[int, int]]:
    """The rows [t0, t1) of K1's n passes, as csrc/quant_matmul.cu splits them."""
    return [(t * k // n, t * (k + 1) // n) for k in range(n)]


@pytest.mark.parametrize("sms", [1, 3, 7, 132])
@pytest.mark.parametrize("t", [1, 8, 17, 24, 32, 33, 127])
@pytest.mark.parametrize("geo", list(K1_SHAPES))
def test_k1_passes_and_plan_cover_each_row_once(geo, t, sms):
    """K1 in bf16 takes ceil(t / 32) passes of near-equal rows, each at most
    32, covering the t rows once; the plan of the largest pass (`_check_plan`)
    serves every pass."""
    o, i = K1_SHAPES[geo]
    route, n = qm.rowq_route(t, i, torch.bfloat16)
    assert route == "tc" and n == -(-t // 32)
    rows = _passes(t, n)
    assert rows[0][0] == 0 and rows[-1][1] == t
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert all(1 <= t1 - t0 <= 32 for t0, t1 in rows)
    p = ff.plan_tc(-(-t // n), o, i, False, sms)
    assert max(t1 - t0 for t0, t1 in rows) == p.t
    _check_plan(p, sms)


@pytest.mark.parametrize("t,i,dtype,want", [
    (1, 2048, torch.bfloat16, ("tc", 1)), (32, 2048, torch.bfloat16, ("tc", 1)),
    (33, 5120, torch.bfloat16, ("tc", 2)), (127, 2048, torch.bfloat16, ("tc", 4)),
    (1, 200, torch.bfloat16, ("tiled", 1)), (32, 2048, torch.float32, ("tiled", 1)),
    (33, 2048, torch.float32, ("gemv", 8)), (40, 200, torch.bfloat16, ("gemv", 8)),
    (100, 17920, torch.float32, ("gemv", 2))])
def test_k1_route_follows_dtype_width_and_rows(t, i, dtype, want):
    """K1's kernel by dtype, width and rows only: bf16 at widths % 16 on the
    template; else gemv.cuh's tiled GEMV up to 32 rows, its row-pass GEMV
    above (rows a pass as many as fit 192 KB of f32 x)."""
    assert qm.rowq_route(t, i, dtype) == want


# ----------------------------------------------------- the walks, emulated
def _bf16(a):
    return a.to(torch.bfloat16).float()


def qkv_emulated(qs, s, nw, x, sms=3, splits=None):
    """K2 as the card runs it: the norm phase's h = round((x . rstd) . nw)
    (f32 sum of squares, eps after the mean) in bf16, then the template's
    walk and the row scales (E_SCALE). x bf16 [T, D]; `splits` forces the
    slice count."""
    t, d = x.shape
    xf = x.float()
    rstd = 1.0 / torch.sqrt((xf * xf).sum(-1, keepdim=True) / d + EPS)
    h = _bf16((xf * rstd) * nw)
    p = ff.plan_tc(t, qs.shape[0], d, False, sms)
    if splits is not None:
        p = _forced(p, splits)
    v, _ = walk_phase(h, qs, p)
    return v * s


def rowq_emulated(qs, x, sms=3, splits=None):
    """K1 as the card runs it: the passes of `rowq_route`, each the
    template's walk on its rows (E_RAW: the raw sums)."""
    t, i = x.shape
    _, n = qm.rowq_route(t, i, torch.bfloat16)
    p = ff.plan_tc(-(-t // n), qs.shape[0], i, False, sms)
    if splits is not None:
        p = _forced(p, splits)
    out = []
    for t0, t1 in _passes(t, n):
        v, _ = walk_phase(x[t0:t1].float(), qs, ff.TcPlan(t1 - t0, *(
            getattr(p, f) for f in ("o", "i", "pair", "g", "splits", "ksl", "ctas"))))
        out.append(v)
    return torch.cat(out)


L, D, O = 2, 256, 384


def _rowq(o, i, seed):
    rng = np.random.default_rng(seed)
    qs = rng.integers(-127, 128, size=(L, o, i), dtype=np.int8)
    scales = rng.random((L, o, i // 32), dtype=np.float32) * 0.01 + 0.005
    return rowq_requant(prepare_qtensor(JQTensor(qs, scales, "q8_0")))


@pytest.fixture(scope="module")
def ws():
    jw = {"wqkv": _rowq(O, D, 11),
          "attn_norm": (np.random.default_rng(12).random((L, D)) + 0.5).astype(np.float32)}
    return jw, from_numpy_weights(jw)


@pytest.mark.parametrize("splits", [None, 2, 3])
@pytest.mark.parametrize("t", [1, 8, 17, 24, 32])
def test_qkv_walk_matches_pallas(ws, t, splits):
    """K2's walk (the plan at 3 SMs, and forced to 2 and 3 slices) against
    qkv_norm_fused_rowq(interpret=True) on bf16 x, both layers: within 1e-2
    of the largest JAX output."""
    jw, tw = ws
    x = np.random.default_rng(300 + t).normal(size=(t, D)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for li in range(L):
        want = jlf.qkv_norm_fused_rowq(jw["wqkv"], jnp.asarray(jw["attn_norm"]), jx,
                                       jnp.int32(li), EPS, interpret=True)
        want = np.asarray(want.astype(jnp.float32))
        qs, s = tw["wqkv"].qs[li], tw["wqkv"].scales[li][:, 0]
        got = qkv_emulated(qs, s, tw["attn_norm"][li].float(), tx, splits=splits)
        assert got.shape == (t, O)
        np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("splits", [None, 2])
@pytest.mark.parametrize("t", [1, 8, 17, 24, 32, 33, 127])
def test_rowq_walk_matches_pallas(ws, t, splits):
    """K1's walk in its passes (the plan at 3 SMs, and forced to 2 slices),
    times the row scales in f32, against pallas_matmul._rowq_matmul_2d(
    interpret=True) on bf16 x: within 1e-5 of the largest output (exact
    products; only the f32 sum order differs)."""
    jw, tw = ws
    x = np.random.default_rng(400 + t).normal(size=(t, D)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    want = jpm._rowq_matmul_2d(jnp.asarray(jw["wqkv"].qs[0]), jnp.asarray(jw["wqkv"].scales[0]),
                               jx, interpret=True)
    want = np.asarray(want)
    qs, s = tw["wqkv"].qs[0], tw["wqkv"].scales[0][:, 0]
    got = rowq_emulated(qs, tx, splits=splits) * s
    assert got.shape == (t, O)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_rowq_walk_is_the_plain_product(ws):
    """At integer x whose products and sums are exact in f32, K1's passes
    and walk give the plain version bit for bit, whatever the slices."""
    _, tw = ws
    qs = tw["wqkv"].qs[1]
    x = torch.from_numpy(np.random.default_rng(8).integers(-3, 4, size=(45, D))
                         .astype(np.float32))
    for splits in (None, 1, 2):
        assert torch.equal(rowq_emulated(qs, x, splits=splits), qm.rowq_gemv_plain(x, qs))


# ----------------------------------------------------------------- launchers
class _FakeLib:
    """Records the entry points' arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def lt_qkv_norm(self, *args):
        self.calls.append(args)
        return 0

    def lt_rowq_gemv(self, *args):
        self.calls.append(args)
        return 0


def _no_device(monkeypatch):
    def no_device(*_):
        raise AssertionError("reached the device")
    monkeypatch.setattr(ff._build, "load", no_device)
    monkeypatch.setattr(ff, "_sm_count", no_device)


def _qkv_args(t=8, o=384, d=256, dt=torch.bfloat16):
    z = torch.zeros
    return [z((o, d), dtype=torch.int8), z(o), z(d), z((t, d), dtype=dt)]


@pytest.mark.parametrize("bad", [
    lambda a: a.__setitem__(3, torch.zeros((33, 256), dtype=torch.bfloat16)),  # T > 32
    lambda a: a.__setitem__(3, a[3][:, :-16].contiguous()),                # x width != D
    lambda a: a.__setitem__(0, a[0][:-16]),                                # scales rows != O
    lambda a: a.__setitem__(2, a[2][:-4]),                                 # norm width != D
    lambda a: a.__setitem__(0, torch.zeros((256, 384), dtype=torch.int8).t()),  # not contiguous
    lambda a: a.__setitem__(0, torch.zeros(384 * 256 + 16, dtype=torch.int8)
                            [1:1 + 384 * 256].view(384, 256)),             # misaligned
    lambda a: a.__setitem__(3, a[3].half()),                               # f16 x
    lambda a: a.__setitem__(slice(None), _qkv_args(d=254)),                # D % 4
])
def test_qkv_launcher_checks_raise_before_the_device(bad, monkeypatch):
    """Wrong shapes, T past 32, non-contiguous or misaligned weights and x
    neither bf16 nor f32 raise ValueError before the library is loaded or
    the device asked for."""
    _no_device(monkeypatch)
    a = _qkv_args()
    bad(a)
    with pytest.raises(ValueError):
        lf._qkv_launch(*a, EPS)


@pytest.mark.parametrize("t,o,d,dt,tc", [
    (8, 384, 256, torch.bfloat16, True), (24, 7680, 5120, torch.bfloat16, True),
    (1, 3072, 2048, torch.bfloat16, True), (17, 384, 256, torch.float32, False),
    (8, 384, 200, torch.bfloat16, False), (32, 384, 260, torch.bfloat16, False)])
def test_qkv_launcher_passes_plan_and_scratch(t, o, d, dt, tc, monkeypatch):
    """A valid K2 call reaches lt_qkv_norm with the plan (plan_tc at the
    given SMs), the norm phase's bf16 h and, where the plan splits the
    contraction, the slices' scratch; f32 x and widths that are not
    multiples of 16 take gemv.cuh's tiled GEMV (plan 0, no scratch)."""
    monkeypatch.setattr(ff._build, "stream", lambda: 0)
    lib = _FakeLib()
    y = lf._qkv_launch(*_qkv_args(t, o, d, dt), EPS, lib=lib, sms=5)
    (call,) = lib.calls
    assert y.shape == (t, o) and y.dtype == torch.float32 and len(call) == 18
    assert call[3] == pytest.approx(EPS) and call[9:13] == (t, o, d, 0 if dt == torch.float32 else 1)
    if tc:
        p = ff.plan_tc(t, o, d, False, 5)
        assert call[13:17] == p.args and call[7] is not None
        assert (call[8] is not None) == (p.splits > 1)
    else:
        assert call[13:17] == (0, 0, 0, 0) and call[7:9] == (None, None)


def test_qkv_takes_at_most_32_rows_on_the_card():
    """The forward asks K2 for at most 32 rows (`qkv_fits`, as the JAX
    package's `qkv_norm_fused_rowq`), and the launcher takes no more."""
    assert lf.qkv_fits(32, 384, 256, 2) and not lf.qkv_fits(33, 384, 256, 2)
    with pytest.raises(ValueError):
        lf._qkv_launch(*_qkv_args(t=33), EPS, lib=_FakeLib(), sms=5)


@pytest.mark.parametrize("bad", [
    lambda a: a.__setitem__(1, a[1].to(torch.int16)),                      # qs not int8
    lambda a: a.__setitem__(1, a[1][:, :-4].contiguous()),                 # width != I
    lambda a: a.__setitem__(0, a[0].t().contiguous().t()),                 # x not contiguous
    lambda a: a.__setitem__(0, a[0].half()),                               # f16 x
    lambda a: a.__setitem__(1, torch.zeros(300 * 256 + 16, dtype=torch.int8)
                            [4:4 + 300 * 256].view(300, 256)),             # misaligned, tc route
    lambda a: a.__setitem__(slice(None), [torch.zeros((8, 254), dtype=torch.bfloat16),
                                          torch.zeros((300, 254), dtype=torch.int8)]),  # I % 4
])
def test_rowq_launcher_checks_raise_before_the_device(bad, monkeypatch):
    """Wrong dtypes and shapes, non-contiguous x, weights not 16-byte aligned
    on the template's route and widths not a multiple of 4 raise ValueError
    before the device."""
    _no_device(monkeypatch)
    a = [torch.zeros((8, 256), dtype=torch.bfloat16), torch.zeros((300, 256), dtype=torch.int8)]
    bad(a)
    with pytest.raises(ValueError):
        qm._rowq_launch(*a)


@pytest.mark.parametrize("t,o,i,dt", [
    (1, 300, 256, torch.bfloat16), (32, 128256, 2048, torch.bfloat16),
    (33, 5120, 5120, torch.bfloat16), (127, 300, 256, torch.bfloat16),
    (8, 300, 200, torch.bfloat16), (32, 300, 256, torch.float32),
    (40, 300, 256, torch.float32), (40, 300, 200, torch.bfloat16)])
def test_rowq_launcher_passes_route_plan_and_scratch(t, o, i, dt, monkeypatch):
    """A valid K1 call reaches lt_rowq_gemv on `rowq_route`'s kernel: the
    template's passes with the plan of the largest pass and, where it
    splits the contraction, the slices' scratch; the tiled GEMV (maxt 0, no
    plan); or the row-pass GEMV with its rows a pass."""
    monkeypatch.setattr(ff._build, "stream", lambda: 0)
    lib = _FakeLib()
    y = qm._rowq_launch(torch.zeros((t, i), dtype=dt), torch.zeros((o, i), dtype=torch.int8),
                        lib=lib, sms=7)
    (call,) = lib.calls
    assert y.shape == (t, o) and y.dtype == torch.float32 and len(call) == 15
    assert call[5:8] == (t, o, i)
    route, n = qm.rowq_route(t, i, dt)
    if route == "tc":
        p = ff.plan_tc(-(-t // n), o, i, False, 7)
        assert call[8] == 0 and call[9:13] == p.args and call[13] == n
        assert (call[4] is not None) == (p.splits > 1)
    else:
        assert call[8] == (n if route == "gemv" else 0) and call[9:14] == (0,) * 5
        assert call[4] is None


def test_partial_scratch_serves_the_split_phases():
    """One f32 scratch for the slices' sums of every split phase of a call
    (they run in stream order), none where no phase splits."""
    dev = torch.device("cpu")
    one, split = ff.plan_tc(8, 300, 256, False, 132), ff.plan_tc(24, 7680, 5120, False, 132)
    assert one.splits == 1 and split.splits > 1 and one.partial_floats == 0
    assert ff.tc_partial(dev, one) is None
    buf = ff.tc_partial(dev, one, split)
    assert buf.dtype == torch.float32 and buf.numel() == split.partial_floats
    assert split.partial_floats == split.units * split.rows * split.tp


# ----------------------------------------------------------------- ablation
@pytest.mark.parametrize("name", list(qkv_ab.VARIANTS))
def test_qkv_ablation_variants_edit_the_kernel_sources(name):
    """Each variant of bench/qkv_ab.py still finds, once each, the statements
    it replaces in csrc/rowq_tc.cuh or in the kernel's source (the card
    builds and times the copies), and changes the text; every variant names
    the kernels it applies to."""
    edit_h, edit_cu, kernels = qkv_ab.VARIANTS[name]
    assert kernels and set(kernels) <= set(qkv_ab.SOURCES)
    hdr = (_build.CSRC / "rowq_tc.cuh").read_text()
    changed = False
    if edit_h:
        changed |= edit_h(hdr) != hdr
    for k in kernels if edit_cu else ():
        src = (_build.CSRC / f"{qkv_ab.SOURCES[k]}.cu").read_text()
        text = edit_cu(src)
        changed |= text != src
        assert "#include" in text
    assert changed
