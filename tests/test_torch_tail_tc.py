"""K9's and K20's bf16 phases on the tensor-core template (csrc/rowq_tc.cuh
`rowq_tc_kernel`) on the CPU. The CUDA kernel runs only on the card
(chip_smoke.py `check_tail`, `check_ffn_fused`, `check_phi3_geometry`);
here what surrounds it and its arithmetic are held to the JAX package:

- the plan (`ffn_fused.plan_tc`): every (16-row block, contraction slice)
  exactly once, the CTAs' shares within one unit of each other, the slices
  added in order 0, 1, ... (by the split phases' second launch), a CTA's x
  slice within its shared memory with at least three ring stages beside
  it, at Llama-3.2-1B, Phi-3-medium, Qwen2.5-14B and tiny widths;
- the kernel's walk emulated in torch (bf16 operands, f32 sums per box, a
  unit's 8 warp parts in order, the slices' sums in plan order, the
  epilogues with the sums of squares of x2 per 16-row block) against the
  JAX package's `layer_tail_fused_rowq(interpret=True)` and
  `ffn_fused_rowq(interpret=True)` on the same numpy inputs, within 1e-2 of
  the largest output (the bf16 gate of tests/test_torch_batch.py and
  tests/test_torch_ffn_fused.py);
- the launchers, with a fake library: bad shapes raise before the device,
  the plans and scratch reach the C call (the slices' sums only where a
  phase splits its contraction); f32 activations take gemv.cuh's route, and
  so do K9's widths that are not multiples of 16 (K20 raises for them in
  bf16);
- bench/tail_ab.py's variants, which edit the kernel's source.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llamatpu.ops.ffn_fused as jff
import llamatpu.ops.layer_fused as jlf
from llamatpu.models.weights import QTensor as JQTensor
from llamatpu.models.weights import prepare_qtensor, rowq_requant
from llamatpu_torch import _build
from llamatpu_torch.bench import tail_ab
from llamatpu_torch.models.weights import from_numpy_weights
from llamatpu_torch.ops import ffn_fused as ff
from llamatpu_torch.ops import layer_fused as lf

EPS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one intra-op thread: the test workers and the JAX
    compiler share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- the plan
# (D, H, F) of each geometry: K9's phases wo [D, H], w13 [2F, D], w2 [D, F];
# K20's the last two
WIDTHS = {"llama32-1b": (2048, 2048, 8192), "phi3-medium": (5120, 5120, 17920),
          "qwen25-14b": (5120, 5120, 13824), "tiny": (256, 384, 640)}


def _phases(t, d, h, f, sms):
    return [ff.plan_tc(t, d, h, False, sms), ff.plan_tc(t, f, d, True, sms),
            ff.plan_tc(t, d, f, False, sms)]


def _ring_stages(p: ff.TcPlan) -> int:
    """The ring depth csrc/rowq_tc.cuh `launch_nf` derives: 227 KB less the
    static room, the 1 KB alignment, the x slice, the warps' parts and, with
    one slice, a unit's sums."""
    nh = 2 if p.pair else 1
    xbytes = p.tp * (2 * p.ksl + 32)
    red = nh * 8 * 16 * p.tp * 4
    fin = nh * p.g * 16 * p.tp * 4 if p.splits == 1 else 0
    stage = nh * 8 * 16 * 128
    return min(8, (232448 - 1024 - 1024 - xbytes - red - fin) // stage)


@pytest.mark.parametrize("sms", [1, 3, 7, 132])
@pytest.mark.parametrize("t", [1, 8, 16, 17, 24, 32])
@pytest.mark.parametrize("geo", list(WIDTHS))
def test_plan_covers_each_block_and_slice_once(geo, t, sms):
    """Over all CTAs each phase's units cover every (output row, column)
    exactly once, in blocks of 16 g rows (g of 1, 2, 4) and slices of ksl
    columns (a multiple of 128, the last one shorter); each CTA's share is
    within one unit of every other's and its units are contiguous; the
    slices' sums are added in order; the x slice fits `tc_x_bytes`, which
    leaves at least three ring stages beside it."""
    d, h, f = WIDTHS[geo]
    for p in _phases(t, d, h, f, sms):
        assert p.g in ff.TC_GROUPS and p.rows == 16 * p.g
        assert p.ksl % 128 == 0 and (p.splits - 1) * p.ksl < p.i <= p.splits * p.ksl
        assert p.tp * (2 * p.ksl + 32) <= ff.tc_x_bytes(p.tp, p.pair, p.g, p.splits > 1)
        assert _ring_stages(p) >= 3
        assert p.ctas == min(p.units, sms) and list(p.order) == list(range(p.splits))
        seen = np.zeros((p.splits, p.nrb), dtype=np.int32)
        cols = np.zeros(p.i, dtype=np.int32)
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
                if o0 == 0:
                    cols[k0:k1] += 1
        assert nxt == p.units and (seen == 1).all() and (cols == 1).all()
        assert max(shares) - min(shares) <= 1
        assert p.partial_floats == (0 if p.splits == 1 else
                                    p.units * p.rows * p.tp * (2 if p.pair else 1))


@pytest.mark.parametrize("t", [1, 8, 32])
def test_plan_fills_the_card_at_catalog_widths(t):
    """At 132 SMs every phase of Llama-3.2-1B, Phi-3-medium and Qwen2.5-14B
    keeps the busiest CTA within 20 % of the mean weight columns a CTA (the
    plan trades balance against each unit's fixed cost, TC_UNIT_BYTES), and
    K20's Phi-3-medium w2 phase splits its 17920 columns."""
    for geo in ("llama32-1b", "phi3-medium", "qwen25-14b"):
        d, h, f = WIDTHS[geo]
        for p in _phases(t, d, h, f, 132):
            cols = [sum(p.unit(u)[3] - p.unit(u)[2] for u in p.units_of(c))
                    for c in range(p.ctas)]
            mean = p.nrb * p.i / 132
            assert max(cols) <= 1.2 * max(mean, p.ksl), (geo, t, p)
    assert ff.plan_tc(24, 5120, 17920, False).splits > 1


# ----------------------------------------------------- the walk, emulated
def _bf16(a):
    return a.to(torch.bfloat16).float()


def walk_phase(x, qs, p: ff.TcPlan):
    """The sums of one phase as rowq_tc.cuh takes them: x [T, I] (bf16
    values in f32), qs [rows, I] int8 (PAIR: the up row o + p.o beside gate
    row o). Per unit, each 16-row group's wpg = 8 / g warps split each
    stage's 128 wpg columns, warp j taking columns k + 128 j, summing in
    f32; the group's parts are added in warp order; a block's slices are
    added in plan order. Returns (sum, up sum or None) [T, O]."""
    t = x.shape[0]
    wpg = 8 // p.g
    xp = torch.zeros((p.tp, p.i))
    xp[:t] = x
    w = qs.float()
    out = [torch.zeros((p.tp, p.o)) for _ in range(2 if p.pair else 1)]
    for u in range(p.units):
        o0, o1, k0, k1 = p.unit(u)
        for h, acc in enumerate(out):
            for r0 in range(o0, o1, 16):
                r1 = min(r0 + 16, o1)
                rows = w[r0 + h * p.o:r1 + h * p.o]
                parts = torch.zeros((wpg, p.tp, r1 - r0))
                for k in range(k0, k1, 128 * wpg):
                    for j in range(wpg):
                        c0 = k + 128 * j
                        if c0 < k1:
                            c1 = min(c0 + 128, k1)
                            parts[j] += xp[:, c0:c1] @ rows[:, c0:c1].T
                unit = parts[0].clone()
                for j in range(1, wpg):
                    unit += parts[j]
                acc[:, r0:r1] += unit  # slices in order: u walks slice-major
    return out[0][:t], out[1][:t] if p.pair else None


def tail_emulated(wo, so, w13, s13, w2, s2, nw, attn, x, rs, sms=3, splits=None):
    """K9's three phases on the walk, in the kernel's epilogue order; x and
    attn bf16 [T, *]. `splits` forces the slice counts (to reach the split-K
    path at tiny widths)."""
    t, d = x.shape
    h, f = attn.shape[1], w2.shape[1]
    plans = _phases(t, d, h, f, sms)
    if splits is not None:
        plans = [_forced(p, s) for p, s in zip(plans, splits)]
    v, _ = walk_phase(attn.float(), wo, plans[0])
    x2 = x.float() + (v * so) * rs
    ss = (x2 * x2).reshape(t, -1, 16).sum(-1)  # a 16-row block's sum, then blocks in order
    rstd = 1.0 / torch.sqrt(ss.sum(-1, keepdim=True) / d + EPS)
    hn = _bf16((x2 * rstd) * nw)
    g, u = walk_phase(hn, w13, plans[1])
    gate, up = g * s13[:f], u * s13[f:]
    act = _bf16((gate * torch.sigmoid(gate)) * up)
    v2, _ = walk_phase(act, w2, plans[2])
    return (x2 + (v2 * s2) * rs).to(torch.bfloat16)


def ffn_emulated(w13, s13, w2, s2, x, sms=3, splits=None):
    """K20's two phases on the walk: act in bf16, out f32."""
    t, d = x.shape
    f = w2.shape[1]
    plans = [ff.plan_tc(t, f, d, True, sms), ff.plan_tc(t, d, f, False, sms)]
    if splits is not None:
        plans = [_forced(p, s) for p, s in zip(plans, splits)]
    g, u = walk_phase(x.float(), w13, plans[0])
    gate, up = g * s13[:f], u * s13[f:]
    act = _bf16((gate * torch.sigmoid(gate)) * up)
    v, _ = walk_phase(act, w2, plans[1])
    return v * s2


def _forced(p: ff.TcPlan, splits: int, g: int = 2) -> ff.TcPlan:
    """p with `splits` slices of 16 g-row blocks, on 3 CTAs."""
    ksl = -(-(-(-p.i // splits)) // 128) * 128
    n = -(-p.i // ksl)
    return ff.TcPlan(p.t, p.o, p.i, p.pair, g, n, ksl, min(n * -(-p.o // (16 * g)), 3))


L, D, H, F = 2, 256, 384, 640


def _rowq(o, i, seed):
    rng = np.random.default_rng(seed)
    qs = rng.integers(-127, 128, size=(L, o, i), dtype=np.int8)
    scales = rng.random((L, o, i // 32), dtype=np.float32) * 0.01 + 0.005
    return rowq_requant(prepare_qtensor(JQTensor(qs, scales, "q8_0")))


@pytest.fixture(scope="module")
def ws():
    jw = {"wo": _rowq(D, H, 1), "w13": _rowq(2 * F, D, 2), "w2": _rowq(D, F, 3),
          "ffn_norm": (np.random.default_rng(5).random((L, D)) + 0.5).astype(np.float32)}
    return jw, from_numpy_weights(jw)


def _layer(tw, name, li):
    return tw[name].qs[li], tw[name].scales[li][:, 0]


@pytest.mark.parametrize("splits", [None, (2, 3, 3)])
@pytest.mark.parametrize("t", [1, 5, 8, 17, 24, 32])
def test_tail_walk_matches_pallas(ws, t, splits):
    """K9's walk (the plan at 3 SMs, and forced to 2 / 3 / 3 slices) against
    layer_tail_fused_rowq(interpret=True) on bf16 inputs, both layers,
    rs 1 and 0.5: within 1e-2 of the largest JAX output."""
    jw, tw = ws
    rng = np.random.default_rng(100 + t)
    attn = (rng.normal(size=(t, H)) * 0.5).astype(np.float32)
    x = rng.normal(size=(t, D)).astype(np.float32)
    jx, ja = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(attn).astype(jnp.bfloat16)
    tx, ta = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(attn).to(torch.bfloat16)
    for li, rs in ((0, 1.0), (1, 0.5)):
        want = jlf.layer_tail_fused_rowq(jw["wo"], jw["w13"], jw["w2"],
                                         jnp.asarray(jw["ffn_norm"]), ja, jx, jnp.int32(li),
                                         EPS, rs, interpret=True)
        want = np.asarray(want.astype(jnp.float32))
        got = tail_emulated(*_layer(tw, "wo", li), *_layer(tw, "w13", li),
                            *_layer(tw, "w2", li), tw["ffn_norm"][li].float(), ta, tx, rs,
                            splits=splits)
        assert got.dtype == torch.bfloat16 and got.shape == (t, D)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("splits", [None, (3, 5)])
@pytest.mark.parametrize("t", [1, 5, 8, 17, 24, 32])
def test_ffn_walk_matches_pallas(ws, t, splits):
    """K20's walk (the plan at 3 SMs, and forced to 3 / 5 slices) against
    ffn_fused_rowq(interpret=True) on bf16 x, both layers: within 1e-2 of
    the largest JAX output."""
    jw, tw = ws
    x = np.random.default_rng(200 + t).normal(size=(t, D)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for li in range(L):
        want = jff.ffn_fused_rowq(jw["w13"], jw["w2"], jx, jnp.int32(li), interpret=True)
        want = np.asarray(want.astype(jnp.float32))
        got = ffn_emulated(*_layer(tw, "w13", li), *_layer(tw, "w2", li), tx, splits=splits)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2 * np.abs(want).max())


def test_walk_sums_are_the_plain_products(ws):
    """At f32 inputs whose products and sums are exact (small integers), the
    walk's slice and part order gives the plain product bit for bit: the
    emulation covers every column once."""
    _, tw = ws
    rng = np.random.default_rng(7)
    qs = tw["w13"].qs[0]
    x = torch.from_numpy(rng.integers(-3, 4, size=(9, D)).astype(np.float32))
    for s in (1, 2, 3):
        for grp in ff.TC_GROUPS:
            p = _forced(ff.plan_tc(9, F, D, True, 3), s, grp)
            g, u = walk_phase(x, qs, p)
            assert torch.equal(g, x @ qs[:F].float().T) and torch.equal(u, x @ qs[F:].float().T)


# ----------------------------------------------------------------- launcher
class _FakeLib:
    """Records the entry points' arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def lt_tail(self, *args):
        self.calls.append(args)
        return 0

    def lt_ffn_fused(self, *args):
        self.calls.append(args)
        return 0


def _no_device(monkeypatch):
    def no_device(*_):
        raise AssertionError("reached the device")
    monkeypatch.setattr(ff._build, "load", no_device)
    monkeypatch.setattr(ff, "_sm_count", no_device)  # every plan's SMs (ffn_fused.tc_plan)


def _tail_parts(d=256, h=384, f=640, dt=torch.bfloat16, t=8):
    z = torch.zeros
    parts = ((z((d, h), dtype=torch.int8), z(d)), (z((2 * f, d), dtype=torch.int8), z(2 * f)),
             (z((d, f), dtype=torch.int8), z(d)))
    return [parts, z(d), z((t, h), dtype=dt), z((t, d), dtype=dt)]


@pytest.mark.parametrize("bad", [
    lambda a: a.__setitem__(2, a[2][:, :-16].contiguous()),                # attn width != H
    lambda a: a.__setitem__(3, a[3][:, :-16].contiguous()),                # x width != D
    lambda a: a.__setitem__(2, a[2][:4].contiguous()),                     # attn rows != x rows
    lambda a: (a.__setitem__(2, torch.zeros((33, 384), dtype=torch.bfloat16)),
               a.__setitem__(3, torch.zeros((33, 256), dtype=torch.bfloat16))),  # T > 32
    lambda a: a.__setitem__(0, ((torch.zeros((384, 256), dtype=torch.int8).t(), a[0][0][1]),)
                            + a[0][1:]),                                   # wo not contiguous
    lambda a: a.__setitem__(0, ((a[0][0][0], a[0][0][1]), (a[0][1][0][:-16], a[0][1][1]),
                                a[0][2])),                                 # w13 rows != 2F
    lambda a: a.__setitem__(0, a[0][:2] + ((torch.zeros(256 * 640 + 16, dtype=torch.int8)
                                            [1:1 + 256 * 640].view(256, 640),
                                            a[0][2][1]),)),                # w2 misaligned
])
def test_tail_launcher_checks_raise_before_the_device(bad, monkeypatch):
    """Wrong shapes, T past 32, non-contiguous or misaligned weights raise
    ValueError before the library is loaded or the device asked for."""
    _no_device(monkeypatch)
    a = _tail_parts()
    bad(a)
    with pytest.raises(ValueError):
        lf._tail_launch(*a, EPS, 1.0)


def _ffn_parts(d, f, dt=torch.bfloat16, t=8):
    z = torch.zeros
    return [z((t, d), dtype=dt), z((2 * f, d), dtype=torch.int8), z(2 * f),
            z((d, f), dtype=torch.int8), z(d)]


@pytest.mark.parametrize("bad", [
    lambda a: a.__setitem__(0, a[0][:, :-16].contiguous()),                # x width != D
    lambda a: a.__setitem__(0, torch.zeros((33, 256), dtype=torch.bfloat16)),  # T > 32
    lambda a: a.__setitem__(1, a[1].t().contiguous().t()),                 # w13 not contiguous
    lambda a: a.__setitem__(3, a[3][:, :-16].contiguous()),                # w2 width != F
    lambda a: a.__setitem__(0, a[0].half()),                               # f16 x
    lambda a: a.__setitem__(slice(None), _ffn_parts(200, 640)),            # bf16, D % 16
    lambda a: a.__setitem__(slice(None), _ffn_parts(256, 644)),            # bf16, F % 16
])
def test_ffn_launcher_checks_raise_before_the_device(bad, monkeypatch):
    """Wrong shapes, T past 32, non-contiguous weights, x neither bf16 nor
    f32, and bf16 x at widths that are not multiples of 16 (no TMA route,
    and no shape the JAX fit admits) raise ValueError before the device."""
    _no_device(monkeypatch)
    a = _ffn_parts(256, 640)
    bad(a)
    with pytest.raises(ValueError):
        ff._ffn_launch(*a)


@pytest.mark.parametrize("t,d,h,f,dt,tc", [
    (8, 256, 384, 640, torch.bfloat16, True), (32, 2048, 2048, 8192, torch.bfloat16, True),
    (1, 5120, 5120, 17920, torch.bfloat16, True), (17, 256, 384, 640, torch.float32, False),
    (8, 200, 384, 640, torch.bfloat16, False), (8, 256, 388, 640, torch.bfloat16, False),
    (8, 256, 384, 644, torch.bfloat16, False)])
def test_tail_launcher_passes_plans_and_scratch(t, d, h, f, dt, tc, monkeypatch):
    """A valid K9 call reaches lt_tail with the three phases' plans (plan_tc
    at the given SMs), bf16 act, the sums-of-squares, split and counter
    scratch on the tensor-core route; bf16 at widths that
    are not multiples of 16, and f32, take gemv.cuh's route (plans 0, f32
    act, no tensor-core scratch)."""
    monkeypatch.setattr(ff._build, "stream", lambda: 0)
    lib = _FakeLib()
    assert ff.tc_route(dt, d, h, f) == tc
    parts, nw, a2, x2in = _tail_parts(d, h, f, dt, t)
    out = lf._tail_launch(parts, nw, a2, x2in, EPS, 0.5, lib=lib, sms=5)
    (call,) = lib.calls
    assert out.shape == (t, d) and out.dtype == dt
    assert call[17:22] == (t, d, h, f, 1 if dt == torch.bfloat16 else 0)
    plans = _phases(t, d, h, f, 5)
    if tc:
        assert call[22:34] == tuple(v for p in plans for v in p.args)
        assert call[14]  # ssp; the slices' sums only where a phase splits
        assert (call[15] is not None) == any(p.splits > 1 for p in plans)
    else:
        assert call[22:34] == (0,) * 12 and call[14:16] == (None, None)
    assert len(call) == 35 and call[4:6] == (EPS, 0.5)


@pytest.mark.parametrize("t,d,f,dt,tc", [
    (24, 256, 640, torch.bfloat16, True), (17, 5120, 17920, torch.bfloat16, True),
    (32, 256, 640, torch.float32, False), (8, 208, 656, torch.bfloat16, True),
    (8, 200, 644, torch.float32, False)])
def test_ffn_launcher_passes_plans_and_scratch(t, d, f, dt, tc, monkeypatch):
    """A valid K20 call reaches lt_ffn_fused with both phases' plans and,
    where a phase splits its contraction, the slices' scratch for bf16 x
    (rowq_tc.cuh); f32 x takes gemv.cuh's route at any width that is a
    multiple of 4."""
    monkeypatch.setattr(ff._build, "stream", lambda: 0)
    lib = _FakeLib()
    out = ff._ffn_launch(*_ffn_parts(d, f, dt, t), lib=lib, sms=7)
    (call,) = lib.calls
    assert out.shape == (t, d) and out.dtype == torch.float32 and call[9:12] == (t, d, f)
    if tc:
        p13, p2 = ff.plan_tc(t, f, d, True, 7), ff.plan_tc(t, d, f, False, 7)
        assert call[12:20] == (*p13.args, *p2.args) and call[8]
        assert (call[7] is not None) == (p13.splits > 1 or p2.splits > 1)
    else:
        assert call[12:20] == (0,) * 8 and call[7] is None
    assert len(call) == 21


@pytest.mark.parametrize("t,d,h,f", [(8, 5120, 5120, 17920), (32, 2048, 2048, 8192),
                                     (3, 256, 384, 640)])
def test_tail_scratch_covers_every_phase(t, d, h, f):
    """K9's scratch holds what the kernel writes: act [t, F] bf16, the sums
    of squares of x2 for every 16-row block of D (whatever a phase's row
    groups), and every split phase's units' sums (none if no phase splits)."""
    plans = _phases(t, d, h, f, 132)
    act, ssp, partial = lf._tail_scratch(t, d, f, plans, torch.device("cpu"))
    assert act.shape == (t, f) and act.dtype == torch.bfloat16
    assert ssp.shape == (t, -(-d // 16)) and ssp.dtype == torch.float32
    if any(p.splits > 1 for p in plans):
        assert partial.dtype == torch.float32
        assert all(partial.numel() >= p.partial_floats for p in plans)
    else:
        assert partial is None


# ----------------------------------------------------------------- ablation
@pytest.mark.parametrize("name", list(tail_ab.VARIANTS))
def test_tail_ablation_variants_edit_the_kernel_source(name):
    """Each variant of bench/tail_ab.py still finds, once each, the
    statements it replaces in csrc/rowq_tc.cuh (the card builds and times
    the copies), and changes the text."""
    src = (_build.CSRC / "rowq_tc.cuh").read_text()
    text = tail_ab.VARIANTS[name](src)
    assert text != src and "#include" in text
