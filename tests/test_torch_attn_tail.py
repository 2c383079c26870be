"""K3 (the one-lane decode layer after the qkv projection) and K16 (the
layer tail with w2 on contraction tiles) on the CPU. Their CUDA kernels run
only on the card (chip_smoke.py `check_k3`, `check_tail_kt`); here what
surrounds them and their arithmetic are held to the JAX package:

- K3's plain version with pos as an int32 tensor (as the forward passes
  its pos_vec) against JAX `layer_attn_tail_fused_rowq(interpret=True)`:
  output within rtol 5e-4, atol 1e-3, the cache bit-equal;
- K3's launcher with a fake library: bad shapes raise before the device;
  the attention phase's plan (`attention.plan_dense`), the three
  rowq_tc.cuh plans and the scratch reach the C call, the scratch in one
  buffer, each piece 16-byte aligned and apart; f32 and widths that are not
  multiples of 16 take gemv.cuh's route;
- K16's w2 plan (`layer_fused.kt_plans`): every 16-row block x
  `ktile_width(F)` slice exactly once, the slices summed in order;
- the tensor-core walk of tests/test_torch_tail_tc.py run with K16's plans
  against JAX `_tail_kernel_kt` (`_W2_KTILE` set, interpret mode), within
  1e-2 of the largest output;
- K16's launcher with a fake library, as K3's;
- bench/tail_ab.py's K3 variants: the source edit still applies, and the
  wo plan on the SMs the attention leaves free touches only that phase.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_tail_tc as ttc
import torch

import llamatpu.ops.layer_fused as jlf
from llamatpu_torch import _build
from llamatpu_torch.bench import tail_ab
from llamatpu_torch.models.weights import QTensor
from llamatpu_torch.ops import attention
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


# ------------------------------------------------------------------- K3
L, D, F = 2, 256, 640
KV, G, HD, S = 2, 2, 64, 96  # S = 96: the JAX kernel walks it in 32-row tiles
HDIM = KV * G * HD


@pytest.fixture(scope="module")
def k3_ws():
    jw = {"wo": ttc._rowq(D, HDIM, 11), "w13": ttc._rowq(2 * F, D, 12),
          "w2": ttc._rowq(D, F, 13),
          "ffn_norm": (np.random.default_rng(15).random((L, D)) + 0.5).astype(np.float32)}
    return jw, ttc.from_numpy_weights(jw)


@pytest.mark.parametrize("pos", [0, 31, 32, 63, 95])
def test_k3_plain_with_device_pos_matches_megakernel(k3_ws, pos):
    """K3's plain version, pos an int32 tensor [1] (the forward's pos_vec),
    against layer_attn_tail_fused_rowq(interpret=True), f32: the output
    within rtol 5e-4, atol 1e-3, the cache bit-equal (written at pos only)."""
    jw, tw = k3_ws
    rng = np.random.default_rng(300 + pos)
    kvc = rng.normal(size=(L, 1, KV, S, 2 * HD)).astype(np.float32)
    q4 = rng.normal(size=(1, KV, G, HD)).astype(np.float32)
    kvn = rng.normal(size=(1, KV, 2 * HD)).astype(np.float32)
    x = rng.normal(size=(1, 1, D)).astype(np.float32)
    li, scale, rs = 1, HD ** -0.5, (0.5 if pos == 63 else 1.0)
    port_cache = torch.from_numpy(kvc.copy())
    pv = torch.tensor([pos], dtype=torch.int32)
    got, cache_out = lf.layer_attn_tail_fused_rowq(
        tw["wo"], tw["w13"], tw["w2"], torch.from_numpy(jw["ffn_norm"]), torch.from_numpy(q4),
        torch.from_numpy(kvn), port_cache, torch.from_numpy(x), pv, li, EPS, scale, HD, rs)
    assert cache_out is port_cache
    out = jlf.layer_attn_tail_fused_rowq(
        jw["wo"], jw["w13"], jw["w2"], jnp.asarray(jw["ffn_norm"]), jnp.asarray(q4),
        jnp.asarray(kvn), jnp.asarray(kvc), jnp.asarray(x), jnp.asarray([pos], jnp.int32), li,
        EPS, scale, HD, rs, interpret=True)
    assert out is not None, "JAX megakernel declined the test geometry"
    want, want_cache = out
    np.testing.assert_array_equal(port_cache.numpy(), np.asarray(want_cache))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=1e-3)
    assert lf.layer_attn_tail_fused_rowq.launches == 0


class _FakeLib:
    """Records the entry points' arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def lt_attn_tail(self, *args):
        self.calls.append(args)
        return 0

    def lt_tail_kt(self, *args):
        self.calls.append(args)
        return 0


def _rowq_stack(o, i, n=L):
    return QTensor(torch.zeros((n, o, i), dtype=torch.int8), torch.ones((n, o, 1)), "q8_row")


def _k3_args(d=D, hdim=HDIM, f=F, dt=torch.bfloat16, cdt=None, s_len=S, kvh=KV, g=G, hd=HD):
    """_attn_tail_launch's tensors at the given widths: stacked q8_row wo,
    w13, w2 and ffn_norm of L layers, q, kv_new, the stacked cache, x, pos."""
    vhd = hdim // (kvh * g)
    z = torch.zeros
    return [_rowq_stack(d, hdim), _rowq_stack(2 * f, d), _rowq_stack(d, f), torch.ones((L, d)),
            z((1, kvh, g, hd), dtype=dt), z((1, kvh, hd + vhd), dtype=dt),
            z((L, 1, kvh, s_len, hd + vhd), dtype=cdt or dt), z((1, 1, d), dtype=dt),
            torch.tensor([5], dtype=torch.int32)]


def _k3_call(a, li=1, lib=None, sms=None):
    return lf._attn_tail_launch(*a, li, EPS, HD ** -0.5, a[4].shape[-1], 0.5, lib=lib, sms=sms)


def _misaligned(o, i):
    qs = torch.zeros(L * o * i + 16, dtype=torch.int8)[1:1 + L * o * i].view(L, o, i)
    return QTensor(qs, torch.ones((L, o, 1)), "q8_row")


@pytest.mark.parametrize("bad", [
    lambda a: a.__setitem__(0, _rowq_stack(D, HDIM - 64)),                 # wo width != H
    lambda a: a.__setitem__(1, _rowq_stack(2 * F - 16, D)),                # w13 rows != 2F
    lambda a: a.__setitem__(5, a[5][..., :-8].contiguous()),               # kv_new width
    lambda a: a.__setitem__(8, torch.tensor([5])),                         # int64 pos
    lambda a: a.__setitem__(8, torch.tensor([5, 6], dtype=torch.int32)),   # two positions
    lambda a: a.__setitem__(4, a[4].float()),                              # q not in x's dtype
    lambda a: a.__setitem__(7, a[7][..., :-16].contiguous()),              # x width != D
    lambda a: a.__setitem__(3, torch.ones((L, D + 16))),                   # ffn_norm width
    lambda a: a.__setitem__(3, torch.ones((L, D), dtype=torch.bfloat16)),  # ffn_norm not f32
    lambda a: a.__setitem__(0, QTensor(a[0].qs, torch.ones((L, D, 2)), "q8_row")),  # scales
    lambda a: a.__setitem__(0, QTensor(torch.zeros((L, HDIM, D), dtype=torch.int8)
                                       .transpose(1, 2), a[0].scales, "q8_row")),  # wo strided
    lambda a: a.__setitem__(2, _misaligned(D, F)),                         # w2 misaligned
    lambda a: a.__setitem__(6, a[6][:, :, :, :, :].transpose(3, 3)[:1].expand(L, 1, KV, S, 2 * HD)),
])
def test_k3_launcher_checks_raise_before_the_device(bad, monkeypatch):
    """Wrong shapes, a position that is not one int32, q in another dtype
    than x, scales that are not one a row, strided or misaligned weights
    and caches raise ValueError before the library is loaded or the device
    asked for."""
    ttc._no_device(monkeypatch)
    a = _k3_args()
    bad(a)
    with pytest.raises(ValueError):
        _k3_call(a)


def test_k3_launcher_checks_the_layer_and_declines_unported_heads(monkeypatch):
    """A layer past the stack raises ValueError; groups past 8 and value
    heads past 128 are not taken (the attention phase's register sums),
    before the device; a cache whose rows are no multiple of the plan's
    stage rows raises ValueError."""
    ttc._no_device(monkeypatch)
    with pytest.raises(ValueError):
        _k3_call(_k3_args(), li=L, sms=132)
    with pytest.raises(NotImplementedError):
        _k3_call(_k3_args(hdim=1 * 16 * HD, kvh=1, g=16))
    with pytest.raises(NotImplementedError):
        _k3_call(_k3_args(hdim=2 * 2 * 192, hd=192))
    with pytest.raises(ValueError):
        _k3_call(_k3_args(s_len=100), sms=132)


def _pieces(call, sizes):
    """The scratch pointers in order, each 16-byte aligned and at least its
    piece's bytes past the one before."""
    ptrs = [p for p in call[24:29]]
    live = [(p, n) for p, n in zip(ptrs, sizes) if n]
    assert all(p is not None and p % 16 == 0 for p, _ in live)
    for (p0, n0), (p1, _) in zip(live, live[1:]):
        assert p1 - p0 >= 4 * n0
    return ptrs


@pytest.mark.parametrize("d,hdim,f,dt,cdt,tc", [
    (D, HDIM, F, torch.bfloat16, torch.bfloat16, True),
    (2048, 2048, 8192, torch.bfloat16, torch.bfloat16, True),
    (D, HDIM, F, torch.bfloat16, torch.float32, True),
    (D, HDIM, F, torch.float32, torch.float32, False),
    (208, HDIM, F, torch.bfloat16, torch.bfloat16, True),
    (200, HDIM, F, torch.bfloat16, torch.bfloat16, False),
    (D, HDIM, 644, torch.bfloat16, torch.bfloat16, False)])
def test_k3_launcher_passes_plans_and_scratch(d, hdim, f, dt, cdt, tc, monkeypatch):
    """A valid K3 call reaches lt_attn_tail with layer li's addresses in the
    stacked weights, norms and cache, the device position's pointer,
    plan_dense's cluster and stage rows for one lane, the three plan_tc
    plans at T = 1 and the scratch (aflat, x2, act, the sums of squares, the
    slices' sums) carved from one buffer on the tensor-core route; f32, and
    bf16 at widths that are not multiples of 16, take gemv.cuh's route
    (plans 0, f32 act, no tensor-core scratch). A second call reuses the
    geometry's setup."""
    monkeypatch.setattr(ff._build, "stream", lambda: 0)
    kvh = 8 if hdim == 2048 else KV
    g = 4 if hdim == 2048 else G
    s_len = 1152 if hdim == 2048 else S
    a = _k3_args(d, hdim, f, dt, cdt, s_len, kvh, g)
    lib = _FakeLib()
    out = _k3_call(a, lib=lib, sms=7)
    assert out.shape == (1, 1, d) and out.dtype == dt
    assert ff.tc_route(dt, d, hdim, f) == tc
    n_setups = len(lf._ATTN_TAIL_SETUPS)
    _k3_call(a, lib=lib, sms=7)
    assert len(lf._ATTN_TAIL_SETUPS) == n_setups
    call = lib.calls[0]
    again = lib.calls[1]  # its own scratch and output, the same everything else
    assert again[:24] + again[30:] == call[:24] + call[30:] and len(call) == 46
    wo, w13, w2, nw, q4, kvn, kvc, x, pv = a
    ap = attention.plan_dense(1, kvh, s_len, 2 * HD, cdt.itemsize, 7)
    layer = kvh * s_len * 2 * HD * cdt.itemsize
    assert call[:6] == (q4.data_ptr(), kvn.data_ptr(), 1 if dt == torch.bfloat16 else 0,
                        kvc.data_ptr() + layer, 1 if cdt == torch.bfloat16 else 0, pv.data_ptr())
    assert call[6:14] == (s_len, kvh, g, HD, HD, HD ** -0.5, ap.cluster, ap.rows)
    assert call[14:18] == (x.data_ptr(), nw[1].data_ptr(), EPS, 0.5)
    assert call[18:24] == (wo.qs[1].data_ptr(), wo.scales[1].data_ptr(), w13.qs[1].data_ptr(),
                           w13.scales[1].data_ptr(), w2.qs[1].data_ptr(), w2.scales[1].data_ptr())
    assert call[30:33] == (d, f, 1 if dt == torch.bfloat16 else 0)
    if tc:
        plans = (ff.plan_tc(1, d, hdim, False, 7), ff.plan_tc(1, f, d, True, 7),
                 ff.plan_tc(1, d, f, False, 7))
        assert call[33:45] == tuple(v for p in plans for v in p.args)
        split = max(p.partial_floats for p in plans)
        ptrs = _pieces(call, (hdim, d, -(-f // 2), -(-d // 16), split))
        assert ptrs[3] is not None and (ptrs[4] is not None) == (split > 0)
    else:
        assert call[33:45] == (0,) * 12
        ptrs = _pieces(call, (hdim, d, f, 0, 0))
        assert ptrs[3:] == [None, None]


# ------------------------------------------------------------------ K16
@pytest.mark.parametrize("sms", [1, 3, 7, 132])
@pytest.mark.parametrize("t", [1, 8, 17, 32])
@pytest.mark.parametrize("geo", list(ttc.WIDTHS))
def test_k16_w2_plan_covers_each_block_and_tile_once(geo, t, sms):
    """K16's w2 plan slices the contraction at ktile_width(F) (1024 at
    Llama-3.2-1B: 8 slices): over all CTAs every 16 g-row block and tile is
    one unit, each CTA's share within a unit of the others', the slices
    added in order 0, 1, ... (the TPU kernel's tile order); its wo and w13
    plans are K9's."""
    d, h, f = ttc.WIDTHS[geo]
    tf = lf.ktile_width(f)
    p_o, p13, p2 = lf.kt_plans(t, d, h, f, torch.device("cpu"), sms)
    assert (p_o, p13) == (ff.plan_tc(t, d, h, False, sms), ff.plan_tc(t, f, d, True, sms))
    assert p2.ksl == tf and p2.splits == f // tf and p2.g in ff.TC_GROUPS
    assert list(p2.order) == list(range(f // tf)) and p2.ctas == min(p2.units, sms)
    assert p2.tp * (2 * p2.ksl + 32) <= ff.tc_x_bytes(p2.tp, False, p2.g, True)
    seen = np.zeros((p2.splits, p2.nrb), dtype=np.int32)
    shares = []
    for c in range(p2.ctas):
        us = p2.units_of(c)
        shares.append(len(us))
        for u in us:
            o0, o1, k0, k1 = p2.unit(u)
            assert k0 == (u // p2.nrb) * tf and k1 - k0 == tf and o0 % p2.rows == 0
            seen[k0 // tf, o0 // p2.rows] += 1
    assert (seen == 1).all() and max(shares) - min(shares) <= 1
    if geo == "llama32-1b":
        assert (tf, p2.splits) == (1024, 8)


def test_k16_w2_walk_is_the_tiled_sum():
    """At small integers (exact sums) the w2 walk on K16's plan gives the
    tiles' products summed in tile order bit for bit."""
    rng = np.random.default_rng(9)
    qs = torch.from_numpy(rng.integers(-127, 128, size=(D, F), dtype=np.int8))
    x = torch.from_numpy(rng.integers(-3, 4, size=(9, F)).astype(np.float32))
    p2 = lf.kt_plans(9, D, 384, F, torch.device("cpu"), 3)[2]
    got, _ = ttc.walk_phase(x, qs, p2)
    tf = lf.ktile_width(F)
    want = torch.zeros((9, D))
    for k0 in range(0, F, tf):
        want += x[:, k0:k0 + tf] @ qs[:, k0:k0 + tf].float().T
    assert torch.equal(got, want)


@pytest.mark.parametrize("t", [1, 5, 8, 17, 32])
def test_k16_walk_matches_pallas_ktile(t, monkeypatch):
    """K9's emulated walk with K16's plans (the w2 slices at the tile width)
    against layer_tail_fused_rowq(interpret=True) with `_W2_KTILE` set
    (`_tail_kernel_kt`) on bf16 inputs, both layers, rs 1 and 0.5: within
    1e-2 of the largest JAX output."""
    jw = {"wo": ttc._rowq(ttc.D, ttc.H, 1), "w13": ttc._rowq(2 * ttc.F, ttc.D, 2),
          "w2": ttc._rowq(ttc.D, ttc.F, 3),
          "ffn_norm": (np.random.default_rng(5).random((ttc.L, ttc.D)) + 0.5).astype(np.float32)}
    tw = ttc.from_numpy_weights(jw)
    monkeypatch.setattr(jlf, "_W2_KTILE", True)
    assert jlf._fit_tail_tiles_kt(t, ttc.D, ttc.H, 2 * ttc.F, ttc.F, 2)[2] == \
        lf.ktile_width(ttc.F)
    rng = np.random.default_rng(400 + t)
    attn = (rng.normal(size=(t, ttc.H)) * 0.5).astype(np.float32)
    x = rng.normal(size=(t, ttc.D)).astype(np.float32)
    ja, jx = jnp.asarray(attn).astype(jnp.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)
    ta, tx = torch.from_numpy(attn).to(torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    monkeypatch.setattr(ttc, "_phases", lambda t_, d, h, f, sms: list(
        lf.kt_plans(t_, d, h, f, torch.device("cpu"), sms)))
    for li, rs in ((0, 1.0), (1, 0.5)):
        want = jlf.layer_tail_fused_rowq(jw["wo"], jw["w13"], jw["w2"],
                                         jnp.asarray(jw["ffn_norm"]), ja, jx, jnp.int32(li), EPS,
                                         rs, interpret=True)
        want = np.asarray(want.astype(jnp.float32))
        got = ttc.tail_emulated(*ttc._layer(tw, "wo", li), *ttc._layer(tw, "w13", li),
                                *ttc._layer(tw, "w2", li), tw["ffn_norm"][li].float(), ta, tx, rs)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("bad", [
    lambda a: a.__setitem__(2, a[2][:, :-16].contiguous()),                # attn width != H
    lambda a: a.__setitem__(3, a[3][:4].contiguous()),                     # x rows != attn rows
    lambda a: (a.__setitem__(2, torch.zeros((33, 384), dtype=torch.bfloat16)),
               a.__setitem__(3, torch.zeros((33, 256), dtype=torch.bfloat16))),  # T > 32
    lambda a: a.__setitem__(0, a[0][:2] + ((torch.zeros((256, 644), dtype=torch.int8),
                                            a[0][2][1]),)),                # no tile divides F
    lambda a: a.__setitem__(0, a[0][:2] + ((torch.zeros(256 * 640 + 16, dtype=torch.int8)
                                            [1:1 + 256 * 640].view(256, 640),
                                            a[0][2][1]),)),                # w2 misaligned
])
def test_k16_launcher_checks_raise_before_the_device(bad, monkeypatch):
    """Wrong shapes, T past 32, an F no tile divides, misaligned weights
    raise ValueError before the library is loaded or the device asked for."""
    ttc._no_device(monkeypatch)
    a = ttc._tail_parts()
    bad(a)
    with pytest.raises(ValueError):
        lf._tail_launch(*a, EPS, 1.0, kt=True)


@pytest.mark.parametrize("t,d,h,f,dt,tc", [
    (8, 256, 384, 640, torch.bfloat16, True), (32, 2048, 2048, 8192, torch.bfloat16, True),
    (1, 2048, 2048, 8192, torch.bfloat16, True), (17, 256, 384, 640, torch.float32, False),
    (8, 200, 384, 640, torch.bfloat16, False)])
def test_k16_launcher_passes_plans_and_scratch(t, d, h, f, dt, tc, monkeypatch):
    """A valid K16 call reaches lt_tail_kt with the tile width and, on the
    tensor-core route, kt_plans' three plans, bf16 act, the sums of squares
    and the slices' sums; f32, and bf16 at widths that are not multiples of
    16, take gemv.cuh's route: plans 0, f32 act and the tiles' partials
    [F / tf, T, D]."""
    monkeypatch.setattr(ff._build, "stream", lambda: 0)
    lib = _FakeLib()
    parts, nw, a2, x2in = ttc._tail_parts(d, h, f, dt, t)
    out = lf._tail_launch(parts, nw, a2, x2in, EPS, 0.5, lib=lib, sms=5, kt=True)
    (call,) = lib.calls
    tf = lf.ktile_width(f)
    assert out.shape == (t, d) and out.dtype == dt and len(call) == 36
    assert call[17:23] == (t, d, h, f, tf, 1 if dt == torch.bfloat16 else 0)
    assert call[4:6] == (EPS, 0.5)
    if tc:
        plans = lf.kt_plans(t, d, h, f, torch.device("cpu"), 5)
        assert call[23:35] == tuple(v for p in plans for v in p.args)
        assert call[32:34] == (f // tf, tf)  # the w2 plan's slices are the tiles
        assert call[14] is not None and call[15] is not None  # ssp; w2 always splits
    else:
        assert call[23:35] == (0,) * 12 and call[14] is None and call[15] is not None


@pytest.mark.parametrize("name", list(tail_ab.K3_VARIANTS))
def test_k3_ablation_variants_edit_the_kernel_source(name):
    """Each K3 variant of bench/tail_ab.py still finds, once, the statement it
    replaces in csrc/layer_fused.cu (the card builds and times the copy),
    and changes the text."""
    src = (_build.CSRC / "layer_fused.cu").read_text()
    text = tail_ab.K3_VARIANTS[name](src)
    assert text != src and '#include "attention.cu"' in text


def test_k3_ablation_plans_wo_on_the_free_sms(monkeypatch):
    """tail_ab's `WoOnFreeSms` plans only K3's wo phase (T = 1, [D, H]) on
    the SMs the attention's CTAs leave free, and restores the planner."""
    monkeypatch.setattr(ff, "_sm_count", lambda i: 132)
    plan = ff.tc_plan
    with tail_ab.WoOnFreeSms(lf, ff, 2048, 2048, 64):
        dev = torch.device("cpu")
        assert ff.tc_plan(1, 2048, 2048, False, dev) == ff.plan_tc(1, 2048, 2048, False, 68)
        assert ff.tc_plan(1, 2048, 8192, False, dev) == ff.plan_tc(1, 2048, 8192, False, 132)
        assert ff.tc_plan(8, 2048, 2048, False, dev) == ff.plan_tc(8, 2048, 2048, False, 132)
    assert ff.tc_plan is plan
