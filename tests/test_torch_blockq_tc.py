"""K5 and K7's kernels (csrc/block_matmul.cu) on the CPU. The CUDA kernels run
only on the card (chip_smoke.py `check_block_matmul`, `check_block_edges`,
`check_block_wide`);
here what surrounds them and their arithmetic are held to the JAX package:

- `block_route` at every (T, x dtype, weight kind, I % 128) case;
- the wgmma GEMM's plan (ops/gemm.py `plan_gemm`, K17's mode) at the paths'
  shapes: every output tile once, a shared tile's K stages summed in order,
  every SM busy where the tiles can fill them; `plan_tc` with the block
  kinds (whole boxes of 128 or 256 columns, the x slice and three stages of
  weights and scales in shared memory);
- the plain K5 / K7 against `_quant_matmul_2d` / `_quant_matmul_2d_li` in
  interpret mode with bf16 x;
- a lane's reads of both routes emulated on the swizzled stages (the wgmma
  route's natural k order: columns 2q, 2q + 1, 2q + 8, 2q + 9 of a step;
  rowq_tc.cuh's permuted one: 4q .. 4q + 3), the weight they rebuild
  bit-equal to the plain dequantization, and the wgmma route's walk
  emulated against JAX;
- chip_smoke.py's cases at the other paths' widths reach the plans the
  Llama widths do not;
- the launcher: the route code and plan it passes, and its checks;
- bench/block_ab.py's variants, which edit the kernel's source.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_blockq import _jax_weight
from test_torch_gemm import _iterations
from test_torch_moe_tc import bf16_bits, bf16_value, spread_nibbles

from llamatpu.ops.pallas_matmul import _quant_matmul_2d, _quant_matmul_2d_li
from llamatpu_torch.bench import block_ab
from llamatpu_torch.models.weights import unpack4_pairs
from llamatpu_torch.ops import ffn_fused as ff
from llamatpu_torch.ops import gemm
from llamatpu_torch.ops import quant_matmul as qm

BF16, F32 = torch.bfloat16, torch.float32


# ------------------------------------------------------------------- route
@pytest.mark.parametrize("t", [1, 8, 15, 16, 17, 32, 33, 64, 512])
def test_block_route(t):
    """bf16 at widths % 128 == 0: rowq_tc.cuh up to 32 rows, the wgmma GEMM
    above; f32, and bf16 where a row of block scales is not a 16-byte
    multiple, the CUDA-core GEMV below 16 rows and the tiled kernel from 16.
    K5 and K7 alike."""
    for packed in (False, True):
        for i in (2048, 2080, 5120, 8192):
            for dt in (BF16, F32):
                got = qm.block_route(t, i, dt, packed)
                if dt == BF16 and i % 128 == 0:
                    want = "tc" if t <= 32 else "wgmma"
                else:
                    want = "gemv" if t < 16 else "tiled"
                assert got == want, (t, i, dt, packed)


# ------------------------------------------------------------------- plans
LLAMA = dict(wqkv=(3072, 2048), wo=(2048, 2048), w13=(16384, 2048), w2=(2048, 8192))
PHI3 = dict(wqkv=(7680, 5120), wo=(5120, 5120), w13=(35840, 5120), w2=(5120, 17920))
QWEN_ATTN = dict(wqkv=(6144, 2048), wo=(2048, 2048))
HEADS = dict(llama=(128256, 2048), qwen=(151936, 2048), phi3=(32064, 5120))
WGMMA_SHAPES = ([(512, o, i) for o, i in LLAMA.values()] + [(33, 3072, 2048), (200, 2048, 8192)]
                + [(512, o, i) for o, i in PHI3.values()]
                + [(512, o, i) for o, i in QWEN_ATTN.values()]
                + [(512, o, i) for o, i in HEADS.values()] + [(64, 200, 2048), (130, 200, 256)])


@pytest.mark.parametrize("t,o,i", WGMMA_SHAPES)
def test_wgmma_plan_at_path_shapes(t, o, i):
    """The wgmma route's plan on 132 SMs and on 7, both weight kinds: tiles
    of 128 weight rows and 128 nx x rows (nx = 2 only above 128 rows); every
    (tile, K stage) exactly once; a shared tile's pieces from consecutive
    CTAs in K order, each workspace slot holding one tile; no CTA idle where
    the tiles (whole tiles in rounds) or their stages (plan_gemm's K17 plan)
    could fill the SMs; the plan is the cheapest candidate of the cost
    model."""
    for sms in (132, 7):
        plan, nx = qm.wgmma_plan(t, o, i, sms)
        assert qm.block_plan(t, o, i, "wgmma", True, sms) == (plan, nx)
        assert nx in ((1, 2) if t > 128 else (1,))
        rows = 128 * nx
        assert (plan.tiles_m, plan.tiles_n, plan.nk) == (-(-t // rows), -(-o // 128), i // 128)
        seen, per_cta = _iterations(plan)
        assert len(seen) == plan.tiles * plan.nk and max(per_cta) == plan.busiest
        if plan.tiles_dp == plan.tiles:  # whole tiles in rounds
            assert plan.ctas == min(sms, plan.tiles) and not plan.split
        else:
            assert plan == gemm.plan_gemm(t, o, i, sms, True, rows)
            assert plan.ctas == min(sms, plan.tiles * plan.nk) and min(per_cta) >= 1
        slots = {}
        for tile in range(plan.tiles):
            pcs = plan.pieces(tile)
            assert [c for c, _ in pcs] == (sorted({seen[(tile, k)] for k in range(plan.nk)})
                                           if pcs else [])
            for c, slot in pcs:
                assert slots.setdefault((c, slot), tile) == tile
        for other in (1, 2) if t > 128 else (1,):
            per, fill = qm.WGMMA_TWO_BLOCKS if other == 2 else (1.0, 0.0)
            base = gemm.plan_gemm(t, o, i, sms, True, 128 * other)
            cost = base.busiest * per + fill + (qm.WGMMA_SPLIT_COST if base.split else 0)
            mine = plan.busiest * (qm.WGMMA_TWO_BLOCKS[0] if nx == 2 else 1.0) + \
                (qm.WGMMA_TWO_BLOCKS[1] if nx == 2 else 0) + \
                (qm.WGMMA_SPLIT_COST if plan.split else 0)
            assert mine <= cost


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("packed", [False, True])
def test_smoke_wide_cases_reach_the_other_plans(packed):
    """chip_smoke.py's `block_wide_cases`, held to the plain version on the
    card, reach on a 132-SM H100 the plans the Llama-3.2-1B widths do not:
    the wgmma route's stream-K over 140 K stages (Phi-3-medium w2), shared
    tiles beside whole ones, two x blocks a tile at I = 5120; the tc route's
    split contraction at I = 17920."""
    wgmma, tc = [], []
    for _, o, i, rows in _smoke().block_wide_cases():
        for t in rows:
            route = qm.block_route(t, i, BF16, packed)
            plan = qm.block_plan(t, o, i, route, packed, 132)
            (wgmma if route == "wgmma" else tc).append((i, plan))
    assert any(p.split and p.nk == 140 for _, (p, _) in wgmma)
    assert any(p.split and 0 < p.tiles_dp < p.tiles for _, (p, _) in wgmma)
    assert any(nx == 2 and i == 5120 for i, (_, nx) in wgmma)
    assert any(p.splits > 1 and i == 17920 for i, p in tc)


@pytest.mark.parametrize("kind", ["q8_0", "q4p"])
@pytest.mark.parametrize("t", [1, 8, 32])
def test_plan_tc_block_kinds(kind, t):
    """plan_tc for K5 (q8_0) and K7 (q4p) at the paths' shapes: slices of
    whole boxes (128 columns, 256 packed) that cover I, the x slice fits
    beside three stages of weight and scale boxes, CTAs within the units
    and the SMs; the q8_row plans are what they were."""
    box = ff.TC_KINDS[kind][0]
    for o, i in [*LLAMA.values(), *PHI3.values(), *HEADS.values(), (200, 2048)]:
        p = ff.plan_tc(t, o, i, False, 132, kind)
        assert p.kind == kind and p.ksl % box == 0 and p.splits == -(-i // p.ksl)
        assert (p.splits - 1) * p.ksl < i <= p.splits * p.ksl
        assert p.tp * (2 * p.ksl + 32) <= ff.tc_x_bytes(p.tp, False, p.g, p.splits > 1, kind)
        assert 1 <= p.ctas <= min(132, p.units)
        assert qm.block_plan(t, o, i, "tc", kind == "q4p", 132) == p
        r = ff.plan_tc(t, o, i, False, 132)
        assert r.kind == "rowq" and r == ff.plan_tc(t, o, i, False)
    # scale boxes take shared memory from the x slice: 8 a stage, 3 stages
    assert ff.tc_x_bytes(8, False, 1, False, kind) == \
        ff.tc_x_bytes(8, False, 1, False) - 3 * 8 * 16 * ff.TC_KINDS[kind][2] * 4


# ------------------------------------------------------ plain against JAX
@pytest.mark.parametrize("t", [1, 8, 32, 33, 64])
@pytest.mark.parametrize("kind,pack4", [("q8_0", False), ("q4_0", False), ("q4_0", True)])
def test_plain_bf16_matches_pallas(kind, pack4, t):
    """K5 / K7's plain versions with bf16 x against `_quant_matmul_2d_li`
    (li = 1) and `_quant_matmul_2d` in interpret mode: both round the
    dequantized weight to bf16 before the dot and sum exact products in
    f32, so they agree within 1e-5 of the largest |value| (summation
    order). O = 200 is not a multiple of the JAX tiles."""
    rng = np.random.default_rng(100 + t)
    jw, tw = _jax_weight(rng, (2, 200, 256), kind, pack4)
    x = jnp.asarray(rng.normal(size=(t, 256)).astype(np.float32)).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16)
    kern = qm.packed4_matmul if pack4 else qm.block_matmul
    for li in (1, 0):
        if li:
            want = _quant_matmul_2d_li(jnp.asarray(jw.qs), jnp.asarray(jw.scales), x, li,
                                       interpret=True, layout=jw.layout)
        else:
            want = _quant_matmul_2d(jnp.asarray(jw.qs[0]), jnp.asarray(jw.scales[0]), x,
                                    interpret=True, layout=jw.layout)
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))[:, :200]
        got = kern(xt, tw.qs[li], tw.scales[li])[:, :200]  # JAX-padded rows dropped
        assert got.dtype == F32 and got.shape == (t, 200)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert qm.block_matmul.launches == qm.packed4_matmul.launches == 0


# ---------------------------------------------------- the lanes' reads
def _swizzled(rows: np.ndarray, span: int) -> np.ndarray:
    """A TMA box [r, span] of bytes as shared memory holds it under the
    `span`-byte swizzle: byte offset a at a ^ ((a >> 7) & m) << 4."""
    flat = np.ascontiguousarray(rows, dtype=np.uint8).reshape(-1)
    a = np.arange(flat.size)
    m = 7 if span == 128 else 3
    out = np.empty_like(flat)
    out[a ^ (((a >> 7) & m) << 4)] = flat
    return out


def _word(mem: np.ndarray, addr: int, n: int = 4) -> int:
    return int.from_bytes(mem[addr:addr + n].tobytes(), "little")


def _prmt(a: int, b: int, sel: int) -> int:
    src = a.to_bytes(4, "little") + b.to_bytes(4, "little")
    return int.from_bytes(bytes(src[(sel >> 4 * n) & 7] for n in range(4)), "little")


def _dequant(raw: int, sc: float, packed: bool) -> np.ndarray:
    """The kernels' `dequant_block`: 4 biased bytes under the exponent of
    2^23, the bias taken off, __fmul_rn by the block scale, bf16 RNE."""
    u = int(spread_nibbles(np.array([raw & 0xFFFF]))[0]) if packed else raw ^ 0x80808080
    bias = 8 if packed else 128
    f = np.array([np.uint32(0x4B000000 | ((u >> 8 * e) & 0xFF)).view(np.float32)
                  - np.float32(8388608 + bias) for e in range(4)], np.float32)
    return bf16_value(bf16_bits((f * np.float32(sc)).astype(np.float32)))


def _weights(rng, o, i, packed):
    q = rng.integers(-8, 8, size=(o, i)) if packed else rng.integers(-128, 128, size=(o, i))
    q = q.astype(np.int8)
    s = (rng.random((o, i // 32), dtype=np.float32) * 0.01 + 1e-4).astype(np.float32)
    s[:, ::3] = np.float32(1 + 2 ** -8) * np.float32(2.0 ** -7)  # ties for odd q
    raw = ((q[:, 0::2].astype(np.int32) & 0xF) | ((q[:, 1::2].astype(np.int32) & 0xF) << 4)
           ).astype(np.uint8).view(np.int8) if packed else q
    want = qm.dequant_blocks(torch.from_numpy(q), torch.from_numpy(s), BF16).float().numpy()
    return raw, s, want


@pytest.mark.parametrize("packed", [False, True])
def test_wgmma_lane_reads_rebuild_the_weight(packed):
    """The wgmma route's A fragments, emulated as `load_frags` reads a stage
    (128 rows: Q8_0 128 bytes a row in the 128-byte swizzle, two 4-byte
    loads and a byte permute a row and step; packed 64 bytes in the 64-byte
    swizzle, one 8-byte load and a permute), placed at the k of wgmma's
    register A (lane q: 2q, 2q + 1, 2q + 8, 2q + 9 of each 16-deep step),
    rebuild the plain version's bf16 weight bit for bit."""
    rng = np.random.default_rng(5 + packed)
    raw, s, want = _weights(rng, 128, 128, packed)
    wrow = 64 if packed else 128
    mem = _swizzled(raw.view(np.uint8), wrow)
    got = np.full((128, 128), np.nan, np.float32)
    for r in range(128):
        g = r & 7
        for k in range(8):
            for q in range(4):
                if packed:
                    off = (((k >> 1) ^ (g >> 1)) << 4) + 8 * (k & 1)
                    v0, v1 = _word(mem, r * wrow + off), _word(mem, r * wrow + off + 4)
                    rw = _prmt(v0, v1, q | ((q + 4) << 4))
                else:
                    off = ((k ^ g) << 4) + 4 * (q >> 1)
                    rw = _prmt(_word(mem, r * wrow + off), _word(mem, r * wrow + off + 8),
                               0x7632 if q & 1 else 0x5410)
                cols = [16 * k + c for c in (2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9)]
                assert np.isnan(got[r, cols]).all()
                got[r, cols] = _dequant(rw, s[r, k >> 1], packed)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("packed", [False, True])
def test_tc_lane_reads_rebuild_the_weight(packed):
    """rowq_tc.cuh's block kinds (`products_block`), emulated on one warp's
    box of 16 rows x 128 bytes in the 128-byte swizzle: Q8_0 8 steps of 128
    columns, a lane's 4 bytes one load; packed 16 steps of 256 columns, a
    lane's 2 bytes one load. Each lane's 4 values sit at the x columns its B
    fragment reads (4q .. 4q + 3 of the step: the k order permuted alike in
    A and B) and rebuild the plain bf16 weight bit for bit."""
    rng = np.random.default_rng(7 + packed)
    cols = 256 if packed else 128
    raw, s, want = _weights(rng, 16, cols, packed)
    mem = _swizzled(raw.view(np.uint8), 128)
    got = np.full((16, cols), np.nan, np.float32)
    for r in range(16):
        g = r & 7
        for j in range(cols // 16):
            for q in range(4):
                if packed:
                    rw = _word(mem, r * 128 + (((j >> 1) ^ g) << 4) + 8 * (j & 1) + 2 * q, 2)
                else:
                    rw = _word(mem, r * 128 + ((j ^ g) << 4) + 4 * q)
                c = [16 * j + 4 * q + e for e in range(4)]
                assert np.isnan(got[r, c]).all()
                got[r, c] = _dequant(rw, s[r, j >> 1], packed)
    np.testing.assert_array_equal(got, want)


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float64).to(torch.float32)


def wgmma_walk(x: torch.Tensor, w: np.ndarray, plan, nx: int) -> torch.Tensor:
    """The wgmma route's result in its order, f32: per segment of each CTA
    (plan.segments), the tile's stages in order, each 16-deep step's exact
    products summed and rounded once to f32 into the accumulator; a shared
    tile's pieces added in plan.pieces order. w: the bf16 weight [O, I];
    tiles of 128 weight rows and nx x 128 x rows."""
    t, i = x.shape
    o = w.shape[0]
    rows = 128 * nx
    xd = x.double()
    wd = torch.from_numpy(w).double()
    y = torch.zeros((t, o), dtype=torch.float32)
    parts = {}
    for c in range(plan.ctas):
        for tile, k0, k1, slot in plan.segments(c):
            t0, o0 = (tile % plan.tiles_m) * rows, (tile // plan.tiles_m) * 128
            xs, ws = xd[t0:t0 + rows], wd[o0:o0 + 128]
            acc = torch.zeros((xs.shape[0], ws.shape[0]), dtype=torch.float32)
            for k in range(k0 * 128, k1 * 128, 16):
                acc = acc + _f32(xs[:, k:k + 16] @ ws[:, k:k + 16].T)
            if slot < 0:
                y[t0:t0 + rows, o0:o0 + 128] = acc
            else:
                parts[(c, slot)] = acc
    for tile in range(plan.tiles_dp, plan.tiles):
        pcs = plan.pieces(tile)
        if pcs:
            t0, o0 = (tile % plan.tiles_m) * rows, (tile // plan.tiles_m) * 128
            acc = parts[pcs[0]]
            for pc in pcs[1:]:
                acc = acc + parts[pc]
            y[t0:t0 + rows, o0:o0 + 128] = acc
    return y


@pytest.mark.parametrize("t,o,sms,nx,whole", [(33, 200, 3, 1, False), (130, 200, 5, 1, False),
                                              (130, 200, 2, 2, True), (200, 384, 2, 2, False)])
@pytest.mark.parametrize("kind,pack4", [("q8_0", False), ("q4_0", True)])
def test_wgmma_walk_matches_pallas(kind, pack4, t, o, sms, nx, whole):
    """The wgmma route's walk on the bf16 weight the lanes rebuild, against
    `_quant_matmul_2d_li(interpret=True)` with bf16 x at I = 512, under each
    kind of plan the kernel takes: tiles of 128 x rows shared by 3 and 5
    SMs (plan_gemm's stream-K), 256 x rows whole in rounds on 2 SMs and
    shared on 2 (O = 384); within 1e-5 of the largest |value| (the kernel
    sums its 16-deep steps in another order than XLA)."""
    rng = np.random.default_rng(t + sms)
    jw, tw = _jax_weight(rng, (2, o, 512), kind, pack4)
    x = jnp.asarray(rng.normal(size=(t, 512)).astype(np.float32)).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32)))
    want = np.asarray(jnp.asarray(_quant_matmul_2d_li(
        jnp.asarray(jw.qs), jnp.asarray(jw.scales), x, 1, interpret=True,
        layout=jw.layout)).astype(jnp.float32))[:, :o]
    q = tw.qs[1][:o]
    wq = unpack4_pairs(q) if pack4 else q
    wb = qm.dequant_blocks(wq, tw.scales[1][:o], BF16).float().numpy()
    plan = gemm.plan_gemm(t, o, 512, sms, True, 128 * nx)
    if whole:
        plan = gemm.GemmPlan(t, o, 512, plan.tiles_m, plan.tiles_n, plan.nk,
                             min(sms, plan.tiles), plan.tiles)
    assert plan.split == (not whole)
    got = wgmma_walk(xt, wb, plan, nx).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# ----------------------------------------------------------------- launcher
class _FakeLib:
    """Records lt_block_matmul's arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def lt_block_matmul(self, *args):
        self.calls.append(args)
        return 0


def _operands(t, o, i, packed, dt):
    w = torch.zeros((o, i // 2 if packed else i), dtype=torch.int8)
    return torch.zeros((t, i), dtype=dt), w, torch.zeros((o, i // 32), dtype=F32)


@pytest.mark.parametrize("t,i,dt,packed", [(1, 2048, BF16, False), (32, 2048, BF16, True),
                                           (33, 2048, BF16, False), (512, 8192, BF16, True),
                                           (8, 2048, F32, False), (64, 2080, BF16, True)])
def test_launcher_passes_route_and_plan(t, i, dt, packed, monkeypatch):
    """A valid call reaches lt_block_matmul with the sizes, the kind, the
    route code of `block_route` and its plan: plan_tc's (g, splits, ksl,
    ctas) with slice scratch when split, plan_gemm's (ctas, tiles_dp) with a
    workspace of 2 ctas x 128 x 128 f32 when a tile is shared, the GEMV's
    rows a block pass."""
    lib = _FakeLib()
    monkeypatch.setattr(qm._build, "stream", lambda: 0)
    monkeypatch.setattr(qm, "_sm_count", lambda _: 132)
    o = 2048
    x, w, s = _operands(t, o, i, packed, dt)
    y = qm._launch_block(x, w, s, packed, "k", lib=lib)
    (call,) = lib.calls
    assert y.shape == (t, o) and y.dtype == F32
    route = qm.block_route(t, i, dt, packed)
    assert call[6:11] == (t, o, i, int(packed), qm.BLOCK_ROUTES[route])
    plan = qm.block_plan(t, o, i, route, packed, 132)
    if route == "tc":
        assert call[11:15] == plan.args and (call[5] is None) == (plan.splits == 1)
    elif route == "wgmma":
        plan, nx = plan
        assert call[11:14] == (plan.ctas, plan.tiles_dp, nx)
        assert (call[5] is None) == (not plan.split)
    elif route == "gemv":
        assert call[11] == qm._gemv_rows(t, i)


@pytest.mark.parametrize("bad", [
    lambda x, w, s: (x[:, :64], w, s),                        # x columns != I
    lambda x, w, s: (x.to(torch.float16), w, s),              # x neither f32 nor bf16
    lambda x, w, s: (x, w.to(torch.int16), s),                # weights not int8
    lambda x, w, s: (x, w, s[:, :1].contiguous()),            # scales not [O, I / 32]
    lambda x, w, s: (x.t().contiguous().t(), w, s),           # x not contiguous
])
def test_launcher_checks_raise_before_the_device(bad, monkeypatch):
    """Wrong shapes, dtypes or contiguity raise before the library is
    loaded or the device asked for."""
    def no_device(*_):
        raise AssertionError("reached the device")
    monkeypatch.setattr(qm._build, "load", no_device)
    monkeypatch.setattr(qm, "_sm_count", no_device)
    x, w, s = bad(*_operands(40, 64, 128, False, BF16))
    with pytest.raises((ValueError, TypeError)):
        qm._launch_block(x, w, s, False, "block_matmul")


# ----------------------------------------------------------------- ablation
@pytest.mark.parametrize("name", list(block_ab.VARIANTS))
def test_block_ablation_variants_edit_the_kernel_source(name):
    """Each variant of bench/block_ab.py still finds the statements it
    replaces in csrc/block_matmul.cu (the card builds and times them)."""
    src = (qm._build.CSRC / "block_matmul.cu").read_text()
    edit = block_ab.VARIANTS[name]
    text = edit(src) if edit else src
    assert (text == src) == (name == "as built")
