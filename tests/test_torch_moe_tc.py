"""K10-K13's tensor-core kernel (csrc/moe_grouped.cu `grouped_tc_kernel`) on
the CPU. The CUDA kernel runs only on the card (chip_smoke.py
`check_moe_kernels`, `check_moe_edges`); here what surrounds it and its
arithmetic are held to the JAX package:

- the unit plan (`plan_grouped`): every (active tile, O row) exactly once,
  the CTAs' shares within a unit of each other, nothing read from the
  routing;
- a lane's dequantization emulated in numpy (Q8_0 with the lane's one block
  scale, packed4 nibbles spread into bytes, q8_row, f32 to bf16), bit-equal to
  the plain version's `_expert_weight` and to the weight the JAX kernels
  multiply (read back through `grouped_matmul(interpret=True)` with one-hot
  rows), over scale sweeps with ties;
- the kernel's walk emulated in torch (real-row fragments, pad rows and
  inactive tiles zero, the GEMV form's parts and even/odd steps, the tiled
  form's stages, the f32 form's FMAs in column order, partial last stages)
  against `_grouped_matmul_q` / `_grouped_matmul_dense` in interpret mode;
- the launcher's checks, which raise before the device is asked for;
- bench/moe_ablation.py's variants, which edit the kernel's source.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe import _jax_stack, _routing, _t

from llamatpu.models import weights as jw
from llamatpu.ops import moe_grouped as jmg
from llamatpu_torch.bench import moe_ablation
from llamatpu_torch.ops import moe_grouped as tmg

KINDS = [("q8_0", False), ("q4_0", False), ("q4_0", True), ("q8_row", False), ("f32", False),
         ("bf16", False)]


def _front_end(tw) -> int:
    """The kernel front end grouped_matmul takes for a bridged weight."""
    if isinstance(tw, torch.Tensor):
        return tmg._K_DENSE
    if tw.kind == "q8_row":
        return tmg._K_ROWQ
    return tmg._K_PACKED if tw.layout == "packed4" else tmg._K_BLOCK


# ----------------------------------------------------------------- the plan
@pytest.mark.parametrize("sms", [1, 3, 7, 132])
@pytest.mark.parametrize("n,k,tm,x_f32", [(1, 8, 8, False), (8, 8, 8, False), (16, 8, 32, False),
                                          (200, 6, 128, False), (5, 4, 8, True),
                                          (40, 4, 32, True)])
def test_plan_covers_each_active_tile_row_once(n, k, tm, x_f32, sms):
    """Over all CTAs the units cover every (tile, O row) exactly once, each
    CTA's share within one unit of every other's, at O = 2816 and 200; the
    plan is a function of (Mp, tm, O, I, SMs) alone, so two routings with the
    same static row bound get the same walk, and every active tile's rows
    are covered whatever the routing."""
    e = 12
    mp = tmg.sorted_rows(n, k, e, tm)
    for o, i in ((2816, 2048), (200, 1408), (136, 4608)):
        plan = tmg.plan_grouped(mp, tm, o, i, x_f32, sms)
        assert plan.gemv == (not x_f32 and tm <= 8 and i <= 4096)
        assert plan.rows == (16 if plan.gemv else 128) and plan.ctas == min(plan.units, sms)
        seen = np.zeros((mp // tm, o), dtype=np.int32)
        shares = []
        for c in range(plan.ctas):
            us = list(plan.units_of(c))
            shares.append(len(us))
            for u in us:
                tile, o0, o1 = plan.unit(u)
                assert 0 <= o0 < o1 <= o and o1 - o0 <= plan.rows
                seen[tile, o0:o1] += 1
        assert (seen == 1).all() and max(shares) - min(shares) <= 1
        for seed in (1, 2):
            top = _routing(n, k, e, seed=seed)
            _, _, te = tmg.sort_by_expert(_t(top), e, tm)
            assert te.shape[0] == mp // tm
            assert tmg.plan_grouped(te.shape[0] * tm, tm, o, i, x_f32, sms) == plan
            assert (seen[(te >= 0).numpy()] == 1).all()


# -------------------------------------------------- a lane's dequantization
MAGIC = 2 ** 23


def bf16_bits(f: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits, rounded to nearest even (finite values)."""
    b = np.ascontiguousarray(f, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) >> np.uint32(16)) \
        .astype(np.uint32)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def permute_bytes(u: np.ndarray, bias: int) -> np.ndarray:
    """uint32 words of 4 biased bytes -> f32 [..., 4] as the kernel converts
    them: byte e under the exponent bits of 2^23, then 2^23 + bias taken off
    (exact for every byte)."""
    return np.stack([(np.uint32(0x4B000000) | ((u >> np.uint32(8 * e)) & np.uint32(0xFF)))
                     .view(np.float32) - np.float32(MAGIC + bias) for e in range(4)], -1)


def spread_nibbles(raw: np.ndarray) -> np.ndarray:
    """The kernel's packed4 lane: 2 bytes (columns 4q .. 4q + 3, the low
    nibble first) -> a word of bytes n + 8."""
    u = (raw.astype(np.uint32) ^ np.uint32(0x8888)) & np.uint32(0xFFFF)
    v = (u | (u << np.uint32(8))) & np.uint32(0x00FF00FF)
    return (v | (v << np.uint32(4))) & np.uint32(0x0F0F0F0F)


def lane_dequant(kind: int, raw_row: np.ndarray, scales: np.ndarray | None,
                 bf16: bool = True) -> np.ndarray:
    """One weight row as the kernel's lanes build it, 4 columns a lane
    fragment: raw_row is the row's stored bytes (int8 [I], packed4 [I / 2])
    or values (f32 / bf16-as-f32 [I]); scales the row's block scales [I /
    32] (Q8_0, packed4). Returns f32 [I] (bf16 values when bf16)."""
    if kind == tmg._K_DENSE:
        f = raw_row.astype(np.float32).reshape(-1, 4)
    elif kind == tmg._K_PACKED:
        raw = np.ascontiguousarray(raw_row).view(np.uint16).astype(np.uint32)  # 2 bytes a lane
        f = permute_bytes(spread_nibbles(raw), 8)
    else:
        words = np.ascontiguousarray(raw_row).view(np.uint32) ^ np.uint32(0x80808080)
        f = permute_bytes(words, 128)
    if kind in (tmg._K_BLOCK, tmg._K_PACKED):  # 4 columns share a 32-column block
        sc = np.repeat(scales.astype(np.float32), 8)[:, None]
        f = (f * sc).astype(np.float32)  # one f32 rounding (__fmul_rn)
    f = f.reshape(-1)
    return bf16_value(bf16_bits(f)) if bf16 else f


def scale_sweep(rng, shape) -> np.ndarray:
    """Block scales: a third on ties (q * s halfway between two bf16 values
    for odd q: 1 + 2^-8 and its neighbours on the f32 grid, times powers of
    two), the rest spread over five decades."""
    ties = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -8 + 2 ** -20, 1 + 2 ** -8 - 2 ** -20,
                     1.5 + 2 ** -8, 1 + 2 ** -9], dtype=np.float32)
    s = (rng.random(shape) * 10.0 ** rng.integers(-5, 0, size=shape)).astype(np.float32)
    tie = rng.random(shape) < 1 / 3
    pick = ties[rng.integers(0, len(ties), size=shape)] * np.float32(2.0) ** \
        rng.integers(-14, -4, size=shape).astype(np.float32)
    return np.where(tie, pick, s).astype(np.float32)


def _jax_weight(jwt, i: int, e: int, bf16: bool) -> np.ndarray:
    """Expert e's weight [O, I] as the JAX kernel multiplies it: the
    one-hot rows eye(I) through grouped_matmul (interpret mode), one tile of
    32 rows an expert-e tile; one-hot x and bf16 / f32 values sum exactly."""
    x = jnp.eye(i, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    te = jnp.full((i // 32,), e, dtype=jnp.int32)
    return np.asarray(jmg.grouped_matmul(jwt, x, te, 32, interpret=True)).T


@pytest.mark.parametrize("kind,pack4", KINDS)
def test_lane_dequant_bit_equal_to_plain_and_jax(kind, pack4):
    """The emulated lanes' weights equal `_expert_weight` (the plain
    versions) and the weight the JAX kernel multiplies, bit for bit, in bf16
    (f32 x: the f32 values), with Q8_0 / Q4_0 block scales over a sweep with
    ties; I = 160 (a partial 128-column stage)."""
    rng = np.random.default_rng(5 + len(kind) + pack4)
    e, o, i = 2, 128, 160
    jwt, twt = _jax_stack(rng, (e, o, i), "f32" if kind == "bf16" else kind, pack4)
    if kind in ("q8_0", "q4_0"):  # the sweep through both packages' load transforms
        base = jw.QTensor(np.asarray(rng.integers(-8 if kind == "q4_0" else -127,
                                                  8 if kind == "q4_0" else 128,
                                                  size=(e, o, i)), np.int8),
                          scale_sweep(rng, (e, o, i // 32)), kind)
        jwt = jw.prepare_qtensor(base, pack4=pack4)
        from llamatpu_torch.models import weights as tw
        twt = tw.from_numpy_weights({"w": jwt})["w"]
    if kind == "bf16":
        jwt = jnp.asarray(jwt).astype(jnp.bfloat16)
        twt = twt.to(torch.bfloat16)
    fe = _front_end(twt)
    for bf16 in (True, False):
        dt = torch.bfloat16 if bf16 else torch.float32
        for ex in range(e):
            if fe == tmg._K_DENSE:
                raw, sc = twt[ex].float().numpy(), None
            else:
                raw, sc = twt.qs[ex].numpy(), twt.scales[ex].numpy()
            got = np.stack([lane_dequant(fe, raw[r], None if sc is None or fe == tmg._K_ROWQ
                                         else sc[r], bf16) for r in range(o)])
            plain = tmg._expert_weight(fe, twt if fe == tmg._K_DENSE else twt.qs,
                                       None if fe == tmg._K_DENSE else twt.scales, ex, dt)
            np.testing.assert_array_equal(got, plain.float().numpy())
            want = _jax_weight(jwt, i, ex, bf16)[:o]
            if fe == tmg._K_ROWQ:  # JAX folds the row scale into its output
                want = want / np.asarray(twt.scales[ex], np.float32)
                np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
            else:
                np.testing.assert_array_equal(got, want)


def test_packed_nibble_spread_all_values():
    """Every 16-bit lane word of packed4 gives its four nibbles exactly."""
    raw = np.arange(1 << 16, dtype=np.uint32)
    got = permute_bytes(spread_nibbles(raw), 8)
    nib = np.stack([(raw >> np.uint32(4 * e)) & np.uint32(0xF) for e in range(4)], -1)
    want = np.where(nib >= 8, nib.astype(np.int32) - 16, nib.astype(np.int32))
    np.testing.assert_array_equal(got, want.astype(np.float32))


# ----------------------------------------------------------------- the walk
def _f32(v):
    return torch.as_tensor(v, dtype=torch.float64).to(torch.float32)


def walk_emulated(fe: int, x: torch.Tensor, w, s, tile_expert, tm: int, row_token,
                  n_tokens: int, plan) -> torch.Tensor:
    """The kernel's result for x [Mp, I] in its order, f32: for each unit of
    the plan, the tile's real rows (pad rows and inactive tiles zero)
    against the unit's weight rows, dequantized as the lanes do. A 16-column
    step of an mma is its exact products summed and rounded once to f32.
    GEMV form: stages of 1024 bytes a row, warp w's steps j = w (mod 8) of
    each in an even and an odd sum, the 8 parts added in order. Tiled form:
    the steps in order. f32 x: an FMA a column in order."""
    mp, i = x.shape
    o = plan.o
    y = torch.zeros((mp, o), dtype=torch.float32)
    x_f32 = x.dtype == torch.float32
    bits = 4 if fe == tmg._K_PACKED else 8 if fe in (tmg._K_BLOCK, tmg._K_ROWQ) else \
        (32 if w.dtype == torch.float32 else 16)
    kc = 8192 // bits
    te = tile_expert.tolist()
    rt = row_token.numpy()
    for c in range(plan.ctas):
        for u in plan.units_of(c):
            tile, o0, o1 = plan.unit(u)
            e = te[tile]
            m0 = tile * tm
            nr = 0 if e < 0 else int((rt[m0:m0 + tm] < n_tokens).sum())
            if nr == 0:
                continue
            if fe == tmg._K_DENSE:
                raw, sc = w[e, o0:o1].float().numpy(), [None] * (o1 - o0)
            else:
                raw = w.qs[e, o0:o1].numpy()
                sc = [None] * (o1 - o0) if fe == tmg._K_ROWQ else w.scales[e, o0:o1].numpy()
            wd = torch.from_numpy(np.stack([lane_dequant(fe, raw[r], sc[r], not x_f32)
                                            for r in range(o1 - o0)])).double()  # [rows, I]
            xr = x[m0:m0 + nr].to(torch.float32 if x_f32 else torch.bfloat16).double()
            if x_f32:  # one fmaf a column, in order
                acc = torch.zeros((nr, o1 - o0), dtype=torch.float32)
                for k in range(i):
                    acc = _f32(acc.double() + xr[:, k, None] * wd[None, :, k])
            else:
                steps = [_f32(xr[:, j:j + 16] @ wd[:, j:j + 16].T) for j in range(0, i, 16)]
                if plan.gemv:  # per stage, warp w's steps j = w + 8 * idx: parity of idx
                    per = kc // 16
                    parts = []
                    for wp in range(8):
                        ev = torch.zeros((nr, o1 - o0), dtype=torch.float32)
                        od = ev.clone()
                        for j, p in enumerate(steps):
                            if j % 8 == wp:
                                if ((j % per) // 8) % 2 == 0:
                                    ev = ev + p
                                else:
                                    od = od + p
                        parts.append(ev + od)
                    acc = parts[0]
                    for p in parts[1:]:
                        acc = acc + p
                else:
                    acc = torch.zeros((nr, o1 - o0), dtype=torch.float32)
                    for p in steps:
                        acc = acc + p
            if fe == tmg._K_ROWQ:
                acc = acc * w.scales[e, o0:o1, 0][None, :]
            y[m0:m0 + nr, o0:o1] = acc
    return y


@pytest.mark.parametrize("tm", [8, 32])
@pytest.mark.parametrize("i", [96, 160])
@pytest.mark.parametrize("kind,pack4", KINDS)
def test_walk_matches_jax_interpret(kind, pack4, i, tm):
    """The emulated walk against `_grouped_matmul_q` / `_grouped_matmul_dense`
    (interpret mode) and against the plain version, E = 6 (an expert of no
    rows, -1 tail tiles), O = 128 (136 for dense weights: a ragged last
    block), bf16 and f32 x, 3 CTAs (units of several tiles a CTA): within
    1e-5 of the largest |value| (the kernel sums its 16-column steps in
    another order than XLA); pad rows and inactive tiles exactly zero."""
    rng = np.random.default_rng(i + tm + len(kind) + pack4)
    e, n, k = 6, 5 if tm == 8 else 24, 2
    o = 136 if kind in ("f32", "bf16") else 128
    jwt, twt = _jax_stack(rng, (e, o, i), "f32" if kind == "bf16" else kind, pack4)
    if kind == "bf16":
        jwt = jnp.asarray(jwt).astype(jnp.bfloat16)
        twt = twt.to(torch.bfloat16)
    fe = _front_end(twt)
    top_i = _routing(n, k, e, seed=3)
    rt, _, te = tmg.sort_by_expert(_t(top_i), e, tm)
    assert (te == -1).any() and 3 not in te.tolist()
    pad = (rt == n).numpy()
    for x_f32 in (False, True):
        x = rng.normal(size=(rt.shape[0], i)).astype(np.float32)
        x[pad] = 0.0
        if not x_f32:
            x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        xj = jnp.asarray(x) if x_f32 else jnp.asarray(x).astype(jnp.bfloat16)
        xt = _t(x) if x_f32 else _t(x).to(torch.bfloat16)
        want = np.asarray(jmg.grouped_matmul(jwt, xj, jnp.asarray(te.numpy()), tm,
                                             interpret=True))
        plan = tmg.plan_grouped(xt.shape[0], tm, want.shape[1], i, x_f32, 3)
        got = walk_emulated(fe, xt, twt, None, te, tm, rt, n, plan).numpy()
        tol = 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        plain = tmg.grouped_matmul(twt, xt, te, tm, row_token=rt, n_tokens=n)
        np.testing.assert_allclose(got[:, :plain.shape[1]], plain.numpy(), rtol=0, atol=tol)
        assert not got[pad].any() and not got[(te.repeat_interleave(tm) == -1).numpy()].any()


# ----------------------------------------------------------------- launcher
class _FakeLib:
    """Records lt_grouped_matmul's arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def lt_grouped_matmul(self, *args):
        self.calls.append(args)
        return 0


def _args(kind=tmg._K_BLOCK, mp=32, tm=8, e=3, o=48, i=64, x_dtype=torch.bfloat16):
    x = torch.zeros((mp, i), dtype=x_dtype)
    if kind == tmg._K_DENSE:
        w, s = torch.zeros((e, o, i), dtype=torch.bfloat16), None
    else:
        w = torch.zeros((e, o, i // 2 if kind == tmg._K_PACKED else i), dtype=torch.int8)
        s = torch.zeros((e, o, 1 if kind == tmg._K_ROWQ else i // 32), dtype=torch.float32)
    return [kind, x, w, s, torch.zeros(mp // tm, dtype=torch.int32), tm,
            torch.zeros(mp, dtype=torch.int32), 3]


@pytest.mark.parametrize("bad", [
    lambda a: a.__setitem__(1, a[1][:, :48]),                      # x columns != I
    lambda a: a.__setitem__(1, a[1].t().contiguous().t()),         # not contiguous
    lambda a: a.__setitem__(1, a[1].to(torch.float16)),            # x neither f32 nor bf16
    lambda a: a.__setitem__(2, a[2].to(torch.int16)),              # weights not int8
    lambda a: a.__setitem__(3, a[3][..., :1].contiguous()),        # scales [E, O, 1] for Q8_0
    lambda a: a.__setitem__(4, a[4][:-1].contiguous()),            # tile table too short
    lambda a: a.__setitem__(4, a[4].long()),                       # tile table int64
    lambda a: a.__setitem__(5, 16),                                # tm neither <= 8 nor % 32
    lambda a: a.__setitem__(slice(0, 8), _args(mp=256, tm=256)),   # tm past 128
    lambda a: a.__setitem__(6, a[6][:-1].contiguous()),            # row_token too short
    lambda a: (a.__setitem__(1, torch.zeros((32, 48), dtype=torch.bfloat16)),
               a.__setitem__(2, torch.zeros((3, 48, 48), dtype=torch.int8)),
               a.__setitem__(3, torch.zeros((3, 48, 1), dtype=torch.float32))),  # I % 32
])
def test_launcher_checks_raise_before_the_device(bad, monkeypatch):
    """Wrong shapes, dtypes, contiguity or tile sizes raise (ValueError or
    TypeError) before the library is loaded or the device asked for."""
    def no_device(*_):
        raise AssertionError("reached the device")
    monkeypatch.setattr(tmg._build, "load", no_device)
    monkeypatch.setattr(tmg, "_sm_count", no_device)
    a = _args()
    bad(a)
    with pytest.raises((ValueError, TypeError)):
        tmg._launch(*a, "grouped_block_matmul")


@pytest.mark.parametrize("kind,x_dtype,tm,i,gemv", [
    (tmg._K_BLOCK, torch.bfloat16, 8, 64, 1), (tmg._K_PACKED, torch.bfloat16, 32, 64, 0),
    (tmg._K_ROWQ, torch.float32, 8, 64, 0), (tmg._K_DENSE, torch.bfloat16, 8, 4608, 0)])
def test_launcher_passes_the_plan(kind, x_dtype, tm, i, gemv, monkeypatch):
    """A valid call reaches lt_grouped_matmul with the sizes, E, the form
    (GEMV for bf16 x at tm <= 8 and I <= 4096) and plan_grouped's CTAs."""
    lib = _FakeLib()
    monkeypatch.setattr(tmg._build, "load", lambda name: lib)
    monkeypatch.setattr(tmg._build, "stream", lambda: 0)
    monkeypatch.setattr(tmg, "_sm_count", lambda index: 5)
    a = _args(kind=kind, tm=tm, i=i, x_dtype=x_dtype)
    y = tmg._launch(*a, "grouped")
    (call,) = lib.calls
    mp, o, e = 32, 48, 3
    assert y.shape == (mp, o) and y.dtype == torch.float32
    plan = tmg.plan_grouped(mp, tm, o, i, x_dtype == torch.float32, 5)
    assert call[0] == kind and call[10:17] == (mp, o, i, tm, e, gemv, plan.ctas)
    assert plan.gemv == bool(gemv)


# ----------------------------------------------------------------- ablation
@pytest.mark.parametrize("name", list(moe_ablation.VARIANTS))
def test_moe_ablation_variants_edit_the_kernel_source(name):
    """Each variant of bench/moe_ablation.py still finds the statements it
    replaces in csrc/moe_grouped.cu (the card builds and times them), and
    only the product-keeping ones claim to compute the product."""
    src = moe_ablation.source()
    edit, computes = moe_ablation.VARIANTS[name]
    text = edit(src)
    assert (text == src) == (name == "as built")
    dropped = ("no products", "no dequantization", "no scales", "stream only", "kept")
    assert computes == all(k not in name for k in dropped)
