"""K4 and K17's stream-K plan on the CPU (the CUDA kernel itself runs only on
the card, in chip_smoke.py).

- `plan_gemm` at every shape the paths give the kernels: K17 (and K4 where
  it has too few tiles to load the card's L2) with one CTA per SM, ranges of
  whole K stages balanced within one stage; K4 with whole tiles elsewhere;
  every (tile, K stage) iteration walked exactly once, and the workspace the
  second pass reads.
- The plain version of the walk (each CTA's segments as int32 or f32 partial
  products, the shared tiles summed in K order, then the epilogue once)
  against `rowq_gemm_plain` bit for bit (K4) and within 1e-5 (K17), and
  against the JAX package's `rowq_gemm_pallas(interpret=True)` at a T that is
  not a multiple of 8.
- The wrapper's checks, which raise before anything is launched."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamatpu.ops.pallas_gemm import rowq_gemm_pallas
from llamatpu_torch.ops import gemm
from llamatpu_torch.ops.int8_prefill import _INT8_ACC_MAX_I

# (T, O, I) of every K4 call on the paths: llama32-1b's wqkv, wo, w13, w2 at
# T = 512 and 128 (prefill chunks and the 128-row serving chunks),
# Phi-3-medium's at T = 128 (its prompt), and a ragged last chunk
LLAMA = ((3072, 2048), (2048, 2048), (16384, 2048), (2048, 8192))
PHI3_MEDIUM = ((7680, 5120), (5120, 5120), (35840, 5120), (5120, 17920))
PATH_SHAPES = ([(t, o, i) for t in (512, 128) for o, i in LLAMA]
               + [(128, o, i) for o, i in PHI3_MEDIUM] + [(200, 2560, 2064)])
H100_SMS = 132


def _iterations(plan):
    """{(tile, k): cta} over every CTA's segments, and each CTA's count."""
    seen, per_cta = {}, []
    for c in range(plan.ctas):
        n = 0
        for t, k0, k1, slot in plan.segments(c):
            assert 0 <= k0 < k1 <= plan.nk and slot in (-1, 0, 1)
            for k in range(k0, k1):
                assert (t, k) not in seen, f"iteration {(t, k)} walked twice"
                seen[(t, k)] = c
            n += k1 - k0
        per_cta.append(n)
    return seen, per_cta


def _check_plan(plan, sm_count, bf16):
    whole = not bf16 and plan.tiles >= gemm.K4_WHOLE_TILES_MIN_SHARE * sm_count
    if whole:  # K4 on enough tiles to load the card's L2: whole tiles only
        assert plan.ctas == min(sm_count, plan.tiles) and plan.tiles_dp == plan.tiles
    else:
        assert plan.ctas == min(sm_count, plan.tiles * plan.nk)
    assert (plan.nk - 1) * gemm.BK < plan.i <= plan.nk * gemm.BK  # whole stages, zero-filled tail
    seen, per_cta = _iterations(plan)
    assert len(seen) == plan.tiles * plan.nk
    if whole:
        assert max(per_cta) == -(-plan.tiles // plan.ctas) * plan.nk
    elif plan.tiles_dp < plan.tiles:
        # the stream-K ranges: every CTA busy, within one K stage of the others
        sk = [plan.begin(c + 1) - plan.begin(c) for c in range(plan.ctas)]
        assert min(sk) >= 1 and max(sk) - min(sk) <= 1
    else:
        # whole tiles in rounds only where that keeps the SMs >= 90 % busy
        assert plan.tiles * plan.nk >= 0.9 * plan.ctas * max(per_cta)
    # shared tiles: pieces in K order from consecutive CTAs, each slot used once
    slots = {}
    for t in range(plan.tiles):
        pcs = plan.pieces(t)
        if not pcs:
            assert len({seen[(t, k)] for k in range(plan.nk)}) == 1
            continue
        assert [c for c, _ in pcs] == sorted({seen[(t, k)] for k in range(plan.nk)})
        for c, slot in pcs:
            assert slots.setdefault((c, slot), t) == t, f"slot {(c, slot)} holds two tiles"
            assert slot in (0, 1)
    assert plan.split == bool(slots)
    assert plan.ws_slots == (2 * plan.ctas if slots else 0)
    return per_cta


@pytest.mark.parametrize("t,o,i", PATH_SHAPES)
def test_plan_fills_the_card_at_every_path_shape(t, o, i):
    """K17: one persistent CTA per SM at every path shape (132 on the H100),
    each busy for all but at most one K stage of the call. K4: the same
    where its whole tiles would occupy fewer than 0.4 of the SMs, else whole
    tiles on at least 53 SMs, the share at which they load the L2."""
    plan = gemm.plan_gemm(t, o, i, H100_SMS, bf16=True)
    per_cta = _check_plan(plan, H100_SMS, bf16=True)
    assert plan.ctas == H100_SMS
    assert min(per_cta) >= 1
    assert plan.tiles * plan.nk >= 0.85 * plan.ctas * max(per_cta)
    plan = gemm.plan_gemm(t, o, i, H100_SMS)
    per_cta = _check_plan(plan, H100_SMS, bf16=False)
    assert min(per_cta) >= 1
    if plan.tiles_dp < plan.tiles:
        assert plan.ctas == H100_SMS
    else:
        assert plan.ctas >= 0.4 * H100_SMS


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("sm_count", [1, 3, 6, 7, 40])
@pytest.mark.parametrize("t,o,i", [(256, 1280, 256), (200, 2560, 2064), (13, 300, 528),
                                   (512, 16384, 2048)])
def test_plan_walk_on_small_grids(t, o, i, sm_count, bf16):
    """Rounds of whole tiles, stream-K ranges and both together, on grids
    smaller than the card."""
    _check_plan(gemm.plan_gemm(t, o, i, sm_count, bf16), sm_count, bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_plan_modes(bf16):
    """Pure rounds where they fill the SMs, rounds then stream-K where a short
    last round would leave SMs idle (K17), stream-K alone below one round;
    K4 takes whole tiles from 53 tiles up, stream-K below."""
    w13 = gemm.plan_gemm(512, 16384, 2048, bf16=bf16)  # 512 tiles: 3.9 rounds of 132
    assert (w13.ctas, w13.tiles_dp, w13.split) == (132, 512, False)
    phi_w13 = gemm.plan_gemm(128, 35840, 5120, bf16=bf16)  # 280 tiles: 2.1 rounds
    assert (phi_w13.tiles_dp, phi_w13.split) == ((132, True) if bf16 else (280, False))
    wqkv = gemm.plan_gemm(512, 3072, 2048, bf16=bf16)  # 96 tiles
    assert (wqkv.ctas, wqkv.split) == ((132, True) if bf16 else (96, False))
    wo = gemm.plan_gemm(128, 2048, 2048, bf16=bf16)  # 16 tiles, 256 stages over 132 CTAs
    assert wo.tiles_dp == 0 and wo.split and wo.ws_slots == 264
    tiny = gemm.plan_gemm(1, 16, 16, bf16=bf16)  # one iteration: one CTA
    assert (tiny.ctas, tiny.split) == (1, False)


def _walk_plain(qs, sc, xi8, ax, plan, bf16: bool):
    """The kernel's schedule in plain torch: each CTA's segments as int32
    (K4) or f32 (K17) partial products; whole tiles take the epilogue at once,
    shared ones are summed piece by piece in K order by the second pass."""
    y = torch.full((plan.t, plan.o), float("nan"))
    ws = {}

    def tile_rows_cols(tile):
        r0, c0 = tile % plan.tiles_m * gemm.BM, tile // plan.tiles_m * gemm.BN
        return slice(r0, min(r0 + gemm.BM, plan.t)), slice(c0, min(c0 + gemm.BN, plan.o))

    def epilogue(tile, acc):
        rows, cols = tile_rows_cols(tile)
        assert torch.isnan(y[rows, cols]).all(), f"tile {tile} stored twice"
        y[rows, cols] = acc.float() * ax[rows] * sc[cols, 0][None, :]

    for c in range(plan.ctas):
        for tile, k0, k1, slot in plan.segments(c):
            rows, cols = tile_rows_cols(tile)
            ks = slice(k0 * gemm.BK, k1 * gemm.BK)
            if bf16:
                acc = xi8[rows, ks].float() @ qs[cols, ks].float().T
            else:
                acc = xi8[rows, ks].to(torch.int32) @ qs[cols, ks].to(torch.int32).T
            if slot < 0:
                epilogue(tile, acc)
            else:
                ws[(c, slot)] = acc
    for tile in range(plan.tiles):
        pcs = plan.pieces(tile)
        if pcs:
            acc = ws[pcs[0]]
            for p in pcs[1:]:
                acc = acc + ws[p]
            epilogue(tile, acc)
    assert not torch.isnan(y).any()
    return y


def _operands(t, o, i, seed):
    rng = np.random.default_rng(seed)
    qs = rng.integers(-127, 128, size=(o, i), dtype=np.int8)
    sc = (rng.random((o, 1), dtype=np.float32) + 0.5) / 127
    xi8 = rng.integers(-127, 128, size=(t, i), dtype=np.int8)
    ax = rng.random((t, 1), dtype=np.float32) * 0.01
    return qs, sc, xi8, ax


# whole tiles, rounds then stream-K, and stream-K alone, for each kernel's plan
WALKS = [(256, 1280, 256, 6), (200, 300, 528, 7), (13, 300, 528, 16), (130, 384, 1040, 40),
         (128, 256, 2048, 132)]


@pytest.mark.parametrize("t,o,i,sm_count", WALKS)
def test_k4_walk_plain_bit_exact(t, o, i, sm_count):
    """Int32 partials of whole K stages, summed exactly, then the epilogue
    once: bit for bit the plain version."""
    qs, sc, xi8, ax = (torch.from_numpy(a) for a in _operands(t, o, i, t + o + i))
    plan = gemm.plan_gemm(t, o, i, sm_count)
    got = _walk_plain(qs, sc, xi8, ax, plan, bf16=False)
    assert torch.equal(got, gemm.rowq_gemm_plain(qs, sc, xi8, ax))
    plan = gemm.plan_gemm(t, o, i, sm_count, bf16=True)  # K17's walk, with int32 partials
    got = _walk_plain(qs, sc, xi8, ax, plan, bf16=False)
    assert torch.equal(got, gemm.rowq_gemm_plain(qs, sc, xi8, ax))


@pytest.mark.parametrize("t,o,i,sm_count", WALKS)
def test_k17_walk_plain_ordered_f32(t, o, i, sm_count):
    """f32 partials summed in K order (a fixed order, no atomics): within
    1e-5 of the largest plain output, the same exact products in another
    order of f32 sums."""
    qs, sc, xi8, ax = (torch.from_numpy(a) for a in _operands(t, o, i, t * o + i))
    plan = gemm.plan_gemm(t, o, i, sm_count, bf16=True)
    got = _walk_plain(qs, sc, xi8, ax, plan, bf16=True)
    want = gemm.rowq_gemm_bf16_plain(qs, sc, xi8, ax)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    # deterministic: the same walk gives the same bits
    assert torch.equal(got, _walk_plain(qs, sc, xi8, ax, plan, bf16=True))


@pytest.mark.parametrize("variant", ["int8", "bf16"])
def test_walk_plain_matches_pallas_at_ragged_t(variant):
    """T = 13 (not a multiple of 8): rowq_gemm_pallas has no tiling there
    (the JAX caller falls back to XLA), so it runs on the rows zero-padded
    to 16, as the kernel's TMA zero-fills rows past T; its first 13 rows are
    the reference. K4's walk equals it bit for bit, K17's within 1e-6."""
    t, o, i = 13, 256, 384
    qs, sc, xi8, ax = _operands(t, o, i, 1313)
    args = (jnp.asarray(qs), jnp.asarray(sc))
    assert rowq_gemm_pallas(*args, jnp.asarray(xi8), jnp.asarray(ax), interpret=True,
                            variant=variant) is None
    pad = 16 - t
    want = rowq_gemm_pallas(*args, jnp.asarray(np.pad(xi8, ((0, pad), (0, 0)))),
                            jnp.asarray(np.pad(ax, ((0, pad), (0, 0)))), interpret=True,
                            variant=variant)
    want = np.asarray(want)[:t]
    tq, ts, tx, ta = (torch.from_numpy(a) for a in (qs, sc, xi8, ax))
    plan = gemm.plan_gemm(t, o, i, 16, bf16=variant == "bf16")
    assert plan.split
    got = _walk_plain(tq, ts, tx, ta, plan, bf16=variant == "bf16").numpy()
    if variant == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # the wrapper's CPU path (the plain version) agrees too, and counts nothing
    np.testing.assert_array_equal(gemm.rowq_gemm(tq, ts, tx, ta, variant=variant).numpy(),
                                  gemm.rowq_gemm_plain(tq, ts, tx, ta).numpy()
                                  if variant == "int8" else
                                  gemm.rowq_gemm_bf16_plain(tq, ts, tx, ta).numpy())
    assert gemm.rowq_gemm.launches == 0 and gemm.rowq_gemm_bf16.launches == 0


def _args(t=8, o=16, i=32):
    return (torch.zeros((o, i), dtype=torch.int8), torch.ones((o, 1)),
            torch.zeros((t, i), dtype=torch.int8), torch.ones((t, 1)))


@pytest.mark.parametrize("variant", ["int8", "bf16"])
def test_wrapper_rejects_int32_overflow_width(variant):
    qs, sc, xi8, ax = _args(i=_INT8_ACC_MAX_I + 16)
    with pytest.raises(ValueError, match="overflows"):
        gemm.rowq_gemm(qs, sc, xi8, ax, variant=variant)


@pytest.mark.parametrize("bad,match", [
    ("width", "I % 16"),
    ("align", "aligned"),
    ("dtype", "int8 qs"),
    ("scale_dtype", "f32 scales"),
    ("contiguous", "contiguous"),
    ("empty", "empty"),
])
def test_launch_checks_raise_before_launching(bad, match):
    """What the kernel does not take raises ValueError before the plan or the
    library is touched (so here, without a card, too)."""
    qs, sc, xi8, ax = _args()
    if bad == "width":
        qs, sc, xi8, ax = _args(i=40)
    elif bad == "align":
        buf = torch.zeros(8 * 32 + 1, dtype=torch.int8)
        xi8 = buf[1:].view(8, 32)
    elif bad == "dtype":
        qs = qs.to(torch.int16)
    elif bad == "scale_dtype":
        sc = sc.double()
    elif bad == "contiguous":
        xi8 = torch.zeros((32, 8), dtype=torch.int8).T
    elif bad == "empty":
        qs, sc, xi8, ax = _args(t=0)
    with pytest.raises(ValueError, match=match):
        gemm._launch(qs, sc, xi8, ax, 0, "rowq_gemm")
