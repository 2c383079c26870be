"""K14's and K15's single-launch design on the CPU (the CUDA kernel itself
runs only on the card, in chip_smoke.py):

- `plan_stripe`, the P clusters of C CTAs per (lane, KV head) and the ring's
  stage rows, read from the shapes and the SM count alone (no pos), within
  their limits at the path shapes; `stripe_shares`, each of the head's C P
  ranks' stages, covering every row s <= min(pos, s_use - 1) exactly once
  at every position, unit and cluster boundaries included.
- The kernel's order of work emulated in torch (the fused row write; each
  consumer warp of each rank an online softmax in log2 units over its
  stages 16 rows at a time; the warps' combine in warp order, the ranks' in
  rank order within a cluster, then the P clusters' in cluster order, empty
  ones skipped; the statistics' m back in natural-log units) against the
  JAX package's `decode_attention_split[_q]`, `decode_attention_split_stats`,
  `decode_attention_split_fused_write[_q]` and `decode_attention[_q]` in
  interpret mode: f32, bf16 and int8 caches, fused, unfused, stats and
  s_use modes, outputs and m, l within rtol = atol = 1e-5, the fused caches
  and scale rows bit for bit.
- The launcher's checks, which raise before the library is built or a
  kernel launched (so here, without a card, too), and the CPU wrappers,
  which take the plain versions.
- bench/paged_ablation.py's occupancy copy of the source, which queries
  where the launcher launches.
"""
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llamatpu.ops.pallas_attention as jpa
from llamatpu.ops import kv_quant as jkq
from llamatpu_torch import _build
from llamatpu_torch.ops import attention

H100_SMS = 132
KV, G, HD, L = 2, 4, 64, 2
S = 1024        # the split modes' stripe (JAX s_tile 256)
S_FULL, S_USE = 1056, 1000  # K15: s_use not a multiple of the stage rows
S_TILE = 256
SCALE = 0.125
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
KINDS = {"f32": 4, "bf16": 2, "int8": 1}


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


# ------------------------------------------------------------ the planner
def test_plan_reads_no_pos():
    """The planner's inputs are shapes (and the SM count): a host read of
    pos would sync the step and block its CUDA graph."""
    assert list(inspect.signature(attention.plan_stripe).parameters) == \
        ["b", "kvh", "s", "width", "itemsize", "sm_count"]


# the path shapes: (B, KV, S, width, itemsize): Llama-3.2-1B's 32k cache
# (33792 rows) and the 4000-row cache (4128) in bf16, int8 and f32, at one
# and 8 lanes; Phi-3-medium's 10 KV heads of 128 at one and 8 lanes
PATH_SHAPES = [(b, 8, s, 128, it) for b in (1, 8) for s in (33792, 4128) for it in (2, 1, 4)] \
    + [(b, 10, s, 256, it) for b in (1, 8) for s in (4128, 33792) for it in (2, 1)]


@pytest.mark.parametrize("sm_count", [7, H100_SMS])
def test_plan_is_in_range(sm_count):
    """At the path shapes and over B * KV 1..240 and a few stripes: C in
    {1, 2}, P >= 1, the head's C P ranks within one CTA an SM (two where the
    ring fits an SM twice) or 1, a unit each at least (C P R <= S); stages
    of R rows, a power of two dividing 32 and S, within STRIPE_STAGE_BYTES
    (32 rows unless the bytes or S cut them)."""
    shapes = PATH_SHAPES + [(bkv, 1, s, w, it) for bkv in range(1, 241, 7)
                            for s in (32, 96, 1000, 4128, 16384, 33792)
                            for w, it in ((128, 2), (256, 4), (24, 4), (16, 1))]
    for b, kvh, s, width, itemsize in shapes:
        plan = attention.plan_stripe(b, kvh, s, width, itemsize, sm_count)
        ranks = plan.cluster * plan.parts
        per_sm = 2 if attention.STRIPE_RING * plan.rows * width * itemsize \
            <= attention.STRIPE_SHARED_RING else 1
        assert plan.parts * plan.cluster <= max(1, sm_count // (b * kvh)) \
            or s // plan.rows >= 2 * (sm_count // (b * kvh)) * attention.STRIPE_MIN_UNITS
        assert plan.cluster in (1, 2) and plan.parts >= 1
        assert plan.cluster == 2 or plan.parts == 1
        assert ranks == 1 or b * kvh * ranks <= sm_count * per_sm
        assert ranks * plan.rows <= s or ranks == 1
        assert plan.rows in (1, 2, 4, 8, 16, 32) and s % plan.rows == 0
        assert plan.rows * width * itemsize <= attention.STRIPE_STAGE_BYTES or plan.rows == 1
        assert plan.rows == 32 or s % (2 * plan.rows) \
            or 2 * plan.rows * width * itemsize > attention.STRIPE_STAGE_BYTES


def test_plan_at_the_path_shapes():
    """As measured fastest on the H100 (PERF.md): the one-lane Llama 32k and
    4000-row stripes in bf16 and f32 over 16 CTAs a head (C = 2, P = 8: 128
    CTAs), 32-row stages in bf16, 16 in f32; int8's 4 KB stages at 32k over
    32 CTAs a head (P = 16: two CTAs an SM), at 4128 rows over 16 (too few
    stages a rank for two); at 8 lanes one cluster of 2 a head (int8: 2);
    Phi-3-medium's 10 heads C = 2, P = 6 (120 CTAs); 24 lanes one CTA a
    head."""
    assert attention.plan_stripe(1, 8, 33792, 128, 2, H100_SMS) == attention.StripePlan(2, 8, 32)
    assert attention.plan_stripe(1, 8, 33792, 128, 1, H100_SMS) == attention.StripePlan(2, 16, 32)
    assert attention.plan_stripe(1, 8, 16384, 128, 1, H100_SMS) == attention.StripePlan(2, 16, 32)
    assert attention.plan_stripe(1, 8, 4128, 128, 4, H100_SMS) == attention.StripePlan(2, 8, 16)
    assert attention.plan_stripe(1, 8, 4128, 128, 2, H100_SMS) == attention.StripePlan(2, 8, 32)
    assert attention.plan_stripe(1, 8, 4128, 128, 1, H100_SMS) == attention.StripePlan(2, 8, 32)
    assert attention.plan_stripe(8, 8, 33792, 128, 2, H100_SMS) == attention.StripePlan(2, 1, 32)
    assert attention.plan_stripe(8, 8, 33792, 128, 1, H100_SMS) == attention.StripePlan(2, 2, 32)
    assert attention.plan_stripe(1, 10, 4128, 256, 2, H100_SMS) == attention.StripePlan(2, 6, 16)
    assert attention.plan_stripe(24, 10, 4128, 256, 2, H100_SMS) == attention.StripePlan(1, 1, 16)


PLANS = [(1, 1), (2, 1), (8, 1), (2, 3), (4, 2), (2, 8), (8, 2)]


@pytest.mark.parametrize("s", [64, 160, 512])
def test_shares_cover_each_row_once(s):
    """Every pos from -1 to S (S itself out of range), s_use = S and one
    short of a stage boundary, the planner's cluster sizes and P, stages of
    4, 8, 16 and 32 rows: the ranks' stages together read each row s <=
    min(pos, s_use - 1) exactly once and nothing past it; rank r's stages
    are its units r, r + C P, ...; the ranks' stage counts differ by one at
    most; a pos outside [0, S) reads nothing."""
    for c, p in PLANS:
        for rows in (4, 8, 16, 32):
            plan = attention.StripePlan(c, p, rows)
            for s_use in (s, s - rows // 2 - 1):
                for pos in range(-1, s + 1):
                    shares = attention.stripe_shares(pos, s, plan, s_use)
                    assert len(shares) == c * p
                    live = min(pos, s_use - 1) + 1 if 0 <= pos < s else 0
                    seen = sorted(st for rank in shares for st in rank)
                    assert [s0 for s0, _ in seen] == list(range(0, live, rows))
                    assert all(s1 == min(s0 + rows, live) for s0, s1 in seen)
                    assert all(s0 // rows % (c * p) == r
                               for r, rank in enumerate(shares) for s0, _ in rank)
                    counts = [len(rank) for rank in shares]
                    assert max(counts) - min(counts) <= 1


# --------------------------------------------- the kernel's order, emulated
def _combine(states, g, vhd):
    """States (m, l, acc) combined in order, those with no row (m = -inf)
    skipped: w = 2^(m - max m), l = sum w l, acc = sum w acc."""
    live = [st for st in states if bool(torch.isfinite(st[0]).all())]
    if not live:
        return torch.full((g,), float("-inf")), torch.zeros(g), torch.zeros((g, vhd))
    mx = torch.stack([st[0] for st in live]).max(dim=0).values
    num, den = torch.zeros((g, vhd)), torch.zeros(g)
    for m, lsum, acc in live:
        w = torch.exp2(m - mx)
        den = den + w * lsum
        num = num + w[:, None] * acc
    return mx, den, num


def emulate_stripe(q, kv_new, s_new, kvc, scale_rows, pos_vec, scale, hd, plan,
                   s_use=None, fused=False):
    """The stripe kernel's arithmetic in its order on one layer's cache [B,
    KV, S, W] (and scale rows [B, KV, 2, S]), written in place in fused mode:
    the rank holding pos writes row pos cast to the cache dtype (and its
    scales); the head's rank gr = p C + r (rank r of cluster p) takes
    stripe_shares' stages, consumer warp w its stages w, w + PAGED_WARPS,
    ..., 16 rows at a time, each an online-softmax step in log2 units
    (scores * scale * log2(e) * k_scale, weights 2^(x - m) * v_scale, the sum
    l without the V scale); the warps combine in warp order, a cluster's
    ranks in rank order, the P clusters in cluster order. Returns (out [B,
    KV, G, vhd], m, l [B, KV, G, 1]) f32, m = max * ln 2; NaN for a pos out of
    range."""
    b_n, kvh, g, _ = q.shape
    s_len, width = kvc.shape[-2], kvc.shape[-1]
    vhd = width - hd
    c_n = plan.cluster
    out = torch.empty((b_n, kvh, g, vhd), dtype=torch.float32)
    m_out = torch.empty((b_n, kvh, g, 1), dtype=torch.float32)
    l_out = torch.empty((b_n, kvh, g, 1), dtype=torch.float32)
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    ln2 = torch.tensor(LN2, dtype=torch.float32)
    for b in range(b_n):
        pos = int(pos_vec[b])
        valid = 0 <= pos < s_len
        shares = attention.stripe_shares(pos, s_len, plan, s_use)
        if fused and valid:  # the owner's write, then the stage's row is the cast one
            kvc[b, :, pos] = kv_new[b].to(kvc.dtype)
            if scale_rows is not None:
                scale_rows[b, :, :, pos] = s_new[b]
        for h in range(kvh):
            qf = q[b, h].float()
            ranks = []
            for stages in shares:
                warps = []
                for w in range(attention.PAGED_WARPS):
                    m = torch.full((g,), float("-inf"))
                    lsum = torch.zeros(g)
                    acc = torch.zeros((g, vhd))
                    for s0, s1 in stages[w::attention.PAGED_WARPS]:
                        for j0 in range(s0, s1, 16):
                            rows = slice(j0, min(j0 + 16, s1))
                            kv = kvc[b, h, rows].float()
                            sc = (qf @ kv[:, :hd].T) * sl2
                            if scale_rows is not None:
                                sc = sc * scale_rows[b, h, 0, rows]
                            m_new = torch.maximum(m, sc.max(dim=1).values)
                            e = torch.exp2(sc - m_new[:, None])
                            alpha = torch.exp2(m - m_new)
                            lsum = lsum * alpha + e.sum(dim=1)
                            if scale_rows is not None:
                                e = e * scale_rows[b, h, 1, rows]
                            acc = acc * alpha[:, None] + e @ kv[:, hd:]
                            m = m_new
                    warps.append((m, lsum, acc))
                ranks.append(_combine(warps, g, vhd))
            clusters = [_combine(ranks[p * c_n:(p + 1) * c_n], g, vhd)
                        for p in range(plan.parts)]
            m, lsum, acc = _combine(clusters, g, vhd)
            if valid:
                out[b, h] = acc / lsum[:, None]
                m_out[b, h, :, 0], l_out[b, h, :, 0] = m * ln2, lsum
            else:
                out[b, h] = m_out[b, h] = l_out[b, h] = float("nan")
    return out, m_out, l_out


def _rows(kind: str, s: int = S) -> int:
    return attention.plan_stripe(1, KV, s, 2 * HD, KINDS[kind]).rows


def _plans(kind: str, s: int = S):
    """The planner's plan on the H100 (KV 2: C = 2 and P = 16 at 1024 rows),
    P = 3 clusters of 2, and P = 2 clusters of 8."""
    r = _rows(kind, s)
    return [attention.plan_stripe(1, KV, s, 2 * HD, KINDS[kind], H100_SMS),
            attention.StripePlan(2, 3, r), attention.StripePlan(8, 2, r)]


def _positions(kind: str, mode: str):
    """B = 1 at 0, R - 1, R (a unit boundary), 2 R (the second cluster's
    first unit at C = 2), 8 R (at C = 8), 16 R - 1 (the end of the first
    round at 16 ranks) and the stripe's last row; then B = 3 lanes at 6 R +
    5, 2 R + 5 and one parked at S - 1. K15 (mode s_use) also at s_use - 1
    and past s_use, where every s_use row is attended."""
    r = _rows(kind, S_FULL if mode == "s_use" else S)
    if mode == "s_use":
        return [[0], [r - 1], [r], [8 * r], [S_USE - 1], [S_USE + 7],
                [6 * r + 5, S_USE - 2, S_FULL - 1]]
    return [[0], [r - 1], [r], [2 * r], [8 * r], [16 * r - 1], [S - 1],
            [6 * r + 5, 2 * r + 5, S - 1]]


@functools.lru_cache(maxsize=None)
def _case(kind: str, mode: str, case: int):
    """Inputs and the JAX package's kernel (interpret mode) at layer 1 of a
    2-layer stacked cache: (q, kv_new, s_new, cache, scale rows, pos) before
    the call as torch tensors, and JAX's (out, m, l, cache, scale rows) after
    it as numpy arrays (m, l None but in stats mode; the cache and scale rows
    None but in fused mode)."""
    positions = _positions(kind, mode)[case]
    b = len(positions)
    s_len = S_FULL if mode == "s_use" else S
    rng = np.random.default_rng(100 * case + 10 * len(mode) + len(kind))
    pv = np.asarray(positions, np.int32)
    jpv = jnp.asarray(pv)
    q = rng.normal(size=(b, KV, G, HD)).astype(np.float32)
    x = rng.normal(size=(L, b, KV, s_len, 2 * HD)).astype(np.float32)
    new = rng.normal(size=(b, KV, 2 * HD)).astype(np.float32)
    m = l = jkvc = jsc = None
    if kind == "int8":
        x[..., :3, :HD] = 0.0  # rows of scale 0
        (kq, ks), (vq, vs) = jkq.quantize_kv(jnp.asarray(x[..., :HD])), \
            jkq.quantize_kv(jnp.asarray(x[..., HD:]))
        kvc, sc = jnp.concatenate([kq, vq], axis=-1), jnp.stack([ks, vs], axis=-2)
        (nk, nks), (nv, nvs) = jkq.quantize_kv(jnp.asarray(new[..., :HD])), \
            jkq.quantize_kv(jnp.asarray(new[..., HD:]))
        kvn, sn = jnp.concatenate([nk, nv], axis=-1), jnp.stack([nks, nvs], axis=-1)
        jq = jnp.asarray(q)
        before = (_t(q), _t(kvn), _t(sn), _t(kvc), _t(sc), _t(pv))
        if mode == "fused":
            out, kvc2, sc2 = jpa.decode_attention_split_fused_write_q(
                jq, kvn, sn, kvc, sc, jpv, SCALE, 1, hd=HD, s_tile=S_TILE, interpret=True)
            jkvc, jsc = np.asarray(kvc2), np.asarray(sc2)
        elif mode == "unfused":
            out = jpa.decode_attention_split_q(jq, kvc, sc, jpv, SCALE, hd=HD, s_tile=S_TILE,
                                               interpret=True, layer_index=1)
        else:
            out = jpa.decode_attention_q(jq, kvc, sc, jpv, SCALE, hd=HD, interpret=True,
                                         s_use=S_USE, layer_index=1)
        return before, (np.asarray(out), m, l, jkvc, jsc)
    jdt = jnp.float32 if kind == "f32" else jnp.bfloat16
    jq, kvn, kvc = jnp.asarray(q, jdt), jnp.asarray(new, jdt), jnp.asarray(x, jdt)
    tdt = torch.float32 if kind == "f32" else torch.bfloat16

    def tt(a):
        return _t(np.asarray(a.astype(jnp.float32))).to(tdt)
    before = (tt(jq), tt(kvn), None, tt(kvc), None, _t(pv))
    if mode == "fused":
        out, kvc2 = jpa.decode_attention_split_fused_write(jq, kvn, kvc, jpv, SCALE, 1, hd=HD,
                                                           s_tile=S_TILE, interpret=True)
        jkvc = tt(kvc2)
    elif mode == "unfused":
        out = jpa.decode_attention_split(jq, kvc, jpv, SCALE, hd=HD, s_tile=S_TILE,
                                         interpret=True, layer_index=1)
    elif mode == "stats":
        out, m, l = jpa.decode_attention_split_stats(jq, kvc, jpv, SCALE, hd=HD, s_tile=S_TILE,
                                                     interpret=True, layer_index=1)
        m, l = np.asarray(m), np.asarray(l)
    else:
        out = jpa.decode_attention(jq, kvc, jpv, SCALE, hd=HD, interpret=True, s_use=S_USE,
                                   layer_index=1)
    return before, (np.asarray(out), m, l, jkvc, jsc)


MODES = [("f32", "fused"), ("bf16", "fused"), ("int8", "fused"),
         ("f32", "unfused"), ("bf16", "unfused"), ("int8", "unfused"),
         ("f32", "stats"), ("bf16", "stats"),
         ("f32", "s_use"), ("bf16", "s_use"), ("int8", "s_use")]


@pytest.mark.parametrize("kind,mode", MODES)
def test_kernel_order_matches_pallas(kind, mode):
    """The emulated kernel under the planner's plan, P = 3 clusters of 2 and
    P = 2 clusters of 8, against JAX's kernels in interpret mode at every
    position case: outputs (and the statistics' m and l) within rtol = atol
    = 1e-5; in fused mode the written cache (and scale rows) bit-equal to
    JAX's, only row pos of each lane changed."""
    s_len = S_FULL if mode == "s_use" else S
    for case in range(len(_positions(kind, mode))):
        (q, kvn, sn, kvc, sc, pv), (want, wm, wl, jkvc, jsc) = _case(kind, mode, case)
        for plan in _plans(kind, s_len):
            c1 = kvc.clone()
            s1 = None if sc is None else sc.clone()
            got, m, l = emulate_stripe(q, kvn, sn, c1[1], None if s1 is None else s1[1], pv,
                                       SCALE, HD, plan, S_USE if mode == "s_use" else None,
                                       fused=mode == "fused")
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
            if mode == "stats":
                np.testing.assert_allclose(m.numpy(), wm, rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(l.numpy(), wl, rtol=1e-5, atol=1e-5)
            if mode != "fused":
                assert torch.equal(c1, kvc)
                continue
            if kind == "int8":
                assert np.array_equal(c1.numpy(), jkvc) and np.array_equal(s1.numpy(), jsc)
            else:
                assert torch.equal(c1, jkvc)
            changed = (c1 != kvc).any(dim=-1)  # [L, B, KV, S]
            written = torch.zeros_like(changed)
            written[1, torch.arange(len(pv)), :, pv.long()] = True
            assert not (changed & ~written).any()


@pytest.mark.parametrize("kind,mode", MODES)
def test_plain_versions_match_pallas(kind, mode):
    """The K14 and K15 wrappers on CPU tensors (their plain versions) at the
    same cases: outputs and m, l within 1e-5, fused caches and scale rows
    bit-equal to JAX's; no launch counted."""
    for case in range(len(_positions(kind, mode))):
        (q, kvn, sn, kvc, sc, pv), (want, wm, wl, jkvc, jsc) = _case(kind, mode, case)
        c1 = kvc.clone()
        s1 = None if sc is None else sc.clone()
        if mode == "fused" and kind == "int8":
            got, c2, s2 = attention.decode_attention_split_fused_write_q(
                q, kvn, sn, c1, s1, pv, SCALE, 1, HD, S_TILE)
            assert c2 is c1 and s2 is s1
            assert np.array_equal(c1.numpy(), jkvc) and np.array_equal(s1.numpy(), jsc)
        elif mode == "fused":
            got, c2 = attention.decode_attention_split_fused_write(q, kvn, c1, pv, SCALE, 1, HD,
                                                                   S_TILE)
            assert c2 is c1 and torch.equal(c1, jkvc)
        elif mode == "unfused":
            got = attention.decode_attention_split_q(q, c1, s1, pv, SCALE, HD, S_TILE, 1) \
                if kind == "int8" else attention.decode_attention_split(q, c1, pv, SCALE, HD,
                                                                        S_TILE, 1)
        elif mode == "stats":
            got, m, l = attention.decode_attention_split_stats(q, c1, pv, SCALE, HD, S_TILE, 1)
            np.testing.assert_allclose(m.numpy(), wm, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(l.numpy(), wl, rtol=1e-5, atol=1e-5)
        else:
            got = attention.decode_attention_q(q, c1, s1, pv, SCALE, HD, S_USE, 1) \
                if kind == "int8" else attention.decode_attention(q, c1, pv, SCALE, HD, S_USE, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for name in ("decode_attention_split_fused_write", "decode_attention_split_fused_write_q",
                 "decode_attention_split", "decode_attention_split_q",
                 "decode_attention_split_stats", "decode_attention", "decode_attention_q"):
        assert getattr(attention, name).launches == 0


@pytest.mark.parametrize("plan", [attention.StripePlan(1, 1, 32), attention.StripePlan(8, 2, 32)])
def test_out_of_range_pos_gives_nan_and_writes_nothing(plan):
    """pos -1 and S in fused mode: no row is written and the output, m and l
    are NaN (the kernel makes the fault visible); the third lane attends."""
    (q, kvn, sn, kvc, sc, _), _ = _case("int8", "fused", 7)
    c1, s1 = kvc.clone(), sc.clone()
    pv = torch.tensor([-1, S, 3], dtype=torch.int32)
    got, m, l = emulate_stripe(q, kvn, sn, c1[1], s1[1], pv, SCALE, HD, plan, fused=True)
    for t in (got, m, l):
        assert bool(torch.isnan(t[:2]).all()) and bool(torch.isfinite(t[2]).all())
    assert torch.equal(c1[:, :2], kvc[:, :2]) and torch.equal(s1[:, :2], sc[:, :2])


# ------------------------------------------------------- the launcher's checks
@pytest.fixture
def no_build(monkeypatch):
    """Fail loudly if a check lets the launcher reach the library."""
    def load(name):
        raise AssertionError(f"the launcher reached _build.load({name!r})")
    monkeypatch.setattr(_build, "load", load)


def _inputs(g=G, hd=HD, width=2 * HD, s=64, dtype=torch.bfloat16, b=2):
    q = torch.zeros((b, KV, g, hd), dtype=torch.bfloat16 if dtype != torch.float32 else dtype)
    kvc = torch.zeros((L, b, KV, s, width), dtype=dtype)
    kvn = torch.zeros((b, KV, width), dtype=dtype)
    pv = torch.zeros((b,), dtype=torch.int32)
    sc = sn = None
    if dtype == torch.int8:
        sc = torch.zeros((L, b, KV, 2, s))
        sn = torch.zeros((b, KV, 2))
    return q, kvn, sn, kvc, sc, pv


@pytest.mark.parametrize("case,exc,match", [
    ("g9", NotImplementedError, "G <= 8"),
    ("w264", NotImplementedError, "hd \\+ vhd <= 256"),
    ("vhd_odd", NotImplementedError, "multiples of 8"),
    ("int8_hd8", NotImplementedError, "multiples of 16"),
    ("q_int", ValueError, "f32 or bf16 q"),
    ("kvn_int8", ValueError, "int8 under int8"),
    ("scales_f16", ValueError, "f32 scales"),
    ("strided", ValueError, "contiguous cache"),
    ("pos_shape", ValueError, "pos_vec \\[B\\]"),
    ("cpu", ValueError, "CUDA device"),
    ("misaligned", ValueError, "16-byte aligned"),
])
def test_launcher_raises_before_any_launch(case, exc, match, no_build):
    kw = {"g9": dict(g=9), "w264": dict(width=264, hd=128), "vhd_odd": dict(width=2 * HD + 4),
          "int8_hd8": dict(dtype=torch.int8, width=2 * HD + 8)}.get(case, {})
    q, kvn, sn, kvc, sc, pv = _inputs(**kw)
    hd = kw.get("hd", HD)
    if case == "q_int":
        q = q.to(torch.int32)
    if case == "kvn_int8":
        kvn = kvn.to(torch.int8)
    if case == "scales_f16":
        q, kvn, sn, kvc, sc, pv = _inputs(dtype=torch.int8)
        sn = sn.half()
    if case == "strided":
        kvc = torch.zeros((L, 2, KV, 2 * HD, 64), dtype=torch.bfloat16).transpose(-1, -2)
    if case == "pos_shape":
        pv = torch.zeros((3,), dtype=torch.int32)
    if case == "misaligned":
        kvc = torch.zeros(kvc.numel() + 1, dtype=kvc.dtype)[1:].view(kvc.shape)
    with pytest.raises(exc, match=match):
        attention._stripe_launch(q, kvc, pv, SCALE, hd, 1, sc, kvn, sn)
    assert attention.decode_attention_split_fused_write.launches == 0


def test_wrappers_take_the_plain_version_only_on_the_cpu(no_build):
    """A CPU cache takes the plain version in every K14 and K15 wrapper (no
    launch counted); the launcher itself refuses CPU tensors, so no CUDA
    tensor can reach a plain version."""
    q, kvn, _, kvc, _, pv = _inputs()
    assert attention.decode_attention_split_fused_write(q, kvn, kvc, pv, SCALE, 1, HD, 64)[0] \
        .shape == (2, KV, G, HD)
    assert attention.decode_attention_split(q, kvc, pv, SCALE, HD, 64, 1).shape == (2, KV, G, HD)
    assert attention.decode_attention_split_stats(q, kvc, pv, SCALE, HD, 64, 1)[1].shape == \
        (2, KV, G, 1)
    assert attention.decode_attention(q, kvc, pv, SCALE, HD, 40, 1).shape == (2, KV, G, HD)
    q, kvn, sn, kvc, sc, pv = _inputs(dtype=torch.int8)
    assert attention.decode_attention_split_fused_write_q(q, kvn, sn, kvc, sc, pv, SCALE, 1, HD,
                                                          64)[0].shape == (2, KV, G, HD)
    assert attention.decode_attention_split_q(q, kvc, sc, pv, SCALE, HD, 64, 1).shape == \
        (2, KV, G, HD)
    assert attention.decode_attention_q(q, kvc, sc, pv, SCALE, HD, 40, 1).shape == (2, KV, G, HD)
    for name in ("decode_attention_split_fused_write", "decode_attention_split_fused_write_q",
                 "decode_attention_split", "decode_attention_split_q",
                 "decode_attention_split_stats", "decode_attention", "decode_attention_q"):
        assert getattr(attention, name).launches == 0
    for fused in (False, True):
        with pytest.raises(ValueError, match="CUDA device"):
            attention._stripe_launch(q, kvc, pv, SCALE, HD, 1, sc, kvn if fused else None,
                                     sn if fused else None)


def test_occupancy_copy_queries_instead_of_launching():
    """bench/paged_ablation.py's occupancy copy of csrc/attention.cu asks
    cudaOccupancyMaxActiveClusters where the launcher would launch, exports
    the answer, and leaves the kernels' code as it is; the shipped source
    has no such query."""
    from llamatpu_torch.bench import paged_ablation

    src = (_build.CSRC / "attention.cu").read_text()
    text = paged_ablation._occupancy(src)
    assert "cudaOccupancyMaxActiveClusters" not in src
    assert text.count("cudaOccupancyMaxActiveClusters(&g_clusters, kernel, &cfg)") == 1
    assert text.index("cudaOccupancyMaxActiveClusters") < text.index(paged_ablation.LAUNCH)
    assert text.rstrip().endswith("LT_EXPORT int lt_clusters_at_once() { return g_clusters; }")
    assert src[:src.index(paged_ablation.LAUNCHER)] in text
    assert src[src.index(paged_ablation.LAUNCH):] in text
