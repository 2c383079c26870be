"""K8's single-launch design on the CPU (the CUDA kernel itself runs only on
the card, in chip_smoke.py):

- `plan_paged`, the cluster of CTAs per (lane, KV head) and the ring's
  stages, and `paged_shares`, each rank's stages: the cluster a power of two
  <= 8 and <= MAXBLK, the ranks' stages covering every live row of a lane
  (so every live block) exactly once, at every position.
- The kernel's order of work emulated in torch (each consumer warp of each
  rank an online softmax over its stages, then the warps' and the ranks'
  combines in order with empty ones skipped) against the JAX package's
  `decode_attention_paged` in interpret mode, bf16, f32 and int8 pools,
  every cluster size.
- The launcher's checks, which raise before the library is built or a
  kernel launched (so here, without a card, too).
- bench/paged_ablation.py's variants, which edit the kernel's source.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llamatpu.ops.pallas_attention as jpa
from llamatpu.ops import kv_quant as jkq
from llamatpu_torch import _build
from llamatpu_torch.bench import paged_ablation
from llamatpu_torch.ops import attention

H100_SMS = 132
KV, G, HD, L = 2, 4, 64, 2
SCALE = 0.125
MAXBLK = 12
PARKED, NAN_LANE, OUT_OF_RANGE = 5, 6, 7


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
@pytest.mark.parametrize("sm_count", [7, H100_SMS])
def test_plan_cluster_is_a_power_of_two_within_the_table(sm_count):
    """For B * KV from 1 to 240 and MAXBLK 1-256: C in {1, 2, 4, 8}, C <=
    MAXBLK, the smallest that gives PAGED_MIN_CTAS_PER_SM CTAs an SM where
    the table allows it; stages of at most 16 rows within
    PAGED_STAGE_BYTES."""
    for bkv in range(1, 241):
        for maxblk in range(1, 257):
            c = attention.plan_paged(bkv, 1, maxblk, 128, 2, sm_count).cluster
            assert c in (1, 2, 4, 8) and c <= maxblk
            enough = bkv * c >= attention.PAGED_MIN_CTAS_PER_SM * sm_count
            assert enough or c == 8 or 2 * c > maxblk
            assert c == 1 or bkv * (c // 2) < attention.PAGED_MIN_CTAS_PER_SM * sm_count
    for width, itemsize in ((16, 1), (128, 1), (256, 1), (128, 2), (256, 2), (192, 2),
                            (128, 4), (256, 4), (24, 4)):
        plan = attention.plan_paged(8, 8, 128, width, itemsize, sm_count)
        assert plan.rows & (plan.rows - 1) == 0 and 1 <= plan.rows <= 16
        assert plan.rows * width * itemsize <= attention.PAGED_STAGE_BYTES
        assert plan.rows == 16 or 2 * plan.rows * width * itemsize > attention.PAGED_STAGE_BYTES
        if itemsize == 1:  # int8 scales of a block longer than a stage go by 16-byte copies
            assert plan.rows >= 4


def test_plan_at_the_path_shapes():
    """The serving paths' launches on the H100: Llama-3.2-1B at 8 lanes
    (KV 8), the MoE paged engine (8 lanes, KV 16, hd 128) and
    Phi-3-medium's 24 lanes (KV 10, hd 128), block 16."""
    assert attention.plan_paged(8, 8, 128, 128, 2, H100_SMS) == attention.PagedPlan(4, 16)
    assert attention.plan_paged(8, 8, 128, 128, 1, H100_SMS) == attention.PagedPlan(4, 16)
    assert attention.plan_paged(8, 16, 128, 256, 2, H100_SMS) == attention.PagedPlan(2, 16)
    assert attention.plan_paged(24, 10, 64, 256, 2, H100_SMS) == attention.PagedPlan(1, 16)
    assert attention.plan_paged(1, 8, 1, 128, 2, H100_SMS).cluster == 1  # one block a lane


@pytest.mark.parametrize("bs", [1, 2, 16])
def test_shares_cover_each_live_row_once(bs):
    """MAXBLK 1-17, 31, 64, 127 and 256 / BS; every pos from -1 to MAXBLK *
    BS - 1 (and MAXBLK * BS, out of range), every cluster size the planner
    picks and stages of 1, 4 and 16 rows: the ranks' stages together read
    each row s <= pos exactly once (so every live block, whole or in
    stage-sized pieces) and nothing past pos; a stage is whole blocks or
    lies in one block; the ranks' stage counts differ by one at most."""
    for maxblk in list(range(1, 18)) + [31, 64, 127, 256 // bs]:
        clusters = {attention.plan_paged(bkv, 1, maxblk, 128, 2, sms).cluster
                    for bkv in (1, 8, 64, 240) for sms in (7, H100_SMS)} | {1, 2, 4, 8}
        for c in clusters:
            for rows in (1, 4, 16):
                plan = attention.PagedPlan(c, rows)
                for pos in range(-1, maxblk * bs + 1):
                    shares = attention.paged_shares(pos, bs, maxblk, plan)
                    assert len(shares) == c
                    live = pos + 1 if 0 <= pos < maxblk * bs else 0
                    seen = sorted(st for rank in shares for st in rank)
                    assert [s0 for s0, _ in seen] == list(range(0, live, rows))
                    assert all(s1 == min(s0 + rows, live) for s0, s1 in seen)
                    assert all(s0 % bs == 0 if rows >= bs else s0 // bs == (s1 - 1) // bs
                               for s0, s1 in seen)
                    counts = [len(rank) for rank in shares]
                    assert max(counts) - min(counts) <= 1


# --------------------------------------------- the kernel's order, emulated
def emulate_paged(q, pool, tables, pos_vec, scale, hd, plan, scale_pool=None):
    """K8's arithmetic in the kernel's order, for one layer's pool [NBLK, KV,
    BS, W] (and scale pool [NBLK, KV, 2, BS]): rank r of lane b's cluster for
    KV head h takes paged_shares' stages (units r, r + C, ... of plan.rows
    rows s <= pos), consumer warp w taking stages w, w + PAGED_WARPS, ..., each
    stage an online-softmax step (scores * k_scale, weights * v_scale, the
    sum l without it); the warps' (m, l, acc) combine in warp order, then
    the ranks' in rank order, empty ones skipped; NaN for a pos out of
    range."""
    b_n, kvh, g, _ = q.shape
    bs, width = pool.shape[-2], pool.shape[-1]
    vhd = width - hd
    maxblk = tables.shape[1]
    out = torch.empty((b_n, kvh, g, vhd), dtype=torch.float32)

    def combine(states):
        live = [st for st in states if bool(torch.isfinite(st[0]).all())]
        if not live:
            return torch.full((g,), float("-inf")), torch.zeros(g), torch.zeros((g, vhd))
        mx = torch.stack([st[0] for st in live]).max(dim=0).values
        num, den = torch.zeros((g, vhd)), torch.zeros(g)
        for m, lsum, acc in live:  # in order
            w = torch.exp(m - mx)
            den = den + w * lsum
            num = num + w[:, None] * acc
        return mx, den, num

    for b in range(b_n):
        pos = int(pos_vec[b])
        shares = attention.paged_shares(pos, bs, maxblk, plan)
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
                        rows = range(s0, s1)
                        blk = [int(tables[b, s // bs]) for s in rows]
                        kv = torch.stack([pool[k, h, s % bs] for k, s in zip(blk, rows)]).float()
                        sc = (qf @ kv[:, :hd].T) * scale
                        if scale_pool is not None:
                            sc = sc * torch.stack([scale_pool[k, h, 0, s % bs]
                                                   for k, s in zip(blk, rows)])
                        m_new = torch.maximum(m, sc.max(dim=1).values)
                        e = torch.exp(sc - m_new[:, None])
                        alpha = torch.exp(m - m_new)
                        lsum = lsum * alpha + e.sum(dim=1)
                        if scale_pool is not None:
                            e = e * torch.stack([scale_pool[k, h, 1, s % bs]
                                                 for k, s in zip(blk, rows)])
                        acc = acc * alpha[:, None] + e @ kv[:, hd:]
                        m = m_new
                    warps.append((m, lsum, acc))
                ranks.append(combine(warps))
            m, lsum, acc = combine(ranks)
            out[b, h] = acc / lsum[:, None] if bool(torch.isfinite(m).all()) else float("nan")
    return out


def _tables(rng, bs, positions, n_blocks, parked):
    trash = n_blocks - 1
    free = list(rng.permutation(n_blocks - 1))
    tables = np.full((len(positions), MAXBLK), trash, np.int32)
    for b, pos in enumerate(positions):
        if b not in parked:
            for j in range(min(pos, MAXBLK * bs - 1) // bs + 1):
                tables[b, j] = free.pop()
    return tables


@functools.lru_cache(maxsize=None)
def _case(bs: int, kind: str):
    """Inputs and the JAX package's `decode_attention_paged(interpret=True)`
    for layer 1 of a shuffled 2-layer pool: lanes at 0, BS - 1, BS, a block
    boundary in the middle, MAXLEN - 1, one parked at the trash block, one
    at pos -1 and one at MAXLEN (out of range, NaN from the kernel)."""
    rng = np.random.default_rng(100 * bs + len(kind))
    positions = [0, bs - 1, bs, 6 * bs, MAXBLK * bs - 1, 3 * bs + 5, -1, MAXBLK * bs]
    n_blocks = len(positions) * MAXBLK + 1
    tables = _tables(rng, bs, [max(p, 0) for p in positions], n_blocks,
                     parked=(PARKED, NAN_LANE, OUT_OF_RANGE))
    q = rng.normal(size=(len(positions), KV, G, HD)).astype(np.float32)
    pv = np.asarray(positions, np.int32)
    spool = None
    if kind == "int8":
        x = rng.normal(size=(L, n_blocks, KV, bs, 2 * HD)).astype(np.float32)
        x[..., :2, :HD] = 0.0  # rows of scale 0
        (kq, ks), (vq, vs) = jkq.quantize_kv(jnp.asarray(x[..., :HD])), \
            jkq.quantize_kv(jnp.asarray(x[..., HD:]))
        pool, spool = jnp.concatenate([kq, vq], axis=-1), jnp.stack([ks, vs], axis=-2)
        jq = jnp.asarray(q)
    else:
        jdt = jnp.float32 if kind == "f32" else jnp.bfloat16
        pool = jnp.asarray(rng.normal(size=(L, n_blocks, KV, bs, 2 * HD)).astype(np.float32), jdt)
        jq = jnp.asarray(q, jdt)
    want = np.asarray(jpa.decode_attention_paged(jq, pool, jnp.asarray(tables), jnp.asarray(pv),
                                                 SCALE, scale_pool=spool, hd=HD, interpret=True,
                                                 layer_index=1))
    tq = _t(np.asarray(jq.astype(jnp.float32)))
    tpool = _t(np.asarray(pool.astype(jnp.float32)) if kind != "int8" else np.asarray(pool))
    if kind == "bf16":
        tq, tpool = tq.to(torch.bfloat16), tpool.to(torch.bfloat16)
    return tq, tpool, None if spool is None else _t(spool), _t(tables), _t(pv), want


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bs", [8, 16])
def test_kernel_order_matches_pallas(bs, kind, cluster):
    """The emulated kernel (the planner's stages, and 4-row stages that cut
    a block into pieces) against JAX's `_paged_kernel` in interpret mode:
    rtol 1e-5, atol 1e-5 * max|want| over the lanes with pos in range; NaN
    at pos -1 and MAXLEN. Also against the port's plain version."""
    q, pool, spool, tables, pv, want = _case(bs, kind)
    plan = attention.plan_paged(q.shape[0], KV, MAXBLK, pool.shape[-1], pool.element_size())
    keep = [b for b in range(q.shape[0]) if b not in (NAN_LANE, OUT_OF_RANGE)]
    tol = 1e-5 * float(np.abs(want[keep]).max())
    for rows in (plan.rows, 4):
        stage = attention.PagedPlan(cluster, rows)
        got = emulate_paged(q, pool[1], tables, pv, SCALE, HD, stage,
                            None if spool is None else spool[1])
        assert bool(torch.isnan(got[[NAN_LANE, OUT_OF_RANGE]]).all())
        np.testing.assert_allclose(got[keep].numpy(), want[keep], rtol=1e-5, atol=tol)
    plain = attention.decode_attention_paged_plain(q, pool, tables, pv, SCALE, HD, 1,
                                                   scale_pool=spool)
    np.testing.assert_allclose(plain[keep].numpy(), want[keep], rtol=1e-5, atol=tol)


# ------------------------------------------------------- the launcher's checks
@pytest.fixture
def no_build(monkeypatch):
    """Fail loudly if a check lets the launcher reach the library."""
    def load(name):
        raise AssertionError(f"the launcher reached _build.load({name!r})")
    monkeypatch.setattr(_build, "load", load)


def _inputs(g=G, hd=HD, width=2 * HD, bs=16, dtype=torch.bfloat16, b=2, nblk=5):
    q = torch.zeros((b, KV, g, hd), dtype=torch.bfloat16)
    pool = torch.zeros((L, nblk, KV, bs, width), dtype=dtype)
    tables = torch.zeros((b, 3), dtype=torch.int32)
    pv = torch.zeros((b,), dtype=torch.int32)
    return q, pool, tables, pv


@pytest.mark.parametrize("case,exc,match", [
    ("g9", NotImplementedError, "G <= 8"),
    ("w264", NotImplementedError, "hd \\+ vhd <= 256"),
    ("vhd_odd", NotImplementedError, "multiples of 8"),
    ("bs12", ValueError, "power of two"),
    ("f16", NotImplementedError, "float16 KV pool"),
    ("q_int", ValueError, "f32 or bf16 q"),
    ("scales_f16", ValueError, "f32 scale pool"),
    ("strided", ValueError, "contiguous pool"),
    ("cpu", ValueError, "CUDA device"),
])
def test_launcher_raises_before_any_launch(case, exc, match, no_build):
    kw = {"g9": dict(g=9), "w264": dict(width=264, hd=128), "vhd_odd": dict(width=2 * HD + 4),
          "bs12": dict(bs=12), "f16": dict(dtype=torch.float16)}.get(case, {})
    q, pool, tables, pv = _inputs(**kw)
    spool = None
    hd = kw.get("hd", HD)
    if case == "q_int":
        q = q.to(torch.int32)
    if case == "scales_f16":
        pool = pool.to(torch.int8)
        spool = torch.zeros(pool.shape[:-2] + (2, pool.shape[-2]), dtype=torch.float16)
    if case == "strided":
        pool = torch.zeros((L, 5, KV, 2 * HD, 16), dtype=torch.bfloat16).transpose(-1, -2)
    with pytest.raises(exc, match=match):
        attention._paged_launch(q, pool, tables, pv, SCALE, hd, 1, spool)
    assert attention.decode_attention_paged.launches == 0


def test_wrappers_take_the_plain_version_only_on_the_cpu(no_build):
    """A CPU pool takes the plain version (no launch counted); the launcher
    itself refuses CPU tensors, so no CUDA tensor can reach the plain one."""
    q, pool, tables, pv = _inputs()
    out = attention.decode_attention_paged(q, pool, tables, pv, SCALE, HD, 1)
    assert out.shape == (2, KV, G, HD) and attention.decode_attention_paged.launches == 0
    with pytest.raises(ValueError, match="CUDA device"):
        attention._paged_launch(q, pool.to(torch.int8), tables, pv, SCALE, HD, 1,
                                torch.zeros((L, 5, KV, 2, 16)))


@pytest.mark.parametrize("name", list(paged_ablation.VARIANTS))
def test_ablation_variants_edit_the_kernel(name):
    """Each variant of bench/paged_ablation.py still finds the statements it
    edits in csrc/attention.cu (the phase clocks every mark's), and keeps K6's
    and the walk kernel's source as it is."""
    src = (_build.CSRC / "attention.cu").read_text()
    text = paged_ablation.VARIANTS[name][0](src)
    assert (text == src) == (name == "as built")
    head = src[:src.index(paged_ablation.K8_SECTION)]
    assert text.count("paged_cluster_kernel") == src.count("paged_cluster_kernel")
    assert head in text
    if name == "phase clocks":
        assert all(f"g_marks[rank][warp][{m}]" in text for m in range(1, paged_ablation.N_MARKS))
