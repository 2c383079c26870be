"""K6's single-launch design on the CPU (the CUDA kernel itself runs only on
the card, in chip_smoke.py):

- `plan_dense`, the cluster of CTAs per (lane, KV head) and the ring's
  stage rows, read from the shapes alone (no pos), and `dense_shares`, each
  rank's stages: the cluster a power of two within the stripe, the stage
  rows dividing 32, the ranks' stages covering every row s <= pos exactly
  once at every position.
- The kernel's order of work emulated in torch (the fused row write, each
  consumer warp of each rank an online softmax in log2 units over its
  stages 16 rows at a time with row pos taken from the cast row, then the
  warps' and the ranks' combines in order with empty ones skipped) against
  the JAX package's `decode_attention_fused_write[_q]` in interpret mode,
  f32, bf16 and int8 caches, every cluster size; caches and scale rows bit
  for bit.
- The launcher's checks, which raise before the library is built or a
  kernel launched (so here, without a card, too), and the CPU wrappers,
  which take the plain versions.
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
from llamatpu_torch.bench import paged_ablation
from llamatpu_torch.ops import attention

H100_SMS = 132
KV, G, HD, L = 2, 4, 64, 2
S = 512
SCALE = 0.125
LOG2E = 1.4426950408889634


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
    assert list(inspect.signature(attention.plan_dense).parameters) == \
        ["b", "kvh", "s", "width", "itemsize", "sm_count"]


@pytest.mark.parametrize("sm_count", [7, H100_SMS])
def test_plan_cluster_is_a_power_of_two_within_the_stripe(sm_count):
    """For B * KV from 1 to 240 and S every multiple of 32 to 1024, then
    2048-16384: C in {1, 2, 4, 8}, C * R <= S and B * KV * C CTAs within the
    SMs where C > 1; stages of R rows, a power of two dividing 32 (so S % R
    == 0 for every K6 caller) within DENSE_STAGE_BYTES: 16 at C >= 4, else
    32, unless the bytes or the stripe cut them."""
    for bkv in range(1, 241):
        for s in list(range(32, 1025, 32)) + [2048, 4096, 8160, 15360, 16384]:
            for width, itemsize in ((128, 2), (256, 2), (128, 1), (256, 1), (128, 4), (256, 4),
                                    (16, 1), (24, 4)):
                plan = attention.plan_dense(bkv, 1, s, width, itemsize, sm_count)
                assert plan.cluster in (1, 2, 4, 8) and plan.cluster * plan.rows <= s
                assert plan.cluster == 1 or bkv * plan.cluster <= sm_count
                assert plan.rows in (1, 2, 4, 8, 16, 32) and s % plan.rows == 0
                assert plan.rows * width * itemsize <= attention.DENSE_STAGE_BYTES
                assert plan.rows == (16 if plan.cluster >= 4 else 32) \
                    or 2 * plan.rows * width * itemsize > attention.DENSE_STAGE_BYTES \
                    or plan.cluster * 2 * plan.rows > s


def test_plan_at_the_path_shapes():
    """The engines' launches on the H100, as measured best at pos 512
    (PERF.md): Llama-3.2-1B (KV 8, hd 64) at one lane C = 8 of 16-row stages
    in bf16, f32 and int8, at 8 lanes C = 2 of 32 rows; Qwen1.5-MoE (KV 16,
    hd 128) and Phi-3-medium (KV 10, hd 128) at one lane C = 8, at 8 and 24
    lanes one CTA a lane-head. The plan does not follow S: the time at a
    position must not grow with the physical length."""
    for s in (1152, 8160):
        assert attention.plan_dense(1, 8, s, 128, 2, H100_SMS) == attention.DensePlan(8, 16)
        assert attention.plan_dense(8, 8, s, 128, 2, H100_SMS) == attention.DensePlan(2, 32)
    assert attention.plan_dense(1, 8, 15360, 128, 1, H100_SMS) == attention.DensePlan(8, 16)
    assert attention.plan_dense(8, 8, 15360, 128, 1, H100_SMS) == attention.DensePlan(2, 32)
    assert attention.plan_dense(1, 8, 1152, 128, 4, H100_SMS) == attention.DensePlan(8, 16)
    assert attention.plan_dense(1, 16, 1152, 256, 2, H100_SMS) == attention.DensePlan(8, 16)
    assert attention.plan_dense(1, 10, 4128, 256, 2, H100_SMS) == attention.DensePlan(8, 16)
    assert attention.plan_dense(8, 10, 1152, 256, 2, H100_SMS) == attention.DensePlan(1, 16)
    assert attention.plan_dense(24, 10, 1152, 256, 2, H100_SMS) == attention.DensePlan(1, 16)
    assert attention.plan_dense(1, 8, 32, 128, 2, H100_SMS) == attention.DensePlan(2, 16)


@pytest.mark.parametrize("s", [32, 64, 96, 160, 512])
def test_shares_cover_each_row_once(s):
    """Every pos from -1 to S (S itself out of range), every cluster size and
    stages of 4, 8, 16 and 32 rows: the ranks' stages together read each row
    s <= pos exactly once and nothing past pos; rank r's stages are its
    units r, r + C, ...; the ranks' stage counts differ by one at most; a
    pos outside [0, S) reads nothing."""
    for c in (1, 2, 4, 8):
        for rows in (4, 8, 16, 32):
            plan = attention.DensePlan(c, rows)
            for pos in range(-1, s + 1):
                shares = attention.dense_shares(pos, s, plan)
                assert len(shares) == c
                live = pos + 1 if 0 <= pos < s else 0
                seen = sorted(st for rank in shares for st in rank)
                assert [s0 for s0, _ in seen] == list(range(0, live, rows))
                assert all(s1 == min(s0 + rows, live) for s0, s1 in seen)
                assert all(s0 // rows % c == r for r, rank in enumerate(shares) for s0, _ in rank)
                counts = [len(rank) for rank in shares]
                assert max(counts) - min(counts) <= 1


# --------------------------------------------- the kernel's order, emulated
def emulate_dense(q, kv_new, s_new, kvc, scale_rows, pos_vec, scale, hd, plan):
    """K6's arithmetic in the kernel's order on one layer's cache [B, KV, S,
    W] (and scale rows [B, KV, 2, S]), both written in place: the rank
    holding pos writes row pos cast to the cache dtype (and its scales);
    rank r of lane b's cluster for KV head h takes dense_shares' stages
    (units r, r + C, ... of plan.rows rows s <= pos), consumer warp w taking
    stages w, w + PAGED_WARPS, ..., each stage 16 rows at a time, row pos
    the cast row; each 16 rows an online-softmax step in log2 units (scores
    * scale * log2(e) * k_scale, weights 2^(x - m) * v_scale, the sum l
    without the V scale); the warps' (m, l, acc) combine in warp order, then
    the ranks' in rank order, empty ones skipped; NaN for a pos out of
    range. Returns out [B, KV, G, vhd] f32."""
    b_n, kvh, g, _ = q.shape
    s_len, width = kvc.shape[-2], kvc.shape[-1]
    vhd = width - hd
    out = torch.empty((b_n, kvh, g, vhd), dtype=torch.float32)
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)

    def combine(states):
        live = [st for st in states if bool(torch.isfinite(st[0]).all())]
        if not live:
            return torch.full((g,), float("-inf")), torch.zeros(g), torch.zeros((g, vhd))
        mx = torch.stack([st[0] for st in live]).max(dim=0).values
        num, den = torch.zeros((g, vhd)), torch.zeros(g)
        for m, lsum, acc in live:  # in order
            w = torch.exp2(m - mx)
            den = den + w * lsum
            num = num + w[:, None] * acc
        return mx, den, num

    for b in range(b_n):
        pos = int(pos_vec[b])
        shares = attention.dense_shares(pos, s_len, plan)
        if 0 <= pos < s_len:  # the owner's write, then the stage's row is the cast one
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
                ranks.append(combine(warps))
            m, lsum, acc = combine(ranks)
            out[b, h] = acc / lsum[:, None] if bool(torch.isfinite(m).all()) else float("nan")
    return out


def _rows(kind: str) -> int:
    itemsize = {"f32": 4, "bf16": 2, "int8": 1}[kind]
    return attention.plan_dense(1, KV, S, 2 * HD, itemsize).rows


def _positions(kind: str):
    """B = 1 at 0, R - 1, R, 4 R (a rank boundary at C = 4) and S - 1; then
    B = 3: 8 R - 1 (the last row of C = 8's first round), 2 R + 5, and a
    lane parked at S - 1."""
    r = _rows(kind)
    return [[0], [r - 1], [r], [4 * r], [S - 1], [8 * r - 1, 2 * r + 5, S - 1]]


@functools.lru_cache(maxsize=None)
def _case(kind: str, case: int):
    """Inputs and the JAX package's `decode_attention_fused_write[_q]`
    (interpret mode) at layer 1 of a 2-layer stacked cache: (q, kv_new,
    s_new, cache, scale rows, pos) before the call as torch tensors, and
    JAX's (out, cache, scale rows) after it as numpy arrays."""
    positions = _positions(kind)[case]
    b = len(positions)
    rng = np.random.default_rng(10 * case + len(kind))
    pv = np.asarray(positions, np.int32)
    q = rng.normal(size=(b, KV, G, HD)).astype(np.float32)
    x = rng.normal(size=(L, b, KV, S, 2 * HD)).astype(np.float32)
    new = rng.normal(size=(b, KV, 2 * HD)).astype(np.float32)
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
        jout, kvc2, sc2 = jpa.decode_attention_fused_write_q(
            jq, kvn, sn, kvc, sc, jnp.asarray(pv), SCALE, 1, hd=HD, interpret=True)
        return before, (np.asarray(jout), np.asarray(kvc2), np.asarray(sc2))
    jdt = jnp.float32 if kind == "f32" else jnp.bfloat16
    jq, kvn, kvc = jnp.asarray(q, jdt), jnp.asarray(new, jdt), jnp.asarray(x, jdt)
    tdt = torch.float32 if kind == "f32" else torch.bfloat16

    def tt(a):
        return _t(np.asarray(a.astype(jnp.float32))).to(tdt)
    before = (tt(jq), tt(kvn), None, tt(kvc), None, _t(pv))
    jout, kvc2 = jpa.decode_attention_fused_write(jq, kvn, kvc, jnp.asarray(pv), SCALE, 1, hd=HD,
                                                  interpret=True)
    return before, (np.asarray(jout), _t(np.asarray(kvc2.astype(jnp.float32))).to(tdt), None)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_kernel_order_matches_pallas(kind, cluster):
    """The emulated kernel at the planner's stage rows against JAX's
    `_fused_write_kernel` in interpret mode at every position case: outputs
    within rtol = atol = 1e-5 (f32 attention), the written cache (and scale
    rows) bit-equal to JAX's, only row pos of each lane changed."""
    for case in range(len(_positions(kind))):
        (q, kvn, sn, kvc, sc, pv), (want, jkvc, jsc) = _case(kind, case)
        plan = attention.DensePlan(cluster, _rows(kind))
        c1 = kvc.clone()
        s1 = None if sc is None else sc.clone()
        got = emulate_dense(q, kvn, sn, c1[1], None if s1 is None else s1[1], pv, SCALE, HD, plan)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        if kind == "int8":
            assert np.array_equal(c1.numpy(), jkvc) and np.array_equal(s1.numpy(), jsc)
        else:
            assert torch.equal(c1, jkvc)
        changed = (c1 != kvc).any(dim=-1)  # [L, B, KV, S]
        written = torch.zeros_like(changed)
        written[1, torch.arange(len(pv)), :, pv.long()] = True
        assert not (changed & ~written).any()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_plain_versions_match_pallas(kind):
    """K6's plain versions (what the CPU wrappers take) at the same cases:
    outputs within 1e-5, caches and scale rows bit-equal to JAX's."""
    for case in range(len(_positions(kind))):
        (q, kvn, sn, kvc, sc, pv), (want, jkvc, jsc) = _case(kind, case)
        c1 = kvc.clone()
        if kind == "int8":
            s1 = sc.clone()
            got, c2, s2 = attention.decode_attention_fused_write_q(q, kvn, sn, c1, s1, pv, SCALE,
                                                                   1, HD)
            assert c2 is c1 and s2 is s1
            assert np.array_equal(c1.numpy(), jkvc) and np.array_equal(s1.numpy(), jsc)
        else:
            got, c2 = attention.decode_attention_fused_write(q, kvn, c1, pv, SCALE, 1, HD)
            assert c2 is c1 and torch.equal(c1, jkvc)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert attention.decode_attention_fused_write.launches == 0
    assert attention.decode_attention_fused_write_q.launches == 0


@pytest.mark.parametrize("cluster", [1, 4])
def test_out_of_range_pos_gives_nan_and_writes_nothing(cluster):
    """pos -1 and S: no row is written and the output is NaN (the kernel
    makes the fault visible)."""
    (q, kvn, sn, kvc, sc, _), _ = _case("int8", 5)
    c1, s1 = kvc.clone(), sc.clone()
    pv = torch.tensor([-1, S, 3], dtype=torch.int32)
    got = emulate_dense(q, kvn, sn, c1[1], s1[1], pv, SCALE, HD, attention.DensePlan(cluster, 32))
    assert bool(torch.isnan(got[:2]).all()) and bool(torch.isfinite(got[2]).all())
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
    kvn = torch.zeros((b, KV, width), dtype=dtype if dtype != torch.int8 else torch.int8)
    if dtype == torch.bfloat16:
        kvn = kvn.to(torch.bfloat16)
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
    ("s_rows", ValueError, "not a multiple of the stage's"),
    ("q_int", ValueError, "f32 or bf16 q"),
    ("kvn_dtype", ValueError, "kv_new of q's dtype"),
    ("scales_f16", ValueError, "f32 scales"),
    ("strided", ValueError, "contiguous cache"),
    ("pos_shape", ValueError, "pos_vec \\[B\\]"),
    ("cpu", ValueError, "CUDA device"),
    ("misaligned", ValueError, "16-byte aligned"),
])
def test_launcher_raises_before_any_launch(case, exc, match, no_build):
    kw = {"g9": dict(g=9), "w264": dict(width=264, hd=128), "vhd_odd": dict(width=2 * HD + 4),
          "int8_hd8": dict(dtype=torch.int8, width=2 * HD + 8), "s_rows": dict(s=40)}.get(case, {})
    q, kvn, sn, kvc, sc, pv = _inputs(**kw)
    hd = kw.get("hd", HD)
    if case == "q_int":
        q = q.to(torch.int32)
    if case == "kvn_dtype":
        kvn = kvn.float()
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
        attention._dense_launch(q, kvn, sn, kvc, sc, pv, SCALE, hd, 1)
    assert attention.decode_attention_fused_write.launches == 0


def test_wrappers_take_the_plain_version_only_on_the_cpu(no_build):
    """A CPU cache takes the plain version (no launch counted); the launcher
    itself refuses CPU tensors, so no CUDA tensor can reach the plain one."""
    q, kvn, _, kvc, _, pv = _inputs()
    out, _ = attention.decode_attention_fused_write(q, kvn, kvc, pv, SCALE, 1, HD)
    assert out.shape == (2, KV, G, HD) and attention.decode_attention_fused_write.launches == 0
    q, kvn, sn, kvc, sc, pv = _inputs(dtype=torch.int8)
    out, _, _ = attention.decode_attention_fused_write_q(q, kvn, sn, kvc, sc, pv, SCALE, 1, HD)
    assert out.shape == (2, KV, G, HD) and attention.decode_attention_fused_write_q.launches == 0
    with pytest.raises(ValueError, match="CUDA device"):
        attention._dense_launch(q, kvn, sn, kvc, sc, pv, SCALE, HD, 1)


@pytest.mark.parametrize("name", list(paged_ablation.VARIANTS))
def test_ablation_variants_edit_the_dense_kernel(name):
    """bench/paged_ablation.py's variants edit the body that
    dense_cluster_kernel shares with paged_cluster_kernel (the phase clocks
    every mark, once), and keep the walk kernel's source as it is."""
    src = (_build.CSRC / "attention.cu").read_text()
    text = paged_ablation.VARIANTS[name][0](src)
    body = src[src.index("cluster_attention(const ClusterArgs& a)"):
               src.index("    dense_cluster_kernel(ClusterArgs a)")]
    assert (body in text) == (name == "as built")
    assert text.count("dense_cluster_kernel") == src.count("dense_cluster_kernel")
    assert src[src.index(paged_ablation.WALK_SECTION):] in text
    if name == "phase clocks":
        assert all(text.count(f"g_marks[rank][warp][{m}] = ") == 1
                   for m in range(1, paged_ablation.N_MARKS))
