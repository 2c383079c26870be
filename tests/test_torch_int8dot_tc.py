"""The int8 kind (W_S8) of the tensor-core GEMV on the CPU: K18d
step_q8_int8dot, K18h call3_q8_int8dot and K18e step_q8_int8dot_blockscale
(csrc/probes.cu `probe_gemv_tc_kernel<W_S8>`, `probe_s8_sum_kernel`). The
CUDA kernel runs only on the card (chip_smoke.py `check_roofline_probes`,
`check_int8dot_edges`); here its arithmetic and its order are emulated in
numpy and torch:

- a lane's permuted m16n8k32 fragments (8 adjacent bytes of x and of a
  weight row, even and odd steps in A rows 0-7 and 8-15) through the PTX
  fragment layout, against the plain dot;
- the walk (plan_gemv's units, 32-column steps j mod PARTS of each
  2048-column stage, even and odd sums, a last half step of zero x over
  stale weight bytes, int32 parts and K-slice partial sums added by the
  second pass) against the JAX script's functions in TPU interpret mode and
  the plain versions, bit for bit;
- why the workspace is int32: K-slice partial sums above 2^24 that f32
  partials would round;
- K18e's corrections in the kernel's order (a lane's block scales by FMA,
  then a butterfly over the lanes), the same under either plan;
- the launcher's checks, which raise before the device is touched;
- bench/gemv_ablation.py's s8 variants, which edit the kernel's source.
"""
import re

import numpy as np
import pytest
import torch
from test_torch_probes import SI, SL, SO, _jax, _load_script, _torch, stacks  # noqa: F401

from llamatpu_torch import _build
from llamatpu_torch.bench import gemv_ablation, roofline
from llamatpu_torch.ops import probes

STEP = 32  # columns of a W_S8 mma step
F32_EXACT = 2 ** 24


@pytest.fixture(scope="module")
def script_out(stacks):  # noqa: F811
    """The script's K18d / K18h / K18e on the shrunk stacks in TPU interpret
    mode, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mod = _load_script("bench_roofline", mp)
        x, qs, ss = _jax(stacks["x"]), stacks["qs"], stacks["ss"]
        return {"step_q8_int8dot": np.asarray(mod.step_q8_int8dot((_jax(qs[0]), _jax(ss[0])), x)),
                "call3_q8_int8dot": np.asarray(mod.call3_q8_int8dot((_jax(qs), _jax(ss)), x)),
                "step_q8_int8dot_blockscale": np.asarray(
                    mod.step_q8_int8dot_blockscale((_jax(qs[0]), _jax(ss[0])), x))}


def _plan(plan_of: str, o: int, i: int, layers: int):
    if plan_of.startswith("split"):
        nks = int(plan_of[5:] or 2)
        return probes.GemvPlan(o, i, layers, nks, 64 - 64 % nks)
    return probes.plan_gemv(o, i, layers, 132 if plan_of == "card" else 7)


# ------------------------------------------------------------- fragments
def _words(m: np.ndarray) -> np.ndarray:
    """int8 [rows, 4n] -> uint32 [rows, n], word j = bytes 4j .. 4j + 3 (the lowest first)."""
    return np.ascontiguousarray(m, dtype=np.int8).view(np.uint32)


def lane_fragments(x_even, x_odd, w_step):
    """A pair of steps' fragments as lane (g, q) loads them: x_even, x_odd
    int8 [8, 32] (x rows of an even and an odd step), w_step int8 [8, 32]
    (the stripe's rows of one step). a [32, 4] uint32: x_even[g, 8q .. 8q +
    3], x_odd[g, 8q ..], x_even[g, 8q + 4 .. 8q + 7], x_odd[g, 8q + 4 ..];
    b [32, 2]: w_step[g, 8q .. 8q + 3], w_step[g, 8q + 4 .. 8q + 7]."""
    xe, xo, w = _words(x_even), _words(x_odd), _words(w_step)
    a = np.empty((32, 4), np.uint32)
    b = np.empty((32, 2), np.uint32)
    for lane in range(32):
        g, q = divmod(lane, 4)
        a[lane] = xe[g, 2 * q], xo[g, 2 * q], xe[g, 2 * q + 1], xo[g, 2 * q + 1]
        b[lane] = w[g, 2 * q], w[g, 2 * q + 1]
    return a, b


def mma_m16n8k32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on the lanes'
    fragments, by the PTX ISA's layout: lane (g, q)'s a0 / a1 / a2 / a3 are
    A[g, 4q ..], A[g + 8, 4q ..], A[g, 16 + 4q ..], A[g + 8, 16 + 4q ..]
    (4 bytes each), b0 / b1 are B[4q .., g], B[16 + 4q .., g]; C = A . B in
    int32, returned as the lanes' c0, c1 (C[g, 2q], C[g, 2q + 1]) and c2, c3
    (C[g + 8, 2q], C[g + 8, 2q + 1])."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, q = divmod(lane, 4)
        for r, (row, k) in enumerate([(g, 4 * q), (g + 8, 4 * q), (g, 16 + 4 * q),
                                      (g + 8, 16 + 4 * q)]):
            A[row, k:k + 4] = a[lane, r:r + 1].view(np.int8)
        for r, k in enumerate([4 * q, 16 + 4 * q]):
            B[k:k + 4, g] = b[lane, r:r + 1].view(np.int8)
    C = A @ B
    assert np.abs(C).max() < 2 ** 31
    return np.array([[C[g, 2 * q], C[g, 2 * q + 1], C[g + 8, 2 * q], C[g + 8, 2 * q + 1]]
                     for g, q in (divmod(lane, 4) for lane in range(32))], dtype=np.int32)


def _fragment_data(kind: str, rng):
    """x int8 [8, 64] and w int8 [8, 64] (two 32-column steps)."""
    if kind == "random":
        return (rng.integers(-127, 128, (8, 64)).astype(np.int8),
                rng.integers(-128, 128, (8, 64)).astype(np.int8))
    sign = rng.choice(np.array([-1, 1], np.int8), (8, 64))
    if kind == "+-127":
        return (127 * sign).astype(np.int8), (127 * rng.choice([-1, 1], (8, 64))).astype(np.int8)
    return (127 * sign).astype(np.int8), np.full((8, 64), -128, np.int8)  # "-128"


@pytest.mark.parametrize("kind", ["random", "+-127", "-128"])
def test_permuted_fragments_give_the_plain_dot(kind):
    """Over all 32 lanes: the even step's mma (x_even in A rows 0-7, x_odd in
    8-15, the even step's weights as B) leaves x_even . w_even^T in c0, c1;
    the odd step's leaves x_odd . w_odd^T in c2, c3; a warp's part (c0 +
    c2, c1 + c3 of the two accumulators) is the int32 dot over both steps'
    64 columns for t = g, stripe rows 2q and 2q + 1: the permutation of each
    step's contraction index cancels."""
    x, w = _fragment_data(kind, np.random.default_rng(3))
    a, b_even = lane_fragments(x[:, :STEP], x[:, STEP:], w[:, :STEP])
    _, b_odd = lane_fragments(x[:, :STEP], x[:, STEP:], w[:, STEP:])
    c_even, c_odd = mma_m16n8k32(a, b_even), mma_m16n8k32(a, b_odd)
    want = x.astype(np.int64) @ w.astype(np.int64).T                     # [t, row]
    even = x[:, :STEP].astype(np.int64) @ w[:, :STEP].astype(np.int64).T
    for lane in range(32):
        g, q = divmod(lane, 4)
        np.testing.assert_array_equal(c_even[lane, :2], even[g, 2 * q:2 * q + 2])
        np.testing.assert_array_equal(c_even[lane, :2] + c_odd[lane, 2:], want[g, 2 * q:2 * q + 2])


# ------------------------------------------------------------------ walk
def int8dot_walk(xq, w, plan, rng=None, partials=None) -> torch.Tensor:
    """K18d / K18h's kernel in its order, in int32: each unit (layer, rows,
    K slice) of each CTA sums PARTS column parts, part p the 32-column steps
    j = p + PARTS i of each STAGE_K-column stage into an even and an odd sum;
    a slice of an odd count of 16-column halves ends in half a step whose
    second half has zero x over stale weight bytes (random here); the parts
    are added in order into the int32 workspace [nks, L, T, O], whose slices
    the second pass adds in int32 before the one conversion to f32.
    `partials`, a dict, receives the workspace."""
    xi, wi = torch.as_tensor(xq).to(torch.int32), torch.as_tensor(w).to(torch.int32)
    lay, o, _ = wi.shape
    t = xi.shape[0]
    rng = rng or np.random.default_rng(0)
    part = torch.zeros((plan.nks, lay, t, o), dtype=torch.int32)
    starts = [plan.slice(k)[0] for k in range(plan.nks)]
    for c in range(plan.ctas):
        for layer, r0, r1, k0, k1 in plan.units(c):
            sums = [[torch.zeros((t, r1 - r0), dtype=torch.int32) for _ in range(2)]
                    for _ in range(probes.PARTS)]
            for k in range(k0, k1, probes.STAGE_K):
                kc = min(probes.STAGE_K, k1 - k)
                for j in range(-(-kc // STEP)):
                    lo, hi = k + STEP * j, min(k + STEP * j + STEP, k + kc)
                    xs = torch.zeros((t, STEP), dtype=torch.int32)
                    ws = torch.as_tensor(rng.integers(-128, 128, (r1 - r0, STEP)),
                                         dtype=torch.int32)  # stale bytes past the slice
                    xs[:, :hi - lo] = xi[:, lo:hi]
                    ws[:, :hi - lo] = wi[layer, r0:r1, lo:hi]
                    p, i = j % probes.PARTS, j // probes.PARTS
                    sums[p][i % 2] = sums[p][i % 2] + xs @ ws.T
            acc = sums[0][0] + sums[0][1]
            for even, odd in sums[1:]:
                acc = acc + (even + odd)
            part[starts.index(k0), layer, :, r0:r1] = acc
    if partials is not None:
        partials["part"] = part
    return part.sum(0, dtype=torch.int32).float()


@pytest.mark.parametrize("plan_of", ["card", "7 sms", "split"])
@pytest.mark.parametrize("name", ["step_q8_int8dot", "call3_q8_int8dot"])
def test_walk_bit_equal_to_roofline_script(stacks, script_out, name, plan_of):  # noqa: F811
    """The W_S8 walk emulated in int32 under its plan on the H100 (132 SMs),
    on 7 SMs, and with two K slices and their second pass, bit-equal to the
    script's int32 dot in TPU interpret mode and to the plain version."""
    stacked = name.startswith("call3")
    qs = stacks["qs"] if stacked else stacks["qs"][:1]
    xq = roofline.quantize_x(_torch(stacks["x"]))
    plan = _plan(plan_of, SO, SI, qs.shape[0])
    assert (plan.nks > 1) == (plan_of == "split")
    got = int8dot_walk(xq, qs, plan)[0].numpy()
    np.testing.assert_array_equal(got, script_out[name])
    ws = (_torch(qs if stacked else qs[0]), _torch(stacks["ss"][0]))
    plain = getattr(roofline, name + "_plain")(ws, _torch(stacks["x"])).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("plan_of", ["card", "split3"])
def test_walk_with_half_steps_exact(plan_of):
    """I = 16 x 33, split into three slices of 11 16-column halves (or
    whole): every slice ends in half a step (stale weight bytes times zero
    x), over a ragged O = 300 at T = 5: exact, against the plain dot."""
    rng = np.random.default_rng(7)
    xq = rng.integers(-127, 128, (5, 528)).astype(np.int8)
    w = rng.integers(-128, 128, (2, 300, 528)).astype(np.int8)
    plan = _plan(plan_of, 300, 528, 2)
    assert all((k1 - k0) % 32 == 16 for k0, k1 in map(plan.slice, range(plan.nks)))
    got = int8dot_walk(xq, w, plan, rng)
    want = roofline._int_dot(torch.from_numpy(xq), torch.from_numpy(w))
    assert torch.equal(got, want)


def _slice_with_sum(target: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """x and w of n columns, x = 127 but for its last column (1), with
    sum(x * w) == target: the other weights share target // 127, the last
    takes the remainder."""
    share, rest = divmod(target, 127)
    q, r = divmod(share, n - 1)
    w = np.array([q + 1] * r + [q] * (n - 1 - r) + [rest], dtype=np.int64)
    assert w.min() >= -128 and w.max() <= 127
    x = np.full(n, 127, np.int64)
    x[-1] = 1
    return x, w


def test_int32_workspace_exact_where_f32_partials_round():
    """Two K slices whose partial sums are 2^24 + 1 and 2^24 + 5 (stripe row
    0) and the extremes I x 127 x 127 and -I x 127 x 128 (rows 1, 2): the
    walk's int32 workspace and second pass give the exact sums, each rounded
    once to f32 (2^25 + 6 -> 2^25 + 8); f32 partial sums would round each
    slice first (2^24 and 2^24 + 4) and give 2^25 + 4."""
    i = 4096
    plan = probes.GemvPlan(8, i, 1, 2, 2)
    assert [plan.slice(k) for k in range(2)] == [(0, 2048), (2048, 4096)]
    x0, w0a = _slice_with_sum(F32_EXACT + 1, 2048)
    x1, w0b = _slice_with_sum(F32_EXACT + 5, 2048)
    xq = np.concatenate([x0, x1])[None].astype(np.int8)
    w = np.zeros((1, 8, i), np.int8)
    w[0, 0] = np.concatenate([w0a, w0b])
    w[0, 1], w[0, 2] = 127, -128
    w[0, 3:] = np.random.default_rng(1).integers(-128, 128, (5, i))
    parts = {}
    got = int8dot_walk(xq, w, plan, partials=parts)
    want = roofline._int_dot(torch.from_numpy(xq), torch.from_numpy(w))
    assert torch.equal(got, want)
    assert parts["part"][:, 0, 0, 0].tolist() == [F32_EXACT + 1, F32_EXACT + 5]
    assert got[0, 0, 0].item() == 2 ** 25 + 8
    assert got[0, 0, 1:3].tolist() == [127 * (127 * (i - 2) + 2), -128 * (127 * (i - 2) + 2)]
    assert all(abs(v) > F32_EXACT for v in got[0, 0, :3].tolist())
    f32_parts = parts["part"].float()  # f32 partials: each slice rounded, then an f32 sum
    assert (f32_parts[0] + f32_parts[1])[0, 0, 0].item() == 2 ** 25 + 4 != got[0, 0, 0].item()


# ----------------------------------------------------------- block scales
def block_corr(s: np.ndarray, xsc: np.ndarray, n_regs: int = 4) -> np.ndarray:
    """corr [..., O, T] as the kernel forms it for each weight row (the
    whole-K kernel's warp w for stripe row w, or the split's second pass):
    lane l sums s[b] * xsc[t, b] over b = l + 32 m in order of m, one FMA
    each (emulated in f64, rounded to f32: a true FMA rounds once, so this
    may differ by an ulp), then a butterfly over the lanes (offsets 16, 8,
    4, 2, 1, f32 adds; the kernel's 9-shuffle form adds in the same tree,
    see the test below). n_regs (the block scales a lane holds) does not
    change the order."""
    *lead, nb = s.shape
    t = xsc.shape[0]
    lanes = np.zeros((*lead, 32, t), np.float32)
    for b in range(nb):
        prod = s[..., b, None].astype(np.float64) * xsc[:, b].astype(np.float64)
        lanes[..., b % 32, :] = (prod + lanes[..., b % 32, :]).astype(np.float32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ off, :]
    assert (lanes == lanes[..., :1, :]).all()  # every lane the same bits
    return lanes[..., 0, :]


def transposing_butterfly(lanes: np.ndarray) -> np.ndarray:
    """block_corr's reduction of f32 lanes [32, 8] (lane, t), shuffle by
    shuffle: at offsets 16, 8 and 4 a lane keeps the half of its sums whose
    t bit (2, 1, 0) equals its lane bit (4, 3, 2) and adds its partner's
    copy of them; then offsets 2 and 1. Returns what each lane holds [32]
    (t = lane / 4)."""
    v = [list(lanes[l]) for l in range(32)]
    for off, bit in ((16, 4), (8, 2), (4, 1)):
        half = len(v[0]) // 2
        v = [[np.float32(v[l][i + half * h] + v[l ^ off][i + half * h]) for i in range(half)]
             for l in range(32) for h in [(l & off) > 0]]
    z = np.array([v[l][0] for l in range(32)], np.float32)
    for off in (2, 1):
        z = z + z[np.arange(32) ^ off]
    return z


def test_transposing_butterfly_adds_in_the_butterflys_tree():
    """block_corr's 9-shuffle reduction gives lane (g, q) the bits of the
    plain 40-shuffle butterfly's sum of t = g (the emulation above)."""
    rng = np.random.default_rng(5)
    lanes = (rng.standard_normal((32, 8)) * np.exp(rng.uniform(-8, 8, (32, 8)))).astype(np.float32)
    plain = lanes.copy()
    for off in (16, 8, 4, 2, 1):
        plain = plain + plain[np.arange(32) ^ off]
    got = transposing_butterfly(lanes)
    np.testing.assert_array_equal(got.view(np.uint32), plain[np.arange(32), np.arange(32) // 4]
                                  .view(np.uint32))
    assert not np.array_equal(plain[0], np.float32(lanes.sum(0)))  # the order shows


@pytest.mark.parametrize("plan_of", ["card", "split"])
@pytest.mark.parametrize("source", ["script", "plain NB = 200"])
def test_block_scale_corrections(stacks, script_out, plan_of, source):  # noqa: F811
    """K18e: f32(the walk's int32 dot) times the tree-ordered corrections,
    within rel 1e-5 of max|want| of the script's step_q8_int8dot_blockscale
    (NB = I / 32 = 16, xs = ones) or, at NB = 200 (past a lane's four
    registers) with signed xsc, of the plain product; the same bits under
    either plan (the split's second pass forms the corrections alike)."""
    rng = np.random.default_rng(11)
    if source == "script":
        qs, ss = stacks["qs"][:1], stacks["ss"][:1]
        xq = roofline.quantize_x(_torch(stacks["x"])).numpy()
        xsc = np.ones((8, ss.shape[-1]), np.float32)
        want = script_out["step_q8_int8dot_blockscale"]
    else:
        qs = rng.integers(-128, 128, (1, 96, SI)).astype(np.int8)
        ss = (np.abs(rng.standard_normal((1, 96, 200))) * 0.01).astype(np.float32)
        xq = rng.integers(-127, 128, (5, SI)).astype(np.int8)
        xsc = rng.standard_normal((5, 200)).astype(np.float32)
        want = (roofline._int_dot(torch.from_numpy(xq), torch.from_numpy(qs))
                * (torch.from_numpy(ss) @ torch.from_numpy(xsc).T).transpose(-1, -2))[0].numpy()
    corr = block_corr(ss, xsc)                                      # [L, O, T]
    ys = [(int8dot_walk(xq, qs, _plan(p, qs.shape[1], SI, 1)) * torch.from_numpy(corr)
           .transpose(-1, -2))[0].numpy() for p in (plan_of, "card")]
    np.testing.assert_array_equal(ys[0], ys[1])
    assert np.abs(ys[0] - want).max() <= 1e-5 * np.abs(want).max()


# ------------------------------------------------------- launcher checks
def _operands(t=8, o=64, i=512, nb=16):
    return (torch.zeros((t, i), dtype=torch.int8), torch.zeros((o, i), dtype=torch.int8),
            torch.ones((o, nb)), torch.ones((t, nb)))


@pytest.mark.parametrize("bad,match", [
    ("rows", "T <= 8"),
    ("width", "I % 16"),
    ("xq_dtype", "int8 xq and w"),
    ("w_dtype", "int8 xq and w"),
    ("s_dtype", "f32 scales"),
    ("xsc_dtype", "f32 scales"),
    ("scale_shape", r"scales \[L, O, NB\]"),
    ("xsc_shape", r"xsc \[T, NB\]"),
    ("s_alone", "both or neither"),
    ("align", "aligned"),
    ("contiguous", "contiguous"),
    ("cpu", "CUDA tensors"),
    ("devices", "one device"),
])
def test_launch_checks_raise_before_launching(bad, match, monkeypatch):
    """What the kernel does not take raises ValueError before the plan, the
    device or the library is touched (each is made to fail if it were)."""
    for name in ("plan_gemv", "_sm_count"):
        monkeypatch.setattr(probes, name, lambda *a, **k: pytest.fail("reached the device"))
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail("reached the library"))
    xq, w, s, xsc = _operands()
    if bad == "rows":
        xq, w, s, xsc = _operands(t=9)
    elif bad == "width":
        xq, w, s, xsc = _operands(i=520)
    elif bad == "xq_dtype":
        xq = xq.to(torch.bfloat16)
    elif bad == "w_dtype":
        w = w.to(torch.bfloat16)
    elif bad == "s_dtype":
        s = s.double()
    elif bad == "xsc_dtype":
        xsc = xsc.to(torch.bfloat16)
    elif bad == "scale_shape":
        s = torch.ones((65, 16))
    elif bad == "xsc_shape":
        xsc = torch.ones((8, 17))
    elif bad == "s_alone":
        xsc = None
    elif bad == "align":
        xq = torch.zeros(8 * 512 + 1, dtype=torch.int8)[1:].view(8, 512)
    elif bad == "contiguous":
        w = torch.zeros((512, 64), dtype=torch.int8).T
    elif bad == "devices":
        w = torch.zeros((64, 512), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match=match):
        probes.int8dot(xq, w, s, xsc)
    if bad in ("rows", "width", "align", "contiguous", "cpu", "devices", "xq_dtype"):
        with pytest.raises(ValueError, match=match):
            probes.int8dot(xq, w)


def test_kind_code_mirrors_the_kernel():
    """ops/probes.py's kind codes are tc_gemv.cuh's WKind, and the ctypes
    signature of lt_probe_int8dot has the plan and the workspace."""
    src = (_build.CSRC / "tc_gemv.cuh").read_text()
    codes = dict(re.findall(r"(W_\w+) = (\d)", src.split("enum WKind")[1].split(";")[0]))
    assert {k: int(v) for k, v in codes.items()} == {
        "W_BF16": probes.W_BF16, "W_Q8_F32": probes.W_Q8_F32, "W_Q8_BF16": probes.W_Q8_BF16,
        "W_S8": probes.W_S8}
    decl = (_build.CSRC / "probes.cu").read_text().split("LT_EXPORT int lt_probe_int8dot(")[1]
    params = decl.split(")")[0].split(",")
    assert len(params) == len(_build._SIGNATURES["probes"]["lt_probe_int8dot"])
    assert "probe_int8dot_kernel" not in (_build.CSRC / "probes.cu").read_text()


@pytest.mark.parametrize("name", list(gemv_ablation.S8_VARIANTS))
def test_s8_ablation_variants_edit_the_kernel_source(name):
    """Each s8 variant of bench/gemv_ablation.py still finds the statements it
    replaces in csrc/probes.cu with tc_gemv.cuh written in (the card builds
    and times them); the plan variants keep the source."""
    src = gemv_ablation.source()
    edit, computes, split = gemv_ablation.S8_VARIANTS[name]
    text = edit(src)
    assert gemv_ablation.MMA_S8 in src and gemv_ablation.CORR in src
    assert (text == src) == (name == "s8: as built" or split)
    assert split == ("plan" in name)
    assert (gemv_ablation.MMA_S8 in text) == ("no products" not in name)
    assert (gemv_ablation.READ_SCALES in text) == ("no lookahead" not in name)
    assert (gemv_ablation.CORR in text) == ("no corrections" not in name)
    if "first design" in name:
        assert text.startswith(src) and "lt_probe_int8dot_first" in text
    if name.endswith("ahead"):
        assert re.findall(r"kScaleAhead = (\d)", text) != re.findall(r"kScaleAhead = (\d)", src)
    assert computes == all(k not in name for k in ("no products", "no block-scale", "no corr"))
