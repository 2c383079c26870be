"""The int8 forms of the tensor-core GEMV (K18b step_q8_current, K18c
step_q8_bf16mul, K18g call3_q8_current; csrc/probes.cu
`probe_gemv_tc_kernel<W_Q8_*>`) on the CPU. The CUDA kernel runs only on the
card (chip_smoke.py `check_roofline_probes`, `check_gemv_q8_edges`); here its
arithmetic and its order are emulated in numpy and torch:

- the byte-permute conversion of int8 to f32 (q ^ 0x80 under the exponent of
  2^23, minus 2^23 + 128), exact for all 256 values;
- a lane's scale columns (fixed for a unit when NB divides 16 * PARTS, else
  taken a step), equal to k % NB for every column of every K slice;
- both dequantizations of a lane's fragment, bit-equal to bench/roofline.py's
  `deq_q8_current` / `deq_q8_bf16mul` over a sweep of scales with ties;
- the walk (plan_gemv's units, parts j mod PARTS of each 2048-column int8
  stage with their even and odd steps summed apart, the parts' ordered sum,
  the K slices' second pass; test_torch_probes.py's emulation of the bf16
  form) against the JAX script's functions in TPU interpret mode and the
  plain versions;
- the launcher's checks, which raise before the device is touched;
- bench/gemv_ablation.py's q8 variants, which edit the kernel's source.
"""
import numpy as np
import pytest
import torch
from test_torch_probes import (SI, SO, _gemv_tc_walk_plain, _jax, _load_script,  # noqa: F401
                               _torch, stacks)

from llamatpu_torch.bench import gemv_ablation, roofline
from llamatpu_torch.ops import probes

MAGIC = np.float32(2 ** 23 + 128)
Q8_STAGE_K = probes.STAGE_K  # int8 columns of a ring stage
KINDS = {"f32": probes.W_Q8_F32, "bf16": probes.W_Q8_BF16}


def permute_to_f32(words: np.ndarray) -> np.ndarray:
    """uint32 words of 4 int8 weights (the lowest byte first) -> f32 [..., 4]
    as the kernel converts them: byte e of word ^ 0x80808080 (q + 128) is
    permuted under the exponent bits of 2^23 and 2^23 + 128 subtracted."""
    u = words ^ np.uint32(0x80808080)
    return np.stack([(np.uint32(0x4B000000) | ((u >> np.uint32(8 * e)) & np.uint32(0xFF)))
                     .view(np.float32) - MAGIC for e in range(4)], -1)


def bf16_bits(f: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits, rounded to nearest even (finite values)."""
    b = np.ascontiguousarray(f, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) >> np.uint32(16)) \
        .astype(np.uint32)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def dequant_lane(words: np.ndarray, sc: np.ndarray, kind: int) -> np.ndarray:
    """A lane's B fragments: words uint32 [...], their four f32 scales sc
    [..., 4] -> the bf16 weights as f32 [..., 4]. W_Q8_F32: f32 product,
    one rounding to bf16; W_Q8_BF16: bf16(q) (the high half of the permuted
    f32) times the scales rounded to bf16, the exact product rounded once."""
    f = permute_to_f32(words)
    if kind == probes.W_Q8_F32:
        return bf16_value(bf16_bits(f * sc.astype(np.float32)))
    q = f.view(np.uint32) >> np.uint32(16)
    exact = bf16_value(q).astype(np.float64) * bf16_value(bf16_bits(sc)).astype(np.float64)
    return bf16_value(bf16_bits(exact.astype(np.float32)))  # <= 16 bits: exact in f32


def lane_scale_index(k0: int, k1: int, nb: int) -> np.ndarray:
    """The scale column each kernel lane takes for columns k0 .. k1 - 1 of a K
    slice: warp w, lane (g, q) holds columns col + 4q + e of step j = w +
    PARTS * i of each stage; fixed at (k0 + 16 w) % NB + 4q + e for the unit
    when scales_fixed(NB), else (the step's first column) % NB + 4q + e."""
    idx = np.full(k1 - k0, -1)
    fixed = probes.scales_fixed(nb)
    for st in range(k0, k1, Q8_STAGE_K):
        steps = min(Q8_STAGE_K, k1 - st) // 16
        for w in range(probes.PARTS):
            for j in range(w, steps, probes.PARTS):
                base = (k0 + 16 * w) % nb if fixed else (st + 16 * j) % nb
                col = st + 16 * j - k0
                idx[col:col + 16] = base + np.arange(16)  # 4q + e for q, e in 0 .. 3
    return idx


def deq_walk(qs: np.ndarray, ss: np.ndarray, plan, kind: int) -> np.ndarray:
    """The [L, O, I] weights as the kernel's lanes dequantize them, slice by
    slice with the lanes' scale columns."""
    lay, o, i = qs.shape
    wd = np.empty((lay, o, i), dtype=np.float32)
    for ks in range(plan.nks):
        k0, k1 = plan.slice(ks)
        words = np.ascontiguousarray(qs[:, :, k0:k1]).view(np.uint32)
        sc = ss[:, :, lane_scale_index(k0, k1, ss.shape[-1])].reshape(*words.shape, 4)
        wd[:, :, k0:k1] = dequant_lane(words, sc, kind).reshape(lay, o, k1 - k0)
    return wd


def gemv_q8_walk_plain(x, qs, ss, plan, kind) -> torch.Tensor:
    """K18b / K18c / K18g's kernel: the lanes' dequantization, then the
    tensor-core GEMV's summation order over Q8_STAGE_K-column stages."""
    wd = torch.from_numpy(deq_walk(qs, ss, plan, kind))
    return _gemv_tc_walk_plain(torch.from_numpy(np.asarray(x, dtype=np.float32)), wd, plan,
                               stage_k=Q8_STAGE_K)


def test_byte_permute_is_exact_for_every_int8():
    """All 256 int8 values convert to exactly float(q), and the f32's low
    half is zero (so its high half is bf16(q), exactly, for W_Q8_BF16)."""
    q = np.arange(-128, 128, dtype=np.int8)
    f = permute_to_f32(q.view(np.uint32)).reshape(-1)
    np.testing.assert_array_equal(f.view(np.uint32), q.astype(np.float32).view(np.uint32))
    assert not np.any(f.view(np.uint32) & np.uint32(0xFFFF))


@pytest.mark.parametrize("nb,i,plan_of", [(128, 4096, "whole"), (128, 4096, "split"),
                                          (16, 528, "whole"), (256, 4096, "split"),
                                          (528, 528, "whole")])
def test_lane_scale_columns_equal_k_mod_nb(nb, i, plan_of):
    """For every column of every K slice, the scale a lane takes is s[k %
    NB]: with the scales fixed a unit (NB = 128, 16) and taken a step (NB =
    256 = I / 16, 528 = I), whole-K and over ten slices that start off
    multiples of 128."""
    plan = probes.plan_gemv(300 if plan_of == "split" else 4096, i, 1, 132)
    assert (plan.nks > 1) == (plan_of == "split")
    assert probes.scales_fixed(nb) == (nb in (16, 128))
    for ks in range(plan.nks):
        k0, k1 = plan.slice(ks)
        np.testing.assert_array_equal(lane_scale_index(k0, k1, nb), np.arange(k0, k1) % nb)
    if plan_of == "split":
        assert any(plan.slice(ks)[0] % 128 for ks in range(plan.nks))


def _scale_sweep() -> np.ndarray:
    """Scales over 1e-8 .. 1e3 of both signs, and f32 values whose low 16
    bits are 0x8000: a bf16 tie themselves, and their products with q = ±1,
    ±2, ±4, ... too."""
    rng = np.random.default_rng(12)
    mags = np.exp(rng.uniform(np.log(1e-8), np.log(1e3), 96)).astype(np.float32)
    ties = ((rng.integers(0x3000, 0x4300, 64).astype(np.uint32) << np.uint32(16))
            | np.uint32(0x8000)).view(np.float32)
    odd = ((rng.integers(0x3000, 0x4300, 32).astype(np.uint32) << np.uint32(16))
           | rng.integers(0, 0x10000, 32).astype(np.uint32)).view(np.float32)
    return np.concatenate([mags, -mags[:32], ties, -ties[:16], odd])


@pytest.mark.parametrize("kind", list(KINDS))
def test_lane_dequantization_bit_equal_to_roofline(kind):
    """Each lane's dequantization of all 256 int8 values under every scale of
    the sweep is bit-equal to bench/roofline.py's deq_q8_current (f32
    product, rounded to bf16) / deq_q8_bf16mul (bf16 product)."""
    sc = _scale_sweep()
    qs = np.tile(np.arange(-128, 128, dtype=np.int8), (sc.size, 1))
    ss = np.repeat(sc[:, None], 16, axis=1)  # NB = 16: every column the row's scale
    got = dequant_lane(qs.view(np.uint32), np.repeat(sc[:, None, None], 4, axis=2).repeat(
        64, axis=1), KINDS[kind]).reshape(sc.size, 256)
    deq = roofline.deq_q8_current if kind == "f32" else roofline.deq_q8_bf16mul
    want = deq(torch.from_numpy(qs), torch.from_numpy(ss))
    assert want.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16_bits(got).astype(np.uint16),
                                  want.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("plan_of", ["card", "7 sms", "split"])
@pytest.mark.parametrize("name", ["step_q8_current", "step_q8_bf16mul", "call3_q8_current"])
def test_q8_walk_order_matches_roofline_script(stacks, monkeypatch, name, plan_of):  # noqa: F811
    """The int8 GEMV emulated lane by lane (byte-permute conversion, the
    lanes' scale columns, bf16 rounding) in its summation order, under its
    plan on the H100 (132 SMs), on 7 SMs, and with two K slices and their
    second pass, against the script's function in TPU interpret mode at the
    K18 tolerance (rtol 1e-5, atol 1e-5 of the largest output), and against
    the plain version."""
    mod = _load_script("bench_roofline", monkeypatch)
    stacked = name.startswith("call3")
    kind = probes.W_Q8_BF16 if name == "step_q8_bf16mul" else probes.W_Q8_F32
    qs, ss = (stacks["qs"], stacks["ss"]) if stacked else (stacks["qs"][:1], stacks["ss"][:1])
    assert ss.shape[-1] == SI // 32
    plan = (probes.GemvPlan(SO, SI, qs.shape[0], 2, 64) if plan_of == "split" else
            probes.plan_gemv(SO, SI, qs.shape[0], 132 if plan_of == "card" else 7))
    got = gemv_q8_walk_plain(stacks["x"].astype(np.float32), qs, ss, plan, kind)[0].numpy()
    ws = (qs, ss) if stacked else (qs[0], ss[0])
    want = np.asarray(getattr(mod, name)(tuple(_jax(a) for a in ws), _jax(stacks["x"])))
    assert got.shape == want.shape == (8, SO)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    plain = getattr(roofline, name + "_plain")(tuple(_torch(a) for a in ws),
                                               _torch(stacks["x"])).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5 * np.abs(plain).max())


def _operands(t=8, o=64, i=512, nb=16):
    return (torch.zeros((t, i), dtype=torch.bfloat16), torch.zeros((o, i), dtype=torch.int8),
            torch.ones((o, nb), dtype=torch.float32))


@pytest.mark.parametrize("bad,match", [
    ("rows", "T <= 8"),
    ("width", "I % 16"),
    ("nb16", "NB % 16"),
    ("nb_divides", "I % NB"),
    ("scale_shape", r"scales \[L, O, NB\]"),
    ("w_dtype", "int8 w"),
    ("s_dtype", "f32 scales"),
    ("kind", "q8 weight kind"),
    ("align_x", "aligned"),
    ("align_s", "aligned"),
    ("contiguous", "contiguous"),
    ("cpu", "CUDA tensors"),
])
def test_q8_launch_checks_raise_before_launching(bad, match):
    """What the kernel does not take raises ValueError before the plan, the
    device or the library is touched; a CPU tensor raises too (the plain
    versions in bench/roofline.py take the CPU)."""
    x, w, s = _operands()
    kind = probes.W_Q8_F32
    if bad == "rows":
        x, w, s = _operands(t=9)
    elif bad == "width":
        x, w, s = _operands(i=520, nb=8)
    elif bad == "nb16":
        x, w, s = _operands(i=480, nb=24)
    elif bad == "nb_divides":
        x, w, s = _operands(nb=48)
    elif bad == "scale_shape":
        s = torch.ones((65, 16))
    elif bad == "w_dtype":
        w = w.to(torch.bfloat16)
    elif bad == "s_dtype":
        s = s.double()
    elif bad == "kind":
        kind = probes.W_BF16
    elif bad == "align_x":
        x = torch.zeros(8 * 512 + 1, dtype=torch.bfloat16)[1:].view(8, 512)
    elif bad == "align_s":
        s = torch.ones(64 * 16 + 1)[1:].view(64, 16)
    elif bad == "contiguous":
        w = torch.zeros((512, 64), dtype=torch.int8).T
    with pytest.raises(ValueError, match=match):
        probes.gemv(x, w, s, kind)


@pytest.mark.parametrize("name", list(gemv_ablation.Q8_VARIANTS))
def test_q8_ablation_variants_edit_the_kernel_source(name):
    """Each q8 variant of bench/gemv_ablation.py still finds the statements it
    replaces in csrc/probes.cu with its header tc_gemv.cuh written in (the
    card builds and times them)."""
    src = gemv_ablation.source()
    assert '#include "tc_gemv.cuh"' not in src and "void dequant4(" in src
    edit, computes = gemv_ablation.Q8_VARIANTS[name]
    text = edit(src)
    assert text != src
    gone = {"I2F": gemv_ablation.PERMUTE, "integer bf16": gemv_ablation.CVT,
            "no dequantization": gemv_ablation.DEQUANT, "no products": gemv_ablation.MMA}
    for key, stmt in gone.items():
        assert (stmt in src) and ((stmt in text) == (key not in name))
    if "first design" in name:
        assert "lt_probe_gemv_first" in text and text.startswith(src)
    if "4096-column" in name:
        assert "int K = kStageK * 2 / esize;" in text and "int depth = kDepth;" in text
    assert computes == all(k not in name for k in ("no dequantization", "no products"))
