"""The bf16 tensor-core GEMV of K18a / K18i on the CPU (the CUDA kernel itself
runs only on the card, in chip_smoke.py):

- `plan_gemv`, the walk of its persistent CTAs over (layer, 8-row stripe, K
  slice) units: every weight (layer, row, 16-column step) walked exactly
  once, one K slice a CTA, no CTA's bytes over the mean by more than a unit, at
  SM counts from 1 to the H100's 132; whole-K stripes at the probe shapes.
- The wrapper's checks, which raise before the device or the library is
  touched (so here, without a card, too).
- bench/gemv_ablation.py's variants, which edit the kernel's source.

The walk's summation order against the JAX script is in test_torch_probes.py.
"""
import numpy as np
import pytest
import torch

from llamatpu_torch.bench import gemv_ablation
from llamatpu_torch.ops import probes

H100_SMS = 132
# (L, O, I): the probe scripts' layer and stack, and a ragged O, I
SHAPES = [(1, 4096, 4096), (24, 4096, 4096), (1, 300, 528), (2, 300, 528)]


def _check_plan(plan, sm_count):
    assert plan.ctas % plan.nks == 0 and plan.nks <= plan.ctas <= max(sm_count, plan.nks)
    n16 = plan.i // 16
    seen = np.zeros((plan.layers, plan.o, n16), dtype=np.int16)
    per_cta, unit_bytes = [], []
    for c in range(plan.ctas):
        units = plan.units(c)
        assert units, f"CTA {c} has no unit"
        assert len({(k0, k1) for *_, k0, k1 in units}) == 1, "a CTA stages one K slice"
        n = 0
        for layer, r0, r1, k0, k1 in units:
            assert 0 <= r0 < r1 <= min(plan.o, r0 + probes.STRIPE) and r0 % probes.STRIPE == 0
            assert k0 % 16 == 0 and k1 % 16 == 0 and 0 < k1 - k0 <= probes.MAX_SLICE
            seen[layer, r0:r1, k0 // 16:k1 // 16] += 1
            unit_bytes.append(2 * (r1 - r0) * (k1 - k0))
            n += unit_bytes[-1]
        per_cta.append(n)
    assert seen.min() == seen.max() == 1, "a weight walked twice or never"
    # the call lasts as long as its busiest CTA: none more than a unit over the mean
    assert max(per_cta) - sum(per_cta) / len(per_cta) <= max(unit_bytes)
    return per_cta


@pytest.mark.parametrize("sm_count", [1, 3, 7, 40, H100_SMS])
@pytest.mark.parametrize("layers,o,i", SHAPES)
def test_plan_covers_each_weight_once_balanced(layers, o, i, sm_count):
    _check_plan(probes.plan_gemv(o, i, layers, sm_count), sm_count)


@pytest.mark.parametrize("sm_count", [3, H100_SMS])
def test_plan_slices_rows_wider_than_a_cta_stages(sm_count):
    """I = 9232 > MAX_SLICE: at least three K slices, each staged whole."""
    plan = probes.plan_gemv(1000, 9232, 1, sm_count)
    assert plan.nks >= 3
    _check_plan(plan, sm_count)


def test_plan_at_the_probe_shapes():
    """Whole-K stripes on the probe scripts' shapes (no partial sums), one
    CTA per SM: the 512 stripes of a [4096, 4096] layer in 4 rounds, the
    12288 of the [24, 4096, 4096] stack in 94 (>= 90 % busy); the ragged
    2-layer O = 300, I = 528 keeps its 76 stripes whole too (two K slices of
    256 and 272 columns would not fill the SMs better)."""
    layer = probes.plan_gemv(4096, 4096, 1, H100_SMS)
    assert (layer.nks, layer.ctas, layer.n_units) == (1, H100_SMS, 512)
    assert max(len(layer.units(c)) for c in range(layer.ctas)) == 4
    stack = probes.plan_gemv(4096, 4096, 24, H100_SMS)
    assert (stack.nks, stack.ctas, stack.n_units) == (1, H100_SMS, 12288)
    assert max(len(stack.units(c)) for c in range(stack.ctas)) == 94
    ragged = probes.plan_gemv(300, 528, 2, H100_SMS)
    assert (ragged.nks, ragged.ctas) == (1, 76)
    assert ragged.units(75) == [(1, 296, 300, 0, 528)]


def _operands(t=8, o=64, i=512):
    return (torch.zeros((t, i), dtype=torch.bfloat16), torch.zeros((o, i), dtype=torch.bfloat16))


@pytest.mark.parametrize("bad,match", [
    ("rows", "T <= 8"),
    ("width", "I % 16"),
    ("dtype", "bf16 x and w"),
    ("align", "aligned"),
    ("contiguous", "contiguous"),
    ("cpu", "CUDA tensors"),
])
def test_launch_checks_raise_before_launching(bad, match):
    """What the kernel does not take raises ValueError before the plan, the
    device or the library is touched; a CPU tensor raises too (the plain
    versions in bench/roofline.py take the CPU)."""
    x, w = _operands()
    if bad == "rows":
        x, w = _operands(t=9)
    elif bad == "width":
        x, w = _operands(i=520)
    elif bad == "dtype":
        w = w.float()
    elif bad == "align":
        buf = torch.zeros(8 * 512 + 1, dtype=torch.bfloat16)
        x = buf[1:].view(8, 512)
    elif bad == "contiguous":
        w = torch.zeros((512, 64), dtype=torch.bfloat16).T
    with pytest.raises(ValueError, match=match):
        probes.gemv_bf16(x, w)


@pytest.mark.parametrize("name", list(gemv_ablation.VARIANTS))
def test_ablation_variants_edit_the_kernel_source(name):
    """Each variant of bench/gemv_ablation.py still finds the statements it
    replaces in csrc/probes.cu (the card builds and times them)."""
    src = (probes._build.CSRC / "probes.cu").read_text()
    edit, computes = gemv_ablation.VARIANTS[name]
    text = edit(src)
    assert (text == src) == (name == "as built")
    if name.startswith("x copy after"):
        assert text.count("send_x();") == 2 and "auto send_x = [&]()" in text
    if not computes:
        assert gemv_ablation.X_COPY not in text and gemv_ablation.X_FRAG not in text
