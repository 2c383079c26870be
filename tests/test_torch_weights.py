"""The port's load path (llamatpu_torch.models) against the JAX package's:
synthetic models, the q8_row load transforms and the weights bridge must give
the same arrays BIT FOR BIT from the same preset and seed."""
import jax
import numpy as np
import pytest
import torch

from llamatpu.models import synthetic as jsyn
from llamatpu.models import weights as jw
from llamatpu_torch.models import synthetic as tsyn
from llamatpu_torch.models import weights as tw

# dims multiples of 128 so the JAX package's row padding leaves q/k/v and
# gate/up fusable; vocab 300 pads to 384 there (logical_out = 300)
TINY = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab_size=300)


def _build(mod, dtype="f32", seed=3):
    return mod.build_synthetic_model("llama32-1b", n_layers=2, dtype=dtype, seed=seed,
                                     context_length=256, overrides=TINY)


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    t = np.asarray(t)
    return t.view(np.int16) if t.dtype.name == "bfloat16" else t


def _assert_tree_equal(port: dict, ref: dict, path=""):
    """port: the port's tree; ref: the bridged JAX tree (also port QTensors)."""
    assert port.keys() == ref.keys(), path
    for k in port:
        a, b = port[k], ref[k]
        if isinstance(a, dict):
            _assert_tree_equal(a, b, f"{path}/{k}")
        elif isinstance(a, tw.QTensor):
            assert (a.kind, a.layout) == (b.kind, b.layout), f"{path}/{k}"
            n = a.qs.shape[-2]
            # the JAX head is row-padded; its real rows are the port's rows
            assert b.logical_out in (0, n) and a.logical_out == 0, f"{path}/{k}"
            np.testing.assert_array_equal(_np(a.qs), _np(b.qs)[..., :n, :], f"{path}/{k}.qs")
            np.testing.assert_array_equal(_np(a.scales), _np(b.scales)[..., :n, :],
                                          f"{path}/{k}.scales")
            assert not _np(b.qs)[..., n:, :].any(), f"{path}/{k} pad rows"
        else:
            np.testing.assert_array_equal(_np(a), _np(b), f"{path}/{k}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_synthetic_model_bit_exact(dtype):
    port, ref = _build(tsyn, dtype), _build(jsyn, dtype)
    assert port.cfg.__dict__ == {**ref.cfg.__dict__, "family": port.cfg.family}
    assert port.cfg.family.value == ref.cfg.family.value
    _assert_tree_equal(port.weights, tw.from_numpy_weights(ref.weights))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_serving_weights_rowq_bit_exact(dtype):
    """Fuse + equalize + requant: the port's q8_row weights equal llamatpu's
    serving_weights(..., rowq=True) after jax.device_get, through the bridge."""
    port, ref = _build(tsyn, dtype), _build(jsyn, dtype)
    got = tw.serving_weights(port.cfg, port.weights, rowq=True, device="cpu")
    want = tw.from_numpy_weights(
        jax.device_get(jw.serving_weights(ref.cfg, ref.weights, rowq=True)))
    assert got["layers"]["wqkv"].kind == "q8_row" and "wq" not in got["layers"]
    assert want["wcls"].logical_out == TINY["vocab_size"]
    _assert_tree_equal(got, want)


def test_bridge_raw_dict_then_port_transforms():
    """The raw (interleaved, row-padded) JAX synthetic dict, bridged, then
    served by the port, equals the port's own serving of its own synthetic
    model — so both packages compute the same function."""
    port, ref = _build(tsyn), _build(jsyn)
    assert ref.weights["layers"]["wq"].layout == "interleaved"
    bridged = tw.from_numpy_weights(ref.weights)
    assert bridged["layers"]["wq"].layout == "canonical"
    got = tw.serving_weights(port.cfg, bridged, rowq=True, device="cpu")
    want = tw.serving_weights(port.cfg, port.weights, rowq=True, device="cpu")
    _assert_tree_equal(want, got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rowq_convert_without_equalization_bit_exact(monkeypatch, dtype):
    """LLAMATPU_NO_ROWQ_EQ=1 on both sides: rowq_convert_weights skips the
    equalization (plain per-row requant, norms unscaled) and the port's
    converted tensors equal the JAX package's bit for bit."""
    monkeypatch.setenv("LLAMATPU_NO_ROWQ_EQ", "1")
    port, ref = _build(tsyn, dtype), _build(jsyn, dtype)
    got = tw.rowq_convert_weights(tw.fuse_layer_weights(port.cfg, port.weights))
    want = tw.from_numpy_weights(jax.device_get(
        jw.rowq_convert_weights(jw.fuse_layer_weights(ref.cfg, ref.weights))))
    np.testing.assert_array_equal(_np(got["layers"]["ffn_norm"]),
                                  _np(port.weights["layers"]["ffn_norm"]))
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("layout", ["canonical", "interleaved"])
def test_rowq_requant_bit_exact(layout):
    rng = np.random.default_rng(11)
    qs = rng.integers(-127, 128, size=(3, 64, 128), dtype=np.int8)
    qs[1, 5] = 0  # a zero row gives (0, 0)
    scales = rng.random((3, 64, 4), dtype=np.float32) * 0.01
    if layout == "interleaved":
        qs = jw.interleave_columns(qs)
    got = tw.rowq_requant(tw.QTensor(qs, scales, "q8_0", layout=layout))
    want = jw.rowq_requant(jw.QTensor(qs, scales, "q8_0", layout=layout))
    np.testing.assert_array_equal(got.qs, np.asarray(want.qs))
    np.testing.assert_array_equal(got.scales, np.asarray(want.scales))
    assert got.kind == want.kind == "q8_row" and not got.scales[1, 5].any()


def test_fused_and_unfused_equalization_bit_exact():
    """equalize_rowq_layers on the unfused layer dict (the parity harness's
    input) as well as the fused one."""
    port = _build(tsyn)
    layers = port.weights["layers"]
    got = tw.equalize_rowq_layers(layers)
    want = jw.equalize_rowq_layers(
        {k: (jw.QTensor(v.qs, v.scales, v.kind) if isinstance(v, tw.QTensor) else v)
         for k, v in layers.items()})
    for k in ("wq", "wk", "wv", "w1", "w3", "w2"):
        np.testing.assert_array_equal(got[k].qs, np.asarray(want[k].qs), k)
        np.testing.assert_array_equal(got[k].scales, np.asarray(want[k].scales), k)
    for k in ("attn_norm", "ffn_norm"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    assert got["wo"] is layers["wo"]  # wo keeps plain rowq (converted later)
