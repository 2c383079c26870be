"""The port's native GGUF codecs (gguf/native.py, csrc/quantops.cpp built
with this machine's C++ compiler) against the port's numpy codecs, bit for
bit: dequantization of Q8_0 / Q4_0 / Q4_K / Q5_K / Q6_K blocks, the ggml
Q8_0 encode and the depacking, with finite f16 scales as
tests/test_native_quants.py sets them; the quants.dequantize and
requantize_to_q8_0 dispatch; LLAMATPU_NO_NATIVE=1 selecting numpy; and a
missing compiler or a failed build raising."""
import numpy as np
import pytest

from llamatpu_torch.gguf import native, quants
from llamatpu_torch.gguf.ggml_type import GGMLType

# byte ranges of a block holding f16 scales (d, and dmin for the K-quants
# with mins); the rest of a block is integer payload
SCALE_SPANS = {"q8_0": [(0, 2)], "q4_0": [(0, 2)], "q4_k": [(0, 2), (2, 4)],
               "q5_k": [(0, 2), (2, 4)], "q6_k": [(208, 210)]}
KINDS = [("q8_0", GGMLType.Q8_0, 34, 32), ("q4_0", GGMLType.Q4_0, 18, 32),
         ("q4_k", GGMLType.Q4_K, 144, 256), ("q5_k", GGMLType.Q5_K, 176, 256),
         ("q6_k", GGMLType.Q6_K, 210, 256)]


def _raw(kind: str, block_bytes: int, nb: int, seed: int) -> np.ndarray:
    """Random blocks with finite f16 scales (random scale bytes would hold
    NaN / inf, which no checkpoint ships)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, nb * block_bytes, dtype=np.uint8).reshape(nb, block_bytes)
    for lo, hi in SCALE_SPANS[kind]:
        raw[:, lo:hi] = rng.normal(scale=0.05, size=nb).astype(np.float16).view(
            np.uint8).reshape(nb, 2)
    return np.ascontiguousarray(raw.reshape(-1))


def test_native_builds_and_serves():
    assert native.available()
    assert native.build().name.startswith("libquantops-")


@pytest.mark.parametrize("kind,ggml_type,block_bytes,block_elems", KINDS)
def test_dequant_bit_equal_numpy(kind, ggml_type, block_bytes, block_elems):
    nb = 37
    raw = _raw(kind, block_bytes, nb, int(ggml_type))
    got = native.dequant(kind, raw, nb, block_elems)
    want = quants._DEQUANT[ggml_type](raw, nb * block_elems)
    assert np.isfinite(want).all()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("kind,ggml_type,block_bytes,block_elems", KINDS)
def test_dequantize_dispatch_native_and_no_native(kind, ggml_type, block_bytes, block_elems,
                                                  monkeypatch):
    """quants.dequantize takes the native codec (a native call counted) and,
    under LLAMATPU_NO_NATIVE=1 (read at each call), numpy: equal output."""
    nb = 9
    raw = _raw(kind, block_bytes, nb, 100 + int(ggml_type))
    calls = native.calls
    fast = quants.dequantize(ggml_type, raw, nb * block_elems)
    assert native.calls == calls + 1
    monkeypatch.setenv("LLAMATPU_NO_NATIVE", "1")
    assert not native.available()
    slow = quants.dequantize(ggml_type, raw, nb * block_elems)
    assert native.calls == calls + 1
    assert np.array_equal(fast, slow)


def test_quantize_q8_0_bit_equal_numpy():
    """The ggml Q8_0 encode (full-precision inv, half away from zero, f16
    scale) byte for byte, with ties, zero blocks and tiny blocks."""
    x = np.random.default_rng(3).normal(size=4096).astype(np.float32)
    x[:32] = np.array([127.0, -2.5, 2.5, 0.5, -0.5, 3.5] + [1.0] * 26, np.float32)
    x[32:64] = 0.0
    x[64:96] *= 1e-6
    assert np.array_equal(native.quantize_q8_0(x), quants.quantize_q8_0(x))


@pytest.mark.parametrize("kind,encoder,views", [("q8_0", quants.quantize_q8_0, quants.q8_0_views),
                                                ("q4_0", quants.quantize_q4_0, quants.q4_0_views)])
def test_depack_bit_equal_numpy(kind, encoder, views):
    x = np.random.default_rng(4).normal(size=512).astype(np.float32)
    raw = encoder(x)
    qs, scales = native.depack(kind, raw, 16)
    qs_np, scales_np = views(raw, 512)
    assert np.array_equal(qs, qs_np)
    assert np.array_equal(scales, scales_np.astype(np.float32))


def test_requantize_to_q8_0_native_equals_numpy(monkeypatch):
    """K-quant -> Q8_0 (the loader's Q6_K path): native decode + encode byte
    for byte the numpy one."""
    raw = _raw("q6_k", 210, 24, 6)
    fast = quants.requantize_to_q8_0(GGMLType.Q6_K, raw, 24 * 256)
    monkeypatch.setenv("LLAMATPU_NO_NATIVE", "1")
    assert np.array_equal(fast, quants.requantize_to_q8_0(GGMLType.Q6_K, raw, 24 * 256))


def test_missing_compiler_and_failed_build_raise(monkeypatch, tmp_path):
    """No quiet degrade: no compiler on PATH raises, and so does a source
    that does not compile (the build directory and source redirected)."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
    monkeypatch.undo()
    bad = tmp_path / "quantops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native codec build failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
