"""The plain PyTorch versions of the port's four kernels (and the ops around
them) against the JAX package's functions on the same numpy inputs. On the
CPU every kernel wrapper takes its plain version; the CUDA kernels themselves
are held against these on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamatpu.models.weights import QTensor as JQTensor
from llamatpu.ops import int8_prefill as j8
from llamatpu.ops.layer_fused import layer_attn_tail_fused_rowq as j_attn_tail
from llamatpu.ops.layer_fused import qkv_norm_fused_rowq as j_qkv_norm
from llamatpu.ops.pallas_gemm import rowq_gemm_pallas
from llamatpu.ops.pallas_matmul import _rowq_matmul_2d
from llamatpu.ops.rmsnorm import rmsnorm as j_rmsnorm
from llamatpu.ops.rope import apply_rope as j_apply_rope
from llamatpu_torch.models.weights import QTensor
from llamatpu_torch.ops import gemm, int8_prefill, layer_fused, quant_matmul
from llamatpu_torch.ops.matmul import matmul
from llamatpu_torch.ops.rmsnorm import rmsnorm
from llamatpu_torch.ops.rope import apply_rope

EPS = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rowq(rng, shape):
    qs = rng.integers(-127, 128, size=shape, dtype=np.int8)
    sc = ((rng.random((*shape[:-1], 1), dtype=np.float32) + 0.5) / 127).astype(np.float32)
    return qs, sc


# ------------------------------------------------------- int8 prefill (K4)
def _act(rng, t, i):
    x = rng.normal(size=(t, i)).astype(np.float32)
    x[0] = 0.0                                   # zero row -> (0, 0)
    x[1, :4] = [2.5, -2.5, 127.0, -127.0]        # exact half steps at ax = 1
    x[1, 4:] = 0.5
    return x


def test_quantize_activation_rows_bit_exact():
    x = _act(np.random.default_rng(0), 16, 256)
    xi8, ax = int8_prefill.quantize_activation_rows(_t(x))
    jx, jax_ = j8.quantize_activation_rows(jnp.asarray(x))
    np.testing.assert_array_equal(xi8.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ax.numpy(), np.asarray(jax_))
    assert not xi8[0].any() and ax[0, 0] == 0
    assert xi8[1, :2].tolist() == [3, -3]        # half away from zero


@pytest.mark.parametrize("t,o,i", [(128, 256, 128), (256, 384, 512), (130, 128, 256)])
def test_k4_plain_bit_exact_vs_xla_and_pallas(t, o, i):
    """rowq_matmul_mxu (the plain path of K4) equals the JAX package's XLA
    int8 dot and its Pallas GEMM (interpret mode) bit for bit."""
    rng = np.random.default_rng(t + o + i)
    x = _act(rng, t, i)
    qs, sc = _rowq(rng, (o, i))
    got = int8_prefill.rowq_matmul_mxu(_t(qs), _t(sc), _t(x)).numpy()
    want = np.asarray(j8.rowq_matmul_mxu(jnp.asarray(qs), jnp.asarray(sc), jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    xi8, ax = int8_prefill.quantize_activation_rows(_t(x))
    k4 = gemm.rowq_gemm(_t(qs), _t(sc), xi8, ax).numpy()     # CPU: the plain version
    np.testing.assert_array_equal(k4, want)
    if t % 8 == 0:  # the Pallas GEMM tiles T in multiples of 8
        pal = rowq_gemm_pallas(jnp.asarray(qs), jnp.asarray(sc), jnp.asarray(xi8.numpy()),
                               jnp.asarray(ax.numpy()), interpret=True)
        np.testing.assert_array_equal(k4, np.asarray(pal))


def test_k4_rejects_int32_overflow_width():
    xi8 = torch.zeros((128, int8_prefill._INT8_ACC_MAX_I + 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflows"):
        gemm.rowq_gemm(xi8[:1], torch.ones(1, 1), xi8, torch.ones(128, 1))


# ------------------------------------------------------------------- K1
@pytest.mark.parametrize("t", [1, 5, 32])
def test_k1_plain_vs_pallas_rowq(t):
    rng = np.random.default_rng(t)
    qs, sc = _rowq(rng, (384, 256))
    x = rng.normal(size=(t, 256)).astype(np.float32)
    got = (quant_matmul.rowq_gemv(_t(x), _t(qs)) * _t(sc)[:, 0][None, :]).numpy()
    want = np.asarray(_rowq_matmul_2d(jnp.asarray(qs), jnp.asarray(sc), jnp.asarray(x),
                                      interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_matmul_dispatch_slices_logical_rows_and_casts():
    rng = np.random.default_rng(4)
    qs, sc = _rowq(rng, (256, 128))
    qs[200:] = 0
    w = QTensor(_t(qs), _t(sc), "q8_row", logical_out=200)
    for t in (1, 128):  # K1 and K4 paths
        x = torch.from_numpy(rng.normal(size=(1, t, 128)).astype(np.float32)).bfloat16()
        y = matmul(w, x)
        assert y.shape == (1, t, 200) and y.dtype == torch.bfloat16
    # block quants route to K5 (slicing and cast alike); K-quants add their
    # offset term to K5's f32 sums before the cast
    sb = (rng.random((256, 4)) * 0.01).astype(np.float32)
    yb = matmul(QTensor(_t(qs), _t(sb), "q8_0", logical_out=200), x)
    assert yb.shape == (1, 128, 200) and yb.dtype == torch.bfloat16
    yk = matmul(QTensor(_t(qs), _t(sb), "q4_k", logical_out=200, offs=_t(sb)), x)
    x2 = x.reshape(128, 128)
    want = (quant_matmul.block_matmul(x2, _t(qs), _t(sb))
            + x2.float().reshape(128, 4, 32).sum(-1) @ _t(sb).T).to(torch.bfloat16)
    assert torch.equal(yk[0], want[:, :200])


# ------------------------------------------------------------------- K2
L, D, F, H = 2, 256, 256, 256


@pytest.fixture(scope="module")
def layer_ws():
    rng = np.random.default_rng(21)
    return {
        "wqkv": _rowq(rng, (L, 384, D)),
        "wo": _rowq(rng, (L, D, H)),
        "w13": _rowq(rng, (L, 2 * F, D)),
        "w2": _rowq(rng, (L, D, F)),
        "attn_norm": rng.normal(size=(L, D)).astype(np.float32),
        "ffn_norm": (rng.normal(0, 0.1, size=(L, D)) + 1).astype(np.float32),
    }


def _port_q(w):
    return QTensor(_t(w[0]), _t(w[1]), "q8_row")


def _jax_q(w):
    return JQTensor(jnp.asarray(w[0]), jnp.asarray(w[1]), "q8_row")


@pytest.mark.parametrize("li", [0, 1])
def test_k2_plain_vs_qkv_norm_fused(layer_ws, li):
    x = np.random.default_rng(li).normal(size=(1, 1, D)).astype(np.float32)
    got = layer_fused.qkv_norm_fused_rowq(_port_q(layer_ws["wqkv"]),
                                          _t(layer_ws["attn_norm"]), _t(x), li, EPS)
    want = j_qkv_norm(_jax_q(layer_ws["wqkv"]), jnp.asarray(layer_ws["attn_norm"]),
                      jnp.asarray(x), jnp.int32(li), EPS, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=1e-3)


# ------------------------------------------------------------------- K3
KV, G, HD, S = 2, 2, 64, 96  # S = 96: the JAX kernel walks it in 32-row tiles


@pytest.mark.parametrize("pos", [0, 31, 32, 63, 95])
def test_k3_plain_vs_attn_tail_megakernel(layer_ws, pos):
    rng = np.random.default_rng(100 + pos)
    kvc = rng.normal(size=(L, 1, KV, S, 2 * HD)).astype(np.float32)
    q4 = rng.normal(size=(1, KV, G, HD)).astype(np.float32)
    kvn = rng.normal(size=(1, KV, 2 * HD)).astype(np.float32)
    x = rng.normal(size=(1, 1, D)).astype(np.float32)
    li, scale, rs = 1, HD ** -0.5, (0.5 if pos == 63 else 1.0)
    port_cache = _t(kvc.copy())
    got, cache_out = layer_fused.layer_attn_tail_fused_rowq(
        _port_q(layer_ws["wo"]), _port_q(layer_ws["w13"]), _port_q(layer_ws["w2"]),
        _t(layer_ws["ffn_norm"]), _t(q4), _t(kvn), port_cache, _t(x), pos, li, EPS,
        scale, HD, rs)
    assert cache_out is port_cache  # updated in place
    out = j_attn_tail(_jax_q(layer_ws["wo"]), _jax_q(layer_ws["w13"]), _jax_q(layer_ws["w2"]),
                      jnp.asarray(layer_ws["ffn_norm"]), jnp.asarray(q4), jnp.asarray(kvn),
                      jnp.asarray(kvc), jnp.asarray(x), jnp.asarray([pos], jnp.int32), li,
                      EPS, scale, HD, rs, interpret=True)
    assert out is not None, "JAX megakernel declined the test geometry"
    want, want_cache = out
    np.testing.assert_array_equal(port_cache.numpy(), np.asarray(want_cache))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=1e-3)


def test_k3_raises_on_unported_configurations(layer_ws):
    args = (_port_q(layer_ws["wo"]), _port_q(layer_ws["w13"]), _port_q(layer_ws["w2"]),
            _t(layer_ws["ffn_norm"]))
    q4, kvn, x = torch.zeros(1, KV, G, HD), torch.zeros(1, KV, 2 * HD), torch.zeros(1, 1, D)
    with pytest.raises(NotImplementedError, match="int8"):
        layer_fused.layer_attn_tail_fused_rowq(
            *args, q4, kvn, torch.zeros(L, 1, KV, S, 2 * HD, dtype=torch.int8), x, 0, 0,
            EPS, 0.125, HD)
    with pytest.raises(NotImplementedError, match="B = 1"):
        layer_fused.layer_attn_tail_fused_rowq(
            *args, q4.repeat(2, 1, 1, 1), kvn, torch.zeros(L, 2, KV, S, 2 * HD),
            x.repeat(2, 1, 1), 0, 0, EPS, 0.125, HD)


# ------------------------------------------------------- plain ops + counters
def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 7, 4, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(rmsnorm(_t(x), _t(w), EPS).numpy(),
                               np.asarray(j_rmsnorm(jnp.asarray(x), jnp.asarray(w), EPS)),
                               rtol=1e-6, atol=1e-6)
    cos = rng.normal(size=(1, 7, 1, 32)).astype(np.float32)
    sin = rng.normal(size=(1, 7, 1, 32)).astype(np.float32)
    for style in ("interleaved", "neox"):
        np.testing.assert_allclose(
            apply_rope(_t(x), _t(cos), _t(sin), style).numpy(),
            np.asarray(j_apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), style)),
            rtol=1e-6, atol=1e-6)


def test_cpu_tensors_never_count_a_launch(layer_ws):
    fns = (quant_matmul.rowq_gemv, gemm.rowq_gemm, layer_fused.qkv_norm_fused_rowq,
           layer_fused.layer_attn_tail_fused_rowq)
    before = [f.launches for f in fns]
    x = torch.ones(1, 1, D)
    layer_fused.qkv_norm_fused_rowq(_port_q(layer_ws["wqkv"]), _t(layer_ws["attn_norm"]),
                                    x, 0, EPS)
    layer_fused.layer_attn_tail_fused_rowq(
        _port_q(layer_ws["wo"]), _port_q(layer_ws["w13"]), _port_q(layer_ws["w2"]),
        _t(layer_ws["ffn_norm"]), torch.ones(1, KV, G, HD), torch.ones(1, KV, 2 * HD),
        torch.zeros(L, 1, KV, S, 2 * HD), x, 3, 0, EPS, 0.125, HD)
    w = _port_q(layer_ws["wqkv"])
    matmul(w, torch.ones(1, 1, D), li=0)
    matmul(w, torch.ones(1, 128, D), li=1)
    assert [f.launches for f in fns] == before == [0, 0, 0, 0]
