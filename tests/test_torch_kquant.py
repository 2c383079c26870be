"""Native Q4_K / Q5_K in the port on the CPU against the JAX package: the
codecs (views, encoders, decoders, the dequantize dispatch) bit for bit,
`_load_matmul` bit for bit (canonical and pack4), the dense offset epilogue
(canonical, packed4, stacked and not) and the experts' offset term through
K13's plain version against the Pallas kernels in interpret mode at
rtol = atol = 1e-5 in f32, `convert` of a Q4_K source byte for byte, and a
Q4_K_M-style GGUF (Q4_K with Q6_K attn_v / ffn_down) served end to end with
the JAX engine's greedy ids. No kernel launch is counted on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tiny_models import build_tiny_gguf

from llamatpu.gguf import GGMLType as JT
from llamatpu.gguf import GGUFReader as JReader
from llamatpu.gguf import quants as jq
from llamatpu.gguf.convert import requantize_gguf as j_requantize
from llamatpu.models import loader as jloader
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.models.weights import QTensor as JQTensor
from llamatpu.models.weights import prepare_qtensor
from llamatpu.ops.moe_grouped import grouped_matmul as j_grouped_matmul
from llamatpu.ops.moe_grouped import sort_by_expert as j_sort_by_expert
from llamatpu.ops.pallas_matmul import quant_matmul_pallas
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu_torch import cli
from llamatpu_torch.gguf import GGUFReader, GGUFWriter, quants
from llamatpu_torch.gguf.convert import requantize_gguf
from llamatpu_torch.gguf.ggml_type import GGMLType
from llamatpu_torch.models import loader
from llamatpu_torch.models.synthetic import build_synthetic_model as t_build
from llamatpu_torch.models.weights import (QTensor, from_numpy_weights, fuse_layer_weights,
                                           pad_offsets, serving_weights, unpack4_pairs)
from llamatpu_torch.ops import moe_grouped, quant_matmul
from llamatpu_torch.ops.matmul import matmul
from llamatpu_torch.runtime.engine import Engine

KINDS = {"q4_k": (quants.quantize_q4_k, quants.q4_k_views, quants.dequantize_q4_k,
                  GGMLType.Q4_K, JT.Q4_K),
         "q5_k": (quants.quantize_q5_k, quants.q5_k_views, quants.dequantize_q5_k,
                  GGMLType.Q5_K, JT.Q5_K)}
WRAPPERS = (quant_matmul.block_matmul, quant_matmul.packed4_matmul,
            moe_grouped.grouped_block_matmul, moe_grouped.grouped_packed4_matmul,
            moe_grouped.grouped_dense_matmul)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one intra-op thread: the test workers and the JAX
    compiler share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _values(n=4096, seed=0):
    """Weights as checkpoints have them, with a few outlier and all-zero
    sub-blocks and one constant superblock."""
    v = np.random.default_rng(seed).normal(size=n).astype(np.float32) * 0.05
    v[37] = 1.5
    v[512:544] = 0.0
    v[768:1024] = 0.25
    return v


# ------------------------------------------------------------ codecs
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("seed", [0, 1])
def test_encoders_views_and_decoders_bit_exact(kind, seed):
    enc, views, dec, t, jt = KINDS[kind]
    v = _values(seed=seed)
    raw = enc(v)
    assert np.array_equal(raw, getattr(jq, enc.__name__)(v))
    got, want = views(raw, v.size), getattr(jq, views.__name__)(raw, v.size)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    qs, sc, offs = got
    lo, hi = (-8, 7) if kind == "q4_k" else (-16, 15)
    assert qs.min() >= lo and qs.max() <= hi
    decoded = dec(raw, v.size)
    # the views reconstruct the decoder's values; the JAX numpy decoder and
    # its dispatch (the native codec where built) give the same f32 bits
    np.testing.assert_allclose(qs.astype(np.float32) * sc[:, None] + offs[:, None],
                               decoded.reshape(-1, 32), rtol=1e-6, atol=1e-7)
    assert np.array_equal(decoded, getattr(jq, dec.__name__)(raw, v.size))
    assert np.array_equal(quants.dequantize(t, raw, v.size), jq.dequantize(jt, raw, v.size))
    assert np.abs(decoded - v).max() < 0.05


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_scale_and_min_pack_round_trips(kind):
    """The 12-byte 6-bit pack of every (scale, min) code pair reads back."""
    rng = np.random.default_rng(3)
    sc = rng.integers(0, 64, size=(16, 8), dtype=np.int32)
    mn = rng.integers(0, 64, size=(16, 8), dtype=np.int32)
    out = np.zeros((16, 144 if kind == "q4_k" else 176), np.uint8)
    d = np.full(16, 0.01, np.float16)
    quants._kquant_pack_head(out, d, d, sc, mn)
    got = quants._kquant_scales_mins(out[:, 4:16])
    want = jq._kquant_scales_mins(out[:, 4:16])
    assert np.array_equal(got[0], sc) and np.array_equal(got[1], mn)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _kquant_gguf(path, kind, shapes):
    w = GGUFWriter()
    w.add("general.architecture", "llama")
    rng = np.random.default_rng(4)
    arrs = {}
    for name, shape in shapes.items():
        arrs[name] = rng.normal(size=shape).astype(np.float32) * 0.05
        w.add_tensor(name, arrs[name], KINDS[kind][3])
    w.write(str(path))
    return arrs


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("pack4", [False, True])
def test_load_matmul_bit_exact(tmp_path, kind, pack4):
    """A native K-quant tensor loads as the JAX loader's QTensor: the same
    int8 values (packed as adjacent pairs under pack4, Q4_K only), f32
    scales and offsets, canonical block order."""
    path = tmp_path / "k.gguf"
    _kquant_gguf(path, kind, {"x.w": (48, 512), "x.e": (3, 40, 256)})
    for name in ("x.w", "x.e"):
        with GGUFReader(path) as r, JReader(path) as jr:
            got = loader._load_matmul(r, name, torch.float32, pack4)
            ref = jloader._load_matmul(jr, name, "quant", np.float32)
        assert got.kind == ref.kind == kind
        packed = pack4 and kind == "q4_k"
        assert got.layout == ("packed4" if packed else "canonical")
        qs = unpack4_pairs(got.qs) if packed else got.qs
        assert np.array_equal(qs, ref.qs)
        assert np.array_equal(got.scales, ref.scales) and np.array_equal(got.offs, ref.offs)
        assert got.scales.dtype == got.offs.dtype == np.float32
        assert got.offs.shape == (*ref.qs.shape[:-1], ref.qs.shape[-1] // 32)


def test_writer_encodes_k_quants_as_the_codecs():
    v = _values(1024).reshape(4, 256)
    w = GGUFWriter()
    w.add_tensor("a", v, GGMLType.Q4_K)
    w.add_tensor("b", v, GGMLType.Q5_K)
    assert np.array_equal(w._tensors[0][3], jq.quantize_q4_k(v.reshape(-1)))
    assert np.array_equal(w._tensors[1][3], jq.quantize_q5_k(v.reshape(-1)))


# ------------------------------------------------------------ the offset epilogue
def _kweight(rng, shape, kind):
    """A random native K-quant weight (values, f32 scales, offsets)."""
    lo, hi = (-8, 8) if kind == "q4_k" else (-16, 16)
    qs = rng.integers(lo, hi, size=shape, dtype=np.int8)
    sc = rng.random((*shape[:-1], shape[-1] // 32), dtype=np.float32) * 0.01 + 0.005
    offs = (rng.random(sc.shape, dtype=np.float32) - 0.5) * 0.02
    return qs, sc, offs


@pytest.mark.parametrize("t", [1, 5, 40])
@pytest.mark.parametrize("kind,pack4", [("q4_k", False), ("q4_k", True), ("q5_k", False)])
def test_matmul_with_offsets_matches_pallas(kind, pack4, t):
    """matmul over a stacked [L, O, I] K-quant weight (K5, or K7 under
    pack4, then y += xbsum @ offs^T) and over one layer unstacked, against
    `quant_matmul_pallas(interpret=True)` with the JAX package's prepared
    (interleaved or column-halves packed, row-padded) weight: f32, rtol =
    atol = 1e-5. O = 200 is not a multiple of the JAX tiles."""
    rng = np.random.default_rng(t)
    qs, sc, offs = _kweight(rng, (2, 200, 256), kind)
    jw = prepare_qtensor(JQTensor(qs, sc, kind, offs=offs), pack4=pack4)
    tw = from_numpy_weights({"w": jw})["w"]
    assert tw.kind == kind and tw.layout == ("packed4" if pack4 else "canonical")
    assert np.array_equal(tw.offs.numpy()[..., :200, :], offs)
    x = rng.normal(size=(1, t, 256)).astype(np.float32)
    for li in (0, 1):
        want = np.asarray(quant_matmul_pallas(jw, jnp.asarray(x), interpret=True, li=li))
        got = matmul(tw, _t(x), li=li)
        np.testing.assert_allclose(got.numpy(), want[..., :200], rtol=1e-5, atol=1e-5)
    one = QTensor(tw.qs[1], tw.scales[1], kind, tw.logical_out, tw.layout, tw.offs[1])
    j1 = JQTensor(jw.qs[1], jw.scales[1], kind, jw.logical_out, jw.layout, jw.offs[1])
    want = np.asarray(quant_matmul_pallas(j1, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(matmul(one, _t(x)).numpy(), want[..., :200], rtol=1e-5, atol=1e-5)
    assert all(f.launches == 0 for f in WRAPPERS)


def test_offset_term_uses_the_canonical_blocks_before_the_pack():
    """Under pack4 the values pair adjacent columns while the offsets stay in
    canonical block order: the term is the same with the values zeroed, and
    equals the per-block sums of x against offs."""
    rng = np.random.default_rng(8)
    qs, sc, offs = _kweight(rng, (64, 128), "q4_k")
    x = _t(rng.normal(size=(3, 128)).astype(np.float32))
    zero = QTensor(torch.zeros((64, 64), dtype=torch.int8), _t(sc), "q4_k", layout="packed4",
                   offs=_t(offs))
    want = x.view(3, 4, 32).sum(-1) @ _t(offs).T
    torch.testing.assert_close(matmul(zero, x), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,i", [(1, 64), (6, 256), (40, 1408)])
@pytest.mark.parametrize("kind", ["q4_k", "q5_k"])
def test_grouped_offset_term_matches_jax(kind, n, i):
    """Expert stacks [E, O, I] of native K-quants: grouped_matmul (K10 on
    the values, the offset term through K13 on the same tile maps, offs
    zero-padded at load to a width K13 takes and xbsum to the same) against
    the JAX grouped_matmul in interpret mode, f32, rtol = atol = 1e-5; the
    padded route equals the unpadded product; unpadded offs raise."""
    rng = np.random.default_rng(n + i)
    e, o, k = 4, 96, 2
    qs, sc, offs = _kweight(rng, (e, o, i), kind)
    jw = prepare_qtensor(JQTensor(qs, sc, kind, offs=offs))
    bridged = from_numpy_weights({"w": jw})["w"]
    tw = pad_offsets(bridged)
    width = -(-i // 1024) * 32
    assert tw.offs.shape == (*bridged.offs.shape[:2], width)
    assert torch.equal(tw.offs[..., :i // 32], bridged.offs)
    assert not tw.offs[..., i // 32:].any()
    top_i = np.stack([rng.permutation(e)[:k] for _ in range(n)]).astype(np.int32)
    tm = 8
    row_token, row_src, tile_expert = j_sort_by_expert(jnp.asarray(top_i), e, tm)
    x = rng.normal(size=(n, i)).astype(np.float32)
    xs = np.concatenate([x, np.zeros((1, i), np.float32)])[np.asarray(row_token)]
    want = np.asarray(j_grouped_matmul(jw, jnp.asarray(xs), tile_expert, tm, interpret=True))
    te = _t(np.asarray(tile_expert))
    got = moe_grouped.grouped_matmul(tw, _t(xs), te, tm, row_token=_t(np.asarray(row_token)),
                                     n_tokens=n)
    np.testing.assert_allclose(got.numpy(), want[:, :o], rtol=1e-5, atol=1e-5)
    xb = _t(xs).view(xs.shape[0], i // 32, 32).sum(-1)
    plain = moe_grouped.grouped_dense_matmul_plain(xb, bridged.offs, te, tm)
    torch.testing.assert_close(moe_grouped.grouped_offset_term(_t(xs), tw.offs, te, tm), plain,
                               rtol=1e-6, atol=1e-6)
    if i // 32 % 32:
        with pytest.raises(ValueError, match="pad_offsets"):
            moe_grouped.grouped_offset_term(_t(xs), bridged.offs, te, tm)
    assert all(f.launches == 0 for f in WRAPPERS)


# ------------------------------------------------------------ weights
def test_fuse_and_fold_carry_the_offsets():
    """wq/wk/wv and w1/w3 fuse with their offsets in row order; the MoE
    shared expert folds into q4_k expert stacks with its offsets cut as its
    values are (rows of gate/up, column blocks of down)."""
    kw = dict(n_layers=2, dtype="f32", seed=2, context_length=64, quant="q4_k",
              overrides=dict(dim=128, hidden_dim=256, moe_hidden_dim=128, n_experts=4,
                             n_experts_used=2, n_heads=2, n_kv_heads=2, head_dim=64,
                             vocab_size=300))
    tm = t_build("qwen15-moe-a2.7b", **kw)
    lw = tm.weights["layers"]
    fused = fuse_layer_weights(tm.cfg, tm.weights)["layers"]
    assert np.array_equal(fused["wqkv"].offs,
                          np.concatenate([lw[k].offs for k in ("wq", "wk", "wv")], axis=-2))
    gu, down = fused["gu_exps"], fused["down_exps"]  # offsets padded for K13: 4 -> 32
    assert gu.offs.shape == (2, 6, 256, 32) and down.offs.shape == (2, 6, 128, 32)
    assert not gu.offs[..., 4:].any() and not down.offs[..., 4:].any()
    assert np.array_equal(gu.offs[:, :4, :128, :4], lw["gate_exps"].offs)
    assert np.array_equal(gu.offs[:, 4, 128:, :4], lw["shared_up"].offs[:, :128])
    assert np.array_equal(down.offs[:, 5, :, :4], lw["shared_down"].offs[:, :, 4:])
    dev = serving_weights(tm.cfg, tm.weights, device="cpu")["layers"]["gu_exps"]
    assert isinstance(dev.offs, torch.Tensor) and dev.offs.shape == (2, 6, 256, 32)


def test_rowq_leaves_the_k_quants_alone():
    kw = dict(n_layers=1, dtype="f32", seed=2, context_length=64, quant="q4_k",
              overrides=dict(dim=128, hidden_dim=256, n_heads=2, n_kv_heads=2, head_dim=64,
                             vocab_size=64))
    tm = t_build("llama32-1b", **kw)
    with pytest.warns(UserWarning, match="no Q8_0"):
        w = serving_weights(tm.cfg, tm.weights, rowq=True, device="cpu")
    assert w["layers"]["wqkv"].kind == "q4_k" and w["layers"]["wqkv"].offs is not None


# ------------------------------------------------------------ models
@pytest.mark.parametrize("quant,pack4", [("q4_k", False), ("q4_k", True), ("q5_k", False)])
def test_synthetic_engine_greedy_ids_match_jax(quant, pack4):
    """The synthetic Qwen3 preset shrunk (q width 512 != dim 256, head 128,
    q/k norm), native K-quant weights drawn in the JAX package's order:
    the same arrays, and the greedy ids of Engine equal the JAX Engine's
    (impl="pallas")."""
    kw = dict(n_layers=2, dtype="f32", seed=9, context_length=128, quant=quant, pack4=pack4,
              overrides=dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=128,
                             vocab_size=300))
    tm, jm = t_build("qwen3-0.6b", **kw), j_build("qwen3-0.6b", **kw)
    bridged = from_numpy_weights(jax.device_get(jm.weights))["layers"]["wq"]
    assert torch.equal(bridged.qs, _t(tm.weights["layers"]["wq"].qs))
    assert np.array_equal(bridged.offs.numpy(), tm.weights["layers"]["wq"].offs)
    prompt = [(11 * i + 5) % 300 for i in range(21)]
    common = dict(cache_len=128, prefill_chunk=16, decode_window=4)
    je = JEngine(jm, impl="pallas", cache_dtype=jnp.float32, aot_compile=False, **common)
    te = Engine(tm, cache_dtype=torch.float32, device="cpu", **common)
    assert te.generate(prompt, 9).tokens == je.generate(prompt, 9).tokens


def test_q4_k_moe_engine_matches_jax():
    """Q4_K routed experts (folded shared expert: the offset term of each
    stack through K13's plain version, Qwen1.5-MoE's down width shrunk to 96
    = 3 blocks): the greedy ids equal the JAX Engine's."""
    kw = dict(n_layers=2, dtype="f32", seed=6, context_length=128, quant="q4_k",
              overrides=dict(dim=128, hidden_dim=192, moe_hidden_dim=96, n_experts=8,
                             n_experts_used=2, n_heads=2, n_kv_heads=2, head_dim=64,
                             vocab_size=300))
    tm, jm = t_build("qwen15-moe-a2.7b", **kw), j_build("qwen15-moe-a2.7b", **kw)
    prompt = [(7 * i + 3) % 300 for i in range(19)]
    common = dict(cache_len=128, prefill_chunk=16, decode_window=4)
    je = JEngine(jm, impl="pallas", cache_dtype=jnp.float32, aot_compile=False, **common)
    te = Engine(tm, cache_dtype=torch.float32, device="cpu", **common)
    assert te.weights["layers"]["down_exps"].offs.shape[-2:] == (128, 32)  # 3 blocks, padded
    assert te.generate(prompt, 8).tokens == je.generate(prompt, 8).tokens


# ------------------------------------------------------------ files
def _q4_k_m(src, dst):
    """A Q4_K_M-style copy of a tiny F32 GGUF: Q4_K matmuls, Q6_K attn_v and
    ffn_down (raw superblocks from `_q6_k_raw`, small finite f16 scales),
    norms and widths that are not whole superblocks F32."""
    with GGUFReader(src) as r:
        md = {k: v for k, v in r.metadata.items() if k != "tokenizer.ggml.tokens.length"}
        tensors = {n: r.tensor_f32(n) for n in r.tensor_infos}
    w = GGUFWriter()
    for k, v in md.items():
        w.add(k, v)
    for name, arr in tensors.items():
        if arr.ndim < 2 or "norm" in name or arr.size % 256:
            w.add_tensor(name, arr, GGMLType.F32)
        elif "attn_v" in name or "ffn_down" in name:
            w.add_tensor_raw(name, arr.shape, GGMLType.Q6_K, _q6_k_raw(arr))
        else:
            w.add_tensor(name, arr, GGMLType.Q4_K)
    w.write(str(dst))


def _q6_k_raw(arr):
    """Q6_K superblocks of `arr` (a plain absmax encode: ql/qh 6-bit values
    around 32, one int8 scale per 16 and an f16 d)."""
    v = arr.reshape(-1, 256).astype(np.float32)
    nb = v.shape[0]
    sub = v.reshape(nb, 16, 16)
    amax = np.abs(sub).max(-1)                                   # [nb, 16]
    d = (amax.max(-1) / (31 * 127)).astype(np.float16).astype(np.float32)
    d = np.where(d > 0, d, 1e-4).astype(np.float16)
    sc = np.clip(np.round(amax / (31 * d.astype(np.float32)[:, None])), 1, 127).astype(np.int8)
    q = np.clip(np.round(sub / (d.astype(np.float32)[:, None, None] * sc[..., None])), -32, 31)
    q = (q.astype(np.int32) + 32).reshape(nb, 256)
    out = np.zeros((nb, 210), np.uint8)
    for half in range(2):
        qh_ = q[:, half * 128:(half + 1) * 128]
        g = [qh_[:, 32 * k:32 * (k + 1)] for k in range(4)]
        out[:, half * 64:half * 64 + 32] = (g[0] & 15) | ((g[2] & 15) << 4)
        out[:, half * 64 + 32:half * 64 + 64] = (g[1] & 15) | ((g[3] & 15) << 4)
        out[:, 128 + half * 32:128 + (half + 1) * 32] = ((g[0] >> 4) | ((g[1] >> 4) << 2)
                                                         | ((g[2] >> 4) << 4) | ((g[3] >> 4) << 6))
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = d[:, None].view(np.uint8)
    return out.reshape(-1)


@pytest.fixture(scope="module")
def q4_k_m(tmp_path_factory):
    d = tmp_path_factory.mktemp("q4km")
    build_tiny_gguf(d / "f32.gguf", family="qwen3", quant=JT.F32, seed=3, with_tokenizer=True)
    _q4_k_m(d / "f32.gguf", d / "q4km.gguf")
    return d / "q4km.gguf"


def test_q6_k_encode_reads_back(q4_k_m):
    v = _values(2048)
    raw = _q6_k_raw(v)
    # half a step of the sub-block holding the 1.5 outlier: 1.5 / 62
    np.testing.assert_allclose(jq.dequantize_q6_k(raw, v.size), v, atol=0.025)
    assert np.array_equal(quants.dequantize(GGMLType.Q6_K, raw, v.size),
                          jq.dequantize(JT.Q6_K, raw, v.size))


def test_q4_k_m_file_loads_and_serves_as_jax(q4_k_m):
    """The Q4_K_M-style file: Q4_K projections native, Q6_K attn_v and
    ffn_down requantized to Q8_0, so wqkv does not fuse (mixed kinds); the
    port's greedy ids equal the JAX Engine's (impl="pallas") on the same
    file, and with pack4 too."""
    for pack4 in (False, True):
        tm = loader.load_model(str(q4_k_m), param_dtype=torch.float32, pack4=pack4,
                               load_tokenizer=False)
        jm = jloader.load_model(str(q4_k_m), param_dtype=jnp.float32, pack4=pack4,
                                load_tokenizer=False, device_put=False)
        lw = tm.weights["layers"]
        assert lw["wq"].kind == "q4_k" and lw["wv"].kind == "q8_0" and lw["w2"].kind == "q8_0"
        prompt = [(5 * i + 1) % 270 for i in range(13)]
        common = dict(cache_len=64, prefill_chunk=16, decode_window=4)
        je = JEngine(jm, impl="pallas", cache_dtype=jnp.float32, aot_compile=False, **common)
        te = Engine(tm, cache_dtype=torch.float32, device="cpu", **common)
        assert "wqkv" not in te.weights["layers"]
        assert te.generate(prompt, 8).tokens == je.generate(prompt, 8).tokens


def test_q4_k_m_file_runs_through_the_cli(q4_k_m, capsys):
    for extra in ([], ["--no-thinking"], ["--pack4"]):
        rc = cli.main(["run", "-m", str(q4_k_m), "-p", "hello", "--device", "cpu", "-n", "40",
                       "--temperature", "0", "--metrics-format", "none"] + extra)
        assert rc == 0
        assert capsys.readouterr().out.strip()


def test_convert_from_a_q4_k_source_equals_jax(tmp_path, q4_k_m):
    out, jout = tmp_path / "p.gguf", tmp_path / "j.gguf"
    stats = requantize_gguf(str(q4_k_m), str(out))
    assert stats == j_requantize(str(q4_k_m), str(jout))
    assert stats["requantized"] > 0
    assert out.read_bytes() == jout.read_bytes()
