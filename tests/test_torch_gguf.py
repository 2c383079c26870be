"""The port's GGUF reader, writer, block-quant codecs and loader against the
JAX package's, on the same bytes: codecs bit-exact, a file written by the
port read back by both readers, and tiny Llama checkpoints loaded into the
same values bit for bit (raw and served)."""
import numpy as np
import pytest
import torch
from tiny_models import build_tiny_gguf

from llamatpu.gguf import GGMLType as JT
from llamatpu.gguf import GGUFReader as JReader
from llamatpu.gguf import quants as jq
from llamatpu.models.loader import load_model as j_load
from llamatpu.models.weights import serving_weights as j_serving
from llamatpu_torch.gguf import GGMLType, GGUFReader, GGUFWriter, quants
from llamatpu_torch.models.loader import load_model
from llamatpu_torch.models.weights import (QTensor, from_numpy_weights, serving_weights,
                                           tree_to)

QUANTS = {"q8_0": GGMLType.Q8_0, "q4_0": GGMLType.Q4_0, "f32": GGMLType.F32}


def _values(n=4096, seed=0):
    v = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    v[:32] = 0.0  # an all-zero block: scale 0
    return v


def _q6k_raw(nblocks=8, seed=1):
    raw = np.random.default_rng(seed).integers(0, 256, size=210 * nblocks, dtype=np.uint8)
    raw[208::210], raw[209::210] = 0x00, 0x3C  # d = 1.0 as f16
    return raw


@pytest.mark.parametrize("codec", ["quantize_q8_0", "quantize_q4_0"])
def test_quantize_bit_exact(codec):
    v = _values()
    assert np.array_equal(getattr(quants, codec)(v), getattr(jq, codec)(v))


@pytest.mark.parametrize("name", ["Q8_0", "Q4_0", "F16", "BF16", "F32", "Q6_K"])
def test_dequantize_bit_exact(name):
    v = _values()
    raw = {"Q8_0": lambda: jq.quantize_q8_0(v), "Q4_0": lambda: jq.quantize_q4_0(v),
           "F16": lambda: v.astype(np.float16).view(np.uint8),
           "BF16": lambda: (v.view(np.uint32) >> 16).astype(np.uint16).view(np.uint8),
           "F32": lambda: v.view(np.uint8), "Q6_K": _q6k_raw}[name]()
    n = 2048 if name == "Q6_K" else v.size
    got = quants.dequantize(GGMLType[name], raw, n)
    assert np.array_equal(got, jq.dequantize(JT[name], raw, n))


def test_views_blocks_and_requant_bit_exact():
    v = _values()
    for views, blocks, enc in ((quants.q8_0_views, quants.q8_0_blocks, jq.quantize_q8_0),
                               (quants.q4_0_views, quants.q4_0_blocks, jq.quantize_q4_0)):
        raw = enc(v)
        qs, sc = views(raw, v.size)
        jqs, jsc = getattr(jq, views.__name__)(raw, v.size)
        assert np.array_equal(qs, jqs) and np.array_equal(sc, jsc)
        assert np.array_equal(blocks(qs, sc), raw)  # the writer's inverse
    raw = _q6k_raw()
    assert np.array_equal(quants.requantize_to_q8_0(GGMLType.Q6_K, raw, 2048),
                          jq.requantize_to_q8_0(JT.Q6_K, raw, 2048))
    with pytest.raises(NotImplementedError, match="quant-breadth"):
        quants.dequantize(GGMLType.Q4_K, np.zeros(144, np.uint8), 256)


def test_writer_read_back_by_both_readers(tmp_path):
    rng = np.random.default_rng(2)
    w = GGUFWriter()
    md = {"general.architecture": "llama", "llama.block_count": 3, "big": 2 ** 40,
          "flag": True, "eps": 1e-5, "names": ["a", "bé", "<|eot_id|>"],
          "ids": np.arange(5, dtype=np.int32), "scores": np.linspace(0, 1, 4, dtype=np.float32)}
    for k, v in md.items():
        w.add(k, v)
    dense = rng.normal(size=(4, 64)).astype(np.float32)
    w.add_tensor("f32", dense)
    w.add_tensor("f16", dense.astype(np.float16))
    w.add_tensor("q8", dense, GGMLType.Q8_0)
    w.add_tensor("q4", dense, GGMLType.Q4_0)
    w.add_tensor_raw("q8raw", (4, 64), GGMLType.Q8_0, jq.quantize_q8_0(dense).tobytes())
    path = tmp_path / "w.gguf"
    w.write(str(path))
    with GGUFReader(path) as tr, JReader(path) as jr:
        assert tr.metadata.keys() == jr.metadata.keys()
        for k in md:
            a, b = tr.metadata[k], jr.metadata[k]
            assert (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b), k
        assert tr.tensor_infos.keys() == jr.tensor_infos.keys()
        for name, info in tr.tensor_infos.items():
            j = jr.tensor_infos[name]
            assert (info.shape, int(info.ggml_type), info.offset) == \
                (j.shape, int(j.ggml_type), j.offset)
            assert np.array_equal(tr.tensor_raw(name), jr.tensor_raw(name))
            assert np.array_equal(tr.tensor_f32(name), jr.tensor_f32(name))


def _same_tree(port: dict, ref: dict, path=""):
    """Bit-equality of two port trees; `ref`'s padded rows (logical_out) are
    sliced off first."""
    assert port.keys() == ref.keys(), path
    for k in port:
        a, b = port[k], ref[k]
        if isinstance(a, dict):
            _same_tree(a, b, f"{path}/{k}")
        elif isinstance(a, QTensor):
            assert (a.kind, a.layout) == (b.kind, b.layout), f"{path}/{k}"
            o = b.logical_out or b.qs.shape[-2]
            assert torch.equal(a.qs, b.qs[..., :o, :]), f"{path}/{k}"
            assert torch.equal(a.scales, b.scales[..., :o, :]), f"{path}/{k}"
        else:
            assert torch.equal(a, b), f"{path}/{k}"


@pytest.mark.parametrize("pack4", [False, True])
@pytest.mark.parametrize("quant", list(QUANTS))
def test_load_model_matches_jax(quant, pack4, tmp_path):
    """The raw loaded tree, and the served (fused) tree, equal llamatpu's
    load_model(..., device_put=False) through from_numpy_weights, bit for
    bit (packed4 compared as unpacked values too)."""
    import jax
    import jax.numpy as jnp

    path = tmp_path / "m.gguf"
    build_tiny_gguf(path, family="llama", quant=QUANTS[quant], seed=4, with_tokenizer=True)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tm = load_model(str(path), param_dtype=tdt, pack4=pack4)
        jm = j_load(str(path), param_dtype=jdt, device_put=False, pack4=pack4)
        assert tm.cfg == type(tm.cfg)(**{**jm.cfg.__dict__, "family": tm.cfg.family})
        assert tm.quant_label == jm.quant_label
        _same_tree(tree_to(tm.weights, "cpu"), from_numpy_weights(jm.weights))
    # served: the port fuses what the JAX package leaves padded and unfused
    tw = serving_weights(tm.cfg, tm.weights, device="cpu")
    jw = from_numpy_weights(jax.device_get(j_serving(jm.cfg, jm.weights)))
    for fused, parts in (("wqkv", ("wq", "wk", "wv")), ("w13", ("w1", "w3"))):
        got = tw["layers"][fused]
        ref = [jw["layers"][p] for p in parts] if parts[0] in jw["layers"] \
            else [jw["layers"][fused]]
        if isinstance(got, QTensor):
            cat = torch.cat([r.qs[..., : r.logical_out or r.qs.shape[-2], :] for r in ref], -2)
            assert torch.equal(got.qs, cat)
        else:
            assert torch.equal(got, torch.cat(ref, -2))


def test_load_model_onto_a_device_serves_the_same(tmp_path):
    """load_model(device=...) returns the tree as torch tensors there; served
    and run, it gives the tokens of the host-side tree."""
    from llamatpu_torch.runtime.engine import Engine

    path = tmp_path / "m.gguf"
    build_tiny_gguf(path, family="llama", quant=GGMLType.Q4_0, seed=6, with_tokenizer=True)
    host = load_model(str(path), pack4=True, param_dtype=torch.float32)
    dev = load_model(str(path), pack4=True, param_dtype=torch.float32, device="cpu")
    assert isinstance(dev.weights["layers"]["wq"].qs, torch.Tensor)
    _same_tree(tree_to(host.weights, "cpu"), dev.weights)
    kw = dict(cache_len=64, prefill_chunk=32, decode_window=4, device="cpu")
    prompt = [1, 2, 3, 4, 5]
    assert Engine(dev, **kw).generate(prompt, 6).tokens == \
        Engine(host, **kw).generate(prompt, 6).tokens


def _copy_gguf(path, out, drop: str = "", extra=()):
    """Copy a GGUF through the port's writer, dropping one tensor and adding
    `extra` (name, shape, type, raw) tensors."""
    w = GGUFWriter()
    with GGUFReader(path) as r:
        for k, v in r.metadata.items():
            if k != "tokenizer.ggml.tokens.length":
                w.add(k, v)
        for name, info in r.tensor_infos.items():
            if name != drop:
                w.add_tensor_raw(name, info.shape, info.ggml_type, r.tensor_raw(name).copy())
    for name, shape, t, raw in extra:
        w.add_tensor_raw(name, shape, t, raw)
    w.write(str(out))


def test_tied_head(tmp_path):
    """No output.weight: the head is token_embd as a QTensor, the embedding
    its dequantized values (Llama-3.2-1B ships that way)."""
    src = tmp_path / "m.gguf"
    build_tiny_gguf(src, family="llama", quant=GGMLType.Q8_0, seed=5, with_tokenizer=True)
    tied = tmp_path / "tied.gguf"
    _copy_gguf(src, tied, drop="output.weight")
    tm = load_model(str(tied), param_dtype=torch.float32)
    jm = j_load(str(tied), param_dtype=np.float32, device_put=False)
    _same_tree(tree_to(tm.weights, "cpu"), from_numpy_weights(jm.weights))
    w = tm.weights["wcls"]
    assert isinstance(w, QTensor) and w.kind == "q8_0"
    emb = w.qs.astype(np.float32) * np.repeat(w.scales, 32, axis=-1)
    assert np.array_equal(tm.weights["tok_emb"], emb)


def test_k_quant_tensors(tmp_path):
    """A Q6_K projection requantizes to Q8_0 exactly as the JAX loader does;
    native Q4_K raises, naming the quant-breadth slice."""
    from llamatpu.gguf import quants as jqq
    from llamatpu.models import loader as jloader
    from llamatpu_torch.models import loader

    src = tmp_path / "m.gguf"
    build_tiny_gguf(src, family="llama", quant=GGMLType.F32, seed=7, with_tokenizer=True)
    out = tmp_path / "k.gguf"
    q4k = jqq.quantize_q4_k(np.random.default_rng(8).normal(size=1024).astype(np.float32))
    _copy_gguf(src, out, extra=[("x.q6k", (8, 256), GGMLType.Q6_K, _q6k_raw(8)),
                                ("x.q4k", (4, 256), GGMLType.Q4_K, q4k)])
    with GGUFReader(out) as r, JReader(out) as jr:
        got = loader._load_matmul(r, "x.q6k", torch.float32, False)
        ref = jloader._load_matmul(jr, "x.q6k", "quant", np.float32)
        assert got.kind == ref.kind == "q8_0"
        assert np.array_equal(got.qs, ref.qs) and np.array_equal(got.scales, ref.scales)
        with pytest.raises(NotImplementedError, match="quant-breadth"):
            loader._load_matmul(r, "x.q4k", torch.float32, False)
