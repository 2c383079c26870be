"""The port's forward and Engine (llamatpu_torch) against the JAX package's
impl="pallas" path on a tiny f32 model, plus the port's package rules: no
JAX import, the card by default."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llamatpu.models import transformer as jtr
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.models.weights import serving_weights as j_serving
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu_torch.models import transformer as ttr
from llamatpu_torch.models.synthetic import build_synthetic_model as t_build
from llamatpu_torch.models.weights import from_numpy_weights
from llamatpu_torch.runtime.engine import Engine

TINY = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab_size=300)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _models(ctx=256):
    kw = dict(n_layers=2, dtype="f32", seed=5, context_length=ctx, overrides=TINY)
    return t_build("llama32-1b", **kw), j_build("llama32-1b", **kw)


def test_forward_prefill_and_decode_match_jax_pallas():
    """A 128-token prefill (the int8 K4 path) and one decode step (K2 + K3):
    logits and cache against llamatpu forward_tokens(impl="pallas"), f32."""
    tm, jm = _models()
    cfg = tm.cfg
    jw = j_serving(jm.cfg, jm.weights, rowq=True)
    # the port runs llamatpu's own served weights, through the bridge
    tw = from_numpy_weights(jax.device_get(jw))
    assert tw["wcls"].logical_out == TINY["vocab_size"]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 128))
    cache = ttr.init_cache(cfg, 1, torch.float32, device="cpu")
    jcache = jtr.init_cache(jm.cfg, 1, jnp.float32)
    logits, cache = ttr.forward_tokens(cfg, tw, torch.from_numpy(toks), cache, 0)
    jlogits, jcache = jtr.forward_tokens(jm.cfg, jw, jnp.asarray(toks, jnp.int32), jcache, 0,
                                         impl="pallas")
    assert logits.shape == (1, 128, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(cache.kv.numpy(), np.asarray(jcache.kv), rtol=5e-4, atol=5e-4)
    step = torch.tensor([[17]])
    logits2, cache = ttr.forward_tokens(cfg, tw, step, cache, 128, last_logit_only=True)
    jlogits2, jcache = jtr.forward_tokens(jm.cfg, jw, jnp.asarray([[17]], jnp.int32), jcache,
                                          128, impl="pallas", last_logit_only=True)
    np.testing.assert_allclose(logits2.numpy(), np.asarray(jlogits2), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(cache.kv.numpy(), np.asarray(jcache.kv), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("stop", [False, True])
def test_engine_greedy_tokens_match_jax_engine(stop):
    """Two prefill chunks (the second padded from 2 to 128 rows), then decode
    windows: the greedy token list equals llamatpu's Engine(impl="pallas",
    rowq=True) on the same tiny f32 model; with a stop token both stop at it."""
    tm, jm = _models()
    prompt = [(7 * i + 3) % TINY["vocab_size"] for i in range(130)]
    kw = dict(cache_len=256, prefill_chunk=128, decode_window=4, rowq=True)
    je = JEngine(jm, impl="pallas", cache_dtype=jnp.float32, aot_compile=False, **kw)
    ref = je.generate(prompt, 8).tokens
    stops = {ref[5]} if stop else set()
    if stop:
        je.reset()
        ref = je.generate(prompt, 8, stop_tokens=stops)
        assert ref.stop_reason == "stop_token"
        ref = ref.tokens
    te = Engine(tm, cache_dtype=torch.float32, device="cpu", **kw)
    got = te.generate(prompt, 8, stop_tokens=stops)
    assert got.tokens == ref
    assert got.stop_reason == ("stop_token" if stop else "length")
    assert te.metrics.prefill_tokens == 130 and te.metrics.decode_tokens == len(ref)


def test_engine_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm, _ = _models(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tm, rowq=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tm)
    # sampled decoding and block-quant serving (the default) run on the CPU
    assert len(Engine(tm, rowq=True, temperature=0.7, device="cpu").generate([1, 2], 2).tokens) == 2
    assert Engine(tm, device="cpu").weights["layers"]["wqkv"].kind == "q8_0"
    e = Engine(tm, rowq=True, device="cpu", cache_dtype=torch.float32)
    assert e.cache.kv.shape == (2, 1, 2, ttr.physical_cache_len(64, 64), 128)


def test_cache_geometry_matches_jax():
    for logical, chunk in ((1024, 512), (1000, 128), (9000, 512), (64, 32)):
        assert ttr.physical_cache_len(logical, chunk) == jtr.physical_cache_len(logical, chunk)
        for real in (1, 2, 127, 130, chunk):
            if real <= chunk:
                assert ttr.pad_chunk_len(real, chunk) == jtr.pad_chunk_len(real, chunk)


def test_port_imports_no_jax_and_no_llamatpu():
    """Every module of the port (slice 2's GGUF, tokenizer, format, CLI,
    session and bench modules, slice 3's paged cache, batch engines,
    scheduler, server and tool parser, slice 4's grouped expert matmuls,
    slice 5's int8 KV quantization and slice 6's measuring tools and probes
    included), imported in a fresh
    interpreter, loads no jax, no ml_dtypes,
    no regex and no module of the JAX package."""
    code = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
import llamatpu_torch
for m in pkgutil.walk_packages(llamatpu_torch.__path__, "llamatpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
new = set(sys.modules) - before
bad = sorted(n for n in new if n.split(".")[0] in ("jax", "jaxlib", "llamatpu", "ml_dtypes", "regex"))
print("BAD", bad)
need = ["llamatpu_torch." + m for m in (
    "cli", "gguf.reader", "gguf.writer", "gguf.quants", "models.loader", "models.detect",
    "tokenizer.bpe", "tokenizer.builders", "tokenizer.stream", "format.chat_format",
    "ops.attention", "runtime.session", "bench.perplexity", "bench.validate",
    "runtime.paged_cache", "runtime.batch_engine", "runtime.paged_engine",
    "runtime.scheduler", "server.service", "server.openai_server", "server.stop_strings",
    "format.tool_parser", "bench.serving_latency", "ops.moe_grouped", "ops.kv_quant",
    "ops.probes", "bench.roofline", "bench.dma_sweep", "bench.sweep_tail", "bench.bench_gemm",
    "bench.llama_bench", "gguf.convert", "utils.profiling")]
print("MISSING", [m for m in need if m not in new])
print("N", sum(n.startswith("llamatpu_torch") for n in new))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert "BAD []" in out and "MISSING []" in out, out
    assert int(out.split("N")[-1]) >= 46, out
