"""Phi-3 in the port on the CPU against the JAX package: `validate`
reproduces the committed phi3 goldens; the SentencePiece tokenizer (byte
fallback, scored merges, the Phi-3 specials) and the chat format give the
JAX package's ids on the tiny phi3 GGUF and on random text; Engine's greedy
ids equal the JAX Engine's (impl="pallas"); the server's answers equal the
JAX server's; `run` streams text at the family's defaults. No kernel launch
is counted on the CPU."""
import json
import pathlib
import random
import threading
import urllib.request

import jax.numpy as jnp
import pytest
import torch
from tiny_models import build_tiny_gguf

from llamatpu.format.chat_format import Message as JMessage
from llamatpu.gguf import GGMLType
from llamatpu.models import loader as jloader
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu.server import service as jservice
from llamatpu.server.openai_server import make_server as j_make_server
from llamatpu.tokenizer.adversarial import ADVERSARIAL_TEXTS
from llamatpu.tokenizer.stream import StreamDecoder as JStreamDecoder
from llamatpu_torch import cli
from llamatpu_torch.bench.validate import PROBE_TEXTS
from llamatpu_torch.format import Message, Phi3ChatFormat, Role
from llamatpu_torch.models.loader import load_model
from llamatpu_torch.ops import ffn_fused, layer_fused, quant_matmul
from llamatpu_torch.runtime.engine import Engine
from llamatpu_torch.runtime.paged_engine import PagedBatchEngine
from llamatpu_torch.server import service
from llamatpu_torch.server.openai_server import make_server
from llamatpu_torch.tokenizer import SPMTokenizer, StreamDecoder

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / "fixtures" / "golden"
WRAPPERS = (quant_matmul.block_matmul, quant_matmul.rowq_gemv, layer_fused.qkv_norm_fused_rowq,
            layer_fused.layer_attn_tail_fused_rowq, layer_fused.layer_tail_fused_rowq,
            ffn_fused.ffn_fused_rowq)
SPECIAL_TEXTS = ["<|user|>\nhi<|end|>\n<|assistant|>", "<s>x</s><unk>", "a<|end|>b<|endoftext|>"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one intra-op thread: the test workers and the JAX
    compiler share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("phi3")
    out = {}
    for name, q in (("q8_0", GGMLType.Q8_0), ("q4_0", GGMLType.Q4_0)):
        out[name] = d / f"phi3_{name}.gguf"
        build_tiny_gguf(out[name], family="phi3", quant=q, seed=0, with_tokenizer=True)
    return out


@pytest.fixture(scope="module")
def phi3_models(ggufs):
    path = str(ggufs["q8_0"])
    return load_model(path, param_dtype=torch.float32), \
        jloader.load_model(path, param_dtype=jnp.float32)


@pytest.mark.parametrize("quant", ["q8_0", "q4_0"])
def test_validate_reproduces_the_phi3_goldens(ggufs, quant, capsys):
    """fixtures/golden/phi3_q{8,4}_0.json hold the JAX CLI's f32 `validate`
    results: the port reproduces the greedy ids exactly and the quick ppl
    within 1%."""
    rc = cli.main(["validate", "-m", str(ggufs[quant]), "--dtype", "f32", "--device", "cpu",
                   "--golden", str(GOLDEN / f"phi3_{quant}.json")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[PASS] golden-tokens" in out and "[PASS] golden-ppl" in out
    assert "family=PHI_3" in out


def test_spm_tokenizer_matches_jax(phi3_models):
    """Token ids, decoded text and streamed text equal the JAX SPM
    tokenizer's on the probes, the special-token texts and 2000 random
    strings (letters, the vocab's merged pieces, spaces, non-ASCII text that
    falls back to <0xNN> bytes); the specials are the GGUF's CONTROL types."""
    tok, jtok = phi3_models[0].tokenizer, phi3_models[1].tokenizer
    assert isinstance(tok, SPMTokenizer)
    assert tok.special_tokens == jtok.special_tokens and "<|end|>" in tok.special_tokens
    rng = random.Random(3)
    alphabet = list("abehilnortw  \n\t.,!?'") + ["the", "hello", "world", "ing", "日本", "é",
                                                  "👩‍🏽", "\ud800"]
    texts = PROBE_TEXTS + SPECIAL_TEXTS + [
        "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 16))) for _ in range(2000)]
    for text in texts:
        for allowed in ("none", "all"):
            ids = tok.encode(text, allowed_special=allowed)
            assert ids == jtok.encode(text, allowed_special=allowed), repr(text)
            assert tok.decode(ids) == jtok.decode(ids)
    ids = tok.encode("héllo 日本 👩‍🏽 world")
    assert any(tok.vocabulary.get(i).startswith("<0x") for i in ids)
    sd, jsd = StreamDecoder(tok), JStreamDecoder(jtok)
    assert [sd.push(i) for i in ids] == [jsd.push(i) for i in ids]
    assert sd.flush() == jsd.flush()


def test_phi3_fallback_specials_match_jax(phi3_models):
    """A Phi-3 vocab without token types: ids >= 32000 and <s>, </s>, <unk>
    by name are special, as in the JAX builder."""
    from llamatpu.models.config import Family as JFamily
    from llamatpu.tokenizer.builders import build_tokenizer as j_build_tokenizer
    from llamatpu_torch.models.config import Family
    from llamatpu_torch.tokenizer import build_tokenizer

    md = dict(phi3_models[0].metadata)
    md.pop("tokenizer.ggml.token_type")
    md["tokenizer.ggml.tokens"] = list(md["tokenizer.ggml.tokens"]) + [
        f"<|placeholder{i}|>" for i in range(32000 - len(md["tokenizer.ggml.tokens"]) + 4)]
    md["tokenizer.ggml.scores"] = list(md["tokenizer.ggml.scores"]) + [0.0] * (
        len(md["tokenizer.ggml.tokens"]) - len(md["tokenizer.ggml.scores"]))
    tok, jtok = build_tokenizer(Family.PHI_3, md), j_build_tokenizer(JFamily.PHI_3, md)
    assert tok.special_tokens == jtok.special_tokens
    names = md["tokenizer.ggml.tokens"]
    assert {"<s>", "</s>", "<unk>"} <= set(tok.special_tokens)
    assert tok.special_tokens[names[32003]] == 32003 and names[31999] not in tok.special_tokens


def test_chat_format_matches_jax(phi3_models):
    """Phi-3 prompts with and without a system prompt, the raw headers, the
    stop tokens <|end|> (and <|endoftext|> where the vocab has it), no
    begin-of-text token, the defaults 0.7 / 0.9."""
    tm, jm = phi3_models
    fmt, jfmt = tm.chat_format, jm.chat_format
    assert isinstance(fmt, Phi3ChatFormat)
    for system in (None, "You are terse."):
        for text in ("Why is the sky blue?", "  padded\n", ADVERSARIAL_TEXTS[1]):
            assert fmt.build_prompt([Message(Role.USER, text)], system_prompt=system) == \
                jfmt.build_prompt([JMessage("user", text)], system_prompt=system)
    turns = [Message(Role.USER, "hi"), Message(Role.ASSISTANT, "hello"), Message("tool", "x")]
    assert fmt.build_prompt(turns) == jfmt.build_prompt([JMessage(m.role, m.content)
                                                         for m in turns])
    assert fmt.stop_tokens() == jfmt.stop_tokens() == {tm.tokenizer.special_tokens["<|end|>"]}
    assert fmt.begin_of_text() == jfmt.begin_of_text() and not fmt.add_begin_of_text
    assert not jfmt.add_begin_of_text
    assert (fmt.default_temperature(), fmt.default_top_p()) == \
        (jfmt.default_temperature(), jfmt.default_top_p())


@pytest.mark.parametrize("quant", ["q8_0", "q4_0"])
def test_engine_greedy_ids_match_jax(ggufs, quant):
    """The tiny phi3 GGUF (fused qkv and gate|up rows split at load), f32,
    prefill chunks of 16 (the last padded) and decode windows of 4: the
    port's Engine gives the JAX Engine's greedy ids."""
    path = str(ggufs[quant])
    tm = load_model(path, param_dtype=torch.float32)
    jm = jloader.load_model(path, param_dtype=jnp.float32)
    te = Engine(tm, cache_len=64, prefill_chunk=16, decode_window=4, cache_dtype=torch.float32,
                device="cpu")
    je = JEngine(jm, cache_len=64, prefill_chunk=16, decode_window=4, impl="pallas",
                 cache_dtype=jnp.float32, aot_compile=False)
    prompt = tm.chat_format.build_prompt([Message(Role.USER, "hello world")])
    assert te.generate(prompt, 12).tokens == je.generate(prompt, 12).tokens
    assert all(f.launches == 0 for f in WRAPPERS)


def _serve(svc, make):
    srv = make(svc, "127.0.0.1", 0, model_id="tiny-phi3")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_server_answers_equal_the_jax_server(phi3_models):
    """The tiny phi3 GGUF behind the JAX server, the port's single engine and
    the port's paged batcher: greedy chat answers (with a system prompt) and
    a raw completion are equal; prompt ids and stop tokens equal the JAX
    package's."""
    tm, jm = phi3_models
    jsvc = jservice.InferenceService(jm, JEngine(jm, cache_dtype=jnp.float32, aot_compile=False,
                                                 decode_window=4))
    tsvc = service.InferenceService(tm, Engine(tm, cache_dtype=torch.float32, decode_window=4,
                                               device="cpu"))
    peng = PagedBatchEngine(tm, batch_size=2, block_size=8, prefill_chunk=16, decode_window=4,
                            cache_dtype=torch.float32, device="cpu")
    bsvc = service.BatchedInferenceService(tm, peng, interleave_decode_steps=2)
    started = [_serve(jsvc, j_make_server), _serve(tsvc, make_server), _serve(bsvc, make_server)]
    msgs = [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "hello"}]
    bodies = [("/v1/chat/completions", {"messages": msgs, "max_tokens": 10, "temperature": 0}),
              ("/v1/completions", {"prompt": "The capital of France is", "max_tokens": 8,
                                   "temperature": 0})]
    try:
        for route, body in bodies:
            want = _post(started[0][1] + route, body)[1]
            for _, url in started[1:]:
                got = _post(url + route, body)[1]
                assert got["choices"] == want["choices"], (url, route)
                assert got["usage"] == want["usage"]
        req = dict(messages=msgs)
        assert service.encode_request(tm, service.Request(**req)) == \
            jservice.encode_request(jm, jservice.Request(**req))
        assert service.stop_tokens_for(tm, service.Request(**req)) == \
            jservice.stop_tokens_for(jm, jservice.Request(**req))
        assert bsvc.batcher.errors == []
    finally:
        for srv, _ in started:
            srv.shutdown()
        bsvc.batcher.shutdown()
    assert all(f.launches == 0 for f in WRAPPERS)


def test_run_streams_text_at_the_phi3_defaults(ggufs, capsys):
    """`run --device cpu` on the tiny phi3 GGUFs at the family's defaults
    streams text, the same seed giving the same text; --rowq serves q8_row."""
    for quant in ("q8_0", "q4_0"):
        argv = ["run", "-m", str(ggufs[quant]), "-p", "hello world", "--device", "cpu", "-n",
                "40", "--seed", "3", "--metrics-format", "none"]
        assert cli.main(argv) == 0
        first = capsys.readouterr().out
        assert first.strip()
        assert cli.main(argv) == 0 and capsys.readouterr().out == first
    assert cli.main(["run", "-m", str(ggufs["q8_0"]), "-p", "hello world", "--device", "cpu",
                     "-n", "40", "--rowq", "--temperature", "0", "--metrics-format", "none"]) == 0
    assert capsys.readouterr().out.strip()
    assert all(f.launches == 0 for f in WRAPPERS)
