"""The Qwen2 / Qwen2-MoE surface of the port on the CPU against the JAX
package: `validate` reproduces the committed qwen2moe and qwen2 goldens; the
greedy ids of Engine, BatchEngine and PagedBatchEngine on the shrunken
Qwen1.5-MoE preset equal the JAX engines' (impl="pallas"), with and without
rowq; the Qwen pretokenizer against `regex` with QWEN_PATTERN; the ChatML
format with its tool turns; the server's answers and tool calls on a tiny
qwen2moe GGUF; `run`. No kernel launch is counted on the CPU."""
import json
import pathlib
import random
import threading
import urllib.request

import jax.numpy as jnp
import pytest
import regex
import torch
from tiny_models import build_tiny_gguf

from llamatpu.format.chat_format import Message as JMessage
from llamatpu.gguf import GGMLType
from llamatpu.models import loader as jloader
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.runtime.batch_engine import BatchEngine as JBatchEngine
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu.runtime.paged_engine import PagedBatchEngine as JPagedBatchEngine
from llamatpu.server import service as jservice
from llamatpu.server.openai_server import make_server as j_make_server
from llamatpu.tokenizer.adversarial import ADVERSARIAL_TEXTS
from llamatpu.tokenizer.bpe import QWEN_PATTERN
from llamatpu_torch import cli
from llamatpu_torch.bench.validate import PROBE_TEXTS
from llamatpu_torch.format import Message, Role
from llamatpu_torch.format.tool_parser import ToolCall
from llamatpu_torch.models.loader import load_model
from llamatpu_torch.models.synthetic import build_synthetic_model as t_build
from llamatpu_torch.ops import attention, layer_fused, moe_grouped, quant_matmul
from llamatpu_torch.runtime.batch_engine import BatchEngine
from llamatpu_torch.runtime.engine import Engine
from llamatpu_torch.runtime.paged_engine import PagedBatchEngine
from llamatpu_torch.server import service
from llamatpu_torch.server.openai_server import make_server
from llamatpu_torch.tokenizer.bpe import qwen_pieces

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / "fixtures" / "golden"
MOE = dict(dim=128, hidden_dim=512, moe_hidden_dim=128, n_experts=8, n_experts_used=2,
           n_heads=2, n_kv_heads=2, head_dim=64, vocab_size=300)
WRAPPERS = (moe_grouped.grouped_block_matmul, moe_grouped.grouped_packed4_matmul,
            moe_grouped.grouped_rowq_matmul, moe_grouped.grouped_dense_matmul,
            quant_matmul.block_matmul, quant_matmul.rowq_gemv, layer_fused.qkv_norm_fused_rowq,
            layer_fused.layer_attn_tail_fused_rowq, layer_fused.layer_tail_fused_rowq,
            attention.decode_attention_fused_write, attention.decode_attention_paged)
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather of a city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}}]


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
    d = tmp_path_factory.mktemp("qwen")
    out = {}
    for fam in ("qwen2moe", "qwen2"):
        for name, q in (("q8_0", GGMLType.Q8_0), ("q4_0", GGMLType.Q4_0)):
            out[f"{fam}_{name}"] = d / f"{fam}_{name}.gguf"
            build_tiny_gguf(out[f"{fam}_{name}"], family=fam, quant=q, seed=0,
                            with_tokenizer=True)
    return out


@pytest.mark.parametrize("name,extra", [("qwen2moe_q8_0", []), ("qwen2moe_q4_0", []),
                                        ("qwen2moe_q4_0", ["--pack4"]), ("qwen2_q8_0", []),
                                        ("qwen2_q4_0", [])])
def test_validate_reproduces_the_jax_goldens(ggufs, name, extra, capsys):
    """fixtures/golden/{qwen2moe,qwen2}_q{8,4}_0.json hold the JAX CLI's f32
    `validate` results: the port reproduces the greedy ids exactly and the
    quick ppl within 1% (the tiny qwen2moe GGUF does not fold: 96 % 64 != 0,
    so its shared expert runs explicitly beside K10, or K11 with --pack4)."""
    rc = cli.main(["validate", "-m", str(ggufs[name]), "--dtype", "f32", "--device", "cpu",
                   "--golden", str(GOLDEN / f"{name}.json")] + extra)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[PASS] golden-tokens" in out and "[PASS] golden-ppl" in out
    assert "family=QWEN_2" in out


PROMPTS = [[(7 * i + 3) % 300 for i in range(n)] for n in (5, 21, 40)]


def _engines(kind, rowq):
    kw = dict(n_layers=2, dtype="f32", seed=6, context_length=128, overrides=MOE)
    tm, jm = t_build("qwen15-moe-a2.7b", **kw), j_build("qwen15-moe-a2.7b", **kw)
    common = dict(prefill_chunk=16, decode_window=4, rowq=rowq)
    if kind == "single":
        return (Engine(tm, cache_len=128, cache_dtype=torch.float32, device="cpu", **common),
                JEngine(jm, cache_len=128, impl="pallas", cache_dtype=jnp.float32,
                        aot_compile=False, **common))
    common["batch_size"] = 4
    if kind == "paged":
        return (PagedBatchEngine(tm, block_size=8, max_len=128, cache_dtype=torch.float32,
                                 device="cpu", **common),
                JPagedBatchEngine(jm, block_size=8, max_len=128, impl="pallas",
                                  cache_dtype=jnp.float32, **common))
    return (BatchEngine(tm, cache_len=128, cache_dtype=torch.float32, device="cpu", **common),
            JBatchEngine(jm, cache_len=128, impl="pallas", cache_dtype=jnp.float32, **common))


@pytest.mark.parametrize("rowq", [False, True])
@pytest.mark.parametrize("kind", ["single", "batched", "paged"])
def test_engines_greedy_ids_match_jax(kind, rowq):
    """The folded MoE preset, f32, prefill chunks of 16 (the last padded) and
    decode windows of 4: the port's greedy ids equal the JAX engine's.
    Batched: 3 prompts on 4 lanes, so a parked lane routes too (its rows
    must not reach another lane's output)."""
    te, je = _engines(kind, rowq)
    assert te.weights["layers"]["gu_exps"].kind == ("q8_row" if rowq else "q8_0")
    if kind == "single":
        assert te.generate(PROMPTS[2], 10).tokens == je.generate(PROMPTS[2], 10).tokens
    else:
        assert te.generate_batch(PROMPTS, 10) == je.generate_batch(PROMPTS, 10)
    assert all(f.launches == 0 for f in WRAPPERS)


# ----------------------------------------------------------------- tokenizer
def test_qwen_pretokenizer_matches_regex_pattern():
    """qwen_pieces == regex.findall(QWEN_PATTERN) on the probes, the
    adversarial corpus and 3000 random strings: one digit per number piece,
    contractions in ASCII case only (no 'ſ')."""
    pat = regex.compile(QWEN_PATTERN)
    rng = random.Random(1)
    alphabet = list(" \t\r\n\x0b\x1c  　'abSTLDſ12345١٢.,!?-_日本é́👩‍🏽")
    texts = PROBE_TEXTS + ADVERSARIAL_TEXTS + ["'S 'LL 'ſ 're 2024", "x  y", "?!\n\n\rx"] + [
        "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 24))) for _ in range(3000)]
    for t in texts:
        assert qwen_pieces(t) == pat.findall(t), repr(t)
    assert qwen_pieces("'S 'ſ 123") == ["'S", " '", "ſ", " ", "1", "2", "3"]


@pytest.fixture(scope="module")
def qwen_models(ggufs):
    path = str(ggufs["qwen2moe_q8_0"])
    return load_model(path, param_dtype=torch.float32), \
        jloader.load_model(path, param_dtype=jnp.float32)


def test_token_ids_and_chat_format_match_jax(qwen_models):
    """Token ids and decoded text on every probe; ChatML prompts (with and
    without a system prompt), stop tokens, defaults 0.8 / 0.9, the tool
    system suffix, the assistant tool-call turn and the tool-result turn."""
    tm, jm = qwen_models
    tok, jtok = tm.tokenizer, jm.tokenizer
    for text in PROBE_TEXTS + ["<|im_start|>user\nhi<|im_end|>"]:
        for allowed in ("none", "all"):
            ids = tok.encode(text, allowed_special=allowed)
            assert ids == jtok.encode(text, allowed_special=allowed)
            assert tok.decode(ids) == jtok.decode(ids)
    fmt, jfmt = tm.chat_format, jm.chat_format
    for system in (None, "You are terse."):
        for text in ("Why is the sky blue?", "  padded\n", ADVERSARIAL_TEXTS[1]):
            assert fmt.build_prompt([Message(Role.USER, text)], system_prompt=system) == \
                jfmt.build_prompt([JMessage("user", text)], system_prompt=system)
    fim = [("fim_prefix", "def f(x):\n"), ("fim_suffix", "\n    return y"), ("fim_middle", "")]
    assert fmt.build_prompt([Message(r, c) for r, c in fim], append_assistant_header=False) == \
        jfmt.build_prompt([JMessage(r, c) for r, c in fim], append_assistant_header=False)
    assert fmt.stop_tokens() == jfmt.stop_tokens() and fmt.stop_tokens()
    assert fmt.begin_of_text() == jfmt.begin_of_text() and not fmt.add_begin_of_text
    assert (fmt.default_temperature(), fmt.default_top_p()) == (0.8, 0.9) == \
        (jfmt.default_temperature(), jfmt.default_top_p())
    assert fmt.supports_tool_calling() and jfmt.supports_tool_calling()
    tools = json.dumps(TOOLS)
    assert fmt.tool_system_prompt_suffix(tools) == jfmt.tool_system_prompt_suffix(tools)
    from llamatpu.format.tool_parser import ToolCall as JToolCall

    calls = [ToolCall("get_weather", '{"city": "Paris"}', "call_0")]
    jcalls = [JToolCall("get_weather", '{"city": "Paris"}', "call_0")]
    assert fmt.encode_tool_call_assistant_turn(calls) == \
        jfmt.encode_tool_call_assistant_turn(jcalls)
    assert fmt.encode_tool_result_turn("call_0", "get_weather", '{"t": 21}') == \
        jfmt.encode_tool_result_turn("call_0", "get_weather", '{"t": 21}')
    text = '<tool_call>\n{"name":"get_weather","arguments":{"city":"Oslo"}}\n</tool_call>'
    got = [(c.name, c.arguments_json) for c in fmt.extract_all_tool_calls(text)]
    assert got == [(c.name, c.arguments_json) for c in jfmt.extract_all_tool_calls(text)]
    assert got[0][0] == "get_weather"


# ----------------------------------------------------------------- server
def _serve(svc, make):
    srv = make(svc, "127.0.0.1", 0, model_id="tiny-qwen")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_server_answers_and_tool_calls_equal_the_jax_server(qwen_models):
    """The tiny qwen2moe GGUF behind the JAX server, the port's single
    engine and the port's paged batcher: greedy chat answers (with and
    without tool definitions, with an assistant tool call and a tool result
    in the history) and a raw completion are equal; prompt ids and stop
    tokens of tool requests equal the JAX package's."""
    tm, jm = qwen_models
    jsvc = jservice.InferenceService(jm, JEngine(jm, cache_dtype=jnp.float32, aot_compile=False,
                                                 decode_window=4))
    tsvc = service.InferenceService(tm, Engine(tm, cache_dtype=torch.float32, decode_window=4,
                                               device="cpu"))
    peng = PagedBatchEngine(tm, batch_size=2, block_size=8, prefill_chunk=16, decode_window=4,
                            cache_dtype=torch.float32, device="cpu")
    bsvc = service.BatchedInferenceService(tm, peng, interleave_decode_steps=2)
    started = [_serve(jsvc, j_make_server), _serve(tsvc, make_server), _serve(bsvc, make_server)]
    history = [{"role": "user", "content": "weather?"},
               {"role": "assistant", "content": "", "tool_calls": [
                   {"id": "call_0", "function": {"name": "get_weather",
                                                 "arguments": '{"city": "Paris"}'}}]},
               {"role": "tool", "tool_call_id": "call_0", "name": "get_weather",
                "content": '{"temp": 21}'}]
    bodies = [("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello"}],
                                        "max_tokens": 12, "temperature": 0}),
              ("/v1/chat/completions", {"messages": history, "tools": TOOLS, "max_tokens": 8,
                                        "temperature": 0}),
              ("/v1/completions", {"prompt": "The capital of France is", "max_tokens": 8,
                                   "temperature": 0})]
    try:
        for route, body in bodies:
            want = _post(started[0][1] + route, body)[1]
            for _, url in started[1:]:
                got = _post(url + route, body)[1]
                assert got["choices"] == want["choices"], (url, route)
                assert got["usage"]["completion_tokens"] == want["usage"]["completion_tokens"]
        req = dict(messages=history, tools_json=json.dumps(TOOLS))
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


# ----------------------------------------------------------------- CLI
def test_run_streams_text_at_the_qwen_defaults(ggufs, capsys):
    """`run --device cpu` on the tiny qwen2moe and qwen2 GGUFs at the family's
    defaults (temperature 0.8, top-p 0.9) streams text; the same seed gives
    the same text; --rowq serves the experts as q8_row; --ep raises naming
    the parallelism slice."""
    for name in ("qwen2moe_q8_0", "qwen2_q8_0"):
        argv = ["run", "-m", str(ggufs[name]), "-p", "hello world", "--device", "cpu", "-n", "40",
                "--seed", "3", "--metrics-format", "none"]
        assert cli.main(argv) == 0
        first = capsys.readouterr().out
        assert first.strip()
        assert cli.main(argv) == 0 and capsys.readouterr().out == first
    assert cli.main(argv[:-2] + ["--rowq", "--temperature", "0", "--metrics-format",
                                 "none"]) == 0
    e = Engine(load_model(str(ggufs["qwen2moe_q8_0"])), rowq=True, device="cpu")
    assert e.weights["layers"]["gu_exps"].kind == "q8_row"
    with pytest.raises(NotImplementedError, match="parallelism"):
        cli.main(["run", "-m", str(ggufs["qwen2moe_q8_0"]), "-p", "hi", "--device", "cpu",
                  "--ep"])
    assert all(f.launches == 0 for f in WRAPPERS)
