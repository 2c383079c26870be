"""The port's OpenAI server on the CPU against the JAX package's, over real
HTTP on 127.0.0.1 with the same tiny Q8_0 GGUF: the endpoints, the 400s, the
JSON and SSE shapes byte for byte apart from ids and timestamps, and the
greedy text, both behind the single-sequence InferenceService and behind the
continuous batcher over a PagedBatchEngine (concurrent requests, fewer lanes
than requests). Also encode_request with tools, the tool-call parser and the
stop-string matcher against the JAX package's copies, and the `serve`
command line. On the CPU no kernel launch is counted."""
import json
import re
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tiny_models import build_tiny_gguf

from llamatpu.format.tool_parser import parse_all_tool_calls as j_parse_all
from llamatpu.gguf import GGMLType
from llamatpu.models import loader as jloader
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu.server import service as jservice
from llamatpu.server.openai_server import make_server as j_make_server
from llamatpu.server.stop_strings import StopStringMatcher as JMatcher
from llamatpu_torch import cli
from llamatpu_torch.format.tool_parser import parse_all_tool_calls
from llamatpu_torch.models.loader import load_model
from llamatpu_torch.ops import attention, layer_fused, quant_matmul
from llamatpu_torch.runtime.engine import Engine
from llamatpu_torch.runtime.paged_engine import PagedBatchEngine
from llamatpu_torch.server import service
from llamatpu_torch.server.openai_server import make_server
from llamatpu_torch.server.stop_strings import StopStringMatcher

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


def _serve(svc, make):
    srv = make(svc, "127.0.0.1", 0, model_id="tiny-test")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(jax url, port url, port batched url, port model, jax model, batcher):
    the JAX server and the port's two services on one tiny Q8_0 GGUF, f32."""
    path = tmp_path_factory.mktemp("srv") / "m.gguf"
    build_tiny_gguf(path, family="llama", quant=GGMLType.Q8_0, with_tokenizer=True, seed=5)
    jm = jloader.load_model(str(path), param_dtype=jnp.float32)
    jsvc = jservice.InferenceService(jm, JEngine(jm, cache_dtype=jnp.float32,
                                                 aot_compile=False, decode_window=4))
    tm = load_model(str(path), param_dtype=torch.float32)
    tsvc = service.InferenceService(tm, Engine(tm, cache_dtype=torch.float32, decode_window=4,
                                               device="cpu"))
    peng = PagedBatchEngine(tm, batch_size=2, block_size=8, prefill_chunk=16, decode_window=4,
                            cache_dtype=torch.float32, device="cpu")
    bsvc = service.BatchedInferenceService(tm, peng, interleave_decode_steps=2)
    started = [_serve(jsvc, j_make_server), _serve(tsvc, make_server), _serve(bsvc, make_server)]
    yield (*(url for _, url in started), tm, jm, bsvc.batcher)
    for srv, _ in started:
        srv.shutdown()
    bsvc.batcher.shutdown()


def _request(url, body=None, raw=False):
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            out = r.read()
            return r.status, out if raw else json.loads(out)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _normalized(text: str, cached: bool = True) -> str:
    """A response with its ids and timestamps blanked (and its count of
    prefix-cached prompt tokens, with cached=False)."""
    text = re.sub(r'"id": "(chatcmpl|cmpl)-\d+"', r'"id": "\1-N"', text)
    if not cached:
        text = re.sub(r'"cached_tokens": \d+', '"cached_tokens": 0', text)
    return re.sub(r'"created": \d+', '"created": 0', text)


CHAT = {"messages": [{"role": "system", "content": "Be brief."},
                     {"role": "user", "content": "hello there"}],
        "max_tokens": 12, "temperature": 0}
BODIES = [
    ("/v1/chat/completions", CHAT),
    ("/v1/chat/completions", {**CHAT, "stream": True}),
    ("/v1/chat/completions", {**CHAT, "stream": True, "stream_options": {"include_usage": True},
                              "messages": [{"role": "user", "content": "count to ten"}]}),
    ("/v1/completions", {"prompt": "The capital of France is", "max_tokens": 10}),
    ("/v1/completions", {"prompt": "Once upon a time", "max_tokens": 9, "stream": True}),
    ("/v1/chat/completions", {**CHAT, "tools": TOOLS}),
    ("/v1/chat/completions", {**CHAT, "tools": TOOLS, "stream": True}),
]


@pytest.mark.parametrize("which", ["single", "batched"])
def test_responses_equal_the_jax_servers(servers, which):
    """Every response (JSON and SSE, greedy, tools on and off) equals the
    JAX server's byte for byte once ids and timestamps are blanked; the
    SSE stream starts with the role delta and ends with `data: [DONE]`. The
    JAX server reuses the single engine's cached prefix token by token, the
    paged pool whole blocks, so the batched service's cached-token counts
    are blanked too."""
    jurl, turl, burl = servers[:3]
    url = turl if which == "single" else burl
    for route, body in BODIES:
        js, jraw = _request(jurl + route, body, raw=True)
        ts, traw = _request(url + route, body, raw=True)
        assert js == ts == 200
        single = which == "single"
        assert _normalized(traw.decode(), single) == _normalized(jraw.decode(), single), \
            (route, body)
        if body.get("stream"):
            lines = [ln for ln in traw.decode().split("\n\n") if ln]
            assert lines[-1] == "data: [DONE]"
            first = json.loads(lines[0][6:])
            if route.endswith("chat/completions"):
                assert first["choices"][0]["delta"] == {"role": "assistant"}
        else:
            u = json.loads(traw)["usage"]
            assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"] > 0
    assert all(f.launches == 0 for f in (attention.decode_attention_paged,
                                         layer_fused.layer_tail_fused_rowq,
                                         quant_matmul.block_matmul))


def test_concurrent_requests_share_the_batch(servers):
    """Six concurrent greedy requests on two paged lanes: each text equals
    the JAX server's answer to it alone; the batcher records no error and a
    repeated prompt is served partly from the prefix cache."""
    jurl, _, burl, _, _, batcher = servers
    bodies = [{"messages": [{"role": "user", "content": f"question {i} " * (1 + i % 2)}],
               "max_tokens": 5 + 2 * i, "temperature": 0} for i in range(6)]
    want = [_request(jurl + "/v1/chat/completions", b)[1] for b in bodies]
    # budgets clear of the 64-row context (the batched service keeps one row
    # more of slack than the single one, as in the JAX package)
    assert all(w["usage"]["prompt_tokens"] + b["max_tokens"] + 2 <= 64
               for w, b in zip(want, bodies))
    got = [None] * len(bodies)

    def go(i):
        got[i] = _request(burl + "/v1/chat/completions", bodies[i])[1]

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    for g, w in zip(got, want):
        assert g["choices"] == w["choices"]
        assert g["usage"]["completion_tokens"] == w["usage"]["completion_tokens"]
    again = _request(burl + "/v1/chat/completions", bodies[5])[1]
    assert again["choices"] == want[5]["choices"]
    assert again["usage"]["prompt_tokens_details"]["cached_tokens"] > 0
    assert batcher.errors == []


@pytest.mark.parametrize("which", [0, 1, 2])
def test_endpoints_and_bad_requests(servers, which):
    """GET /health, /v1/models and /, 404s, and the 400s of the JAX server
    (tests/test_server.py), with the same bodies."""
    jurl, url = servers[0], servers[which]
    assert _request(url + "/health") == (200, {"status": "ok"})
    assert _request(url + "/v1/models") == _request(jurl + "/v1/models")
    with urllib.request.urlopen(url + "/", timeout=30) as r:
        assert r.status == 200 and b"/v1/chat/completions" in r.read()
    bad = [("/v1/chat/completions", {"messages": []}), ("/v1/completions", {"prompt": ""}),
           ("/v1/chat/completions", {**CHAT, "max_tokens": 0}),
           ("/v1/chat/completions", {**CHAT, "temperature": 3}),
           ("/v1/chat/completions", {**CHAT, "top_p": 0}),
           ("/v1/chat/completions", {**CHAT, "temperature": "hot"}),
           ("/v1/chat/completions", b"{not json"), ("/v1/nothing", CHAT)]
    for route, body in bad:
        got, want = _request(url + route, body), _request(jurl + route, body)
        assert got[0] in (400, 404) and got[0] == want[0], (route, body)
        assert got[1]["error"]["type"] == "invalid_request_error"
        if route != "/v1/chat/completions" or body != b"{not json":
            assert got == want  # the JSON decoder's message differs between runs
    assert _request(url + "/v1/nothing")[0] == 404


def test_stop_strings_and_sampled_requests(servers):
    """The OpenAI `stop` parameter cuts the text where the JAX server cuts
    it; a sampled request (temperature 0.8, seed) answers 200 with a finish
    reason on both services."""
    jurl, turl, burl = servers[:3]
    plain = _request(jurl + "/v1/completions", {"prompt": "abc", "max_tokens": 16})[1]
    text = plain["choices"][0]["text"]
    stop = text[3:5] if len(text) >= 5 else None
    body = {"prompt": "abc", "max_tokens": 16, "stop": stop}
    want = _request(jurl + "/v1/completions", body)[1]
    for url in (turl, burl):
        got = _request(url + "/v1/completions", body)[1]
        assert got["choices"] == want["choices"]
        s = _request(url + "/v1/chat/completions",
                     {**CHAT, "temperature": 0.8, "top_p": 0.9, "seed": 3})
        assert s[0] == 200 and s[1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_encode_request_with_tools_equals_jax(servers):
    """Prompt ids of chat requests with tool definitions, an assistant tool
    call and a tool result turn, and raw completions, equal JAX's; the stop
    set with tools adds <|eom_id|> where the vocab has it."""
    tm, jm = servers[3], servers[4]
    msgs = [{"role": "system", "content": "sys"}, {"role": "user", "content": "weather?"},
            {"role": "assistant", "content": "", "tool_calls": [
                {"id": "call_0", "function": {"name": "get_weather",
                                              "arguments": '{"city": "Paris"}'}}]},
            {"role": "tool", "tool_call_id": "call_0", "name": "get_weather",
             "content": '{"temp": 21}'},
            {"role": "user", "content": "and tomorrow?"}]
    for kw in (dict(messages=msgs, tools_json=json.dumps(TOOLS)), dict(messages=msgs[1:2]),
               dict(messages=[{"role": "user", "content": "raw text"}], raw_prompt=True)):
        got = service.encode_request(tm, service.Request(**kw))
        want = jservice.encode_request(jm, jservice.Request(**kw))
        assert got == want and got
        assert service.stop_tokens_for(tm, service.Request(**kw)) == \
            jservice.stop_tokens_for(jm, jservice.Request(**kw))


TOOL_TEXTS = [
    '<|python_tag|>{"name": "get_weather", "parameters": {"city": "Paris"}}',
    '<tool_call>{"name": "f", "arguments": {"s": "a}b\\"c"}}</tool_call>'
    '<tool_call>{"name": "g", "arguments": {}}</tool_call>',
    '<tool_call>{"name": "unclosed", "arguments": {"x": [1, 2]}}',
    '{"name": "raw", "parameters": {"q": 1}}',
    '```json\n{"name": "fenced", "arguments": {"k": {"n": 2}}}\n```',
    "no call here", "", '{"name": 3}', '<tool_call>not json</tool_call>',
]


def test_tool_call_parser_equals_jax():
    for text in TOOL_TEXTS:
        got = [(c.name, c.arguments_json, c.call_id) for c in parse_all_tool_calls(text)]
        want = [(c.name, c.arguments_json, c.call_id) for c in j_parse_all(text)]
        assert got == want, text


def test_stop_string_matcher_equals_jax_on_random_feeds():
    rng = np.random.default_rng(0)
    alphabet = list("abc d")
    for _ in range(300):
        stops = ["".join(rng.choice(alphabet, rng.integers(1, 4)))
                 for _ in range(rng.integers(0, 4))]
        t, j = StopStringMatcher(stops), JMatcher(stops)
        for _ in range(rng.integers(1, 12)):
            piece = "".join(rng.choice(alphabet, rng.integers(0, 5)))
            assert t.feed(piece) == j.feed(piece), (stops, piece)
        assert t.flush() == j.flush() and t.stopped == j.stopped


def test_serve_command_line(servers, monkeypatch):
    """`serve` without --device asks for the card and raises without one,
    before loading anything, --spec-decode too; --spec-decode (since slice
    21) reaches the batch-1 Engine `build_service` makes; the parser takes
    the serving flags."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "-m", "missing.gguf"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "-m", "missing.gguf", "--spec-decode", "2"])
    from types import SimpleNamespace

    from llamatpu_torch.runtime import engine
    from llamatpu_torch.server.openai_server import build_service

    made = []
    monkeypatch.setattr(engine, "Engine", lambda model, **kw: made.append(kw) or kw)
    for extra, k in ((["--spec-decode", "2"], 2), ([], 0)):
        args = cli.build_parser().parse_args(["serve", "-m", "m.gguf", "--device", "cpu"] + extra)
        build_service(args, SimpleNamespace(cfg=SimpleNamespace(context_length=64)))
        assert made[-1]["spec_decode"] == k
    args = cli.build_parser().parse_args(
        ["serve", "-m", "m.gguf", "--batch-size", "8", "--paged", "--kv-blocks", "64",
         "--kv-block-size", "8", "--no-prefix-cache", "--interleave-decode-steps", "2",
         "--host", "0.0.0.0", "--port", "9000"])
    assert (args.batch_size, args.paged, args.kv_blocks, args.kv_block_size, args.no_prefix_cache,
            args.interleave_decode_steps, args.port, args.device) == \
        (8, True, 64, 8, True, 2, 9000, "cuda")


def test_build_service_follows_the_flags(servers, tmp_path):
    """`serve`'s flags pick the service and engine: batch size 1 the locked
    single-sequence Engine, N lanes a BatchEngine, --paged a PagedBatchEngine
    with the pool and prefix-cache flags; the paged one answers a request."""
    from llamatpu_torch.runtime.batch_engine import BatchEngine
    from llamatpu_torch.server.openai_server import build_service

    path = tmp_path / "m.gguf"
    build_tiny_gguf(path, family="llama", quant=GGMLType.Q8_0, with_tokenizer=True, seed=5)
    base = ["serve", "-m", str(path), "--device", "cpu", "--dtype", "f32", "-n", "64"]
    for extra, svc_type, eng_type in (
            ([], service.InferenceService, Engine),
            (["--batch-size", "2"], service.BatchedInferenceService, BatchEngine),
            (["--batch-size", "2", "--paged", "--kv-blocks", "12", "--kv-block-size", "8",
              "--no-prefix-cache", "--interleave-decode-steps", "2"],
             service.BatchedInferenceService, PagedBatchEngine)):
        args = cli.build_parser().parse_args(base + extra)
        model, _ = cli.load(args)
        svc = build_service(args, model)
        assert type(svc) is svc_type and type(svc.engine) is eng_type
        assert svc.engine.device == torch.device("cpu") and svc.engine.cache_len == 64
        if eng_type is PagedBatchEngine:
            assert (svc.engine.n_blocks, svc.engine.block_size, svc.engine.prefix_cache) == \
                (12, 8, False)
            assert svc.batcher.interleave_decode_steps == 2
            srv, url = _serve(svc, make_server)
            try:
                status, body = _request(url + "/v1/chat/completions", CHAT)
            finally:
                srv.shutdown()
            assert status == 200 and body["usage"]["completion_tokens"] > 0
            assert svc.batcher.errors == []
        if hasattr(svc, "batcher"):
            svc.batcher.shutdown()
