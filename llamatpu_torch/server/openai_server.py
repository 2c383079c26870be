"""OpenAI-compatible HTTP server of the port (llamatpu/server/
openai_server.py): POST /v1/chat/completions and /v1/completions, streamed
as SSE (a role delta first, content deltas, a final empty delta with the
finish reason, `data: [DONE]`) or whole with usage counts; GET /v1/models,
/health and an HTML index at /. Standard library only (http.server). The
response shapes, error codes and SSE framing are the JAX server's.

Behind it, `serve` builds the single-sequence `Engine` with the locked
`InferenceService` (--batch-size 1), or a `BatchEngine` / `PagedBatchEngine`
(--paged) behind the continuous batcher (`BatchedInferenceService`). Handler
threads only read and write HTTP and consume token streams; the batcher's
thread launches the kernels.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from llamatpu_torch.format.chat_format import Message
from llamatpu_torch.server.service import InferenceService, Request

_INDEX_HTML = """<!doctype html><html><head><title>llamatpu</title></head>
<body><h1>llamatpu OpenAI-compatible server</h1>
<p>Endpoints: POST /v1/chat/completions, POST /v1/completions,
GET /v1/models, GET /health</p></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    service: InferenceService = None
    model_id: str = "llamatpu"
    protocol_version = "HTTP/1.1"
    _seq = [0]
    _seq_lock = threading.Lock()

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # -- helpers ----------------------------------------------------------
    def _send_json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, code: int, message: str) -> None:
        self._send_json(code, {"error": {"message": message, "type": "invalid_request_error"}})

    def _next_id(self, prefix: str) -> str:
        with self._seq_lock:
            self._seq[0] += 1
            return f"{prefix}{self._seq[0]}"

    # -- routes -----------------------------------------------------------
    def do_GET(self):
        if self.path == "/health":
            self._send_json(200, {"status": "ok"})
        elif self.path == "/v1/models":
            self._send_json(200, {"object": "list", "data": [
                {"id": self.model_id, "object": "model", "created": 0,
                 "owned_by": "llamatpu"}]})
        elif self.path in ("/", "/index.html"):
            body = _INDEX_HTML.encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send_error_json(404, f"no such endpoint: {self.path}")

    def do_POST(self):
        if self.path == "/v1/chat/completions":
            self._handle_completion(chat=True)
        elif self.path == "/v1/completions":
            self._handle_completion(chat=False)
        else:
            self._send_error_json(404, f"no such endpoint: {self.path}")

    def _handle_completion(self, chat: bool) -> None:
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length).decode("utf-8"))
        except Exception as e:
            self._send_error_json(400, f"Invalid JSON body: {e}")
            return

        messages: list = []
        tools_json = None
        if chat:
            msgs = body.get("messages")
            if not isinstance(msgs, list) or not msgs:
                self._send_error_json(400, "'messages' must be a non-empty array")
                return
            messages = [m if isinstance(m, dict) else {"role": "user", "content": str(m)}
                        for m in msgs]
            tools = body.get("tools")
            if isinstance(tools, list) and tools:
                tools_json = json.dumps(tools)
        else:
            prompt = body.get("prompt", "")
            if not isinstance(prompt, str) or not prompt:
                self._send_error_json(400, "'prompt' must be a non-empty string")
                return
            messages.append(Message("user", prompt))

        stop = body.get("stop")  # OpenAI: string or array of up to 4 strings
        if isinstance(stop, str):
            stop = [stop]
        if isinstance(stop, list):
            stop = [s for s in stop if isinstance(s, str) and s][:4] or None
        else:
            stop = None

        try:
            max_tokens = int(body.get("max_tokens",
                                      body.get("max_completion_tokens", 256)))
            temperature = float(body.get("temperature", 0.0))
            top_p = float(body.get("top_p", 0.95))
        except (TypeError, ValueError) as e:
            self._send_error_json(400, f"invalid sampling parameter: {e}")
            return
        # the official client's server-side validation surface: clients rely
        # on a 400 (not a 200 with garbage) for out-of-range parameters
        if max_tokens < 1:
            self._send_error_json(
                400, "'max_tokens' must be a positive integer")
            return
        if not (0.0 <= temperature <= 2.0):
            self._send_error_json(
                400, "'temperature' must be between 0 and 2")
            return
        if not (0.0 < top_p <= 1.0):
            self._send_error_json(400, "'top_p' must be in (0, 1]")
            return
        req = Request(
            messages=messages,
            max_tokens=max_tokens,
            temperature=temperature,
            top_p=top_p,
            seed=int(body.get("seed", 1234)),
            raw_prompt=not chat,
            tools_json=tools_json,
            stop=stop,
        )
        rid = self._next_id("chatcmpl-" if chat else "cmpl-")
        created = int(time.time())
        if body.get("stream", False):
            include_usage = bool(
                (body.get("stream_options") or {}).get("include_usage"))
            self._stream_response(req, rid, created, chat, include_usage)
        else:
            self._full_response(req, rid, created, chat)

    # -- responses --------------------------------------------------------
    def _full_response(self, req, rid, created, chat) -> None:
        try:
            r = self.service.generate(req)
        except Exception as e:
            self._send_error_json(500, f"generation failed: {e}")
            return
        if chat:
            message = {"role": "assistant", "content": r.text}
            finish = r.finish_reason
            if req.tools_json:
                fmt = self.service.model.chat_format
                calls = fmt.extract_all_tool_calls(r.text)
                if calls:
                    message = {"role": "assistant", "content": None,
                               "tool_calls": [
                                   {"id": f"call_{i}", "type": "function",
                                    "function": {"name": tc.name,
                                                 "arguments": tc.arguments_json}}
                                   for i, tc in enumerate(calls)]}
                    finish = "tool_calls"
            choice = {"index": 0, "message": message, "finish_reason": finish}
            obj = "chat.completion"
        else:
            choice = {"index": 0, "text": r.text, "finish_reason": r.finish_reason}
            obj = "text_completion"
        self._send_json(200, {
            "id": rid, "object": obj, "created": created, "model": self.model_id,
            "choices": [choice],
            "usage": {"prompt_tokens": r.prompt_tokens,
                      "completion_tokens": r.completion_tokens,
                      "total_tokens": r.prompt_tokens + r.completion_tokens,
                      "prompt_tokens_details": {
                          "cached_tokens": getattr(r, "cached_tokens", 0)}},
        })

    def _chunk(self, rid, obj, created, delta, finish, chat) -> bytes:
        choice = {"index": 0, "finish_reason": finish}
        if chat:
            choice["delta"] = delta
        else:
            choice.update(delta)
        payload = {"id": rid, "object": obj, "created": created,
                   "model": self.model_id, "choices": [choice]}
        return f"data: {json.dumps(payload)}\n\n".encode("utf-8")

    def _stream_response(self, req, rid, created, chat,
                         include_usage: bool = False) -> None:
        obj = "chat.completion.chunk" if chat else "text_completion"
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def write_chunk(data: bytes):
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        if chat:  # first chunk carries the assistant role
            write_chunk(self._chunk(rid, obj, created, {"role": "assistant"}, None, chat))

        # with tools active, buffer the output so a tool call can be emitted as
        # OpenAI delta.tool_calls instead of raw <tool_call> text
        buffer_tools = chat and bool(req.tools_json)
        buffered: list[str] = []

        def on_piece(piece: str):
            if buffer_tools:
                buffered.append(piece)
                return
            delta = {"content": piece} if chat else {"text": piece}
            write_chunk(self._chunk(rid, obj, created, delta, None, chat))

        try:
            r = self.service.generate(req, on_piece=on_piece)
            finish = r.finish_reason
            if buffer_tools:
                text = "".join(buffered)
                calls = self.service.model.chat_format.extract_all_tool_calls(text)
                if calls:
                    delta = {"tool_calls": [
                        {"index": i, "id": f"call_{i}", "type": "function",
                         "function": {"name": tc.name, "arguments": tc.arguments_json}}
                        for i, tc in enumerate(calls)]}
                    write_chunk(self._chunk(rid, obj, created, delta, None, chat))
                    finish = "tool_calls"
                elif text:
                    write_chunk(self._chunk(rid, obj, created, {"content": text}, None, chat))
            final_delta = {} if chat else {"text": ""}
            write_chunk(self._chunk(rid, obj, created, final_delta, finish, chat))
            if include_usage:
                # OpenAI stream_options.include_usage: one extra data chunk
                # after the finish chunk with EMPTY choices + the usage object
                payload = {"id": rid, "object": obj, "created": created,
                           "model": self.model_id, "choices": [],
                           "usage": {
                               "prompt_tokens": r.prompt_tokens,
                               "completion_tokens": r.completion_tokens,
                               "total_tokens": (r.prompt_tokens
                                                + r.completion_tokens)}}
                write_chunk(f"data: {json.dumps(payload)}\n\n".encode())
            write_chunk(b"data: [DONE]\n\n")
        finally:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()


def make_server(service: InferenceService, host: str, port: int,
                model_id: str = "llamatpu") -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"service": service, "model_id": model_id})
    return ThreadingHTTPServer((host, port), handler)


def build_service(args, model):
    """The service `serve` runs for the parsed command line: the locked
    single-sequence Engine (batch size 1, with --spec-decode's speculation)
    or the continuous batcher over a BatchEngine / PagedBatchEngine (no
    speculation, as the JAX `serve`)."""
    from llamatpu_torch.cli import cache_dtype

    cache_len = min(args.max_tokens, model.cfg.context_length) if args.max_tokens else None
    common = dict(prefill_chunk=args.prefill_chunk, cache_dtype=cache_dtype(args),
                  rowq=args.rowq, seed=args.seed, device=args.device, impl=args.impl)
    if args.batch_size > 1:
        from llamatpu_torch.server.service import BatchedInferenceService

        if args.paged:
            from llamatpu_torch.runtime.paged_engine import PagedBatchEngine

            engine = PagedBatchEngine(model, batch_size=args.batch_size, max_len=cache_len,
                                      n_blocks=args.kv_blocks or None,
                                      block_size=args.kv_block_size,
                                      prefix_cache=not args.no_prefix_cache, **common)
        else:
            from llamatpu_torch.runtime.batch_engine import BatchEngine

            engine = BatchEngine(model, batch_size=args.batch_size, cache_len=cache_len,
                                 **common)
        return BatchedInferenceService(model, engine,
                                       interleave_decode_steps=args.interleave_decode_steps)
    from llamatpu_torch.runtime.engine import Engine

    engine = Engine(model, cache_len=cache_len, spec_decode=args.spec_decode, **common)
    return InferenceService(model, engine, prefix_cache=not args.no_prefix_cache)


def serve(args) -> None:
    """`python -m llamatpu_torch.cli serve -m model.gguf ...`: load, build the
    service, serve until interrupted."""
    from llamatpu_torch.cli import load
    from llamatpu_torch.runtime.engine import resolve_device

    resolve_device(args.device)  # no card: raise before loading anything
    model, _ = load(args)
    service = build_service(args, model)
    model_id = model.metadata.get("general.name", "llamatpu")
    srv = make_server(service, args.host, args.port, model_id)
    print(f"llamatpu_torch serving {model_id} on http://{args.host}:{srv.server_address[1]} "
          f"({args.device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        batcher = getattr(service, "batcher", None)
        if batcher is not None:
            batcher.shutdown()
