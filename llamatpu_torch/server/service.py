"""Inference services of the port's server (llamatpu/server/service.py):

- `encode_request`: a request's prompt ids (chat template, tool injection,
  tool-turn re-encoding, or a raw prompt);
- `InferenceService`: one single-sequence `Engine` behind a lock, with KV
  prefix reuse across requests (a new request's common prefix with the
  tokens already in the cache skips re-prefill; exact, since prefill is
  deterministic and rows past the written length are never attended);
- `BatchedInferenceService`: concurrent requests share a BatchEngine or
  PagedBatchEngine through the ContinuousBatcher.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

from llamatpu_torch.format.chat_format import Message
from llamatpu_torch.format.tool_parser import ToolCall
from llamatpu_torch.models.loader import LoadedModel
from llamatpu_torch.runtime.engine import Engine
from llamatpu_torch.runtime.scheduler import BatchRequest, ContinuousBatcher
from llamatpu_torch.server.stop_strings import StopStringMatcher
from llamatpu_torch.tokenizer.stream import StreamDecoder


@dataclass
class Request:
    messages: list  # Message objects or raw dicts (role/content/tool_calls/...)
    max_tokens: int = 256
    temperature: float = 0.0
    top_p: float = 0.95
    seed: int = 1234
    raw_prompt: bool = False  # /v1/completions: no chat template
    tools_json: str | None = None  # JSON array of tool definitions (OpenAI style)
    stop: list[str] | None = None  # per-request stop strings (OpenAI `stop`)


@dataclass
class Result:
    text: str
    prompt_tokens: int
    completion_tokens: int
    finish_reason: str  # "stop" | "length"
    cached_tokens: int = 0  # prompt tokens served from the KV prefix cache


def _msg_dict(m) -> dict:
    return m if isinstance(m, dict) else {"role": m.role, "content": m.content}


def encode_request(model: LoadedModel, req: Request) -> list[int]:
    """Build the prompt token ids for a request: chat template (with tool
    injection + tool-turn re-encoding per the family format) or raw prompt."""
    fmt = model.chat_format
    tok = model.tokenizer
    if req.raw_prompt:
        prompt_text = "".join(_msg_dict(m).get("content", "") for m in req.messages)
        tokens = []
        bot = fmt.begin_of_text()
        if fmt.add_begin_of_text and bot >= 0:
            tokens.append(bot)
        tokens += tok.encode(prompt_text, allowed_special="all")
        return tokens

    msgs = [_msg_dict(m) for m in req.messages]
    system = None
    rest = []
    for m in msgs:
        if m.get("role") == "system" and system is None:
            system = m.get("content", "")
        else:
            rest.append(m)

    first_user_prefix = ""
    tools = req.tools_json if (req.tools_json and fmt.supports_tool_calling()) else None
    if tools:
        if fmt.injects_tools_in_user_message():
            system = fmt.tool_system_message_prefix() + (system or "")
            first_user_prefix = fmt.tool_first_user_message_prefix(tools)
        else:
            system = (system or "") + fmt.tool_system_prompt_suffix(tools)

    tokens: list[int] = []
    bot = fmt.begin_of_text()
    if fmt.add_begin_of_text and bot >= 0:
        tokens.append(bot)
    if system is not None and fmt.add_system_prompt:
        tokens.extend(fmt.encode_message(Message("system", system)))

    seen_user = False
    for m in rest:
        role = m.get("role", "user")
        if role == "assistant" and m.get("tool_calls"):
            calls = [ToolCall(tc["function"]["name"], tc["function"].get("arguments", "{}"),
                              tc.get("id", ""))
                     for tc in m["tool_calls"]]
            tokens.extend(fmt.encode_tool_call_assistant_turn(calls))
        elif role == "tool":
            tokens.extend(fmt.encode_tool_result_turn(
                m.get("tool_call_id", ""), m.get("name", ""), m.get("content", "")))
        else:
            content = m.get("content", "")
            if role == "user" and not seen_user and first_user_prefix:
                content = first_user_prefix + content
                seen_user = True
            tokens.extend(fmt.encode_message(Message(role, content)))
    tokens.extend(fmt.encode_header(Message("assistant", "")))
    if fmt.include_reasoning:
        tokens.extend(tok.encode("<think>\n", allowed_special="all"))
    return tokens


def stop_tokens_for(model: LoadedModel, req: Request) -> set[int]:
    fmt = model.chat_format
    if req.tools_json and fmt.supports_tool_calling():
        return fmt.tool_aware_stop_tokens()
    return fmt.stop_tokens()


class InferenceService:
    """Thread-safe serialized executor with KV prefix caching: the token
    sequence held in the engine's cache is remembered across requests, and a
    new request's common prefix (a shared system prompt, replayed turns)
    skips re-prefill; generation starts at the divergence point. A warm
    greedy result equals a cold one."""

    def __init__(self, model: LoadedModel, engine: Engine,
                 prefix_cache: bool = True):
        self.model = model
        self.engine = engine
        self.prefix_cache = prefix_cache
        self._cached_tokens: list[int] = []
        self._lock = threading.Lock()

    def generate(self, req: Request, on_piece=None) -> Result:
        with self._lock:
            fmt = self.model.chat_format
            tok = self.model.tokenizer
            tokens = encode_request(self.model, req)
            engine = self.engine
            engine.reseed(req.seed)
            # reuse at most len-1 tokens: the final prompt token must run
            # through prefill to produce the first sampled token's logits
            reuse = 0
            if self.prefix_cache:
                max_reuse = min(len(self._cached_tokens), len(tokens) - 1)
                while reuse < max_reuse and self._cached_tokens[reuse] == tokens[reuse]:
                    reuse += 1
            self._cached_tokens = []  # invalid until generation completes
            budget = min(req.max_tokens, engine.cache_len - len(tokens) - 1)
            if budget <= 0:
                return Result("", len(tokens), 0, "length")

            sd = StreamDecoder(tok)
            matcher = StopStringMatcher(req.stop) if req.stop else None
            pieces: list[str] = []

            def emit(text):
                pieces.append(text)
                if on_piece:
                    on_piece(text)

            def on_token(t):
                text = sd.push(t)
                if not text:
                    return False
                if matcher is None:
                    emit(text)
                    return False
                out, hit = matcher.feed(text)
                if out:
                    emit(out)
                return hit  # truthy return cancels the engine loop

            res = engine.generate(
                tokens[reuse:], budget, start_pos=reuse,
                stop_tokens=stop_tokens_for(self.model, req),
                on_token=on_token, temperature=req.temperature, top_p=req.top_p)
            if self.prefix_cache:
                # decode wrote KV for every generated token except the last
                self._cached_tokens = tokens + res.tokens[:-1]
                m = engine.metrics
                m.extra["prefix_cached_tokens"] = (
                    m.extra.get("prefix_cached_tokens", 0) + reuse)
            if res.stop_reason != "cancelled":
                tail = sd.flush()
                if matcher is not None:
                    if tail:
                        out, _ = matcher.feed(tail)
                        if out:
                            emit(out)
                    held = matcher.flush()
                    if held:
                        emit(held)
                elif tail:
                    emit(tail)
            finish = ("stop" if res.stop_reason in ("stop_token", "cancelled")
                      else "length")
            n_completion = len(res.tokens)
            return Result("".join(pieces), len(tokens), n_completion, finish,
                          cached_tokens=reuse)


class BatchedInferenceService:
    """Continuous-batching service: concurrent requests share a BatchEngine
    or PagedBatchEngine through the ContinuousBatcher; requests are not
    serialized."""

    def __init__(self, model: LoadedModel, batch_engine,
                 interleave_decode_steps: int = 4):
        self.model = model
        self.batcher = ContinuousBatcher(
            batch_engine, model.chat_format.stop_tokens(),
            interleave_decode_steps=interleave_decode_steps)
        self.engine = batch_engine

    def generate(self, req: Request, on_piece=None) -> Result:
        tokens = encode_request(self.model, req)
        budget = min(req.max_tokens, self.engine.cache_len - len(tokens) - 2)
        if budget <= 0:
            return Result("", len(tokens), 0, "length")
        stream = self.batcher.submit(BatchRequest(
            prompt_tokens=tokens, max_new_tokens=budget,
            temperature=req.temperature, top_p=req.top_p))
        sd = StreamDecoder(self.model.tokenizer)
        matcher = StopStringMatcher(req.stop) if req.stop else None
        pieces: list[str] = []

        def emit(text):
            pieces.append(text)
            if on_piece:
                on_piece(text)

        n = 0
        hit = False
        for t in stream:
            n += 1
            text = sd.push(t)
            if not text:
                continue
            if matcher is None:
                emit(text)
                continue
            out, hit = matcher.feed(text)
            if out:
                emit(out)
            if hit:
                stream.cancel()  # frees the lane at the next scheduler step
                break
        if not hit:
            tail = sd.flush()
            if matcher is not None:
                if tail:
                    out, _ = matcher.feed(tail)
                    if out:
                        emit(out)
                held = matcher.flush()
                if held:
                    emit(held)
            elif tail:
                emit(tail)
        finish = "stop" if hit else (stream.finish_reason or "length")
        return Result("".join(pieces), len(tokens), n, finish,
                      cached_tokens=stream.cached_tokens)
