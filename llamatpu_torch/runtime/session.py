"""High-level run modes (the port of llamatpu/runtime/session.py):
instruct-once and interactive chat with KV continuation across turns."""
from __future__ import annotations

import sys

from llamatpu_torch.format.chat_format import Message, Role
from llamatpu_torch.models.loader import LoadedModel
from llamatpu_torch.runtime.engine import Engine
from llamatpu_torch.tokenizer.stream import StreamDecoder


def run_instruct_once(model: LoadedModel, engine: Engine, prompt: str,
                      system_prompt: str | None = None, max_new_tokens: int = 512,
                      stream: bool = True, echo: bool = False, out=None,
                      enable_thinking: bool = True) -> str:
    fmt = model.chat_format
    out = out or sys.stdout
    tokens = fmt.build_prompt([Message(Role.USER, prompt)], system_prompt=system_prompt)
    tokens.extend(fmt.encode_thinking_control(enable_thinking))
    stop = fmt.stop_tokens()
    # max_new_tokens bounds TOTAL positions (prompt + generation)
    budget = max(1, min(max_new_tokens, engine.cache_len) - len(tokens))

    pieces: list[str] = []
    sd = StreamDecoder(model.tokenizer)

    if fmt.include_reasoning and stream:
        out.write("<think>\n")

    def on_token(t):
        text = sd.push(t)
        if text:
            pieces.append(text)
            if stream:
                out.write(text)
                out.flush()

    engine.generate(tokens, budget, stop_tokens=stop, on_token=on_token, echo=echo)
    tail = sd.flush()
    if tail:
        pieces.append(tail)
        if stream:
            out.write(tail)
    if stream:
        out.write("\n")
    text = "".join(pieces)
    if fmt.include_reasoning and not stream:
        text = "<think>\n" + text
    return text


class ChatSession:
    """Interactive multi-turn chat with KV-cache continuation: the cache
    position carries over from turn to turn."""

    def __init__(self, model: LoadedModel, engine: Engine,
                 system_prompt: str | None = None, enable_thinking: bool = True):
        self.model = model
        self.engine = engine
        self.fmt = model.chat_format
        self.enable_thinking = enable_thinking
        self.pos = 0
        self._pending: list[int] = []
        if self.fmt.add_begin_of_text:
            bot = self.fmt.begin_of_text()
            if bot >= 0:
                self._pending.append(bot)
        if system_prompt is not None and self.fmt.add_system_prompt:
            self._pending.extend(self.fmt.encode_message(Message(Role.SYSTEM, system_prompt)))

    def send(self, user_text: str, max_new_tokens: int = 512, on_text=None) -> str:
        tokens = list(self._pending)
        self._pending = []
        tokens.extend(self.fmt.encode_message(Message(Role.USER, user_text)))
        tokens.extend(self.fmt.encode_header(Message(Role.ASSISTANT, "")))
        tokens.extend(self.fmt.encode_thinking_control(self.enable_thinking))

        sd = StreamDecoder(self.model.tokenizer)
        pieces: list[str] = []

        def on_token(t):
            text = sd.push(t)
            if text:
                pieces.append(text)
                if on_text:
                    on_text(text)

        res = self.engine.generate(tokens, max_new_tokens,
                                   stop_tokens=self.fmt.stop_tokens(),
                                   on_token=on_token, start_pos=self.pos)
        tail = sd.flush()
        if tail:
            pieces.append(tail)
            if on_text:
                on_text(tail)
        # the final generated token's KV was never written (decode writes a
        # token's KV when it is fed back, and generation stops before feeding
        # it): re-feed it at the start of the next turn
        if res.tokens:
            self._pending = [res.tokens[-1]] + self._pending
            self.pos += len(tokens) + len(res.tokens) - 1
        else:
            self.pos += len(tokens)
        return "".join(pieces)


def run_interactive(model: LoadedModel, engine: Engine, system_prompt=None,
                    max_new_tokens: int = 512, enable_thinking: bool = True) -> None:
    session = ChatSession(model, engine, system_prompt, enable_thinking)
    print("llamatpu_torch interactive — /exit to quit", file=sys.stderr)
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            break
        if line.strip() in ("/exit", "/quit"):
            break
        if not line.strip():
            continue
        session.send(line, max_new_tokens,
                     on_text=lambda s: (sys.stdout.write(s), sys.stdout.flush()))
        print()
