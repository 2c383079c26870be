"""Chat formats: prompt templates, stop tokens and default sampling
parameters. The port's copy of the Llama 3 part of
llamatpu/format/chat_format.py (`Message`, `Role`, the `ChatFormat` base,
`LlamaChatFormat`, `build_chat_format`). Tool-calling encodings belong to
the serving slice and the other families' formats to the family-deltas
slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

from llamatpu_torch.models.config import Family


@dataclass(frozen=True)
class Message:
    role: str
    content: str


class Role:
    SYSTEM = "system"
    USER = "user"
    ASSISTANT = "assistant"


class ChatFormat:
    """Base chat format. Subclasses set family-specific behavior."""

    # prompt assembly policy
    add_begin_of_text = True
    add_system_prompt = True
    include_reasoning = False  # a forced "<think>\n" primer (DeepSeek-R1 distills)

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    # -- interface --------------------------------------------------------
    def encode_header(self, message: Message) -> list[int]:
        raise NotImplementedError

    def encode_message(self, message: Message) -> list[int]:
        raise NotImplementedError

    def begin_of_text(self) -> int:
        raise NotImplementedError

    def stop_tokens(self) -> set[int]:
        raise NotImplementedError

    def default_temperature(self) -> float:
        return 0.7

    def default_top_p(self) -> float:
        return 0.9

    # -- thinking control --------------------------------------------------
    def supports_thinking(self) -> bool:
        return False

    def encode_thinking_control(self, enable_thinking: bool) -> list[int]:
        return []

    # -- prompt assembly ---------------------------------------------------
    def build_prompt(self, messages: list[Message], append_assistant_header=True,
                     system_prompt: str | None = None) -> list[int]:
        tokens: list[int] = []
        if self.add_begin_of_text:
            bot = self.begin_of_text()
            if bot >= 0:
                tokens.append(bot)
        if system_prompt is not None and self.add_system_prompt:
            tokens.extend(self.encode_message(Message(Role.SYSTEM, system_prompt)))
        for m in messages:
            tokens.extend(self.encode_message(m))
        if append_assistant_header:
            tokens.extend(self.encode_header(Message(Role.ASSISTANT, "")))
        if self.include_reasoning:
            tokens.extend(self.tokenizer.encode("<think>\n", allowed_special="all"))
        return tokens

    def _enc(self, text: str) -> list[int]:
        return self.tokenizer.encode(text, allowed_special="all")

    def _sp(self, name: str, default: int = -1) -> int:
        return self.tokenizer.special_tokens.get(name, default)


class LlamaChatFormat(ChatFormat):
    """Llama 3 header format."""

    def __init__(self, tokenizer):
        super().__init__(tokenizer)
        self.bot = self._sp("<|begin_of_text|>")
        self.start_header = self._sp("<|start_header_id|>")
        self.end_header = self._sp("<|end_header_id|>")
        self.eot = self._sp("<|eot_id|>")
        self.eos = self._sp("<|end_of_text|>")

    def begin_of_text(self):
        return self.bot

    def stop_tokens(self):
        return {self.eos, self.eot} - {-1}

    def encode_header(self, m):
        return [self.start_header, *self._enc(m.role), self.end_header, *self._enc("\n")]

    def encode_message(self, m):
        return [*self.encode_header(m), *self._enc(m.content.strip()), self.eot]

    def default_temperature(self):
        return 0.3

    def default_top_p(self):
        return 0.95


def build_chat_format(family: Family, tokenizer, md: dict | None = None) -> ChatFormat:
    if family != Family.LLAMA_3:
        raise NotImplementedError(
            f"{family.name} chat format: family-deltas slice of the port")
    return LlamaChatFormat(tokenizer)
