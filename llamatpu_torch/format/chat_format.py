"""Chat formats: prompt templates, stop tokens, default sampling
parameters, thinking control and tool-calling encodings, for all nine
families. The port's copy of llamatpu/format/chat_format.py: `Message`,
`Role`, the `ChatFormat` base with its tool-calling defaults,
`LlamaChatFormat` (Llama 3 headers), `MistralChatFormat` ([INST] turns,
[AVAILABLE_TOOLS] / [TOOL_CALLS] / [TOOL_RESULTS] tokens, fill-in-the-middle)
and `DevstralChatFormat`, `QwenChatFormat` (ChatML for Qwen2 / Qwen2-MoE /
Qwen3 with Qwen3's <think> control, and the DeepSeek-R1 distills' variant
with <｜User｜> / <｜Assistant｜> markers and a forced "<think>\n" primer),
`Phi3ChatFormat`, `GraniteChatFormat` and `build_chat_format`. Token lists
equal the JAX package's (tests/test_torch_families.py).
"""
from __future__ import annotations

from dataclasses import dataclass

from llamatpu_torch.format.tool_parser import (ToolCall, parse_all_tool_calls,
                                               parse_tool_call_response)
from llamatpu_torch.models.config import Family


@dataclass(frozen=True)
class Message:
    role: str
    content: str


class Role:
    SYSTEM = "system"
    USER = "user"
    ASSISTANT = "assistant"
    FIM_PREFIX = "fim_prefix"
    FIM_SUFFIX = "fim_suffix"
    FIM_MIDDLE = "fim_middle"


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

    # -- tool calling (defaults: unsupported) -----------------------------
    def supports_tool_calling(self) -> bool:
        return False

    def tool_system_prompt_suffix(self, tools_json: str) -> str:
        raise NotImplementedError(f"tool calling not supported for {type(self).__name__}")

    def injects_tools_in_user_message(self) -> bool:
        return False

    def tool_system_message_prefix(self) -> str:
        return ""

    def tool_first_user_message_prefix(self, tools_json: str) -> str:
        return ""

    def encode_tool_call_assistant_turn(self, tool_calls: list[ToolCall]) -> list[int]:
        raise NotImplementedError(f"tool calling not supported for {type(self).__name__}")

    def encode_tool_result_turn(self, call_id: str, tool_name: str, result: str) -> list[int]:
        raise NotImplementedError(f"tool calling not supported for {type(self).__name__}")

    def extract_tool_call(self, text: str) -> ToolCall | None:
        return None

    def extract_all_tool_calls(self, text: str) -> list[ToolCall]:
        tc = self.extract_tool_call(text)
        return [tc] if tc else []

    def tool_aware_stop_tokens(self) -> set[int]:
        return self.stop_tokens()

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

    def _enc_ord(self, text: str) -> list[int]:
        return self.tokenizer.encode_ordinary(text)

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
        self.eom = self._sp("<|eom_id|>")             # Llama 3.1 only
        self.python_tag = self._sp("<|python_tag|>")  # Llama 3.1 only

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

    # tools: Llama 3.2 injects the definitions into the FIRST user message
    def supports_tool_calling(self):
        return True

    def injects_tools_in_user_message(self):
        return True

    def tool_system_message_prefix(self):
        return "Environment: ipython\n\n"

    def tool_first_user_message_prefix(self, tools_json):
        return (
            "Given the following functions, please respond with a JSON for a function call "
            "with its proper arguments that best answers the given prompt.\n\n"
            'Respond in the format {"name": function name, "parameters": dictionary of '
            "argument name and its value}. Do not use variables.\n\n" + tools_json + "\n\n"
        )

    def encode_tool_call_assistant_turn(self, tool_calls):
        tokens = self.encode_header(Message(Role.ASSISTANT, ""))
        for tc in tool_calls:
            if self.python_tag != -1:
                tokens.append(self.python_tag)
            tokens.extend(self._enc('{"name": "%s", "parameters": %s}'
                                    % (tc.name, tc.arguments_json)))
        tokens.append(self.eom if self.eom != -1 else self.eot)
        return tokens

    def encode_tool_result_turn(self, call_id, tool_name, result):
        return [self.start_header, *self._enc("ipython"), self.end_header,
                *self._enc("\n"), *self._enc(result), self.eot]

    def extract_tool_call(self, text):
        return parse_tool_call_response(text)

    def extract_all_tool_calls(self, text):
        return parse_all_tool_calls(text)

    def tool_aware_stop_tokens(self):
        s = self.stop_tokens()
        if self.eom != -1:
            s = s | {self.eom}
        return s


class MistralChatFormat(ChatFormat):
    """[INST] role [/INST] content [/INST] turns with <s> as begin-of-text
    and </s> as the stop; tools through the [AVAILABLE_TOOLS],
    [TOOL_CALLS] and [TOOL_RESULTS] tokens where the vocab has them (the
    <unk> id stands in where it does not). Also Devstral's."""

    add_system_prompt = True

    def __init__(self, tokenizer):
        super().__init__(tokenizer)
        self.unk = self._sp("<unk>")
        self.bos = self._sp("<s>")
        self.eos = self._sp("</s>")
        self.boi = self._sp("[INST]")
        self.eoi = self._sp("[/INST]")
        self.tool_calls_tok = self._sp("[TOOL_CALLS]", self.unk)
        self.b_avail = self._sp("[AVAILABLE_TOOLS]", self.unk)
        self.e_avail = self._sp("[/AVAILABLE_TOOLS]", self.unk)
        self.b_res = self._sp("[TOOL_RESULTS]", self.unk)
        self.e_res = self._sp("[/TOOL_RESULTS]", self.unk)
        self.prefix = self._sp("[PREFIX]", self.unk)
        self.suffix = self._sp("[SUFFIX]", self.unk)
        self.middle = self._sp("[MIDDLE]", self.unk)

    def begin_of_text(self):
        return self.bos

    def stop_tokens(self):
        return {self.eos}

    def encode_header(self, m):
        return [self.boi, *self._enc(m.role), self.eoi]

    def encode_message(self, m):
        return [*self.encode_header(m), *self._enc(m.content.strip()), self.eoi]

    def encode_fill_in_the_middle(self, prefix: str, suffix: str) -> list[int]:
        return [self.suffix, *self._enc_ord(suffix), self.prefix, *self._enc_ord(prefix)]

    def supports_tool_calling(self):
        return self.b_avail not in (-1, self.unk)

    def tool_system_prompt_suffix(self, tools_json):
        return ""  # Mistral carries tools in [AVAILABLE_TOOLS] tokens instead

    def encode_available_tools(self, tools_json: str) -> list[int]:
        return [self.b_avail, *self._enc_ord(tools_json), self.e_avail]

    def encode_tool_call_assistant_turn(self, tool_calls):
        body = ",".join('{"name": "%s", "arguments": %s}' % (tc.name, tc.arguments_json)
                        for tc in tool_calls)
        return [self.tool_calls_tok, *self._enc_ord("[" + body + "]"), self.eos]

    def encode_tool_result_turn(self, call_id, tool_name, result):
        return [self.b_res, *self._enc_ord(result), self.e_res]

    def extract_tool_call(self, text):
        return parse_tool_call_response(text)

    def extract_all_tool_calls(self, text):
        return parse_all_tool_calls(text)


class DevstralChatFormat(MistralChatFormat):
    """Devstral: Mistral's format on the Tekken vocab."""


class QwenChatFormat(ChatFormat):
    """ChatML (<|im_start|>role\n ... <|im_end|>\n) of Qwen2, Qwen2-MoE and
    Qwen3, with no begin-of-text token, stops at <|im_end|>, <|end_of_text|>
    and <|endoftext|>, sampling defaults 0.8 / 0.9, the fill-in-the-middle
    roles as their single tokens, Hermes-style tool calls in <tool_call>
    tags and, for Qwen3 (thinking=True), the pre-closed <think></think>
    that turns reasoning off. deepseek=True: the DeepSeek-R1 distills'
    variant, <｜begin▁of▁sentence｜> then <｜User｜> / <｜Assistant｜>
    markers, no <|im_end|>, no system prompt, no tools, and a forced
    "<think>\n" primer after the assistant marker."""

    add_begin_of_text = False

    def __init__(self, tokenizer, deepseek: bool = False, thinking: bool = False):
        super().__init__(tokenizer)
        self.deepseek = deepseek
        self.thinking = thinking
        if deepseek:
            self.bot = self._sp("<｜begin▁of▁sentence｜>")
            self.im_start = -1
            self.im_end = -1
            self.eos = self._sp("<｜end▁of▁sentence｜>")
            self.add_begin_of_text = True
            self.add_system_prompt = False
            self.include_reasoning = True
        else:
            self.bot = -1
            self.im_start = self._sp("<|im_start|>")
            self.im_end = self._sp("<|im_end|>")
            self.eos = self._sp("<|end_of_text|>")
        self.eot_fim = self._sp("<|endoftext|>")
        self.fim_prefix = self._sp("<|fim_prefix|>")
        self.fim_suffix = self._sp("<|fim_suffix|>")
        self.fim_middle = self._sp("<|fim_middle|>")
        vocab = tokenizer.vocabulary
        self.think_start = vocab.index_of("<think>")
        self.think_end = vocab.index_of("</think>")

    def begin_of_text(self):
        return self.bot if self.bot != -1 else self.im_start

    def stop_tokens(self):
        return {self.im_end, self.eos, self.eot_fim} - {-1}

    def encode_header(self, m):
        if self.im_end == -1:  # the DeepSeek-R1 distills
            marker = {"user": "<｜User｜>", "assistant": "<｜Assistant｜>",
                      "fim_prefix": "<|fim_prefix|>", "fim_middle": "<|fim_middle|>",
                      "fim_suffix": "<|fim_suffix|>"}.get(m.role)
            if marker is None:
                return []
            tid = self.tokenizer.special_tokens.get(marker)
            if tid is None:
                raise ValueError(f"unknown token {marker!r}")
            return [tid]
        if m.role == Role.FIM_PREFIX:
            return [self.fim_prefix]
        if m.role == Role.FIM_SUFFIX:
            return [self.fim_suffix]
        if m.role == Role.FIM_MIDDLE:
            return [self.fim_middle]
        return [self.im_start, *self._enc_ord(m.role), *self._enc_ord("\n")]

    def encode_message(self, m):
        tokens = [*self.encode_header(m), *self._enc_ord(m.content.strip())]
        is_fim = m.role in (Role.FIM_PREFIX, Role.FIM_SUFFIX, Role.FIM_MIDDLE)
        if self.im_end != -1 and not is_fim:
            tokens.append(self.im_end)
            tokens.extend(self._enc_ord("\n"))
        return tokens

    def default_temperature(self):
        return 0.8

    def default_top_p(self):
        return 0.9

    # thinking control (Qwen3 only; DeepSeek always thinks)
    def supports_thinking(self):
        return not self.deepseek and self.thinking

    def encode_thinking_control(self, enable_thinking):
        if enable_thinking or not self.supports_thinking():
            return []
        if self.think_start is None or self.think_end is None:
            return self._enc_ord("<think>\n\n</think>\n\n")
        nl = self._enc_ord("\n\n")
        return [self.think_start, *nl, self.think_end, *nl]

    # tools
    def supports_tool_calling(self):
        return not self.deepseek

    def tool_system_prompt_suffix(self, tools_json):
        return (
            "\n\n# Tools\n\n"
            "You may call one or more functions to assist with the user query.\n\n"
            "You are provided with function signatures within <tools></tools> XML tags:\n"
            "<tools>\n" + tools_json + "\n</tools>\n\n"
            "For each function call, return a json object with function name and arguments "
            "within <tool_call></tool_call> XML tags:\n"
            "<tool_call>\n"
            '{"name": <function-name>, "arguments": <args-json-object>}\n'
            "</tool_call>"
        )

    def encode_tool_call_assistant_turn(self, tool_calls):
        tokens = [self.im_start, *self._enc_ord("assistant\n")]
        for tc in tool_calls:
            json_s = '{"name":"%s","arguments":%s}' % (tc.name, tc.arguments_json)
            tokens.extend(self._enc_ord("<tool_call>\n" + json_s + "\n</tool_call>"))
        if self.im_end != -1:
            tokens.append(self.im_end)
        return tokens

    def encode_tool_result_turn(self, call_id, tool_name, result):
        tokens = [self.im_start,
                  *self._enc_ord("user\n<tool_response>\n" + result + "\n</tool_response>")]
        if self.im_end != -1:
            tokens.append(self.im_end)
        return tokens

    def extract_tool_call(self, text):
        return parse_tool_call_response(text)

    def extract_all_tool_calls(self, text):
        return parse_all_tool_calls(text)


class Phi3ChatFormat(ChatFormat):
    """<|system|> / <|user|> / <|assistant|> headers, each message closed by
    <|end|>; no begin-of-text token in the prompt; stops at <|end|> or
    <|endoftext|>."""

    add_begin_of_text = False

    def __init__(self, tokenizer):
        super().__init__(tokenizer)
        self.end = self._sp("<|end|>")
        self.eos = self._sp("<|endoftext|>")
        self.bos = self._sp("<s>", getattr(tokenizer, "bos_id", -1))

    def begin_of_text(self):
        return self.bos

    def stop_tokens(self):
        return {t for t in (self.end, self.eos) if t != -1}

    def encode_header(self, m):
        tid = self.tokenizer.special_tokens.get(f"<|{m.role}|>")
        tokens = [tid] if tid is not None else self._enc(f"<|{m.role}|>")
        tokens.extend(self._enc_ord("\n"))
        return tokens

    def encode_message(self, m):
        return [*self.encode_header(m), *self._enc_ord(m.content.strip()), self.end,
                *self._enc_ord("\n")]


class GraniteChatFormat(ChatFormat):
    """<|start_of_role|>role<|end_of_role|> content <|end_of_text|>, no
    begin-of-text token; stops at <|end_of_text|>."""

    def __init__(self, tokenizer):
        super().__init__(tokenizer)
        self.start_role = self._sp("<|start_of_role|>")
        self.end_role = self._sp("<|end_of_role|>")
        self.eos = self._sp("<|end_of_text|>", 0)

    def begin_of_text(self):
        return -1  # Granite's template carries no BOS

    def stop_tokens(self):
        return {self.eos}

    def encode_header(self, m):
        tokens = []
        if self.start_role != -1:
            tokens.append(self.start_role)
        tokens.extend(self._enc(m.role))
        if self.end_role != -1:
            tokens.append(self.end_role)
        return tokens

    def encode_message(self, m):
        return [*self.encode_header(m), *self._enc(m.content.strip()), self.eos]


def build_chat_format(family: Family, tokenizer, md: dict | None = None) -> ChatFormat:
    if family == Family.MISTRAL:
        return MistralChatFormat(tokenizer)
    if family == Family.DEVSTRAL_2:
        return DevstralChatFormat(tokenizer)
    if family == Family.PHI_3:  # no begin-of-text token (a class attribute)
        return Phi3ChatFormat(tokenizer)
    if family == Family.GRANITE:
        return GraniteChatFormat(tokenizer)
    if family == Family.DEEPSEEK_R1_DISTILL_QWEN:
        return QwenChatFormat(tokenizer, deepseek=True)
    if family in (Family.QWEN_2, Family.QWEN_2_MOE):
        return QwenChatFormat(tokenizer)
    if family == Family.QWEN_3:
        return QwenChatFormat(tokenizer, thinking=True)
    return LlamaChatFormat(tokenizer)
