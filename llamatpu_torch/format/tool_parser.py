"""Pure-string tool-call extraction: the port's copy of
llamatpu/format/tool_parser.py. Handles <|python_tag|>{...} (Llama 3.1),
<tool_call>...</tool_call> blocks (closed or unclosed, several in a row),
raw-JSON and markdown-fenced fallbacks, with brace-in-string safety.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ToolCall:
    name: str
    arguments_json: str
    call_id: str = ""


PYTHON_TAG = "<|python_tag|>"
TC_OPEN, TC_CLOSE = "<tool_call>", "</tool_call>"


def strip_markdown_fences(text: str) -> str:
    if not text.startswith("```"):
        return text
    nl = text.find("\n")
    if nl == -1:
        return text
    body = text[nl + 1 :]
    if body.endswith("```"):
        body = body[:-3].rstrip()
    return body.strip()


def _extract_string_value(json_s: str, key: str) -> str | None:
    marker = f'"{key}"'
    mi = json_s.find(marker)
    if mi == -1:
        return None
    ci = json_s.find(":", mi + len(marker))
    if ci == -1:
        return None
    qs = json_s.find('"', ci + 1)
    if qs == -1:
        return None
    i = qs + 1
    while i < len(json_s):
        c = json_s[i]
        if c == "\\":
            i += 2
        elif c == '"':
            break
        else:
            i += 1
    if i >= len(json_s):
        return None
    return json_s[qs + 1 : i]


def _extract_nested_object(json_s: str, key: str) -> str | None:
    marker = f'"{key}"'
    mi = json_s.find(marker)
    if mi == -1:
        return None
    ci = json_s.find(":", mi + len(marker))
    if ci == -1:
        return None
    bs = json_s.find("{", ci + 1)
    if bs == -1:
        return None
    depth = 0
    in_string = False
    i = bs
    while i < len(json_s):
        c = json_s[i]
        if in_string:
            if c == "\\":
                i += 1
            elif c == '"':
                in_string = False
        elif c == '"':
            in_string = True
        elif c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return json_s[bs : i + 1]
        i += 1
    return None  # unbalanced


def _parse_tool_call_json(json_s: str) -> ToolCall | None:
    name = _extract_string_value(json_s, "name")
    if name is None:
        name = _extract_string_value(json_s, "function")
    if name is None:
        return None
    args = _extract_nested_object(json_s, "parameters")
    if args is None:
        args = _extract_nested_object(json_s, "arguments")
    if args is None:
        args = "{}"
    return ToolCall(name, args)


def parse_tool_call_response(text: str) -> ToolCall | None:
    idx = text.find(PYTHON_TAG)
    if idx != -1:
        return _parse_tool_call_json(text[idx + len(PYTHON_TAG) :].strip())
    s = text.find(TC_OPEN)
    e = text.rfind(TC_CLOSE)
    if s != -1 and e != -1 and e > s:
        return _parse_tool_call_json(text[s + len(TC_OPEN) : e].strip())
    if s != -1 and e == -1:  # unclosed block: model hit a stop token first
        return _parse_tool_call_json(text[s + len(TC_OPEN) :].strip())
    stripped = strip_markdown_fences(text.strip())
    if stripped.startswith("{"):
        return _parse_tool_call_json(stripped)
    return None


def parse_all_tool_calls(text: str) -> list[ToolCall]:
    calls: list[ToolCall] = []
    pi = text.find(PYTHON_TAG)
    if pi != -1:
        tc = _parse_tool_call_json(text[pi + len(PYTHON_TAG) :].strip())
        if tc:
            calls.append(tc)
        return calls
    search = 0
    while True:
        s = text.find(TC_OPEN, search)
        if s == -1:
            break
        e = text.find(TC_CLOSE, s)
        if e != -1:
            json_s = text[s + len(TC_OPEN) : e].strip()
            search = e + len(TC_CLOSE)
        else:
            json_s = text[s + len(TC_OPEN) :].strip()
            search = len(text)
        tc = _parse_tool_call_json(json_s)
        if tc:
            calls.append(tc)
        if e == -1:
            break
    if not calls:
        stripped = strip_markdown_fences(text.strip())
        if stripped.startswith("{"):
            tc = _parse_tool_call_json(stripped)
            if tc:
                calls.append(tc)
    return calls
