"""SentencePiece-style score-based BPE with byte fallback (the port's copy of
llamatpu/tokenizer/spm.py, with `re` for the special-token split).

Used by Mistral and Phi-3: spaces become '▁', each
codepoint maps to a vocab entry or falls back to its '<0xNN>' byte tokens,
then the highest-scoring adjacent pair whose concatenation is in the vocab
merges, leftmost on ties, until no such pair is left.
"""
from __future__ import annotations

import heapq
import re

from llamatpu_torch.tokenizer.vocabulary import Vocabulary

SPACE = "▁"


class SPMTokenizer:
    def __init__(self, vocabulary: Vocabulary, special_tokens: dict[str, int],
                 add_leading_space: bool = False):
        self.vocabulary = vocabulary
        self.special_tokens = dict(special_tokens)
        self._special_ids = set(special_tokens.values())
        b0 = vocabulary.index_of("<0x00>")
        if b0 is None:
            raise ValueError("SPM tokenizer requires <0x00> byte-fallback tokens")
        self.byte0 = b0
        self.add_leading_space = add_leading_space
        if self.special_tokens:
            self._special_re = re.compile(
                "(" + "|".join(re.escape(t) for t in sorted(self.special_tokens, key=len,
                                                            reverse=True)) + ")")
        else:
            self._special_re = None

    def _char_ids(self, text: str) -> list[int]:
        text = text.replace(" ", SPACE)
        ids: list[int] = []
        for ch in text:
            i = self.vocabulary.index_of(ch)
            if i is not None:
                ids.append(i)
            else:
                # a lone surrogate (reachable through JSON "\ud800") falls
                # back to U+FFFD's bytes
                for b in ch.encode("utf-8", errors="replace"):
                    ids.append(self.byte0 + b)
        return ids

    def _encode_ordinary(self, text: str) -> list[int]:
        """Repeatedly merge the highest-scoring in-vocab adjacent pair,
        leftmost on score ties, driven by a heap over the adjacent pairs."""
        ids = self._char_ids(text)
        n = len(ids)
        if n < 2:
            return ids
        vals = list(ids)
        alive = [True] * n
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        heap: list[tuple[float, int, int, int, int]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j == -1:
                return
            m = self.vocabulary.index_of(self.vocabulary.get(vals[i]) + self.vocabulary.get(vals[j]))
            if m is not None:
                # (-score, left position): score first, then leftmost; an
                # entry is stale once either side's value has changed
                heapq.heappush(heap, (-self.vocabulary.score(m), i, vals[i], vals[j], m))

        for i in range(n - 1):
            push(i)
        while heap:
            _, i, vi, vj, m = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j == -1 or vals[i] != vi or vals[j] != vj:
                continue
            vals[i] = m
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            if prv[i] != -1:
                push(prv[i])
            push(i)
        return [vals[i] for i in range(n) if alive[i]]

    def encode(self, text: str, allowed_special: set[str] | str = "none") -> list[int]:
        if allowed_special == "all":
            allowed = set(self.special_tokens)
        elif allowed_special in ("none", None):
            allowed = set()
        else:
            allowed = set(allowed_special)
        if not allowed or self._special_re is None:
            return self._encode_ordinary(text)
        ids: list[int] = []
        for part in self._special_re.split(text):
            if part in allowed:
                ids.append(self.special_tokens[part])
            elif part:
                ids.extend(self._encode_ordinary(part))
        return ids

    def encode_ordinary(self, text: str) -> list[int]:
        return self._encode_ordinary(text)

    def decode_token_bytes(self, token_id: int) -> bytes:
        s = self.vocabulary.get(token_id)
        if len(s) == 6 and s.startswith("<0x") and s.endswith(">"):
            try:
                return bytes([int(s[3:5], 16)])
            except ValueError:
                pass
        return s.replace(SPACE, " ").encode("utf-8")

    def decode(self, ids: list[int]) -> str:
        return b"".join(self.decode_token_bytes(i) for i in ids).decode("utf-8", errors="replace")

    def is_special(self, token_id: int) -> bool:
        return token_id in self._special_ids

    def should_display_token(self, token_id: int) -> bool:
        return token_id not in self._special_ids
