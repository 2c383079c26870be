"""GPT-2-style byte-level BPE with an explicit merges list: the Llama 3,
Qwen, Granite and Tekken (Devstral) tokenizers of the port
(llamatpu/tokenizer/bpe.py).

Text is split by the family's pretokenizer, each piece mapped
bytes -> printable unicode (bytes_to_unicode), then pairs are merged by
merge-list priority; special tokens split the text first and encode as single
ids. Token ids equal the JAX package's on every text
(tests/test_torch_tokenizer.py).

The JAX package splits with the third-party `regex` module's pattern

    (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}
    | ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+

which the port does not import, and Qwen's QWEN_PATTERN, the same but for
two alternatives: the contractions fold ASCII case only
(`'[sS]|'[tT]|...`), and `\\p{N}` matches one digit, not 1-3.
Granite's `dbrx` pretokenizer is Qwen's pattern with `\\p{N}{1,3}`
(`granite_dbrx_pieces`); its `refact` default and Tekken are the Llama 3
pattern. `llama3_pieces`, `qwen_pieces` and `granite_dbrx_pieces` are those
patterns written out as a scanner (the standard library's `re` has no
\\p{L} / \\p{N}): at each position the alternatives are tried in order, with
the backtracking each implies resolved by hand. Letters and numbers are
the Unicode categories L* and N* of `unicodedata`; whitespace is the Unicode White_Space set, as
`regex`'s \\s. A character assigned in a later Unicode version than the
interpreter's `unicodedata` may split differently from `regex`'s tables.
"""
from __future__ import annotations

import functools
import logging
import re
import unicodedata

log = logging.getLogger(__name__)

# Unicode White_Space (what `regex` matches with \s)
_WHITESPACE = frozenset(map(chr, (
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))
# simple case folds onto the contraction letters besides ASCII case
_FOLD = {"ſ": "s"}
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")  # in pattern order


@functools.lru_cache(maxsize=65536)
def _cls(ch: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'O' anything else."""
    if ch in _WHITESPACE:
        return "S"
    c = unicodedata.category(ch)[0]
    return c if c in "LN" else "O"


def _fold(ch: str) -> str:
    return _FOLD.get(ch, ch.lower() if ch.isascii() else ch)


def _fold_ascii(ch: str) -> str:
    return ch.lower() if ch.isascii() else ch


def _run(text: str, i: int, cls: str) -> int:
    """End of the run of class `cls` starting at i."""
    n = len(text)
    while i < n and _cls(text[i]) == cls:
        i += 1
    return i


def _match_at(text: str, i: int, fold=_fold, max_digits: int = 3) -> int:
    """End of the pretokenizer match starting at i (always > i). fold maps a
    contraction letter to the case it matches; max_digits is the number
    alternative's longest run."""
    n = len(text)
    c0 = text[i]
    k0 = _cls(c0)
    # (?i:'s|'t|'re|'ve|'m|'ll|'d), or Qwen's '[sS]|'[tT]|...
    if c0 == "'":
        for con in _CONTRACTIONS:
            e = i + 1 + len(con)
            if e <= n and all(fold(text[i + 1 + j]) == con[j] for j in range(len(con))):
                return e
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if k0 == "L":
        return _run(text, i, "L")
    if c0 not in "\r\n" and k0 in "OS" and i + 1 < n and _cls(text[i + 1]) == "L":
        return _run(text, i + 1, "L")
    # \p{N}{1,3}, or Qwen's \p{N}
    if k0 == "N":
        e = i + 1
        while e < n and e < i + max_digits and _cls(text[e]) == "N":
            e += 1
        return e
    #  ?[^\s\p{L}\p{N}]+[\r\n]*
    j = i + 1 if c0 == " " else i
    if j < n and _cls(text[j]) == "O":
        e = _run(text, j, "O")
        while e < n and text[e] in "\r\n":
            e += 1
        return e
    # the rest start with whitespace: c0 is whitespace here
    e = _run(text, i, "S")
    # \s*[\r\n]+ : the last \r or \n of the run ends the match
    last_nl = max(text.rfind("\r", i, e), text.rfind("\n", i, e))
    if last_nl >= 0:
        return last_nl + 1
    # \s+(?!\S) : the run, less its last char when a non-space follows
    if e == n:
        return e
    if e - 1 > i:
        return e - 1
    # \s+
    return e


def llama3_pieces(text: str) -> list[str]:
    """The Llama 3 pretokenizer's pieces of `text` (regex findall order)."""
    return _pieces(text, _fold, 3)


def qwen_pieces(text: str) -> list[str]:
    """The Qwen pretokenizer's pieces of `text` (QWEN_PATTERN's findall)."""
    return _pieces(text, _fold_ascii, 1)


def granite_dbrx_pieces(text: str) -> list[str]:
    """Granite's `dbrx` pretokenizer (GRANITE_DBRX_PATTERN's findall): Qwen's
    ASCII-folded contractions with numbers of 1-3 digits."""
    return _pieces(text, _fold_ascii, 3)


def _pieces(text: str, fold, max_digits: int) -> list[str]:
    out = []
    i = 0
    while i < len(text):
        e = _match_at(text, i, fold, max_digits)
        out.append(text[i:e])
        i = e
    return out


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable unicode char mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


class BPETokenizer:
    def __init__(self, vocabulary, merges_lines: list[str], special_tokens: dict[str, int],
                 pretokenize=llama3_pieces):
        self.vocabulary = vocabulary
        self.pretokenize = pretokenize
        self.special_tokens = dict(special_tokens)
        self._special_ids = set(special_tokens.values())
        # merge ranks: (id_a, id_b) -> (rank, merged_id)
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, line in enumerate(merges_lines):
            a, b = line.split(" ")
            ia, ib = vocabulary.index_of(a), vocabulary.index_of(b)
            im = vocabulary.index_of(a + b)
            if ia is None or ib is None or im is None:
                continue
            self.merges[(ia, ib)] = (rank, im)
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = unicode_to_bytes()
        if self.special_tokens:
            self._special_re = re.compile(
                "(" + "|".join(re.escape(t) for t in sorted(self.special_tokens, key=len, reverse=True)) + ")")
        else:
            self._special_re = None

    # -- encode -----------------------------------------------------------

    def _encode_chunk(self, chunk: str) -> list[int]:
        # errors="replace": a lone surrogate must not crash encode; it
        # becomes U+FFFD bytes
        s = "".join(self._byte_enc[b] for b in chunk.encode("utf-8", errors="replace"))
        ids = []
        for ch in s:
            i = self.vocabulary.index_of(ch)
            if i is None:
                # a byte-level vocab holds all 256 byte chars, so this only
                # happens with a truncated/corrupt vocab: skip this char
                if not getattr(self, "_warned_unmappable", False):
                    self._warned_unmappable = True
                    log.warning("vocab is missing byte-level char %r (0x%02x); "
                                "skipping occurrences", ch, self._byte_dec.get(ch, 0))
                continue
            ids.append(i)
        while len(ids) > 1:
            best = None
            for i in range(len(ids) - 1):
                m = self.merges.get((ids[i], ids[i + 1]))
                if m is not None and (best is None or m[0] < best[0]):
                    best = (m[0], i, m[1])
            if best is None:
                break
            _, i, merged = best
            ids = ids[:i] + [merged] + ids[i + 2 :]
        return ids

    def encode_ordinary(self, text: str) -> list[int]:
        ids: list[int] = []
        for chunk in self.pretokenize(text):
            ids.extend(self._encode_chunk(chunk))
        return ids

    def encode(self, text: str, allowed_special: set[str] | str = "none") -> list[int]:
        if allowed_special == "all":
            allowed = set(self.special_tokens)
        elif allowed_special in ("none", None):
            allowed = set()
        else:
            allowed = set(allowed_special)
        if not allowed or self._special_re is None:
            return self.encode_ordinary(text)
        ids: list[int] = []
        for part in self._special_re.split(text):
            if part in allowed:
                ids.append(self.special_tokens[part])
            elif part:
                ids.extend(self.encode_ordinary(part))
        return ids

    # -- decode -----------------------------------------------------------

    def decode_token_bytes(self, token_id: int) -> bytes:
        """Raw UTF-8 bytes of one token (for streaming partial-codepoint handling)."""
        s = self.vocabulary.get(token_id)
        if token_id in self._special_ids:
            return s.encode("utf-8")
        return bytes(self._byte_dec.get(c, ord("?") & 0xFF) for c in s)

    def decode(self, ids: list[int]) -> str:
        return b"".join(self.decode_token_bytes(i) for i in ids).decode("utf-8", errors="replace")

    # -- policy -----------------------------------------------------------

    def is_special(self, token_id: int) -> bool:
        return token_id in self._special_ids

    def should_display_token(self, token_id: int) -> bool:
        return token_id not in self._special_ids
