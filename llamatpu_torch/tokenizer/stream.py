"""Streaming UTF-8 token decoder (the port's copy of
llamatpu/tokenizer/stream.py): a small stateful decoder buffers raw token
bytes and only releases complete UTF-8 sequences.
"""
from __future__ import annotations


class StreamDecoder:
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self._buf = b""

    def push(self, token_id: int) -> str:
        """Feed one token id; returns printable text completed by this token."""
        if not self.tokenizer.should_display_token(token_id):
            return ""
        self._buf += self.tokenizer.decode_token_bytes(token_id)
        # find longest prefix of complete UTF-8 sequences
        out, rest = self._split_complete(self._buf)
        self._buf = rest
        return out.decode("utf-8", errors="replace")

    def flush(self) -> str:
        out, self._buf = self._buf, b""
        return out.decode("utf-8", errors="replace")

    @staticmethod
    def _split_complete(buf: bytes) -> tuple[bytes, bytes]:
        """Split buf into (complete utf-8 prefix, trailing partial sequence)."""
        i = len(buf)
        # scan back over up to 3 continuation bytes
        n_cont = 0
        while i > 0 and n_cont < 3 and (buf[i - 1] & 0xC0) == 0x80:
            i -= 1
            n_cont += 1
        if i == 0:
            return b"", buf  # only continuation bytes buffered; keep holding
        lead = buf[i - 1]
        if lead >= 0xF0:
            need = 3
        elif lead >= 0xE0:
            need = 2
        elif lead >= 0xC0:
            need = 1
        else:
            need = 0  # ASCII lead (or malformed): nothing to hold
        if need and n_cont < need:
            return buf[: i - 1], buf[i - 1 :]  # incomplete sequence: hold it
        return buf, b""
