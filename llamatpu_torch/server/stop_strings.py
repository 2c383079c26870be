"""Incremental per-request stop-string matching (the OpenAI `stop`
parameter): the port's copy of llamatpu/server/stop_strings.py.

Generation halts when any of up to 4 strings appears in the decoded text,
and the matched string is excluded from the returned or streamed output.
Stop strings live at the text level (they can span token boundaries), so
matching runs on the decoded piece stream; the matcher holds back any
trailing text that is a prefix of a stop string, so a match split across
pieces is never streamed before it can be recognised.
"""
from __future__ import annotations


class StopStringMatcher:
    """Feed decoded text pieces; get back (text safe to emit, stopped?).

    - On a match, emits text strictly before the earliest match and drops the
      stop string plus everything after it.
    - While no match is possible yet, holds back the longest buffer suffix that
      is a proper prefix of some stop string (the "holdback") and emits the
      rest.
    - `flush()` releases the holdback when generation ends without a match.
    """

    def __init__(self, stops):
        self.stops = [s for s in (stops or []) if s]
        self.stopped = False
        self._buf = ""

    def feed(self, text: str) -> tuple[str, bool]:
        if self.stopped:
            return "", True
        if not self.stops:
            return text, False
        self._buf += text
        earliest = -1
        for s in self.stops:
            i = self._buf.find(s)
            if i >= 0 and (earliest < 0 or i < earliest):
                earliest = i
        if earliest >= 0:
            self.stopped = True
            emit, self._buf = self._buf[:earliest], ""
            return emit, True
        hold = 0
        for s in self.stops:
            top = min(len(s) - 1, len(self._buf))
            for k in range(top, hold, -1):
                if self._buf.endswith(s[:k]):
                    hold = k
                    break
        cut = len(self._buf) - hold
        emit, self._buf = self._buf[:cut], self._buf[cut:]
        return emit, False

    def flush(self) -> str:
        """Release held-back text (call when generation ends without a match)."""
        out, self._buf = self._buf, ""
        return "" if self.stopped else out
