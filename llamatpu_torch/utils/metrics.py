"""Run metrics of the engine: weight upload, prefill and decode phases (the
part of llamatpu/utils/metrics.py that the port's Engine fills)."""
from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class RunMetrics:
    weight_upload_s: float = 0.0
    prefill_tokens: int = 0
    prefill_s: float = 0.0
    decode_tokens: int = 0
    decode_s: float = 0.0

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / self.prefill_s if self.prefill_s > 0 else 0.0

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s > 0 else 0.0


class Timer:
    """Context timer on the host clock (perf_counter)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
