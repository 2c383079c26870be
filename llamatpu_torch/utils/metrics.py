"""Run metrics of the engine: load, weight upload, decode-step capture,
prefill and decode phases, rendered human/json/github or appended to a file
(the part of llamatpu/utils/metrics.py that the port fills; `compile_s` is
the JAX package's field, here the seconds spent capturing decode steps as
CUDA graphs, runtime/decode_graph.py; its trace phase has no counterpart)."""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field


@dataclass
class RunMetrics:
    load_s: float = 0.0
    weight_upload_s: float = 0.0
    compile_s: float = 0.0  # decode-step warm-up and graph capture
    prefill_tokens: int = 0
    prefill_s: float = 0.0
    decode_tokens: int = 0
    decode_s: float = 0.0
    extra: dict = field(default_factory=dict)

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / self.prefill_s if self.prefill_s > 0 else 0.0

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "load_s": round(self.load_s, 4),
            "weight_upload_s": round(self.weight_upload_s, 4),
            "compile_s": round(self.compile_s, 4),
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": round(self.prefill_s, 4),
            "prefill_tok_s": round(self.prefill_tok_s, 2),
            "decode_tokens": self.decode_tokens,
            "decode_s": round(self.decode_s, 4),
            "decode_tok_s": round(self.decode_tok_s, 2),
            **self.extra,
        }

    def write_file(self, path: str) -> None:
        """Append the run's metrics to `path` as one JSON line."""
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(self.to_dict()) + "\n")

    def render(self, fmt: str = "human", stream=None) -> None:
        stream = stream or sys.stderr
        d = self.to_dict()
        if fmt == "json":
            print(json.dumps(d), file=stream)
        elif fmt == "github":
            for k, v in d.items():
                print(f"::notice title=llamatpu_torch::{k}={v}", file=stream)
        else:
            print(f"\nllamatpu_torch: load {d['load_s']:.2f}s | compile {d['compile_s']:.2f}s | "
                  f"upload {d['weight_upload_s']:.2f}s", file=stream)
            print(f"llamatpu_torch: prefill {d['prefill_tokens']} tok in {d['prefill_s']:.3f}s "
                  f"({d['prefill_tok_s']:.1f} tok/s) | decode {d['decode_tokens']} tok in "
                  f"{d['decode_s']:.3f}s ({d['decode_tok_s']:.1f} tok/s)", file=stream)


class Timer:
    """Context timer on the host clock (perf_counter)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
