"""Token vocabulary: id <-> string with optional scores and ggml token types.

The port's copy of llamatpu/tokenizer/vocabulary.py. Token types follow
llama.cpp: 1=NORMAL, 2=UNKNOWN, 3=CONTROL, 4=USER_DEFINED, 5=UNUSED, 6=BYTE.
"""
from __future__ import annotations

import numpy as np


class Vocabulary:
    NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

    def __init__(self, tokens: list[str], scores=None, token_types=None):
        self.tokens = list(tokens)
        self.scores = None if scores is None else np.asarray(scores, dtype=np.float32)
        self.token_types = None if token_types is None else np.asarray(token_types, dtype=np.int32)
        self._index = {t: i for i, t in enumerate(self.tokens)}

    @classmethod
    def from_metadata(cls, md: dict) -> "Vocabulary":
        return cls(
            list(md["tokenizer.ggml.tokens"]),
            md.get("tokenizer.ggml.scores"),
            md.get("tokenizer.ggml.token_type"),
        )

    def __len__(self) -> int:
        return len(self.tokens)

    def get(self, i: int) -> str:
        return self.tokens[i]

    def index_of(self, token: str) -> int | None:
        return self._index.get(token)

    def score(self, i: int) -> float:
        return float(self.scores[i]) if self.scores is not None else 0.0

    def type_of(self, i: int) -> int:
        return int(self.token_types[i]) if self.token_types is not None else self.NORMAL
