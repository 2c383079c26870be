"""On-device sampling. This slice ports greedy argmax only: only the token id
leaves the card. Temperature / top-p sampling is the sampling slice's work."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis. logits: [..., V] -> [...] int32. Ties go to
    the lowest index, as jnp.argmax does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """Next token ids from [..., V] logits: greedy at temperature 0."""
    if temperature == 0.0:
        return greedy(logits)
    raise NotImplementedError(
        "sampled decoding (temperature > 0): sampling slice of the port")
