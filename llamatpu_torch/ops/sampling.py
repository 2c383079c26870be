"""On-device sampling (the port of llamatpu/ops/sampling.py): greedy argmax,
and temperature + top-p nucleus sampling from an explicit torch.Generator.

Only the token id leaves the card, and nothing here waits for the device.
Semantics are those of the JAX package's `sample_dynamic` (what its Engine
runs): temperature 0 is argmax; otherwise softmax of logits / temperature,
restricted to the smallest prefix of probability-sorted tokens whose
cumulative mass reaches top_p (top_p clipped to [1e-6, 1]; the first token
always stays). The sort is stable and descending, so ties keep index order
as `jnp.argsort(descending=True)` does. The draw is Gumbel-max over the
masked log-probabilities, as `jax.random.categorical` draws: the same
distribution, though not the same numbers as JAX's generator.
"""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis. logits: [..., V] -> [...] int32. Ties go to
    the lowest index, as jnp.argmax does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _nucleus(logits: torch.Tensor, temperature: float, top_p: float):
    """(scaled logits, sorted probs, sorted ids, keep mask in sorted order)."""
    scaled = logits.float() / max(temperature, 1e-6)
    top_p = min(max(top_p, 1e-6), 1.0)
    probs = torch.softmax(scaled, dim=-1)
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = (cum - sorted_probs) < top_p  # first token always kept
    return scaled, sorted_probs, sorted_idx, keep


def filtered_scaled_logits(logits: torch.Tensor, temperature: float,
                           top_p: float) -> torch.Tensor:
    """Temperature-scaled logits with the tokens outside the top-p nucleus
    masked to -inf, in the original token order: softmax of a row is the
    distribution `sample` draws from. logits [..., V] -> [..., V] f32."""
    scaled, _, sorted_idx, keep_sorted = _nucleus(logits, temperature, top_p)
    keep = torch.empty_like(keep_sorted).scatter_(-1, sorted_idx, keep_sorted)
    return torch.where(keep, scaled, torch.full_like(scaled, float("-inf")))


def sample(logits: torch.Tensor, temperature: float, top_p: float = 1.0,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Next token ids [...] int32 from [..., V] logits: greedy at temperature
    0, else one nucleus draw per row from `generator` (on logits' device)."""
    if temperature == 0.0:
        return greedy(logits)
    _, sorted_probs, sorted_idx, keep = _nucleus(logits, temperature, top_p)
    masked = torch.where(keep, torch.log(sorted_probs.clamp_min(1e-38)),
                         torch.full_like(sorted_probs, float("-inf")))
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    choice = torch.argmax(masked + gumbel, dim=-1, keepdim=True)
    return torch.gather(sorted_idx, -1, choice)[..., 0].to(torch.int32)
