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

`sample_dynamic` / `sample_lanes` are the batched forms (llamatpu/ops/
sampling.py `sample_dynamic`, llamatpu/runtime/batch_engine.py
`_sample_lanes`): temperature and top-p are per-lane tensors [B] on the
logits' device, so a batched decode step samples with no host sync; lanes at
temperature 0 take the argmax.

The decode step (runtime/decode_graph.py) samples through `sample_lanes`
only, with temperature and top-p read from device tensors, so a captured
step bakes in no sampling value: `any_sampled=False` is the greedy step form
(no draw), True the sampled form (a draw from the generator registered with
the graph). `is_stop` is its stop check, a compare against a fixed-size stop
vector.

`spec_verify_sample` is the speculative verify step's rejection sampling
(llamatpu/ops/sampling.py `spec_verify_sample`) over `filtered_scaled_logits`,
its acceptance uniforms and residual Gumbel draw from the same generator.
"""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis. logits: [..., V] -> [...] int32. Ties go to
    the lowest index, as jnp.argmax does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _nucleus(logits: torch.Tensor, temperature, top_p):
    """(scaled logits, sorted probs, sorted ids, keep mask in sorted order).
    temperature / top_p: floats, or tensors broadcasting against logits'
    leading axes with a trailing 1 (per-lane [B, 1])."""
    if isinstance(temperature, torch.Tensor):
        scaled = logits.float() / torch.clamp(temperature.float(), min=1e-6)
        top_p = torch.clamp(top_p.float(), 1e-6, 1.0)
    else:
        scaled = logits.float() / max(temperature, 1e-6)
        top_p = min(max(top_p, 1e-6), 1.0)
    probs = torch.softmax(scaled, dim=-1)
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = (cum - sorted_probs) < top_p  # first token always kept
    return scaled, sorted_probs, sorted_idx, keep


def filtered_scaled_logits(logits: torch.Tensor, temperature,
                           top_p) -> torch.Tensor:
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
    return _draw(logits, temperature, top_p, generator)


def _draw(logits, temperature, top_p, generator):
    _, sorted_probs, sorted_idx, keep = _nucleus(logits, temperature, top_p)
    masked = torch.where(keep, torch.log(sorted_probs.clamp_min(1e-38)),
                         torch.full_like(sorted_probs, float("-inf")))
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    choice = gumbel_argmax(masked, u)[..., None]
    return torch.gather(sorted_idx, -1, choice)[..., 0].to(torch.int32)


def gumbel_argmax(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """argmax(logits + Gumbel noise) over the last axis from uniforms u in
    [0, 1) of logits' shape: one categorical draw a row."""
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def spec_residual_row(fl: torch.Tensor, drafts: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row m of the filtered logits fl [K + 1, V], with the rejected draft
    d_m masked to -inf where m < K (the bonus row m == K stays unmasked); a
    row left with no finite entry falls back to the unmasked row (the
    nucleus was {d_m} alone and the rejection came from round-off)."""
    k = drafts.shape[0]
    full = fl.index_select(0, m.view(1))[0]
    d_m = drafts.index_select(0, torch.clamp(m, max=k - 1).view(1))
    v_iota = torch.arange(fl.shape[-1], device=fl.device)
    row = torch.where((m < k) & (v_iota == d_m), torch.full_like(full, float("-inf")), full)
    return torch.where(torch.isfinite(row).any(), row, full)


def spec_verify_sample(logits: torch.Tensor, drafts: torch.Tensor, temperature, top_p,
                       generator: torch.Generator | None = None, draws=None):
    """Rejection-sampling verification of deterministic drafts (the port of
    llamatpu/ops/sampling.py `spec_verify_sample`): draft d_i is accepted
    with probability p(d_i) under the filtered softmax; at the first
    rejection m the token is drawn from p with d_m removed (the bonus row
    when all K are accepted). The emitted stream is distributed as plain
    nucleus sampling; the numbers are not JAX's.

    logits [K + 1, V]; drafts [K] int; temperature / top_p floats or [1]
    tensors. draws: (K acceptance uniforms, V residual uniforms), else both
    from `generator`, in that order. Returns (cand [K + 1] int32, m int64
    0-d): cand[:m] == drafts[:m], cand[m] the drawn token, entries past m
    the drafts (callers take m + 1)."""
    k = drafts.shape[0]
    fl = filtered_scaled_logits(logits, temperature, top_p)
    p = torch.softmax(fl, dim=-1)
    if draws is None:
        u_acc = torch.rand(k, generator=generator, device=fl.device)
        u_res = torch.rand(fl.shape[-1], generator=generator, device=fl.device)
    else:
        u_acc, u_res = draws
    pd = torch.gather(p[:k], -1, drafts.long()[:, None])[:, 0]
    m = torch.cumprod((u_acc < pd).to(torch.int64), 0).sum()
    final = gumbel_argmax(spec_residual_row(fl, drafts, m), u_res)
    idxs = torch.arange(k + 1, device=fl.device)
    drafts_ext = torch.cat([drafts.to(torch.int64), drafts.new_zeros(1, dtype=torch.int64)])
    return torch.where(idxs == m, final, drafts_ext).to(torch.int32), m


def sample_dynamic(logits: torch.Tensor, temperatures: torch.Tensor, top_ps: torch.Tensor,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """One nucleus draw per row of [B, V] logits with per-row temperature
    (> 0) and top-p tensors [B]. Returns [B] int32."""
    return _draw(logits, temperatures[:, None], top_ps[:, None], generator)


def sample_lanes(logits: torch.Tensor, temperatures: torch.Tensor, top_ps: torch.Tensor,
                 generator: torch.Generator | None = None,
                 any_sampled: bool = True) -> torch.Tensor:
    """Per-lane sampling: argmax where temperature == 0, else a nucleus draw.
    any_sampled=False (the caller knows every lane is greedy) skips the draw
    and leaves the generator untouched."""
    greedy_ids = greedy(logits)
    if not any_sampled:
        return greedy_ids
    return torch.where(temperatures == 0.0, greedy_ids,
                       sample_dynamic(logits, temperatures, top_ps, generator))


def is_stop(ids: torch.Tensor, stops: torch.Tensor) -> torch.Tensor:
    """ids [...] against the stop vector [N] (padded with -1, which no id
    is): [...] bool. A broadcast compare, where `torch.isin` may take a path
    whose output size depends on the data."""
    return (ids[..., None] == stops.to(ids.dtype)).any(-1)
