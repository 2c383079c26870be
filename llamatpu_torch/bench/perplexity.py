"""Perplexity evaluation (the port of llamatpu/bench/perplexity.py): chunked
causal evaluation through the port's forward on the engine's device.

Texts longer than the cache evaluate with sliding windows: each window of
`cache_len` tokens starts `stride` (default cache_len // 2) after the
previous one from a fresh cache, re-ingests the overlap as unscored context,
and scores only the new tokens.
"""
from __future__ import annotations

import math

import torch

from llamatpu_torch.models.loader import LoadedModel
from llamatpu_torch.models.transformer import forward_tokens, init_cache
from llamatpu_torch.models.weights import serving_weights
from llamatpu_torch.runtime.engine import resolve_device


def perplexity(model: LoadedModel, token_ids: list[int], chunk: int = 128,
               cache_len: int | None = None, dtype: torch.dtype = torch.float32,
               stride: int | None = None, device=None, weights=None) -> dict:
    """ppl of `token_ids`: each position t >= 1 is scored with the logits
    produced after ingesting its predecessors. `weights`: an already served
    tree on `device` (else the model's weights are served here)."""
    cfg = model.cfg
    dev = resolve_device(device)
    n = len(token_ids)
    if n < 2:
        raise ValueError("need at least 2 tokens")
    cache_len = cache_len or min(cfg.context_length, ((n + chunk - 1) // chunk) * chunk)
    chunk = min(chunk, cache_len)
    stride = stride or max(chunk, cache_len // 2)
    stride = -(-stride // chunk) * chunk  # chunk-aligned window starts
    assert 0 < stride <= cache_len
    if weights is None:
        weights = serving_weights(cfg, model.weights, device=dev)

    total_nll = 0.0
    total_cnt = 0
    start = 0  # window start in the text
    while start == 0 or start + (cache_len - stride) < n - 1:
        window = token_ids[start : start + cache_len]
        score_from = 0 if start == 0 else cache_len - stride  # overlap = context only
        cache = init_cache(cfg, 1, dtype, cache_len, dev)
        i = 0
        while i < len(window) - (1 if start + len(window) >= n else 0):
            toks = window[i : i + chunk]
            c = len(toks)
            # targets may extend one past the window's end (text permitting)
            tail = token_ids[start + i + 1 : start + i + 1 + c]
            valid = [j + i >= score_from for j in range(len(tail))] + [False] * (c - len(tail))
            tgts = tail + [0] * (c - len(tail))
            if c < chunk:
                toks = toks + [0] * (chunk - c)
                tgts = tgts + [0] * (chunk - c)
                valid = valid + [False] * (chunk - c)
            logits, cache = forward_tokens(cfg, weights, torch.tensor([toks], device=dev),
                                           cache, i)
            logp = torch.log_softmax(logits.float(), dim=-1)[0]             # [C, V]
            tgt_lp = logp.gather(-1, torch.tensor(tgts, device=dev)[:, None])[:, 0]
            vmask = torch.tensor(valid, device=dev)
            total_nll += float(-torch.where(vmask, tgt_lp, torch.zeros_like(tgt_lp)).sum())
            total_cnt += int(vmask.sum())
            i += c
        if start + cache_len >= n:
            break
        start += stride

    ppl = math.exp(total_nll / max(total_cnt, 1))
    return {"ppl": ppl, "nll": total_nll, "tokens": total_cnt}


def perplexity_of_text(model: LoadedModel, text: str, **kw) -> dict:
    ids = model.tokenizer.encode(text, allowed_special="all")
    bot = model.chat_format.begin_of_text() if model.chat_format else -1
    if bot >= 0:
        ids = [bot] + ids
    return perplexity(model, ids, **kw)
